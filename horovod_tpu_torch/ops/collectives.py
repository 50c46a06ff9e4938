"""Collectives over the ``torch.distributed`` world or an axis of the
data mesh (the counterpart of ``horovod_tpu/ops/collectives.py``'s
in-trace functions).

Every entry takes ``axis_name`` and resolves it through
:func:`horovod_tpu_torch.parallel.mesh.resolve_hops`: ``None`` is the
data mesh's ``dp`` axis (or its ``("dpc", "dpl")`` pair) when
``HOROVOD_MESH`` names one, else the flat world ``"hvd"``.  The divisor
of Average is the axis total, not the world size.

Functional, as in the JAX package: inputs are never modified and a new
tensor is returned.  ``Average`` is a sum followed by a division by the
axis size in the wire dtype (``collectives.py:101-104``), not NCCL's
``AVG``, so it rounds the same way as the reference.

With a ``(cross, local)`` pair and ``HOROVOD_HIERARCHICAL_ALLREDUCE`` a
reduction decomposes into local reduce-scatter -> cross allreduce ->
local all-gather (:func:`hierarchical_allreduce`), and a lossy
compressor (int8, int4, top-k) rides the cross hop only
(:func:`_hierarchical_quantized`); without the knob a pair reduces flat
over both axes.  ``op=Adasum`` runs :mod:`horovod_tpu_torch.ops.adasum`
(hierarchical over a pair) and never the overlap schedule.

The cast compressors (fp16/bf16) wrap a reduction in compress -> reduce
-> decompress; the lossy ones dispatch to the scale-aware and sparse
reductions of :mod:`horovod_tpu_torch.ops.quantization` instead.
``overlap`` (default: the ``HOROVOD_OVERLAP`` knob) runs a reduction as
the bucketed schedule of :mod:`horovod_tpu_torch.ops.overlap`.

The span-wise helpers at the end (:func:`fuse_span`,
:func:`fuse_bucket_piece`, :func:`leaf_from_buckets`) build one bucket
of a fused buffer straight from its leaves, and one leaf straight from
bucket results, so the ZeRO stage-2/3 pipelines never assemble a
full-size fused buffer.
"""

from __future__ import annotations

import bisect

import torch
import torch.nn.functional as F

from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import true_divide
from horovod_tpu_torch.ops import adasum as _adasum
from horovod_tpu_torch.ops import overlap as _overlap
from horovod_tpu_torch.ops import quantization as _quant
from horovod_tpu_torch.ops.compression import (Compression, is_quantized,
                                               wire_mode)
from horovod_tpu_torch.parallel import mesh as _pmesh
from horovod_tpu_torch.parallel.mesh import HopPair

# Values match the JAX package (reference C ABI).
Average = 1
Sum = 2
Adasum = 3


def _check_op(op) -> None:
    if op not in (Average, Sum, Adasum):
        raise HorovodTpuError(f"Unknown reduce op: {op}")


def _check_quantized_op(op) -> None:
    if op == Adasum:
        raise HorovodTpuError(
            "Compression.int8/int4/topk does not compose with op=Adasum: "
            "the projection's dot/norm math is not preserved under "
            "block-scaled requantization or sparsification. Use fp16/bf16 "
            "compression with Adasum instead.")


def shard_index(axis_name=None) -> int:
    """This rank's flat index over ``axis_name`` (cross-major for a
    pair): the segment :func:`_scatter_flat_buffer` gives it."""
    return _pmesh.shard_index(axis_name)


def _reduce_flat(buf: torch.Tensor, op: int, hop) -> torch.Tensor:
    """Sum ``buf`` (owned by the caller, reduced in place) over ``hop``;
    divide for Average.  An integer Average divides at any size, so it
    returns floats as the reference's ``out / size`` does; a floating
    one over one rank skips the division by 1."""
    n = hop.size
    hop.all_reduce(buf)
    if op == Average and (n > 1 or not buf.is_floating_point()):
        buf = true_divide(buf, n)
    return buf


def allreduce(tensor: torch.Tensor, op: int = Average,
              compression=Compression.none,
              overlap: bool | None = None, axis_name=None) -> torch.Tensor:
    """Allreduce one tensor over ``axis_name``."""
    _check_op(op)
    hops = _pmesh.resolve_hops(axis_name)
    if is_quantized(compression) and tensor.is_floating_point():
        _check_quantized_op(op)
        return quantized_allreduce(tensor, op=op,
                                   mode=wire_mode(compression),
                                   overlap=overlap, axis_name=hops)
    wire, ctx = compression.compress(tensor)
    if op == Adasum:
        # never the overlap path: the projection needs the whole vector
        out = _adasum_buffer_reduce(wire.reshape(-1).clone(),
                                    [wire.numel()], hops).view(wire.shape)
    elif _overlap.enabled(overlap):
        out, _ = _overlap.overlapped_allreduce(wire, op=op, axis_name=hops)
    elif _pmesh.two_level(hops):
        out = hierarchical_allreduce(wire, hops.local, hops.cross, op=op)
    else:
        out = _reduce_flat(wire.clone(), op, _pmesh.flat_hop(hops))
    return compression.decompress(out, ctx)


def quantized_allreduce(tensor: torch.Tensor, op: int = Average,
                        block_size: int | None = None,
                        with_error: bool = False, mode: str = "int8",
                        overlap: bool | None = None, axis_name=None):
    """Allreduce on a lossy wire (``mode`` = int8 | int4 | topk).  With
    ``with_error`` also returns this rank's float32 residual (shape of
    ``tensor``) for error feedback.  Under the two-level decomposition
    only the cross hop is lossy.  Average divides after the cast back
    to ``tensor``'s dtype."""
    _check_op(op)
    hops = _pmesh.resolve_hops(axis_name)
    _check_quantized_op(op)
    if _overlap.enabled(overlap):
        out, err = _overlap.overlapped_allreduce(
            tensor, op=Sum, quantized=mode, with_error=with_error,
            block_size=block_size, axis_name=hops)
    elif _pmesh.two_level(hops):
        out, err = _hierarchical_quantized(tensor, hops.local, hops.cross,
                                           block_size, with_error, mode)
    else:
        out, err = _quant._lossy_psum_impl(tensor, mode, block_size, None,
                                           with_error, _pmesh.flat_hop(hops))
    out = out.to(tensor.dtype)
    if op == Average:
        out = true_divide(out, _pmesh.flat_hop(hops).size)
    return (out, err) if with_error else out


def grouped_allreduce(tensors, op: int = Average,
                      compression=Compression.none,
                      overlap: bool | None = None, axis_name=None) -> list:
    """Allreduce a list of tensors as one group: same-dtype payloads are
    concatenated into one flat buffer per dtype, reduced with one
    collective chain (the bucketed schedule under ``overlap``, the
    two-level one under a hierarchical pair, Adasum with per-tensor
    segments), and split back (``_grouped_fused``,
    ``collectives.py:208-237``).  A lossy compressor runs
    :func:`grouped_quantized_allreduce` instead."""
    _check_op(op)
    hops = _pmesh.resolve_hops(axis_name)
    if is_quantized(compression):
        _check_quantized_op(op)
        return grouped_quantized_allreduce(tensors, op=op,
                                           mode=wire_mode(compression),
                                           overlap=overlap,
                                           axis_name=hops)[0]
    if not tensors:
        return []
    wires, ctxs = zip(*[compression.compress(t) for t in tensors])
    if op == Adasum:
        outs = _grouped_fused(wires, lambda buf, sizes: _adasum_buffer_reduce(
            buf, sizes, hops))
    elif _overlap.enabled(overlap):
        outs = _grouped_fused(wires, lambda buf, sizes: _overlap
                              .overlapped_flat_reduce(buf, op=op,
                                                      axis_name=hops)[0])
    elif _pmesh.two_level(hops):
        outs = _grouped_fused(wires, lambda buf, sizes: hierarchical_allreduce(
            buf, hops.local, hops.cross, op=op))
    else:
        outs = _grouped_fused(wires, lambda buf, sizes: _reduce_flat(
            buf, op, _pmesh.flat_hop(hops)))
    return [compression.decompress(o, c) for o, c in zip(outs, ctxs)]


def _grouped_fused(wires, reduce_buffer) -> list:
    """Fuse same-dtype payloads into one flat buffer per dtype (a new
    tensor, owned here), apply ``reduce_buffer(buf, sizes)``, split
    back."""
    groups: dict = {}
    for i, w in enumerate(wires):
        groups.setdefault(w.dtype, []).append(i)
    outs: list = [None] * len(wires)
    for idxs in groups.values():
        sizes = [wires[i].numel() for i in idxs]
        buf = torch.cat([wires[i].reshape(-1) for i in idxs])
        red = reduce_buffer(buf, sizes)
        off = 0
        for i, n in zip(idxs, sizes):
            outs[i] = red[off:off + n].view(wires[i].shape)
            off += n
    return outs


def _adasum_buffer_reduce(buf, sizes, hops):
    """One Adasum over a fused buffer: the exchanges ride the whole
    buffer, the dot products and coefficients stay per tensor."""
    segments = sizes if len(sizes) > 1 else None
    if isinstance(hops, HopPair):
        return _adasum.adasum_hierarchical(buf, hops.local, hops.cross,
                                           segments)
    return _adasum.adasum(buf, hops, segments)


def grouped_quantized_allreduce(tensors, op: int = Average,
                                block_size: int | None = None,
                                with_error: bool = False,
                                mode: str = "int8",
                                overlap: bool | None = None,
                                axis_name=None):
    """Grouped allreduce on a lossy wire: every floating leaf, whatever
    its dtype, is raveled into ONE float32 buffer -> one lossy reduction
    (under ``overlap``, the bucketed schedule: each bucket compressed on
    its own; under a hierarchical pair, lossy on the cross hop only) ->
    split and cast back; integer and bool leaves take an uncompressed
    sum.  Returns ``(outputs, errors)``: ``errors`` is a list of float32
    residuals (zeros for the pass-through leaves) when ``with_error``,
    else ``None``."""
    _check_op(op)
    hops = _pmesh.resolve_hops(axis_name)
    _check_quantized_op(op)
    if not tensors:
        return [], ([] if with_error else None)
    fidx = [i for i, t in enumerate(tensors) if t.is_floating_point()]
    oidx = [i for i, t in enumerate(tensors) if not t.is_floating_point()]
    outs: list = [None] * len(tensors)
    errs: list = [None] * len(tensors)
    n = _pmesh.flat_hop(hops).size
    if fidx:
        buf = torch.cat([tensors[i].to(torch.float32).reshape(-1)
                         for i in fidx])
        if _overlap.enabled(overlap):
            red, err = _overlap.overlapped_flat_reduce(
                buf, op=Sum, quantized=mode, with_error=with_error,
                block_size=block_size, axis_name=hops)
        elif _pmesh.two_level(hops):
            red, err = _hierarchical_quantized(buf, hops.local, hops.cross,
                                               block_size, with_error, mode)
        else:
            red, err = _quant._lossy_psum_impl(buf, mode, block_size, None,
                                               with_error, _pmesh.flat_hop(hops))
        if op == Average:
            red = true_divide(red, n)
        off = 0
        for i in fidx:
            sz, t = tensors[i].numel(), tensors[i]
            outs[i] = red[off:off + sz].reshape(t.shape).to(t.dtype)
            if err is not None:
                errs[i] = err[off:off + sz].reshape(t.shape)
            off += sz
    if oidx:
        reds = _grouped_fused([tensors[i] for i in oidx],
                              lambda buf, sizes: _reduce_flat(buf, op,
                                                              _pmesh.flat_hop(hops)))
        for i, r in zip(oidx, reds):
            outs[i] = r
            if with_error:
                errs[i] = torch.zeros(r.shape, dtype=torch.float32,
                                      device=r.device)
    return outs, (errs if with_error else None)


# ---------------------------------------------------------------------------
# The two-level (cross, local) reductions
# ---------------------------------------------------------------------------


def _pad_to(flat: torch.Tensor, m: int) -> torch.Tensor:
    pad = (-flat.shape[0]) % m
    return F.pad(flat, (0, pad)) if pad else flat


def _local_scatter(flat: torch.Tensor, local) -> torch.Tensor:
    """Full-precision reduce-scatter of ``flat`` (length a multiple of
    the local size) over the local hop."""
    part = torch.empty(flat.shape[0] // local.size, dtype=flat.dtype,
                       device=flat.device)
    local.reduce_scatter(part, flat.contiguous())
    return part


def _local_gather(part: torch.Tensor, local) -> torch.Tensor:
    out = torch.empty(part.shape[0] * local.size, dtype=part.dtype,
                      device=part.device)
    local.all_gather(out, part.contiguous())
    return out


def hierarchical_allreduce(tensor: torch.Tensor, local_axis, cross_axis,
                           op: int = Average, compression=Compression.none,
                           block_size: int | None = None) -> torch.Tensor:
    """Two-level allreduce (the reference's ``NCCLHierarchicalAllreduce``,
    ``horovod_tpu/ops/collectives.py:316-371``): local reduce-scatter ->
    cross allreduce -> local all-gather, the tensor zero-padded to a
    multiple of the local size and trimmed.  Equal to a flat sum over
    both axes up to summation order.  A lossy ``compression`` rides the
    cross hop only.  Average true-divides by ``nl * nc``."""
    if op not in (Average, Sum):
        raise HorovodTpuError(
            f"hierarchical_allreduce supports Sum/Average, got op={op}")
    local = _pmesh.flat_hop(local_axis)
    cross = _pmesh.flat_hop(cross_axis)
    nl, nc = local.size, cross.size
    if is_quantized(compression) and tensor.is_floating_point():
        out, _ = _hierarchical_quantized(tensor, local, cross, block_size,
                                         False, wire_mode(compression))
        out = out.to(tensor.dtype)
        return true_divide(out, nl * nc) if op == Average else out
    flat = tensor.reshape(-1)
    total = flat.shape[0]
    part = _local_scatter(_pad_to(flat, nl), local)
    cross.all_reduce(part)
    out = _local_gather(part, local)[:total].reshape(tensor.shape)
    if op == Average:
        # a true division, as the flat path's: integers promote to float
        out = true_divide(out, nl * nc)
    return out


def _hierarchical_quantized(tensor, local, cross,
                            block_size: int | None = None,
                            with_error: bool = False, mode: str = "int8"):
    """Full-precision local hops, lossy cross hop (``mode`` = int8 | int4
    | topk): ``(sum, residual)`` (``horovod_tpu/ops/collectives.py:
    374-416``).  The cross hop's headroom is ``sum_safe_qmax(nc)``: the
    sum that rides the lossy wire has nc terms.  ``residual`` (float32,
    shape of ``tensor``, ``with_error`` only) is the cross hop's error of
    this rank's local shard, all-gathered over the local hop and
    pre-divided by ``nl``: added to the next step's per-rank gradient,
    the local reduce-scatter rebuilds exactly that shard's error."""
    nl, nc = local.size, cross.size
    shape = tensor.shape
    flat = tensor.to(torch.float32).reshape(-1)
    total = flat.shape[0]
    part = _local_scatter(_pad_to(flat, nl), local)    # full precision
    err_part = None
    if nc > 1:
        part, err_part = _quant._lossy_psum_impl(part, mode, block_size,
                                                 None, with_error, cross)
    elif with_error:
        err_part = torch.zeros_like(part)
    out = _local_gather(part, local)[:total].reshape(shape)
    err = None
    if with_error:
        err = _local_gather(err_part, local)
        err = (true_divide(err, nl) if nl > 1 else err)[:total] \
            .reshape(shape)
    return out, err


def local_allreduce(tensor: torch.Tensor, axis_name=None,
                    op: int = Average) -> torch.Tensor:
    """Reduce over the local hop only (``axis_name[1]`` of a pair; a
    single axis whole), in full precision."""
    if op not in (Average, Sum):
        raise HorovodTpuError(
            f"local_allreduce supports Sum/Average, got op={op}")
    hops = _pmesh.resolve_hops(axis_name)
    hop = hops.local if isinstance(hops, HopPair) else hops
    return _reduce_flat(tensor.detach().clone().contiguous(), op, hop)


def cross_allreduce(tensor: torch.Tensor, axis_name=None,
                    op: int = Average, compression=Compression.none,
                    with_error: bool = False,
                    block_size: int | None = None):
    """Reduce over the cross hop only (pair needed); a lossy
    ``compression`` rides that hop, and ``with_error`` returns this
    rank's residual (not divided: each rank re-injects its own)."""
    if op not in (Average, Sum):
        raise HorovodTpuError(
            f"cross_allreduce supports Sum/Average, got op={op}")
    hops = _pmesh.resolve_hops(axis_name)
    if not isinstance(hops, HopPair):
        raise HorovodTpuError(
            "cross_allreduce needs a (cross, local) axis pair -- a "
            "single axis has no cross hop.  Configure the hierarchical "
            "mesh split (HOROVOD_HIERARCHICAL_ALLREDUCE + "
            "HOROVOD_HIERARCHICAL_LOCAL_SIZE, or a dpc/dpl mesh) or pass "
            "axis_name=(cross, local) explicitly.")
    cross, shape = hops.cross, tensor.shape
    err = None
    if is_quantized(compression) and tensor.is_floating_point():
        red, err = _quant._lossy_psum_impl(
            tensor.to(torch.float32).reshape(-1), wire_mode(compression),
            block_size, None, with_error, cross)
        out = red.to(tensor.dtype).reshape(shape)
        err = err.reshape(shape) if err is not None else None
    else:
        wire, ctx = compression.compress(tensor)
        out = compression.decompress(
            cross.all_reduce(wire.detach().clone().contiguous()), ctx)
        if with_error:
            err = torch.zeros(shape, dtype=torch.float32,
                              device=tensor.device)
    if op == Average:
        out = true_divide(out, cross.size)
    return (out, err) if with_error else out


def hierarchical_allgather(tensor: torch.Tensor, local_axis, cross_axis):
    """Two-level allgather: the local gather, then the cross gather of
    the local blocks: rank-major order for a ``(cross, local)`` pair."""
    local = _pmesh.flat_hop(local_axis)
    cross = _pmesh.flat_hop(cross_axis)
    return _quant._all_gather(_quant._all_gather(tensor, local), cross)


def allgather(tensor: torch.Tensor, axis_name=None) -> torch.Tensor:
    """Concatenate every rank's tensor along axis 0 (equal shapes)."""
    if tensor.dim() == 0:
        raise HorovodTpuError("allgather requires rank >= 1 tensors")
    hops = _pmesh.resolve_hops(axis_name)
    if isinstance(hops, HopPair):
        return hierarchical_allgather(tensor, hops.local, hops.cross)
    return _quant._all_gather(tensor, hops)


def alltoall(tensor: torch.Tensor, axis_name=None) -> torch.Tensor:
    """Equal-split all-to-all along axis 0: chunk ``j`` of this rank's
    tensor goes to the axis member ``j``, and the result stacks what
    every member sent here in axis order.  An
    axis pair is refused, as the reference refuses any two-axis name."""
    ax = _pmesh.resolve_axis(axis_name)
    if isinstance(ax, HopPair) or (isinstance(ax, (tuple, list))
                                   and len(ax) == 2):
        raise HorovodTpuError(
            "alltoall over a hierarchical (cross, local) axis pair is "
            "not supported; pass a single mesh axis name")
    hop = _pmesh.flat_hop(ax)
    n = hop.size
    if tensor.dim() == 0 or tensor.shape[0] % n:
        raise HorovodTpuError(
            f"alltoall needs a leading dimension divisible by the axis "
            f"size {n}, got shape {tuple(tensor.shape)}")
    out = torch.empty_like(tensor, memory_format=torch.contiguous_format)
    hop.all_to_all(out, tensor.contiguous())
    return out


def reducescatter(tensor: torch.Tensor, op: int = Sum,
                  compression=Compression.none,
                  block_size: int | None = None,
                  overlap: bool | None = None,
                  axis_name=None) -> torch.Tensor:
    """Reduce + scatter along axis 0.  A leading dimension that does not
    divide the axis size is zero-padded here: every rank returns
    ``ceil(d0 / n)`` rows, the trailing ranks holding zero tail rows.  A
    lossy compressor rides its wire with blocks laid out inside each
    output shard (under a hierarchical pair, on the cross hop only)."""
    return grouped_reducescatter([tensor], op=op, compression=compression,
                                 block_size=block_size, overlap=overlap,
                                 axis_name=axis_name)[0]


def grouped_reducescatter(tensors, op: int = Sum,
                          compression=Compression.none,
                          block_size: int | None = None,
                          overlap: bool | None = None,
                          axis_name=None) -> list:
    """Reduce + scatter a list of tensors along axis 0 in one group:
    same-dtype payloads fuse into one flat buffer (under a lossy
    compressor, every floating leaf into one float32 buffer), each rank
    getting back its ``ceil(d0 / n)``-row shard of every tensor."""
    if op not in (Average, Sum):
        raise HorovodTpuError(
            f"reducescatter supports Sum/Average only, got op={op}")
    hops = _pmesh.resolve_hops(axis_name)
    if not tensors:
        return []
    if any(t.dim() == 0 for t in tensors):
        raise HorovodTpuError("reducescatter requires rank >= 1 tensors")
    quant = is_quantized(compression)
    if quant:
        wires, ctxs = list(tensors), [None] * len(tensors)
    else:
        wires, ctxs = map(list, zip(*[compression.compress(t)
                                      for t in tensors]))
    n = _pmesh.flat_hop(hops).size
    shard0s = [-(-w.shape[0] // n) for w in wires]
    if n == 1:
        return [compression.decompress(w, c) for w, c in zip(wires, ctxs)]
    groups: dict = {}
    for i, w in enumerate(wires):
        key = "q" if quant and w.is_floating_point() else w.dtype
        groups.setdefault(key, []).append(i)
    outs: list = [None] * len(wires)
    qmode = wire_mode(compression) if quant else "none"
    for key, idxs in groups.items():
        lossy = key == "q"
        segs, sizes = [], []
        for i in idxs:
            w = wires[i]
            rows = shard0s[i] * n
            if rows != w.shape[0]:
                w = torch.cat([w, w.new_zeros((rows - w.shape[0],)
                                              + tuple(w.shape[1:]))])
            seg = w.reshape(n, -1)
            segs.append(seg.to(torch.float32) if lossy else seg)
            sizes.append(seg.shape[1])
        seg = torch.cat(segs, dim=1)
        red, _ = _scatter_flat_buffer(seg.reshape(-1),
                                      quantized=qmode if lossy else False,
                                      block_size=block_size,
                                      overlap=overlap, axis_name=hops)
        if op == Average:
            red = true_divide(red, n)
        off = 0
        for i, sz in zip(idxs, sizes):
            shard = red[off:off + sz].reshape(
                (shard0s[i],) + tuple(wires[i].shape[1:]))
            if lossy:
                outs[i] = shard.to(tensors[i].dtype)
            else:
                # Average on integer leaves promotes to float (the true
                # divide); everything else returns in the wire dtype
                if op == Sum or wires[i].is_floating_point():
                    shard = shard.to(wires[i].dtype)
                outs[i] = compression.decompress(shard, ctxs[i])
            off += sz
    return outs


def _scatter_flat_buffer(buf: torch.Tensor, quantized=False,
                         with_error: bool = False,
                         block_size: int | None = None,
                         overlap: bool | None = None, axis_name=None):
    """Reduce-scatter a 1-D buffer whose length divides by the axis total
    ``n`` into this rank's ``len / n`` shard (summed; the caller divides
    for Average): segment ``i`` lands on the rank whose
    :func:`shard_index` is ``i``.  ``quantized`` is ``False`` or a wire
    mode (``True`` = int8); under a hierarchical pair the scatter is
    local (full precision) then cross, and only the cross hop is lossy
    (``overlap._hier_scatter``).
    Returns ``(shard, err)``; ``err`` (``with_error``, lossy modes) is
    the full-buffer float32 residual (under the pair, gathered over the
    local hop and pre-divided by ``nl``).  ``overlap`` runs it in
    buckets: the same shard and residual layout."""
    hops = _pmesh.resolve_hops(axis_name)
    if _overlap.enabled(overlap):
        return _overlap.overlapped_scatter_flat_buffer(
            buf, quantized=quantized, with_error=with_error,
            block_size=block_size, axis_name=hops)
    return _overlap.scatter_bucket(buf, quantized, with_error, block_size,
                                   axis_name=hops)


def _gather_flat_shard(shard: torch.Tensor, overlap: bool | None = None,
                       axis_name=None):
    """Inverse of :func:`_scatter_flat_buffer`: every rank's 1-D shard
    gathered back into the full buffer in segment order."""
    hops = _pmesh.resolve_hops(axis_name)
    if _overlap.enabled(overlap):
        return _overlap.overlapped_gather_flat_shard(shard, axis_name=hops)
    return _overlap.gather_bucket(shard, axis_name=hops)


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              axis_name=None) -> torch.Tensor:
    """Return the value of ``tensor`` at axis index ``root_rank`` (the
    flat, cross-major index for a pair) on every rank of the axis."""
    hop = _pmesh.flat_hop(axis_name)
    return hop.broadcast(tensor.detach().clone().contiguous(), root_rank)


def broadcast_(tensors, root_rank: int = 0, axis_name=None) -> None:
    """Overwrite each tensor in place with the value at axis index
    ``root_rank``, one collective per dtype (fused like
    :func:`grouped_allreduce`)."""
    hop = _pmesh.flat_hop(axis_name)
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for ts in groups.values():
        buf = torch.cat([t.detach().reshape(-1) for t in ts])
        hop.broadcast(buf, root_rank)
        off = 0
        with torch.no_grad():
            for t in ts:
                n = t.numel()
                t.copy_(buf[off:off + n].view(t.shape))
                off += n


# ---------------------------------------------------------------------------
# Span-wise fused-buffer assembly (the ZeRO stage-2/3 bucket pipelines)
# ---------------------------------------------------------------------------


def _offsets(sizes) -> list:
    offsets = [0]
    for sz in sizes:
        offsets.append(offsets[-1] + sz)
    return offsets


def fuse_span(leaves, idxs, sizes, start: int, end: int, dtype,
              offsets=None) -> torch.Tensor:
    """Elements ``[start, end)`` of the zero-padded fused flat buffer of
    ``leaves[i] for i in idxs`` (flat sizes ``sizes``), without
    concatenating the whole buffer: only the members that overlap the
    window are read, then zeros for the pad.  ``offsets`` (the
    ``len(idxs) + 1`` cumulative member starts) lets repeated callers
    bisect to the first member.  A window inside one member of
    ``dtype`` is a view of it."""
    if offsets is None:
        offsets = _offsets(sizes)
    pieces = []
    j = max(bisect.bisect_right(offsets, start) - 1, 0)
    while j < len(idxs) and offsets[j] < end:
        off, sz = offsets[j], sizes[j]
        a, b = max(start, off), min(end, off + sz)
        if a < b:
            pieces.append(leaves[idxs[j]].reshape(-1)[a - off:b - off]
                          .to(dtype))
        j += 1
    covered = sum(p.shape[0] for p in pieces)
    if covered < end - start:
        dev = leaves[idxs[0]].device
        pieces.append(torch.zeros(end - start - covered, dtype=dtype,
                                  device=dev))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def fuse_bucket_piece(leaves, idxs, sizes, padded: int, n: int, s: int,
                      e: int, dtype, inject=None) -> torch.Tensor:
    """Bucket ``[s, e)`` of the ``(n, L)`` segment view of the padded
    fused buffer, one :func:`fuse_span` per segment, as the flat ``(n *
    (e - s),)`` segment-order buffer a bucket's reduce-scatter takes.
    ``inject(lo, hi)`` (optional) returns a term added to flat window
    ``[lo, hi)``: the error-feedback residual's slice."""
    L = padded // n
    offsets = _offsets(sizes)
    spans = []
    for i in range(n):
        span = fuse_span(leaves, idxs, sizes, i * L + s, i * L + e, dtype,
                         offsets=offsets)
        if inject is not None:
            span = span + inject(i * L + s, i * L + e)
        spans.append(span)
    return spans[0] if len(spans) == 1 else torch.cat(spans)


def leaf_from_buckets(bucket_outs, bounds, n: int, L: int, off: int,
                      sz: int) -> torch.Tensor:
    """The flat leaf at ``[off, off + sz)`` of a fused buffer, from
    bucket results (``bucket_outs[k]`` the flat ``(n * (e_k - s_k),)``
    segment-order result of column bucket ``bounds[k]`` of the ``(n,
    L)`` view): the leaf range splits into runs of one segment and one
    bucket, each a slice of one bucket result, so no full-size buffer is
    assembled.  A leaf in one run is a view."""
    pieces = []
    p, end = off, off + sz
    while p < end:
        seg, c = divmod(p, L)
        k = next(k for k, (s, e) in enumerate(bounds) if s <= c < e)
        s, e = bounds[k]
        run = min(end, seg * L + e) - p
        start = seg * (e - s) + (c - s)
        pieces.append(bucket_outs[k][start:start + run])
        p += run
    if not pieces:
        return bucket_outs[0][:0]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)
