"""Collectives over the ``torch.distributed`` world (the counterpart of
``horovod_tpu/ops/collectives.py`` on the flat world axis).

Functional, as in the JAX package: inputs are never modified and a new
tensor is returned.  ``Average`` is a sum followed by a division by the
world size in the wire dtype (``collectives.py:101-104``), not NCCL's
``AVG``, so it rounds the same way as the reference.

The cast compressors (fp16/bf16) wrap a reduction in compress -> reduce
-> decompress; the lossy ones (int8/int4/topk) dispatch to the
scale-aware and sparse reductions of :mod:`horovod_tpu_torch.ops.
quantization` instead.  ``overlap`` (default: the ``HOROVOD_OVERLAP``
knob) runs a reduction as the bucketed schedule of
:mod:`horovod_tpu_torch.ops.overlap`.

The span-wise helpers at the end (:func:`fuse_span`,
:func:`fuse_bucket_piece`, :func:`leaf_from_buckets`) build one bucket
of a fused buffer straight from its leaves, and one leaf straight from
bucket results, so the ZeRO stage-2/3 pipelines never assemble a
full-size fused buffer.
"""

from __future__ import annotations

import bisect

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import true_divide
from horovod_tpu_torch.ops import overlap as _overlap
from horovod_tpu_torch.ops import quantization as _quant
from horovod_tpu_torch.ops.compression import (Compression, is_quantized,
                                               wire_mode)

# Values match the JAX package (reference C ABI).
Average = 1
Sum = 2
Adasum = 3


def _check_op(op) -> None:
    _config.refuse_not_ported()
    if op == Adasum:
        raise NotImplementedError(
            "op=Adasum is not ported yet (ROADMAP.md Queue A item 9)")
    if op not in (Average, Sum):
        raise HorovodTpuError(f"Unknown reduce op: {op}")


def _check_quantized_op(op) -> None:
    if op == Adasum:
        raise HorovodTpuError(
            "Compression.int8/int4/topk does not compose with op=Adasum: "
            "the projection's dot/norm math is not preserved under "
            "block-scaled requantization or sparsification. Use fp16/bf16 "
            "compression with Adasum instead.")


def _reduce_flat(buf: torch.Tensor, op: int) -> torch.Tensor:
    """Sum ``buf`` (owned by the caller, reduced in place) over the
    world; divide for Average.  An integer Average divides at any world
    size, so it returns floats as the reference's ``out / size`` does; a
    floating one at world 1 skips the division by 1."""
    n = _basics.size()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    if op == Average and (n > 1 or not buf.is_floating_point()):
        buf = true_divide(buf, n)
    return buf


def allreduce(tensor: torch.Tensor, op: int = Average,
              compression=Compression.none,
              overlap: bool | None = None) -> torch.Tensor:
    """Allreduce one tensor over the world."""
    if is_quantized(compression) and tensor.is_floating_point():
        return quantized_allreduce(tensor, op=op,
                                   mode=wire_mode(compression),
                                   overlap=overlap)
    _check_op(op)
    wire, ctx = compression.compress(tensor)
    if _overlap.enabled(overlap):
        out, _ = _overlap.overlapped_allreduce(wire, op=op)
    else:
        out = _reduce_flat(wire.clone(), op)
    return compression.decompress(out, ctx)


def quantized_allreduce(tensor: torch.Tensor, op: int = Average,
                        block_size: int | None = None,
                        with_error: bool = False, mode: str = "int8",
                        overlap: bool | None = None):
    """Allreduce on a lossy wire (``mode`` = int8 | int4 | topk).  With
    ``with_error`` also returns this rank's float32 residual (shape of
    ``tensor``) for error feedback.  Average divides after the cast back
    to ``tensor``'s dtype."""
    _check_quantized_op(op)
    _check_op(op)
    if _overlap.enabled(overlap):
        out, err = _overlap.overlapped_allreduce(
            tensor, op=Sum, quantized=mode, with_error=with_error,
            block_size=block_size)
    else:
        out, err = _quant._lossy_psum_impl(tensor, mode, block_size, None,
                                           with_error)
    out = out.to(tensor.dtype)
    if op == Average:
        out = true_divide(out, _basics.size())
    return (out, err) if with_error else out


def grouped_allreduce(tensors, op: int = Average,
                      compression=Compression.none,
                      overlap: bool | None = None) -> list:
    """Allreduce a list of tensors as one group: same-dtype payloads are
    concatenated into one flat buffer per dtype, reduced with one
    collective (or, under ``overlap``, the bucketed schedule, which
    divides bucket by bucket for Average), and split back
    (``_grouped_fused``, ``collectives.py:208-226``).  A lossy compressor
    runs :func:`grouped_quantized_allreduce` instead."""
    if is_quantized(compression):
        return grouped_quantized_allreduce(tensors, op=op,
                                           mode=wire_mode(compression),
                                           overlap=overlap)[0]
    _check_op(op)
    if not tensors:
        return []
    wires, ctxs = zip(*[compression.compress(t) for t in tensors])
    if _overlap.enabled(overlap):
        outs = _grouped_fused(wires, op, lambda buf, op: _overlap
                              .overlapped_flat_reduce(buf, op=op)[0])
    else:
        outs = _grouped_fused(wires, op)
    return [compression.decompress(o, c) for o, c in zip(outs, ctxs)]


def _grouped_fused(wires, op: int, reduce=_reduce_flat) -> list:
    groups: dict = {}
    for i, w in enumerate(wires):
        groups.setdefault(w.dtype, []).append(i)
    outs: list = [None] * len(wires)
    for idxs in groups.values():
        buf = torch.cat([wires[i].reshape(-1) for i in idxs])
        red = reduce(buf, op)
        off = 0
        for i in idxs:
            n = wires[i].numel()
            outs[i] = red[off:off + n].view(wires[i].shape)
            off += n
    return outs


def grouped_quantized_allreduce(tensors, op: int = Average,
                                block_size: int | None = None,
                                with_error: bool = False,
                                mode: str = "int8",
                                overlap: bool | None = None):
    """Grouped allreduce on a lossy wire: every floating leaf, whatever
    its dtype, is raveled into ONE float32 buffer -> one lossy reduction
    (under ``overlap``, the bucketed schedule: each bucket compressed on
    its own) -> split and cast back; integer and bool leaves take an
    uncompressed sum.  Returns ``(outputs, errors)``: ``errors`` is a
    list of float32 residuals (zeros for the pass-through leaves) when
    ``with_error``, else ``None``."""
    _check_quantized_op(op)
    _check_op(op)
    if not tensors:
        return [], ([] if with_error else None)
    fidx = [i for i, t in enumerate(tensors) if t.is_floating_point()]
    oidx = [i for i, t in enumerate(tensors) if not t.is_floating_point()]
    outs: list = [None] * len(tensors)
    errs: list = [None] * len(tensors)
    n = _basics.size()
    if fidx:
        buf = torch.cat([tensors[i].to(torch.float32).reshape(-1)
                         for i in fidx])
        if _overlap.enabled(overlap):
            red, err = _overlap.overlapped_flat_reduce(
                buf, op=Sum, quantized=mode, with_error=with_error,
                block_size=block_size)
        else:
            red, err = _quant._lossy_psum_impl(buf, mode, block_size, None,
                                               with_error)
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
        for i, r in zip(oidx, _grouped_fused([tensors[i] for i in oidx],
                                             op)):
            outs[i] = r
            if with_error:
                errs[i] = torch.zeros(r.shape, dtype=torch.float32,
                                      device=r.device)
    return outs, (errs if with_error else None)


def allgather(tensor: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's tensor along axis 0 (equal shapes)."""
    _config.refuse_not_ported()
    if tensor.dim() == 0:
        raise HorovodTpuError("allgather requires rank >= 1 tensors")
    return _quant._all_gather(tensor, _basics.size())


def alltoall(tensor: torch.Tensor) -> torch.Tensor:
    """Equal-split all-to-all along axis 0: chunk ``j`` of this rank's
    tensor goes to rank ``j``, and the result stacks what every rank
    sent here in rank order."""
    _config.refuse_not_ported()
    n = _basics.size()
    if tensor.dim() == 0 or tensor.shape[0] % n:
        raise HorovodTpuError(
            f"alltoall needs a leading dimension divisible by the world "
            f"size {n}, got shape {tuple(tensor.shape)}")
    out = torch.empty_like(tensor, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, tensor.contiguous())
    return out


def reducescatter(tensor: torch.Tensor, op: int = Sum,
                  compression=Compression.none,
                  block_size: int | None = None,
                  overlap: bool | None = None) -> torch.Tensor:
    """Reduce + scatter along axis 0.  A leading dimension that does not
    divide the world size is zero-padded here: every rank returns
    ``ceil(d0 / n)`` rows, the trailing ranks holding zero tail rows.  A
    lossy compressor rides its wire with blocks laid out inside each
    output shard."""
    return grouped_reducescatter([tensor], op=op, compression=compression,
                                 block_size=block_size, overlap=overlap)[0]


def grouped_reducescatter(tensors, op: int = Sum,
                          compression=Compression.none,
                          block_size: int | None = None,
                          overlap: bool | None = None) -> list:
    """Reduce + scatter a list of tensors along axis 0 in one group:
    same-dtype payloads fuse into one flat buffer (under a lossy
    compressor, every floating leaf into one float32 buffer), each rank
    getting back its ``ceil(d0 / n)``-row shard of every tensor."""
    if op not in (Average, Sum):
        raise HorovodTpuError(
            f"reducescatter supports Sum/Average only, got op={op}")
    _config.refuse_not_ported()
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
    n = _basics.size()
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
                                      overlap=overlap)
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
                         overlap: bool | None = None):
    """Reduce-scatter a 1-D buffer whose length divides by the world size
    ``n`` into this rank's ``len / n`` shard (summed; the caller divides
    for Average): segment ``i`` lands on rank ``i``.  ``quantized`` is
    ``False`` or a wire mode (``True`` = int8).  Returns ``(shard,
    err)``; ``err`` (``with_error``, lossy modes) is the full-buffer
    float32 residual.  ``overlap`` runs it in buckets: the same shard
    and residual layout."""
    if _overlap.enabled(overlap):
        return _overlap.overlapped_scatter_flat_buffer(
            buf, quantized=quantized, with_error=with_error,
            block_size=block_size)
    return _overlap.scatter_bucket(buf, quantized, with_error, block_size)


def _gather_flat_shard(shard: torch.Tensor, overlap: bool | None = None):
    """Inverse of :func:`_scatter_flat_buffer`: every rank's 1-D shard
    gathered back into the full buffer in segment order."""
    if _overlap.enabled(overlap):
        return _overlap.overlapped_gather_flat_shard(shard)
    return _overlap.gather_bucket(shard)


def broadcast(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """Return ``root_rank``'s value of ``tensor`` on every rank."""
    _config.refuse_not_ported()
    out = tensor.detach().clone().contiguous()
    dist.broadcast(out, src=root_rank)
    return out


def broadcast_(tensors, root_rank: int = 0) -> None:
    """Overwrite each tensor in place with ``root_rank``'s value, one
    collective per dtype (fused like :func:`grouped_allreduce`)."""
    _config.refuse_not_ported()
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for ts in groups.values():
        buf = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(buf, src=root_rank)
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
