"""Collectives over the ``torch.distributed`` world (the counterpart of
``horovod_tpu/ops/collectives.py`` on the flat world axis).

Functional, as in the JAX package: inputs are never modified and a new
tensor is returned.  ``Average`` is a sum followed by a division by the
world size in the wire dtype (``collectives.py:101-104``), not NCCL's
``AVG``, so it rounds the same way as the reference.

The cast compressors (fp16/bf16) wrap a reduction in compress -> reduce
-> decompress; the lossy ones (int8/int4/topk) dispatch to the
scale-aware and sparse reductions of :mod:`horovod_tpu_torch.ops.
quantization` instead.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import true_divide
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
              compression=Compression.none) -> torch.Tensor:
    """Allreduce one tensor over the world."""
    if is_quantized(compression) and tensor.is_floating_point():
        return quantized_allreduce(tensor, op=op,
                                   mode=wire_mode(compression))
    _check_op(op)
    wire, ctx = compression.compress(tensor)
    out = _reduce_flat(wire.clone(), op)
    return compression.decompress(out, ctx)


def quantized_allreduce(tensor: torch.Tensor, op: int = Average,
                        block_size: int | None = None,
                        with_error: bool = False, mode: str = "int8"):
    """Allreduce on a lossy wire (``mode`` = int8 | int4 | topk).  With
    ``with_error`` also returns this rank's float32 residual (shape of
    ``tensor``) for error feedback.  Average divides after the cast back
    to ``tensor``'s dtype."""
    _check_quantized_op(op)
    _check_op(op)
    out, err = _quant._lossy_psum_impl(tensor, mode, block_size, None,
                                       with_error)
    out = out.to(tensor.dtype)
    if op == Average:
        out = true_divide(out, _basics.size())
    return (out, err) if with_error else out


def grouped_allreduce(tensors, op: int = Average,
                      compression=Compression.none) -> list:
    """Allreduce a list of tensors as one group: same-dtype payloads are
    concatenated into one flat buffer per dtype, reduced with one
    collective, and split back (``_grouped_fused``,
    ``collectives.py:208-226``).  A lossy compressor runs
    :func:`grouped_quantized_allreduce` instead."""
    if is_quantized(compression):
        return grouped_quantized_allreduce(tensors, op=op,
                                           mode=wire_mode(compression))[0]
    _check_op(op)
    if not tensors:
        return []
    wires, ctxs = zip(*[compression.compress(t) for t in tensors])
    outs = _grouped_fused(wires, op)
    return [compression.decompress(o, c) for o, c in zip(outs, ctxs)]


def _grouped_fused(wires, op: int) -> list:
    groups: dict = {}
    for i, w in enumerate(wires):
        groups.setdefault(w.dtype, []).append(i)
    outs: list = [None] * len(wires)
    for idxs in groups.values():
        buf = torch.cat([wires[i].reshape(-1) for i in idxs])
        red = _reduce_flat(buf, op)
        off = 0
        for i in idxs:
            n = wires[i].numel()
            outs[i] = red[off:off + n].view(wires[i].shape)
            off += n
    return outs


def grouped_quantized_allreduce(tensors, op: int = Average,
                                block_size: int | None = None,
                                with_error: bool = False,
                                mode: str = "int8"):
    """Grouped allreduce on a lossy wire: every floating leaf, whatever
    its dtype, is raveled into ONE float32 buffer -> one lossy reduction
    -> split and cast back; integer and bool leaves take an uncompressed
    sum.  Returns ``(outputs, errors)``: ``errors`` is a list of float32
    residuals (zeros for the pass-through leaves) when ``with_error``,
    else ``None``."""
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
                  block_size: int | None = None) -> torch.Tensor:
    """Reduce + scatter along axis 0.  A leading dimension that does not
    divide the world size is zero-padded here: every rank returns
    ``ceil(d0 / n)`` rows, the trailing ranks holding zero tail rows.  A
    lossy compressor rides its wire with blocks laid out inside each
    output shard."""
    return grouped_reducescatter([tensor], op=op, compression=compression,
                                 block_size=block_size)[0]


def grouped_reducescatter(tensors, op: int = Sum,
                          compression=Compression.none,
                          block_size: int | None = None) -> list:
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
                                      block_size=block_size)
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
                         block_size: int | None = None):
    """Reduce-scatter a 1-D buffer whose length divides by the world size
    ``n`` into this rank's ``len / n`` shard (summed; the caller divides
    for Average): segment ``i`` lands on rank ``i``.  ``quantized`` is
    ``False`` or a lossy mode (``True`` = int8).  Returns ``(shard,
    err)``; ``err`` (``with_error``, lossy modes) is the full-buffer
    float32 residual."""
    mode = _quant.norm_mode(quantized)
    n = _basics.size()
    if n == 1:
        err = (torch.zeros(buf.shape, dtype=torch.float32, device=buf.device)
               if with_error else None)
        return buf, err
    L = buf.shape[0] // n
    if mode in _quant.LOSSY_MODES:
        seg = buf.to(torch.float32).reshape(n, L)
        out, err2d = _quant.lossy_psum_scatter_segments(
            seg, mode, block_size, with_error)
        err = err2d.reshape(-1) if err2d is not None else None
        return out.to(buf.dtype), err
    if mode != "none":
        raise ValueError(f"unknown wire mode {mode!r}")
    out = torch.empty(L, dtype=buf.dtype, device=buf.device)
    dist.reduce_scatter_tensor(out, buf.contiguous())
    return out, None


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
