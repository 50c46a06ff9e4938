"""Collectives over the ``torch.distributed`` world (the counterpart of
``horovod_tpu/ops/collectives.py`` on the flat world axis).

Functional, as in the JAX package: inputs are never modified and a new
tensor is returned.  ``Average`` is a sum followed by a division by the
world size in the wire dtype (``collectives.py:101-104``), not NCCL's
``AVG``, so it rounds the same way as the reference.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import true_divide
from horovod_tpu_torch.ops.compression import Compression, require_ported

# Values match the JAX package (reference C ABI).
Average = 1
Sum = 2
Adasum = 3


def _check_op(op) -> None:
    if op == Adasum:
        raise NotImplementedError(
            "op=Adasum is not ported yet (ROADMAP.md Queue A item 9)")
    if op not in (Average, Sum):
        raise HorovodTpuError(f"Unknown reduce op: {op}")


def _reduce_flat(buf: torch.Tensor, op: int) -> torch.Tensor:
    """Sum ``buf`` (owned by the caller, reduced in place) over the
    world; divide for Average."""
    n = _basics.size()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    if op == Average and n > 1:
        buf = true_divide(buf, n)
    return buf


def allreduce(tensor: torch.Tensor, op: int = Average,
              compression=Compression.none) -> torch.Tensor:
    """Allreduce one tensor over the world."""
    _check_op(op)
    require_ported(compression)
    wire, ctx = compression.compress(tensor)
    out = _reduce_flat(wire.clone(), op)
    return compression.decompress(out, ctx)


def grouped_allreduce(tensors, op: int = Average,
                      compression=Compression.none) -> list:
    """Allreduce a list of tensors as one group: same-dtype payloads are
    concatenated into one flat buffer per dtype, reduced with one
    collective, and split back (``_grouped_fused``,
    ``collectives.py:208-226``)."""
    _check_op(op)
    require_ported(compression)
    if not tensors:
        return []
    wires, ctxs = zip(*[compression.compress(t) for t in tensors])
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
    return [compression.decompress(o, c) for o, c in zip(outs, ctxs)]


def broadcast(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """Return ``root_rank``'s value of ``tensor`` on every rank."""
    out = tensor.detach().clone().contiguous()
    dist.broadcast(out, src=root_rank)
    return out


def broadcast_(tensors, root_rank: int = 0) -> None:
    """Overwrite each tensor in place with ``root_rank``'s value, one
    collective per dtype (fused like :func:`grouped_allreduce`)."""
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
