"""Adasum: scale-invariant gradient combining (counterpart of
``horovod_tpu/ops/adasum.py``).

Recursive pairwise distance doubling over an axis of ``n = 2**k`` ranks:
at level ``j`` rank ``i`` exchanges its whole vector with rank ``i ^
2**j`` (one ``batch_isend_irecv``) and both combine the pair by
projection instead of addition::

    adasum(a, b) = (1 - a.b / (2|a|^2)) a + (1 - a.b / (2|b|^2)) b

with a zero vector contributing nothing.  A fused buffer of several
tensors takes ``segments`` (their sizes): the exchange rides the whole
buffer, the dot products and coefficients stay per tensor.  The math
maps to torch ops on the card; no kernel is written for it.
"""

from __future__ import annotations

import numpy as np
import torch

from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import true_divide
from horovod_tpu_torch.parallel import mesh as _pmesh

_WIDE = {torch.float16: torch.float32, torch.bfloat16: torch.float32}


def _coefs(dot, asq, bsq):
    """The projection coefficients of ``a`` and ``b`` (a zero vector's is
    0), elementwise over per-segment dot products."""
    one = torch.ones_like(dot)
    acoef = torch.where(asq != 0, one - dot / (2.0 * torch.where(
        asq != 0, asq, one)), torch.zeros_like(dot))
    bcoef = torch.where(bsq != 0, one - dot / (2.0 * torch.where(
        bsq != 0, bsq, one)), torch.zeros_like(dot))
    return acoef, bcoef


def _adasum_pair(a: torch.Tensor, b: torch.Tensor, segments=None):
    """Combine partner vectors (1-D); 16-bit inputs are computed in
    float32 and cast back (``horovod_tpu/ops/adasum.py:39-59``).
    ``segments``: the sizes of the tensors of a fused buffer, each
    combined with its own coefficients."""
    ct = _WIDE.get(a.dtype, a.dtype)
    af, bf = a.to(ct), b.to(ct)
    if segments is None:
        acoef, bcoef = _coefs(torch.dot(af, bf), torch.dot(af, af),
                              torch.dot(bf, bf))
        return (acoef * af + bcoef * bf).to(a.dtype)
    # One segmented sum per dot product over all segments at once
    # (``segment_reduce`` of a 1-D tensor sums each segment in a fixed
    # order, no atomics: both partners get the same bits), and the
    # coefficients spread back over their segments.
    lengths = torch.as_tensor(segments, dtype=torch.int64, device=af.device)

    def seg_sum(x):
        return torch.segment_reduce(x, "sum", lengths=lengths, unsafe=True)

    acoef, bcoef = _coefs(seg_sum(af * bf), seg_sum(af * af),
                          seg_sum(bf * bf))
    n = af.numel()
    acoef = torch.repeat_interleave(acoef, lengths, output_size=n)
    bcoef = torch.repeat_interleave(bcoef, lengths, output_size=n)
    return (acoef * af + bcoef * bf).to(a.dtype)


def adasum(x: torch.Tensor, axis_name=None, segments=None) -> torch.Tensor:
    """Adasum of ``x`` over ``axis_name`` (a single axis): every rank
    returns the same tensor."""
    hop = _pmesh.flat_hop(axis_name)
    n = hop.size
    if n & (n - 1):
        raise HorovodTpuError(
            f"Adasum requires a power-of-2 number of ranks, got {n} "
            "(reference torch/mpi_ops.py:103-119).")
    flat = x.reshape(-1)
    stride = 1
    while stride < n:
        peer = hop.index ^ stride
        other = hop.exchange(flat.contiguous(), peer)
        # The pair's combine is symmetric only in exact arithmetic: both
        # members take the lower axis index's vector as ``a``, so they
        # compute the same operations and hold the same bits.
        a, b = (flat, other) if hop.index < peer else (other, flat)
        flat = _adasum_pair(a, b, segments)
        stride <<= 1
    return flat.reshape(x.shape)


def adasum_hierarchical(x: torch.Tensor, local_axis, cross_axis,
                        segments=None) -> torch.Tensor:
    """Local mean, then Adasum across the cross axis (the reference's
    ``AdasumGpuAllreduceOp``): the scale-invariant combine applies at
    the cross level only."""
    local = _pmesh.flat_hop(local_axis)
    cross = _pmesh.flat_hop(cross_axis)
    total = local.all_reduce(x.detach().clone().contiguous())
    mean = true_divide(total, local.size).to(x.dtype) \
        if local.size > 1 else total
    if cross.size == 1:
        return mean
    return adasum(mean, cross, segments)


def adasum_reference(tensors) -> np.ndarray:
    """The float64 NumPy model of Adasum over a list of per-rank arrays
    (the tests' and ``chip_smoke.py``'s reference)."""
    vecs = [np.asarray(t, dtype=np.float64).reshape(-1) for t in tensors]
    if len(vecs) & (len(vecs) - 1):
        raise ValueError("Adasum needs a power-of-2 number of inputs")

    def pair(a, b):
        dot = float(np.dot(a, b))
        asq = float(np.dot(a, a))
        bsq = float(np.dot(b, b))
        ac = 0.0 if asq == 0 else 1.0 - dot / (2 * asq)
        bc = 0.0 if bsq == 0 else 1.0 - dot / (2 * bsq)
        return ac * a + bc * b

    level = vecs
    while len(level) > 1:
        level = [pair(level[i], level[i + 1])
                 for i in range(0, len(level), 2)]
    return level[0].reshape(np.asarray(tensors[0]).shape)
