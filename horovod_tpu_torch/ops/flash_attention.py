"""Flash attention, kernels B8-B10: the counterpart of
``horovod_tpu/ops/pallas_attention.py``.

- :func:`flash_block_step` (B8): one online-softmax accumulation of a Q
  chunk against one KV block, carrying the running max ``m``, the
  denominator ``l`` and the unnormalised numerator ``o``.
- :func:`flash_bwd_dq` (B9) and :func:`flash_bwd_dkv` (B10): the
  saved-LSE backward, ``p = exp(s - lse)``, ``ds = p (dO.V^T - delta)
  scale``, ``dQ = ds.K``, ``dV = p^T.dO``, ``dK = ds^T.Q``.

Layout ``(BH, L, D)``; ``m``, ``l``, ``lse``, ``delta`` are plain
``(BH, L)`` float32 arrays (the TPU kernels' packed m|l lane tile is not
carried over).  ``q_offset``/``k_offset`` are the global positions of
``q[:, 0]``/``k[:, 0]`` and feed only the causal mask.

The plain versions (``*_plain``) follow the Pallas kernel bodies where
they round: scores accumulate in float32 from the operands, ``scale =
float32(1/sqrt(d))`` multiplies them, ``p`` is cast to the value dtype
before ``p.V`` and to dO's before ``p^T.dO``, ``ds`` to the K/Q dtype
before ``ds.K`` and ``ds^T.Q``; the fully-masked-row guards are kept.
They compute a whole block at once, where the kernels walk tiles of keys
with an online softmax, so the two differ by the order of their sums.

**Kernel selection follows the tensor's device.**  Each wrapper checks
its arguments, then launches its CUDA kernel (``csrc/flash_attention.cu``)
for CUDA tensors and counts the launch in :data:`LAUNCHES`, or runs its
plain version for CPU tensors.  A failed build or launch raises.  On the
card, bfloat16 B8-B10 run on the tensor cores (``wgmma`` on TMA-fed
tiles) and float32 B8-B10 on the CUDA cores; the bfloat16 kernels' sums
run in another order than the plain versions', so bfloat16 results
agree within the JAX package's bfloat16 tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from horovod_tpu_torch import _build
from horovod_tpu_torch.common import events as _events
from horovod_tpu_torch.common.types import HorovodTpuError

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 128
_MAX_BH = 65535  # the kernels' grid y dimension

#: The bounds a bfloat16 kernel result is held to on the card beside the
#: JAX package's rtol/atol of 2e-2, which alone passes a B8 that drops or
#: unmasks one key tile of an 8192-key row
#: (``tests/test_torch_attention.py``): the largest absolute error, and
#: the largest error of one row (last axis) over that row's norm (see
#: :func:`errors`).  Both are over three times what the card reads.
BF16_MAX_ABS = 5e-3
BF16_ROW_REL = 2e-2

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
LAUNCHES = {"flash_block_step": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def softmax_scale(d: int) -> float:
    """``1/sqrt(d)`` rounded to float32, as JAX rounds the Python scalar
    that multiplies the float32 scores."""
    return float(np.float32(1.0 / (d ** 0.5)))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _scores(q, k, q_offset: int, k_offset: int, causal: bool):
    """float32 ``q.k^T * scale``, causally masked to ``-inf`` on global
    positions."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * softmax_scale(q.shape[-1])
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, -torch.inf)
    return s


def flash_block_step_plain(q, k, v, m, l, o, q_offset: int, k_offset: int,
                           causal: bool = True):
    """B8's arithmetic in PyTorch ops; returns ``(m', l', o')``."""
    s = _scores(q, k, q_offset, k_offset, causal)
    m_new = torch.maximum(m, s.amax(-1))
    # fully masked rows keep m = -inf; exp against a finite stand-in
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l_new = l * alpha + p.sum(-1)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return m_new, l_new, o * alpha[..., None] + pv


def _probs(q, k, lse, q_offset, k_offset, causal):
    """``p = exp(s - lse)``; rows with ``lse = -inf`` give ``p = 0``."""
    s = _scores(q, k, q_offset, k_offset, causal)
    ok = torch.isfinite(lse)
    p = torch.exp(s - torch.where(ok, lse, 0.0)[..., None])
    return torch.where(torch.isfinite(s) & ok[..., None], p, 0.0)


def _dscores(q, p, v, do, delta):
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p * (dp - delta[..., None]) * softmax_scale(q.shape[-1])


def flash_bwd_dq_plain(q, k, v, do, lse, delta, q_offset: int,
                       k_offset: int, causal: bool = True):
    """B9's arithmetic in PyTorch ops; returns float32 dQ."""
    p = _probs(q, k, lse, q_offset, k_offset, causal)
    ds = _dscores(q, p, v, do, delta)
    return torch.matmul(ds.to(k.dtype).float(), k.float())


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_offset: int,
                        k_offset: int, causal: bool = True):
    """B10's arithmetic in PyTorch ops; returns float32 ``(dK, dV)``."""
    p = _probs(q, k, lse, q_offset, k_offset, causal)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    ds = _dscores(q, p, v, do, delta)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk, dv


def state_pairs(got, want, normalised: bool):
    """The ``(name, got, want)`` pairs in which two B8 states ``(m, l,
    o)`` are compared.  With ``normalised`` (bfloat16 operands) ``o`` is
    compared as ``o / l``, both over ``want``'s ``l``: the kernel rounds
    ``p`` to bfloat16 against the running max of its key tiles, the
    plain version against the row's final max, so the unnormalised ``o``
    differs by about ``l`` times the rounding of one ``p``."""
    pairs = [("m", got[0], want[0]), ("l", got[1], want[1])]
    if not normalised:
        return pairs + [("o", got[2], want[2])]
    l_safe = torch.where(want[1] == 0, 1.0, want[1])[..., None]
    return pairs + [("o / l", got[2] / l_safe, want[2] / l_safe)]


def errors(got, want):
    """``(largest absolute error, largest row error)`` of ``got``
    against ``want`` over the entries where ``want`` is finite: a row
    error is the norm of one row's (last axis) difference over that
    row's norm in ``want``, or over ``BF16_MAX_ABS`` where the row is
    smaller.  A tile dropped from a long row shows in the row error of
    its rows however small its elements are; a row that is zero up to
    rounding (B9's dQ of a query that sees one key: ``ds = p (dp -
    delta)`` with ``dp = delta``) is held to the absolute bound's scale,
    not to its own rounding noise."""
    w = want.float()
    ok = torch.isfinite(w)
    d = torch.where(ok, got.float() - w, 0.0)
    w = torch.where(ok, w, 0.0)
    if not d.numel():
        return 0.0, 0.0
    rows = d.norm(dim=-1) / w.norm(dim=-1).clamp_min(BF16_MAX_ABS)
    return float(d.abs().max()), float(rows.max())


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_lib = None


def _kernels():
    """The built library, with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i32] * 7 + [f32, p]  # bh lq lk d q_off k_off causal; scale
        lib.hvd_flash_fwd.argtypes = [i32] + [p] * 9 + tail
        lib.hvd_flash_bwd_dq.argtypes = [i32] + [p] * 7 + tail
        lib.hvd_flash_bwd_dkv.argtypes = [i32] + [p] * 8 + tail
        lib.hvd_flash_tc_attributes.argtypes = [i32, i32, p]
        for fn in (lib.hvd_flash_fwd, lib.hvd_flash_bwd_dq,
                   lib.hvd_flash_bwd_dkv, lib.hvd_flash_tc_attributes):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, q, k, v, extra_mm=(), rows=(), full=()) -> None:
    """Raise unless the arguments are what the kernel takes: ``q`` (BH,
    Lq, D), ``k``/``v`` (BH, Lk, D), every matmul operand (q, k, v and
    ``extra_mm``) of one dtype (float32 or bfloat16), float32 ``rows``
    (BH, Lq) and ``full`` (BH, Lq, D), all on one device and
    contiguous."""
    if q.device.type not in ("cpu", "cuda"):
        raise HorovodTpuError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise HorovodTpuError(
            f"{name}: dtype {q.dtype} is not float32 or bfloat16")
    if q.dim() != 3:
        raise HorovodTpuError(
            f"{name}: q must be (BH, L, D), got {tuple(q.shape)}")
    bh, lq, d = q.shape
    if d % 8 or not 0 < d <= _MAX_D:
        raise HorovodTpuError(
            f"{name}: head dim {d} must be a multiple of 8, at most "
            f"{_MAX_D}")
    if not 0 < bh <= _MAX_BH or lq == 0:
        raise HorovodTpuError(
            f"{name}: batch*heads {bh} must be in [1, {_MAX_BH}] and the "
            f"sequence non-empty")
    if k.dim() != 3 or k.shape[0] != bh or k.shape[2] != d or k.shape[1] == 0:
        raise HorovodTpuError(
            f"{name}: k has shape {tuple(k.shape)}, expected ({bh}, Lk, {d})")
    kshape, qshape = tuple(k.shape), tuple(q.shape)
    checks = [(t, q.dtype, kshape, "K/V operand") for t in (k, v)]
    checks += [(t, q.dtype, qshape, "Q-side operand") for t in (q, *extra_mm)]
    checks += [(t, torch.float32, (bh, lq), "row state") for t in rows]
    checks += [(t, torch.float32, qshape, "accumulator") for t in full]
    for t, dtype, shape, what in checks:
        if t.device != q.device or t.dtype != dtype:
            raise HorovodTpuError(
                f"{name}: a {what} is {t.dtype} on {t.device}, expected "
                f"{dtype} on {q.device}")
        if tuple(t.shape) != shape:
            raise HorovodTpuError(
                f"{name}: a {what} has shape {tuple(t.shape)}, expected "
                f"{shape}")
        if not t.is_contiguous():
            raise HorovodTpuError(f"{name}: tensors must be contiguous")


def _check_aligned(name: str, tensors, grid: int) -> None:
    """The bfloat16 tensor-core kernels read their TMA operands from
    16-byte-aligned base addresses and B8's carried ``o`` as float2:
    raise for an operand off that grid, rather than copy it."""
    for t in tensors:
        if t.data_ptr() % grid:
            raise HorovodTpuError(
                f"{name}: a {t.dtype} operand starts at an address that is "
                f"not {grid}-byte aligned")


def tc_kernel_attributes(name: str, d: int) -> dict:
    """The registers and local memory (stack and spills) per thread and
    the dynamic shared memory of the bfloat16 tensor-core kernel of
    ``name`` (``flash_block_step``, ``flash_bwd_dq`` or ``flash_bwd_dkv``)
    that runs at head dim ``d``, from ``cudaFuncGetAttributes`` (builds
    the library)."""
    out = (ctypes.c_int * 3)()
    rc = _kernels().hvd_flash_tc_attributes(
        {"flash_block_step": 0, "flash_bwd_dkv": 1, "flash_bwd_dq": 2}[name],
        d, out)
    if rc != 0:
        raise HorovodTpuError(f"{name}: cudaFuncGetAttributes failed: CUDA "
                              f"error {rc}")
    return {"registers": out[0], "local_bytes": out[1],
            "smem_bytes": out[2]}


def _launch(name: str, fn, q, *args) -> None:
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(_DTYPE_CODES[q.dtype], *args, stream)
    if rc != 0:
        raise HorovodTpuError(f"{name} kernel launch failed: CUDA error {rc}")
    _events.note_launch(LAUNCHES, "flash_attention", name)


def _dims(q, k, q_offset, k_offset, causal):
    bh, lq, d = q.shape
    return (bh, lq, k.shape[1], d, int(q_offset), int(k_offset), int(causal),
            softmax_scale(d))


def flash_block_step(q, k, v, m, l, o, q_offset: int, k_offset: int, *,
                     causal: bool = True):
    """B8: attend ``q`` (BH, Lq, D) against one KV block (BH, Lk, D),
    updating the carried float32 state ``m``, ``l`` (BH, Lq) and ``o``
    (BH, Lq, D).  Returns new ``(m, l, o)``."""
    _check("flash_block_step", q, k, v, rows=(m, l), full=(o,))
    if q.device.type == "cpu":
        return flash_block_step_plain(q, k, v, m, l, o, q_offset, k_offset,
                                      causal)
    if q.dtype == torch.bfloat16:
        _check_aligned("flash_block_step", (q, k, v), 16)
        _check_aligned("flash_block_step", (o,), 8)
    lib = _kernels()
    m2, l2, o2 = torch.empty_like(m), torch.empty_like(l), torch.empty_like(o)
    _launch("flash_block_step", lib.hvd_flash_fwd, q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(),
            o.data_ptr(), m2.data_ptr(), l2.data_ptr(), o2.data_ptr(),
            *_dims(q, k, q_offset, k_offset, causal))
    return m2, l2, o2


def flash_bwd_dq(q, k, v, do, lse, delta, q_offset: int, k_offset: int, *,
                 causal: bool = True):
    """B9: this KV block's float32 dQ contribution (BH, Lq, D), from the
    saved ``lse`` and ``delta = rowsum(dO * O)`` (float32 (BH, Lq)); ``do``
    is in the matmul dtype."""
    _check("flash_bwd_dq", q, k, v, extra_mm=(do,), rows=(lse, delta))
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, q_offset,
                                  k_offset, causal)
    if q.dtype == torch.bfloat16:
        _check_aligned("flash_bwd_dq", (q, k, v, do), 16)
    lib = _kernels()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dq", lib.hvd_flash_bwd_dq, q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(),
            *_dims(q, k, q_offset, k_offset, causal))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, q_offset: int, k_offset: int, *,
                  causal: bool = True):
    """B10: this Q chunk's float32 ``(dK, dV)`` contribution to the KV
    block, same contract as :func:`flash_bwd_dq`."""
    _check("flash_bwd_dkv", q, k, v, extra_mm=(do,), rows=(lse, delta))
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_offset,
                                   k_offset, causal)
    if q.dtype == torch.bfloat16:
        _check_aligned("flash_bwd_dkv", (q, k, v, do, lse, delta), 16)
    lib = _kernels()
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dkv", lib.hvd_flash_bwd_dkv, q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_dims(q, k, q_offset, k_offset, causal))
    return dk, dv
