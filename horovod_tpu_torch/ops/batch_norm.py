"""BatchNorm over the channel (last) dim of an NHWC activation, with the
semantics of ``flax.linen.BatchNorm`` (flax 0.12: ``use_fast_variance``,
``force_float32_reductions``): kernels N1-N4.

The activation is viewed as ``(M, C)``, M = N*H*W rows, float32 or
bfloat16; ``scale``, ``bias`` and every statistic are float32 (C).

- **N1** :func:`bn_stats`: ``mean = mean(x)``, ``var = max(mean(x^2) -
  mean^2, 0)`` (the biased, fast variance), ``rstd = rsqrt(var + eps)``,
  all float32, and, given the running statistics, ``ra = m * ra + (1 -
  m) * stat`` in place (flax's ``momentum``; ``torch.nn.BatchNorm2d``
  would update the running variance with the unbiased estimate);
- **N2** :func:`bn_normalize`: ``y = (x - mean) * (rstd * scale) +
  bias`` in float32, cast to x's dtype (the eval forward too, with the
  running mean and ``rsqrt(running_var + eps)``);
- **N3** :func:`bn_bwd_reduce`: ``dbias = sum(dy)``, ``dscale = sum(dy
  * xhat)`` with ``xhat = (x - mean) * rstd``;
- **N4** :func:`bn_bwd_dx`: ``dx = (scale * rstd / M) * (M * dy - dbias
  - xhat * dscale)``, cast to x's dtype.

**Kernel selection follows the tensor's device.**  Each wrapper launches
its CUDA kernel (``csrc/batch_norm.cu``) for a CUDA tensor, counted in
:data:`LAUNCHES`, and runs its plain version (``*_plain``) for a CPU
tensor.  It checks device, dtype, shape and contiguity and raises on
what the kernel does not take; a failed build or launch raises.  The
kernels' sums run in another order than PyTorch's, so N1 and N3 agree
with the plain versions to float32 rounding; N2 and N4 round every
operation as the plain versions do.  The plain versions compute in
float32, or in float64 for a float64 CPU activation with float64
per-channel vectors (the parity tests use that where float32 rounding
through a deep model would swamp the comparison); no kernel takes
float64.

:class:`BatchNormTrain` is the train-mode ``autograd.Function`` (N1, N2
forward; N3, N4 backward); it saves only x and three per-channel
vectors.  :class:`BatchNormEval` normalises with given statistics (N2)
and differentiates through N3 and N2.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from horovod_tpu_torch import _build
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import true_divide

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
LAUNCHES = {"bn_stats": 0, "bn_normalize": 0, "bn_bwd_reduce": 0,
            "bn_bwd_dx": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the reference for the kernels)
# ---------------------------------------------------------------------------


def _acc(t):
    """``t`` in its accumulation dtype: float32, or float64 for float64
    (flax's ``force_float32_reductions`` promotes to at least float32)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def bn_stats_plain(x2d, eps: float, momentum: float | None = None,
                   running_mean=None, running_var=None):
    """N1's function: ``(mean, var, rstd)``; updates the running
    statistics in place when they are given."""
    xf = _acc(x2d)
    mean = xf.mean(0)
    var = torch.clamp_min((xf * xf).mean(0) - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    if running_mean is not None:
        with torch.no_grad():
            m = momentum
            running_mean.copy_(m * running_mean + (1 - m) * mean)
            running_var.copy_(m * running_var + (1 - m) * var)
    return mean, var, rstd


def bn_normalize_plain(x2d, mean, rstd, scale, bias):
    """N2's function."""
    return ((_acc(x2d) - mean) * (rstd * scale) + bias).to(x2d.dtype)


def bn_bwd_reduce_plain(dy2d, x2d, mean, rstd):
    """N3's function: ``(dbias, dscale)``."""
    dyf = _acc(dy2d)
    xhat = (_acc(x2d) - mean) * rstd
    return dyf.sum(0), (dyf * xhat).sum(0)


def bn_bwd_dx_plain(dy2d, x2d, mean, rstd, scale, dbias, dscale):
    """N4's function.  ``/ M`` is a true division on every device
    (PyTorch divides a CUDA tensor by a Python scalar through its
    reciprocal)."""
    m = x2d.shape[0]
    dyf = _acc(dy2d)
    xhat = (_acc(x2d) - mean) * rstd
    dx = true_divide(scale * rstd, m) * (m * dyf - dbias - xhat * dscale)
    return dx.to(x2d.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers (N1-N4)
# ---------------------------------------------------------------------------

_lib = None


def _kernels():
    """The built library, with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load("batch_norm")
        p, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_float)
        lib.hvd_bn_partials.argtypes = [i64, i32, i32]
        lib.hvd_bn_partials.restype = i64
        lib.hvd_bn_stats.argtypes = [i32, i32, p, i64, i32, p, f32, f32, f32,
                                     p, p, p, p, p, p]
        lib.hvd_bn_normalize.argtypes = [i32, i32, p, p, p, p, p, p, i64,
                                         i32, p]
        lib.hvd_bn_bwd_reduce.argtypes = [i32, i32, p, p, p, p, i64, i32, p,
                                          p, p, p]
        lib.hvd_bn_bwd_dx.argtypes = [i32, i32, p, p, p, p, p, p, p, p, i64,
                                      i32, p]
        for fn in (lib.hvd_bn_stats, lib.hvd_bn_normalize,
                   lib.hvd_bn_bwd_reduce, lib.hvd_bn_bwd_dx):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, acts, vecs) -> None:
    """``acts``: (M, C) activations of one dtype on one device;
    ``vecs``: float32 (float64 for float64 on the CPU) (C) vectors on the
    same device; all contiguous."""
    x = acts[0]
    if x.device.type not in ("cpu", "cuda"):
        raise HorovodTpuError(f"{name}: unsupported device {x.device}")
    cpu64 = x.device.type == "cpu" and x.dtype == torch.float64
    if x.dtype not in _DTYPE_CODES and not cpu64:
        raise HorovodTpuError(f"{name}: activations are {x.dtype} on "
                              f"{x.device}, expected float32 or bfloat16 "
                              "(or float64 on the CPU)")
    vdt = torch.float64 if cpu64 else torch.float32
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise HorovodTpuError(f"{name}: expected a non-empty (M, C) "
                              f"activation, got {tuple(x.shape)}")
    c = x.shape[1]
    for t in acts:
        if t.dtype != x.dtype or t.shape != x.shape or t.device != x.device:
            raise HorovodTpuError(
                f"{name}: activations disagree: {t.dtype} {tuple(t.shape)} "
                f"on {t.device} against {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    for v in vecs:
        if v.dtype != vdt or tuple(v.shape) != (c,) \
                or v.device != x.device:
            raise HorovodTpuError(
                f"{name}: per-channel vectors must be {vdt} ({c},) on "
                f"{x.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")
    if not all(t.is_contiguous() for t in (*acts, *vecs)):
        raise HorovodTpuError(f"{name}: tensors must be contiguous")


def _vec(x, *ptrs) -> int:
    """16-byte vectors when C and every activation pointer allow them,
    else the scalar loop."""
    v = 16 // x.element_size()
    ok = x.shape[1] % v == 0 and all(p % 16 == 0 for p in ptrs)
    return v if ok else 1


def _launch(name: str, rc: int) -> None:
    if rc != 0:
        raise HorovodTpuError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _scratch(lib, x, vec: int):
    m, c = x.shape
    tiles = lib.hvd_bn_partials(m, c, vec)
    return torch.empty(2 * tiles * c, dtype=torch.float32, device=x.device)


def bn_stats(x2d, eps: float, momentum: float | None = None,
             running_mean=None, running_var=None):
    """N1: ``(mean, var, rstd)`` of ``x2d`` (M, C) per channel, float32;
    the running statistics, when given, are updated in place."""
    running = [t for t in (running_mean, running_var) if t is not None]
    if len(running) == 1:
        raise HorovodTpuError("bn_stats: give both running statistics or "
                              "neither")
    _check("bn_stats", (x2d,), running)
    if running and momentum is None:
        raise HorovodTpuError("bn_stats: running statistics need a momentum")
    if x2d.device.type == "cpu":
        return bn_stats_plain(x2d, eps, momentum, running_mean, running_var)
    lib = _kernels()
    m, c = x2d.shape
    vec = _vec(x2d, x2d.data_ptr())
    part = _scratch(lib, x2d, vec)
    mean, var, rstd = (torch.empty(c, dtype=torch.float32, device=x2d.device)
                       for _ in range(3))
    mom = 0.0 if momentum is None else momentum
    _launch("bn_stats", lib.hvd_bn_stats(
        _DTYPE_CODES[x2d.dtype], vec, x2d.data_ptr(), m, c, part.data_ptr(),
        float(np.float32(eps)), float(np.float32(mom)),
        float(np.float32(1 - mom)), mean.data_ptr(), var.data_ptr(),
        rstd.data_ptr(), running_mean.data_ptr() if running else None,
        running_var.data_ptr() if running else None, _stream(x2d)))
    return mean, var, rstd


def bn_normalize(x2d, mean, rstd, scale, bias):
    """N2: ``(x - mean) * (rstd * scale) + bias`` in x's dtype."""
    _check("bn_normalize", (x2d,), (mean, rstd, scale, bias))
    if x2d.device.type == "cpu":
        return bn_normalize_plain(x2d, mean, rstd, scale, bias)
    lib = _kernels()
    m, c = x2d.shape
    y = torch.empty_like(x2d)
    vec = _vec(x2d, x2d.data_ptr(), y.data_ptr())
    _launch("bn_normalize", lib.hvd_bn_normalize(
        _DTYPE_CODES[x2d.dtype], vec, x2d.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), m,
        c, _stream(x2d)))
    return y


def bn_bwd_reduce(dy2d, x2d, mean, rstd):
    """N3: ``(dbias, dscale)``, float32 (C)."""
    _check("bn_bwd_reduce", (x2d, dy2d), (mean, rstd))
    if x2d.device.type == "cpu":
        return bn_bwd_reduce_plain(dy2d, x2d, mean, rstd)
    lib = _kernels()
    m, c = x2d.shape
    vec = _vec(x2d, x2d.data_ptr(), dy2d.data_ptr())
    part = _scratch(lib, x2d, vec)
    dbias, dscale = (torch.empty(c, dtype=torch.float32, device=x2d.device)
                     for _ in range(2))
    _launch("bn_bwd_reduce", lib.hvd_bn_bwd_reduce(
        _DTYPE_CODES[x2d.dtype], vec, dy2d.data_ptr(), x2d.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), m, c, part.data_ptr(),
        dbias.data_ptr(), dscale.data_ptr(), _stream(x2d)))
    return dbias, dscale


def bn_bwd_dx(dy2d, x2d, mean, rstd, scale, dbias, dscale):
    """N4: the input gradient in x's dtype."""
    _check("bn_bwd_dx", (x2d, dy2d), (mean, rstd, scale, dbias, dscale))
    if x2d.device.type == "cpu":
        return bn_bwd_dx_plain(dy2d, x2d, mean, rstd, scale, dbias, dscale)
    lib = _kernels()
    m, c = x2d.shape
    dx = torch.empty_like(x2d)
    vec = _vec(x2d, x2d.data_ptr(), dy2d.data_ptr(), dx.data_ptr())
    _launch("bn_bwd_dx", lib.hvd_bn_bwd_dx(
        _DTYPE_CODES[x2d.dtype], vec, dy2d.data_ptr(), x2d.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(), dbias.data_ptr(),
        dscale.data_ptr(), dx.data_ptr(), m, c, _stream(x2d)))
    return dx


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm of a contiguous (..., C) tensor: N1 (which
    also updates ``running = (mean, var)`` in place) and N2 forward, N3
    and N4 backward.  Saves only x, mean, rstd and scale."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, momentum: float, running):
        x2d = x.view(-1, x.shape[-1])
        mean, _, rstd = bn_stats(x2d, eps, momentum, *running)
        y = bn_normalize(x2d, mean, rstd, scale, bias)
        ctx.save_for_backward(x2d, mean, rstd, scale)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, mean, rstd, scale = ctx.saved_tensors
        dy2d = dy.contiguous().view(x2d.shape)
        dbias, dscale = bn_bwd_reduce(dy2d, x2d, mean, rstd)
        dx = bn_bwd_dx(dy2d, x2d, mean, rstd, scale, dbias, dscale)
        return dx.view(dy.shape), dscale, dbias, None, None, None


class BatchNormEval(torch.autograd.Function):
    """BatchNorm with given statistics ``mean`` and ``rstd`` (the running
    ones): N2 forward; backward ``dbias, dscale`` through N3 and ``dx =
    dy * (rstd * scale)`` through N2 with zero mean and bias."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, rstd):
        x2d = x.view(-1, x.shape[-1])
        ctx.save_for_backward(x2d, mean, rstd, scale)
        return bn_normalize(x2d, mean, rstd, scale, bias).view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, mean, rstd, scale = ctx.saved_tensors
        dy2d = dy.contiguous().view(x2d.shape)
        dbias, dscale = bn_bwd_reduce(dy2d, x2d, mean, rstd)
        zero = torch.zeros_like(mean)
        dx = bn_normalize(dy2d, zero, rstd, scale, zero)
        return dx.view(dy.shape), dscale, dbias, None, None
