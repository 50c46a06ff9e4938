"""The flax layers the port's CNNs share, as ``nn.Module``s with
``flax.linen``'s semantics.

- **Layout.**  Inputs and activations are NHWC, as in the JAX models.
  A convolution or pool hands PyTorch a channels-last NCHW view of the
  same memory (``permute``, no copy) and returns the NHWC view of its
  output.
- **Padding.**  Flax ``"SAME"`` pads ``total // 2`` before and the rest
  after, so a stride-2 3x3 convolution or max-pool on an even input pads
  ``(0, 1)``, where PyTorch's ``padding=1`` would pad ``(1, 1)`` and
  shift every window.  Asymmetric padding goes through ``F.pad`` (with
  ``-inf`` for a max-pool).  ``"VALID"`` pads nothing; explicit padding
  is ``((top, bottom), (left, right))``.
- **BatchNorm** runs through kernels N1-N4 of
  :mod:`horovod_tpu_torch.ops.batch_norm` (their plain versions on the
  CPU): float32 statistics with flax's fast, biased variance, running
  statistics ``momentum * ra + (1 - momentum) * stat``.
- **Precision.**  Parameters and statistics are float32; a layer's
  ``dtype`` is the compute dtype its inputs and parameters are cast to,
  as flax's ``dtype`` with ``param_dtype=float32``.
- **Initialisation** (:func:`init_weights`): flax's defaults, lecun-normal
  kernels (a truncated normal rescaled to unit variance) drawn from one
  ``torch.Generator``, zero biases, unit BatchNorm scales.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common.util import true_divide
from horovod_tpu_torch.ops import batch_norm as _bn

# lecun_normal: truncated normal on [-2, 2] rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(padding, hw, kernel, strides):
    """((top, bottom), (left, right)) for flax's ``padding`` argument."""
    if padding == "SAME":
        return tuple(same_pads(s, k, st)
                     for s, k, st in zip(hw, kernel, strides))
    if padding == "VALID":
        return (0, 0), (0, 0)
    return tuple(tuple(p) for p in padding)


def _pad_nchw(x, pads_h, pads_w, value: float = 0.0):
    """Apply (before, after) pads to H and W: symmetric pads are
    returned for the op's own ``padding=`` argument, asymmetric ones
    are applied here."""
    if pads_h[0] == pads_h[1] and pads_w[0] == pads_w[1]:
        return x, (pads_h[0], pads_w[0])
    return F.pad(x, (*pads_w, *pads_h), value=value), (0, 0)


class Conv(nn.Module):
    """``flax.linen.Conv``: ``weight`` is OIHW float32, ``kernel`` an int
    or ``(kh, kw)``; an optional float32 ``bias``; ``padding`` is
    ``"SAME"``, ``"VALID"`` or explicit."""

    def __init__(self, in_ch: int, out_ch: int, kernel, strides=1,
                 padding="SAME", dtype: torch.dtype = torch.bfloat16,
                 bias: bool = False):
        super().__init__()
        self.kernel, self.strides = _pair(kernel), _pair(strides)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.padding, self.dtype = padding, dtype

    def forward(self, x):
        xc = x.permute(0, 3, 1, 2)
        ph, pw = _pads(self.padding, xc.shape[2:], self.kernel, self.strides)
        xc, pad = _pad_nchw(xc, ph, pw)
        w = self.weight.to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(xc, w, b, stride=self.strides, padding=pad)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum, epsilon)`` over the last (channel)
    dim.  Parameters ``scale``/``bias``; buffers ``mean``/``var`` (flax's
    ``batch_stats``).  The output has the input's dtype."""

    def __init__(self, ch: int, momentum: float = 0.9, eps: float = 1e-5,
                 zero_scale: bool = False):
        super().__init__()
        self.scale = nn.Parameter(
            torch.zeros(ch) if zero_scale else torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))
        self.momentum, self.eps = momentum, eps

    def forward(self, x):
        x = x.contiguous()
        if not self.training:
            rstd = torch.rsqrt(self.var + self.eps)
            return _bn.BatchNormEval.apply(x, self.scale, self.bias,
                                           self.mean, rstd)
        return _bn.BatchNormTrain.apply(x, self.scale, self.bias, self.eps,
                                        self.momentum, (self.mean, self.var))


class Dense(nn.Module):
    """``flax.linen.Dense``: ``weight`` is (out, in) float32; inputs,
    weight and bias are cast to ``dtype`` (float32 by default)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Dropout(nn.Module):
    """``flax.linen.Dropout(rate)``: in training, keeps an element with
    probability ``1 - rate`` and returns ``x / keep_prob`` there, zero
    elsewhere; the identity in ``eval()``.  The mask comes from
    ``generator`` (the model's, seeded from its ``seed``); its bits are
    not flax's."""

    def __init__(self, rate: float, generator: torch.Generator | None = None):
        super().__init__()
        self.rate, self.generator = rate, generator

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, true_divide(x, keep), torch.zeros_like(x))


def max_pool(x, window, strides, padding="VALID"):
    """``flax.linen.max_pool`` of an NHWC tensor (flax's default padding
    is ``"VALID"``)."""
    window, strides = _pair(window), _pair(strides)
    xc = x.permute(0, 3, 1, 2)
    ph, pw = _pads(padding, xc.shape[2:], window, strides)
    xc, pad = _pad_nchw(xc, ph, pw, value=-math.inf)
    return F.max_pool2d(xc, window, strides, padding=pad).permute(0, 2, 3, 1)


def _avgpool3(x):
    """``nn.avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")``: the
    padding counts, so a border window divides by 9 too (flax's
    ``count_include_pad=True``); stride-1 "SAME" pads (1, 1).  The zeros
    are padded explicitly and the pool itself pads nothing: on a
    channels-last CUDA tensor, PyTorch's ``avg_pool2d`` with ``padding``
    returns the right forward but a wrong input gradient (2.11,
    ``tests/test_torch_cuda.py::test_avgpool3_gradient_matches_cpu``)."""
    xc = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1))
    return F.avg_pool2d(xc, 3, 1).permute(0, 2, 3, 1)


def spatial_mean(x, dtype: torch.dtype):
    """``jnp.mean`` over H and W: float32 (float64 for float64)
    accumulation, result in ``dtype``."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.to(acc).mean(dim=(1, 2)).to(dtype)


@torch.no_grad()
def init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """flax's default kernel initialiser (lecun-normal) for every
    :class:`Conv` and :class:`Dense` of ``model``, in ``modules()``
    order, from ``gen``."""
    for m in model.modules():
        if isinstance(m, (Conv, Dense)):
            fan_in = m.weight[0].numel()
            nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0,
                                  generator=gen)
            m.weight.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)
