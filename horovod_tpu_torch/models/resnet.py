"""ResNet (v1.5) as ``nn.Module``s with the flax model's semantics
(``horovod_tpu/models/resnet.py``).

- **Layout.**  Inputs and activations are NHWC, as in the JAX model.
  Each convolution hands cuDNN a channels-last NCHW view of the same
  memory (``permute``, no copy).
- **Padding.**  Flax ``"SAME"`` pads ``total // 2`` before and the rest
  after, so a stride-2 3x3 convolution or max-pool on an even input pads
  ``(0, 1)``, where PyTorch's ``padding=1`` would pad ``(1, 1)`` and
  shift every window.  Asymmetric padding goes through ``F.pad`` (with
  ``-inf`` for the pool).
- **BatchNorm.**  Statistics in float32 with the fast, biased variance
  ``mean(x^2) - mean(x)^2`` clamped at 0; running statistics updated as
  ``0.9 * ra + 0.1 * batch_stat`` (flax ``momentum=0.9``,
  ``epsilon=1e-5``); the normalisation in float32, cast to the compute
  dtype.  Written with plain torch ops (``torch.nn.BatchNorm2d`` would
  update the running variance with the unbiased estimate).
- **Precision.**  Parameters and statistics are float32; convolutions,
  activations and BatchNorm outputs are in ``dtype`` (bfloat16 by
  default); the classifier runs in float32.  No TF32 is involved: the
  convolutions are bf16 and the classifier's float32 matmul follows
  ``torch.backends.cuda.matmul.allow_tf32`` (off by default).
- **Names.**  Submodules carry the flax scope names (``conv_init``,
  ``bn_init``, ``BottleneckBlock_<i>/Conv_<j>``, ``BatchNorm_<j>``,
  ``conv_proj``, ``norm_proj``, ``Dense_0``), so
  :mod:`horovod_tpu_torch.interop` maps weights across mechanically.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common.util import resolve_device

# lecun_normal: truncated normal on [-2, 2] rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x, pads_h, pads_w, value: float = 0.0):
    """Apply (before, after) pads to H and W: symmetric pads are
    returned for the op's own ``padding=`` argument, asymmetric ones
    are applied here."""
    if pads_h[0] == pads_h[1] and pads_w[0] == pads_w[1]:
        return x, (pads_h[0], pads_w[0])
    return F.pad(x, (*pads_w, *pads_h), value=value), (0, 0)


class Conv(nn.Module):
    """``flax.linen.Conv`` without bias.  ``weight`` is OIHW float32;
    ``padding`` is ``"SAME"`` or explicit ((top, bottom), (left,
    right))."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 strides: int = 1, padding="SAME",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.kernel, self.strides, self.padding = kernel, strides, padding
        self.dtype = dtype

    def forward(self, x):
        xc = x.permute(0, 3, 1, 2)
        if self.padding == "SAME":
            ph = same_pads(xc.shape[2], self.kernel, self.strides)
            pw = same_pads(xc.shape[3], self.kernel, self.strides)
        else:
            ph, pw = self.padding
        xc, pad = _pad_nchw(xc, ph, pw)
        w = self.weight.to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        y = F.conv2d(xc, w, stride=self.strides, padding=pad)
        return y.permute(0, 2, 3, 1)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm over the leading dims of an NHWC tensor.
    Saves only the input and per-channel vectors; the backward is the
    closed form of the forward's derivative."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        c = x.shape[-1]
        xf = x.reshape(-1, c).float()
        mean = xf.mean(0)
        var = torch.clamp_min((xf * xf).mean(0) - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        y = ((xf - mean) * (rstd * scale) + bias).to(x.dtype)
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.mark_non_differentiable(mean, var)
        return y.view(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, scale = ctx.saved_tensors
        c = x.shape[-1]
        xf = x.reshape(-1, c).float()
        dyf = dy.reshape(-1, c).float()
        m = xf.shape[0]
        xhat = (xf - mean) * rstd
        dbias = dyf.sum(0)
        dscale = (dyf * xhat).sum(0)
        dx = (scale * rstd / m) * (m * dyf - dbias - xhat * dscale)
        return dx.to(x.dtype).view(x.shape), dscale, dbias, None


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last
    (channel) dim.  Parameters ``scale``/``bias``; buffers
    ``mean``/``var`` (flax's ``batch_stats``)."""

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
        if not self.training:
            mul = torch.rsqrt(self.var + self.eps) * self.scale
            return ((x.float() - self.mean) * mul + self.bias).to(x.dtype)
        y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias,
                                             self.eps)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return y


class Dense(nn.Module):
    """``flax.linen.Dense`` in float32: ``weight`` is (out, in)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return F.linear(x.float(), self.weight, self.bias)


class ResNetBlock(nn.Module):
    """Basic block (ResNet-18/34)."""

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(in_ch, filters, 3, strides, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)
        if in_ch != filters or strides != 1:
            self.conv_proj = Conv(in_ch, filters, 1, strides, dtype=dtype)
            self.norm_proj = BatchNorm(filters)
        self.out_channels = filters

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """Bottleneck block (ResNet-50/101/152), v1.5: stride on the 3x3."""

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(in_ch, filters, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, strides, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, out, 1, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True)
        if in_ch != out or strides != 1:
            self.conv_proj = Conv(in_ch, out, 1, strides, dtype=dtype)
            self.norm_proj = BatchNorm(out)
        self.out_channels = out

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if hasattr(self, "conv_proj"):
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """ResNet over NHWC float inputs; returns float32 logits.  Weights
    are drawn from ``seed`` with flax's initialisers (lecun-normal
    kernels, unit BatchNorm scales except the zero-initialised last one
    of each block).  Runs on ``device`` (default ``cuda``)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: int = 0):
        dev = resolve_device(device)
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2,
                              padding=((3, 3), (3, 3)), dtype=dtype)
        self.bn_init = BatchNorm(num_filters)
        self.block_names = []
        in_ch = num_filters
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                strides = 2 if i > 0 and j == 0 else 1
                blk = block_cls(in_ch, num_filters * 2 ** i, strides, dtype)
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                self.add_module(name, blk)
                self.block_names.append(name)
                in_ch = blk.out_channels
        self.Dense_0 = Dense(in_ch, num_classes)
        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(dev)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (Conv, Dense)):
                fan_in = m.weight[0].numel()
                nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0,
                                      generator=gen)
                m.weight.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)

    def forward(self, x):
        x = x.to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        xc = x.permute(0, 3, 1, 2)
        xc, pad = _pad_nchw(xc, same_pads(xc.shape[2], 3, 2),
                            same_pads(xc.shape[3], 3, 2),
                            value=-math.inf)
        x = F.max_pool2d(xc, 3, 2, padding=pad).permute(0, 2, 3, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # jnp.mean over H, W: float32 accumulation, result in x's dtype
        x = x.float().mean(dim=(1, 2)).to(self.dtype)
        return self.Dense_0(x)


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=ResNetBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3],
                    block_cls=BottleneckBlock)
