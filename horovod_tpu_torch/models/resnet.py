"""ResNet (v1.5) as ``nn.Module``s with the flax model's semantics
(``horovod_tpu/models/resnet.py``).

The layers are the shared flax-semantics ones of
:mod:`horovod_tpu_torch.models.layers` (re-exported here): NHWC
activations with channels-last NCHW views for cuDNN, flax's ``"SAME"``
padding, and BatchNorm (``momentum=0.9``, ``epsilon=1e-5``) through
kernels N1-N4 of :mod:`horovod_tpu_torch.ops.batch_norm` on the card.

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

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common.util import resolve_device
from horovod_tpu_torch.models.layers import (  # noqa: F401
    BatchNorm, Conv, Dense, init_weights, max_pool, same_pads, spatial_mean)


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
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    def forward(self, x):
        x = x.to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = max_pool(x, 3, 2, "SAME")
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.Dense_0(spatial_mean(x, self.dtype))


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=ResNetBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3],
                    block_cls=BottleneckBlock)
