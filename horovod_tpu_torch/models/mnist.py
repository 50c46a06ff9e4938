"""The small CNNs of the JAX package (``horovod_tpu/models/mnist.py``):
``SmallCNN``, the synthetic benchmark's CPU-friendly stand-in for
ResNet, and ``MnistCNN``, the MNIST example's model.  NHWC inputs;
submodules carry the flax scope names (``Conv_<i>``, ``BatchNorm_<i>``,
``Dense_<i>``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common.util import resolve_device
from horovod_tpu_torch.models.layers import (BatchNorm, Conv, Dense,
                                             init_weights, max_pool,
                                             spatial_mean)


class SmallCNN(nn.Module):
    """Three stride-2 "SAME" 3x3 convolutions without bias (16, 32, 64
    filters), each followed by BatchNorm at flax's default momentum 0.99
    and epsilon 1e-5 and a ReLU; a spatial mean; a float32 Dense.
    Compute in ``dtype`` (float32 by default)."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        dev = resolve_device(device)
        super().__init__()
        self.dtype = dtype
        in_ch = 3  # RGB images, as the synthetic benchmark feeds it
        for i, feat in enumerate((16, 32, 64)):
            self.add_module(f"Conv_{i}", Conv(in_ch, feat, 3, 2, dtype=dtype))
            self.add_module(f"BatchNorm_{i}", BatchNorm(feat, momentum=0.99))
            in_ch = feat
        self.Dense_0 = Dense(in_ch, num_classes)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    def forward(self, x):
        x = x.to(self.dtype)
        for i in range(3):
            x = getattr(self, f"Conv_{i}")(x)
            x = F.relu(getattr(self, f"BatchNorm_{i}")(x))
        return self.Dense_0(spatial_mean(x, self.dtype))


class MnistCNN(nn.Module):
    """Two "SAME" 3x3 convolutions with bias (32, 64 filters), each
    followed by a ReLU and 2x2 "VALID" max pooling; the NHWC activation
    flattened in (H, W, C) order, as flax flattens it; Dense 128, ReLU,
    Dense ``num_classes``.  Float32 throughout, on (N, 28, 28, 1) MNIST
    images (the first Dense is 7 * 7 * 64 wide)."""

    def __init__(self, num_classes: int = 10, device=None, seed: int = 0):
        dev = resolve_device(device)
        super().__init__()
        f32 = torch.float32
        self.Conv_0 = Conv(1, 32, 3, dtype=f32, bias=True)
        self.Conv_1 = Conv(32, 64, 3, dtype=f32, bias=True)
        self.Dense_0 = Dense(7 * 7 * 64, 128)
        self.Dense_1 = Dense(128, num_classes)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    def forward(self, x):
        x = x.float()
        x = max_pool(F.relu(self.Conv_0(x)), 2, 2)
        x = max_pool(F.relu(self.Conv_1(x)), 2, 2)
        x = x.reshape(x.shape[0], -1)
        return self.Dense_1(F.relu(self.Dense_0(x)))
