"""VGG (``horovod_tpu/models/vgg.py``): the JAX package's third
benchmark model, whose 138M-parameter dense gradient is the classic
allreduce stress test.  NHWC inputs, float32 parameters, compute in
``dtype`` (bfloat16 by default).  Submodules carry the flax scope names
(``conv<stage>_<i>``, ``Dense_0``-``Dense_2``)."""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common.util import resolve_device
from horovod_tpu_torch.models.layers import (Conv, Dense, Dropout,
                                             init_weights, max_pool)

# stage configs: number of 3x3 convs per stage, doubling widths
_CFG = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}


class VGG(nn.Module):
    """"SAME" 3x3 convolutions with bias, each followed by a ReLU, and
    2x2 "VALID" max pooling after each stage; the activation flattened
    in (H, W, C) order; Dense 4096, ReLU, Dropout(0.5), twice, in
    ``dtype``; a float32 Dense.  ``image_size`` fixes the first Dense's
    width (224 gives 7 x 7 x 512).  Dropout masks come from a generator
    seeded from ``seed``."""

    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 widths: Sequence[int] = (64, 128, 256, 512, 512),
                 image_size: int = 224, device=None, seed: int = 0):
        dev = resolve_device(device)
        super().__init__()
        self.dtype = dtype
        self.conv_names = []
        in_ch = 3
        for stage, n_convs in enumerate(_CFG[depth]):
            for i in range(n_convs):
                name = f"conv{stage}_{i}"
                self.add_module(name, Conv(in_ch, widths[stage], 3,
                                           dtype=dtype, bias=True))
                self.conv_names.append((stage, name))
                in_ch = widths[stage]
        side = image_size >> len(_CFG[depth])
        self.Dense_0 = Dense(side * side * in_ch, 4096, dtype)
        self.Dense_1 = Dense(4096, 4096, dtype)
        self.Dense_2 = Dense(4096, num_classes)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.Dropout_0 = Dropout(0.5, gen)
        self.Dropout_1 = Dropout(0.5, gen)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    def forward(self, x):
        x = x.to(self.dtype)
        for k, (stage, name) in enumerate(self.conv_names):
            x = F.relu(getattr(self, name)(x))
            if k + 1 == len(self.conv_names) \
                    or self.conv_names[k + 1][0] != stage:
                x = max_pool(x, 2, 2)
        x = x.reshape(x.shape[0], -1)
        x = self.Dropout_0(F.relu(self.Dense_0(x)))
        x = self.Dropout_1(F.relu(self.Dense_1(x)))
        return self.Dense_2(x)


VGG11 = partial(VGG, depth=11)
VGG13 = partial(VGG, depth=13)
VGG16 = partial(VGG, depth=16)
VGG19 = partial(VGG, depth=19)
