"""Inception-v3 (``horovod_tpu/models/inception.py``): the Szegedy et
al. 2015 topology (mixed 5b-7c) with bf16 compute and float32
parameters and statistics, NHWC.  The final pool is a spatial mean, so
any input of 75 px or more works (canonical size 299).

Every convolution is a :class:`ConvBN`: a bias-free convolution, then
BatchNorm (momentum 0.9, epsilon 1e-3; kernels N1-N4 on the card), then
a ReLU.  Submodules carry the flax scope names: ``ConvBN_<k>`` numbered
in the order flax creates them inside each block, ``MixedA_<i>``,
``ReductionA_0``, ``MixedB_<i>``, ``ReductionB_0``, ``MixedC_<i>`` and
``Dense_0`` at the top, and ``Conv_0`` / ``BatchNorm_0`` inside each
``ConvBN``.  Branches are concatenated on the channel dim in the JAX
order."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common.util import resolve_device
from horovod_tpu_torch.models.layers import (BatchNorm, Conv, Dense, Dropout,
                                             _avgpool3, init_weights,
                                             max_pool, spatial_mean)


class ConvBN(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel, strides=1,
                 padding="SAME", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, kernel, strides, padding, dtype)
        self.BatchNorm_0 = BatchNorm(features, momentum=0.9, eps=1e-3)
        self.out_channels = features

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class _Block(nn.Module):
    """A block whose ``ConvBN_<k>`` are added by :meth:`cbn` in flax's
    creation order; its branches are tuples of them (tuples, so that
    each module is registered once, under its flax name)."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype, self._n = dtype, 0

    def cbn(self, in_ch, features, kernel, strides=1, padding="SAME"):
        m = ConvBN(in_ch, features, kernel, strides, padding, self.dtype)
        self.add_module(f"ConvBN_{self._n}", m)
        self._n += 1
        return m


class MixedA(_Block):           # mixed 5b/5c/5d
    def __init__(self, in_ch: int, pool_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        self.b1 = (self.cbn(in_ch, 64, 1),)
        self.b5 = (self.cbn(in_ch, 48, 1), self.cbn(48, 64, 5))
        self.b3 = (self.cbn(in_ch, 64, 1), self.cbn(64, 96, 3),
                   self.cbn(96, 96, 3))
        self.bp = (self.cbn(in_ch, pool_features, 1),)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b5, x),
                          _chain(self.b3, x), _chain(self.bp, _avgpool3(x))],
                         dim=-1)


class ReductionA(_Block):       # mixed 6a
    def __init__(self, in_ch: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        self.b3 = (self.cbn(in_ch, 384, 3, 2, "VALID"),)
        self.bd = (self.cbn(in_ch, 64, 1), self.cbn(64, 96, 3),
                   self.cbn(96, 96, 3, 2, "VALID"))
        self.out_channels = 384 + 96 + in_ch

    def forward(self, x):
        return torch.cat([_chain(self.b3, x), _chain(self.bd, x),
                          max_pool(x, 3, 2, "VALID")], dim=-1)


class MixedB(_Block):           # mixed 6b-6e (factorized 7x7)
    def __init__(self, in_ch: int, channels_7x7: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        c = channels_7x7
        self.b1 = (self.cbn(in_ch, 192, 1),)
        self.b7 = (self.cbn(in_ch, c, 1), self.cbn(c, c, (1, 7)),
                   self.cbn(c, 192, (7, 1)))
        self.bd = (self.cbn(in_ch, c, 1), self.cbn(c, c, (7, 1)),
                   self.cbn(c, c, (1, 7)), self.cbn(c, c, (7, 1)),
                   self.cbn(c, 192, (1, 7)))
        self.bp = (self.cbn(in_ch, 192, 1),)
        self.out_channels = 4 * 192

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b7, x),
                          _chain(self.bd, x), _chain(self.bp, _avgpool3(x))],
                         dim=-1)


class ReductionB(_Block):       # mixed 7a
    def __init__(self, in_ch: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        self.b3 = (self.cbn(in_ch, 192, 1),
                   self.cbn(192, 320, 3, 2, "VALID"))
        self.b7 = (self.cbn(in_ch, 192, 1), self.cbn(192, 192, (1, 7)),
                   self.cbn(192, 192, (7, 1)),
                   self.cbn(192, 192, 3, 2, "VALID"))
        self.out_channels = 320 + 192 + in_ch

    def forward(self, x):
        return torch.cat([_chain(self.b3, x), _chain(self.b7, x),
                          max_pool(x, 3, 2, "VALID")], dim=-1)


class MixedC(_Block):           # mixed 7b/7c (expanded filter bank)
    def __init__(self, in_ch: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(dtype)
        self.b1 = (self.cbn(in_ch, 320, 1),)
        self.b3 = (self.cbn(in_ch, 384, 1),)
        self.b3_pair = (self.cbn(384, 384, (1, 3)),
                        self.cbn(384, 384, (3, 1)))
        self.bd = (self.cbn(in_ch, 448, 1), self.cbn(448, 384, 3))
        self.bd_pair = (self.cbn(384, 384, (1, 3)),
                        self.cbn(384, 384, (3, 1)))
        self.bp = (self.cbn(in_ch, 192, 1),)
        self.out_channels = 320 + 768 + 768 + 192

    def forward(self, x):
        b3 = _chain(self.b3, x)
        bd = _chain(self.bd, x)
        return torch.cat([_chain(self.b1, x), *(m(b3) for m in self.b3_pair),
                          *(m(bd) for m in self.bd_pair),
                          _chain(self.bp, _avgpool3(x))], dim=-1)


def _chain(mods, x):
    for m in mods:
        x = m(x)
    return x


class InceptionV3(nn.Module):
    """Inception-v3 over NHWC float inputs; returns float32 logits.
    Dropout(0.5) before the classifier draws its mask from a generator
    seeded from ``seed``."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: int = 0):
        dev = resolve_device(device)
        super().__init__()
        self.dtype = dtype
        stem = [(3, 32, 3, 2, "VALID"), (32, 32, 3, 1, "VALID"),
                (32, 64, 3, 1, "SAME"), (64, 80, 1, 1, "VALID"),
                (80, 192, 3, 1, "VALID")]
        for k, args in enumerate(stem):
            self.add_module(f"ConvBN_{k}", ConvBN(*args, dtype=dtype))
        blocks = [("MixedA_0", MixedA, (32,)), ("MixedA_1", MixedA, (64,)),
                  ("MixedA_2", MixedA, (64,)),
                  ("ReductionA_0", ReductionA, ()),
                  ("MixedB_0", MixedB, (128,)), ("MixedB_1", MixedB, (160,)),
                  ("MixedB_2", MixedB, (160,)), ("MixedB_3", MixedB, (192,)),
                  ("ReductionB_0", ReductionB, ()),
                  ("MixedC_0", MixedC, ()), ("MixedC_1", MixedC, ())]
        self.block_names = []
        in_ch = 192
        for name, cls, args in blocks:
            blk = cls(in_ch, *args, dtype=dtype)
            self.add_module(name, blk)
            self.block_names.append(name)
            in_ch = blk.out_channels
        self.Dropout_0 = Dropout(
            0.5, torch.Generator(device=dev).manual_seed(seed))
        self.Dense_0 = Dense(in_ch, num_classes)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    def forward(self, x):
        x = x.to(self.dtype)
        x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        x = max_pool(x, 3, 2)
        x = self.ConvBN_4(self.ConvBN_3(x))
        x = max_pool(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.Dense_0(self.Dropout_0(spatial_mean(x, self.dtype)))
