"""Frontend gradient compression (counterpart of
``horovod_tpu/torch/compression.py``; reference
``horovod/torch/compression.py``): ``Compression.none``, ``fp16`` and
``bf16`` cast a tensor before it enters the eager wire and back after.
The block-scaled and sparse wires are the ``HOROVOD_COMPRESSION`` knob's
on the eager plane, not per-call compressors."""

from __future__ import annotations

import torch


class Compressor:
    """Interface for compressing and decompressing a given tensor."""

    @staticmethod
    def compress(tensor):
        """Returns the tensor compressed for the wire and a context."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        """Returns the tensor decompressed from the wire."""
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Default no-op compression."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        if tensor.dtype.is_floating_point and tensor.dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is not None:
            return tensor.to(ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    """Compress all floating-point gradients to 16-bit on the wire."""
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """bfloat16 on the wire: float32's exponent range, no overflow."""
    wire_dtype = torch.bfloat16


class Compression:
    """Optional gradient compression algorithm used during allreduce."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
