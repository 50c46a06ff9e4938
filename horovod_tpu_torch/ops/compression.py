"""Gradient compression for allreduce: the cast compressors of
``horovod_tpu/ops/compression.py`` (``none``, ``fp16``, ``bf16``).
The lossy codecs (int8, int4, top-k) are not ported yet: asking for one
raises instead of running uncompressed."""

from __future__ import annotations

import torch

from horovod_tpu_torch.common import config as _config


class NoneCompressor:
    """Identity: the wire carries the tensor as it is."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor:
    wire_dtype: torch.dtype = torch.float32

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point() and tensor.dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    """Floating tensors ride the wire as float16."""
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """Floating tensors ride the wire as bfloat16."""
    wire_dtype = torch.bfloat16


class _NotPorted:
    def __init__(self, mode: str):
        self.mode = mode

    def _raise(self, *_):
        raise NotImplementedError(
            f"Compression.{self.mode} is not ported yet (ROADMAP.md "
            "Queue A item 6, kernels B4-B7); use none, fp16 or bf16")

    compress = decompress = _raise


class Compression:
    """Optional gradient compression algorithm used during allreduce."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = _NotPorted("int8")
    int4 = _NotPorted("int4")
    topk = _NotPorted("topk")

    @classmethod
    def lookup(cls, name: str):
        """Compressor for a ``HOROVOD_COMPRESSION`` knob value."""
        try:
            return {"none": cls.none, "": cls.none, "fp16": cls.fp16,
                    "bf16": cls.bf16, "int8": cls.int8, "int4": cls.int4,
                    "topk": cls.topk}[str(name).lower()]
        except KeyError:
            raise ValueError(
                f"Unknown compression mode {name!r}; expected "
                "none|fp16|bf16|int8|int4|topk") from None


def require_ported(compression) -> None:
    """Raise now, not at the first step, for a codec not ported yet."""
    if isinstance(compression, _NotPorted):
        compression.compress(None)


def active_compression():
    """The compressor selected by the ``HOROVOD_COMPRESSION`` knob."""
    return Compression.lookup(_config.get("compression"))
