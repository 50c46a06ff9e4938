"""Gradient compression for allreduce (``horovod_tpu/ops/compression.py``):
the cast compressors (``none``, ``fp16``, ``bf16``) wrap the reduction in
compress -> reduce -> decompress; the lossy ones (``int8``, ``int4``,
``topk``) are markers the collectives dispatch on to the scale-aware or
sparse reductions of :mod:`horovod_tpu_torch.ops.quantization`.  Their
``compress`` / ``decompress`` stay a standalone local round trip; integer
and bool tensors pass through."""

from __future__ import annotations

import math

import torch

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.ops import quantization as _q


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


class _LossyCompressor:
    """Base of the lossy wire modes: collectives dispatch on
    ``quantized`` and run the mode's reduction instead of compress ->
    reduce -> decompress."""
    quantized = True
    mode = "none"


class Int8Compressor(_LossyCompressor):
    """Block-scaled symmetric int8: ``compress`` gives ``((q, scales),
    meta)`` (kernel B4), ``decompress`` undoes it (B5)."""
    mode = "int8"

    @staticmethod
    def compress(tensor):
        if not tensor.is_floating_point():
            return tensor, None
        q, scales, meta = _q.quantize_block_scaled(tensor)
        return (q, scales), meta

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is None:
            return tensor
        q, scales = tensor
        return _q.dequantize_block_scaled(q, scales, ctx)


class Int4Compressor(_LossyCompressor):
    """Packed int4 (two nibbles per wire byte): B6 and B7."""
    mode = "int4"

    @staticmethod
    def compress(tensor):
        if not tensor.is_floating_point():
            return tensor, None
        p, scales, meta = _q.quantize4_block_scaled(tensor)
        return (p, scales), meta

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is None:
            return tensor
        p, scales = tensor
        return _q.dequantize4_block_scaled(p, scales, ctx)


class TopKCompressor(_LossyCompressor):
    """Magnitude top-k with a fixed ``k = max(1, round(HOROVOD_TOPK_RATIO
    * n))`` index + value payload; the round trip keeps the k largest
    magnitudes and zeroes the rest."""
    mode = "topk"

    @staticmethod
    def compress(tensor):
        if not tensor.is_floating_point():
            return tensor, None
        flat = tensor.to(torch.float32).reshape(-1)
        idx, vals = _q._topk_select(flat, _q.topk_k(flat.numel()))
        return (idx, vals), (tuple(tensor.shape), tensor.dtype)

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is None:
            return tensor
        idx, vals = tensor
        shape, dtype = ctx
        dense = torch.zeros(math.prod(shape), dtype=torch.float32,
                            device=vals.device)
        dense[idx.long()] = vals
        return dense.reshape(shape).to(dtype)


# Aggressiveness ladder: the byte cut grows to the right.
MODE_LADDER = ("none", "bf16", "fp16", "int8", "int4", "topk")


class Compression:
    """Optional gradient compression algorithm used during allreduce."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    int4 = Int4Compressor
    topk = TopKCompressor

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


def is_quantized(compression) -> bool:
    """True for the compressors that need a scale-aware or sparse
    reduction (int8, int4, topk)."""
    return bool(getattr(compression, "quantized", False))


def wire_mode(compression) -> str:
    """The mode string a compressor's wire runs
    (``none|fp16|bf16|int8|int4|topk``)."""
    if is_quantized(compression):
        return compression.mode
    return {torch.float16: "fp16", torch.bfloat16: "bf16"}.get(
        getattr(compression, "wire_dtype", None), "none")


def active_compression():
    """The compressor selected by the ``HOROVOD_COMPRESSION`` knob."""
    return Compression.lookup(_config.get("compression"))


# ---------------------------------------------------------------------------
# Per-bucket modes (``HOROVOD_BUCKET_COMPRESSION``)
# ---------------------------------------------------------------------------


def parse_bucket_modes(spec: str) -> list:
    """Parse a ``HOROVOD_BUCKET_COMPRESSION`` value: colon-separated mode
    names (``int8:int4:topk``), each checked against
    :data:`MODE_LADDER`; a typo raises."""
    modes = [m.strip().lower() for m in str(spec).split(":") if m.strip()]
    for m in modes:
        if m not in MODE_LADDER:
            raise ValueError(
                f"HOROVOD_BUCKET_COMPRESSION entry {m!r} is not a wire "
                f"mode; expected one of {'|'.join(MODE_LADDER)}")
    return modes


def bucket_modes(k: int, default: str = "none") -> list:
    """The wire mode of each of ``k`` buckets: the
    ``HOROVOD_BUCKET_COMPRESSION`` list cycled to length ``k``, or
    ``default`` for every bucket when the knob is unset."""
    k = max(1, int(k))
    modes = parse_bucket_modes(str(_config.get("bucket_compression")).strip())
    if not modes:
        return [default] * k
    return [modes[b % len(modes)] for b in range(k)]
