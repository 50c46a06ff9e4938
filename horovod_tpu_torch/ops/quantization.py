"""Block-scaled lossy wire codecs (int8, packed int4, top-k) with error
feedback: the counterpart of ``horovod_tpu/ops/quantization.py`` over
the ``torch.distributed`` world or one axis of the data mesh (a
:class:`~horovod_tpu_torch.parallel.mesh.Hop`).

**Wire format.**  A flat float32 payload is cut into blocks of
``HOROVOD_QUANT_BLOCK_SIZE`` elements (default 256, zero tail pad); each
block carries one float32 scale and int8 values (int4: two nibbles per
wire byte, element ``i`` of a block paired with ``i + block/2``).

**Reductions.**  Ranks agree on per-block scales with a float ``MAX``
allreduce of the block absmaxes, quantize with the sum-safe headroom
``qmax = 127 // n`` (int4: ``7 // n``), ``n`` the size of the axis the
reduction runs over, so the int8 ``SUM`` allreduce of the payload cannot
overflow, and dequantize with the shared scales.
Top-k gathers every rank's ``(int32 index, float32 value)`` pairs
(``all_gather`` for allreduce, ``all_to_all`` for reduce-scatter) and
scatter-adds them.  Every ``*_with_error`` form also returns this rank's
float32 residual for error feedback.  At world 1 the allreduces return
their input and a zero residual, as the reference does.

**Kernels B4-B7** (``csrc/quantization.cu``): :func:`quantize_values`,
:func:`dequantize_values`, :func:`quantize_pack4_values` and
:func:`unpack_dequantize4_values` launch their CUDA kernel for a CUDA
tensor (counted in :data:`LAUNCHES`) and run their plain version
(:func:`quantize_plain`, :func:`dequantize_plain`,
:func:`quantize_pack4_plain`, :func:`unpack_dequantize4_plain`) for a
CPU tensor.  A failed build or launch raises.

Scales are ``absmax / qmax`` as a true division by a tensor on every
device (PyTorch divides by a Python scalar through its reciprocal).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from horovod_tpu_torch import _build
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import events as _events
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import true_divide
from horovod_tpu_torch.parallel import mesh as _pmesh

DEFAULT_BLOCK_SIZE = 256
_QMAX = 127  # symmetric int8: values in [-127, 127] (-128 unused)
_QMAX4 = 7   # symmetric int4 nibble: values in [-7, 7] (-8 unused)
LOSSY_MODES = ("int8", "int4", "topk")

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
LAUNCHES = {"quantize": 0, "dequantize": 0, "pack4": 0, "unpack4": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_block_size(block_size: int | None = None) -> int:
    if block_size is None:
        block_size = int(_config.get("quant_block_size"))
    return block_size if block_size > 0 else DEFAULT_BLOCK_SIZE


def sum_safe_qmax(n: int) -> int:
    """Largest per-rank magnitude such that an n-rank int8 sum cannot
    overflow: ``n * (127 // n) <= 127``.  Raises past 127 ranks, where no
    headroom is left and the sum would wrap."""
    n = max(int(n), 1)
    qmax = _QMAX // n
    if qmax < 1:
        raise ValueError(
            f"int8 quantized reduction over {n} ranks cannot be made "
            f"sum-safe (127 // {n} == 0); reduce the quantized world or "
            "use fp16/bf16.")
    return qmax


def sum_safe_qmax4(n: int) -> int:
    """The int4 headroom ``7 // n``: raises past 7 ranks."""
    n = max(int(n), 1)
    qmax = _QMAX4 // n
    if qmax < 1:
        raise ValueError(
            f"int4 quantized reduction over {n} ranks cannot be made "
            f"sum-safe (7 // {n} == 0); reduce the quantized world or "
            "use int8.")
    return qmax


def _check_int4_block(block: int) -> int:
    if block % 2:
        raise ValueError(
            f"int4 packing needs an even HOROVOD_QUANT_BLOCK_SIZE, got "
            f"{block} (two nibbles share each wire byte).")
    return block


class QuantMeta(NamedTuple):
    """What undoes the blocking and padding."""
    shape: tuple
    dtype: torch.dtype
    length: int      # valid elements before padding
    block: int


def _to_blocks(x: torch.Tensor, block: int):
    """Flatten to (nblocks, block) float32 with a zero tail pad."""
    flat = x.to(torch.float32).reshape(-1)
    length = flat.numel()
    pad = (-length) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, block), length


def _from_blocks(x2d: torch.Tensor, meta: QuantMeta) -> torch.Tensor:
    flat = x2d.reshape(-1)[:meta.length]
    return flat.reshape(meta.shape).to(meta.dtype)


def block_absmax(x2d: torch.Tensor) -> torch.Tensor:
    """Per-block absolute maximum, shape (nblocks,) float32."""
    return x2d.abs().amax(dim=1)


def _scales(absmax: torch.Tensor, qmax: int) -> torch.Tensor:
    return true_divide(absmax, qmax)


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic in PyTorch ops (``_quantize_jnp``,
# ``_dequantize_jnp``, ``_quantize_pack4_jnp``, ``_unpack_dequantize4_jnp``)
# ---------------------------------------------------------------------------


def _inv_scales(scales: torch.Tensor) -> torch.Tensor:
    pos = scales > 0
    safe = torch.where(pos, scales, torch.ones_like(scales))
    return torch.where(pos, torch.ones_like(scales) / safe,
                       torch.zeros_like(scales))


def _quantize_grid(x2d, scales, qmax: int) -> torch.Tensor:
    """``clip(round_half_even(x * inv), -qmax, qmax)`` as float32."""
    return torch.clamp(torch.round(x2d * _inv_scales(scales)[:, None]),
                       -qmax, qmax)


def quantize_plain(x2d, scales, qmax: int) -> torch.Tensor:
    """B4's function: int8 values of blocked float32 ``x2d``."""
    return _quantize_grid(x2d, scales, qmax).to(torch.int8)


def dequantize_plain(q2d, scales) -> torch.Tensor:
    """B5's function: ``float32(q) * scale`` per block (q int8 or int32
    partial sums)."""
    return q2d.to(torch.float32) * scales[:, None]


def quantize_pack4_plain(x2d, scales, qmax: int) -> torch.Tensor:
    """B6's function: quantize, then ``byte = 16*q[:, half+i] + q[:, i]``
    computed in int32 and narrowed to int8."""
    q = _quantize_grid(x2d, scales, qmax).to(torch.int32)
    half = q.shape[1] // 2
    return (q[:, half:] * 16 + q[:, :half]).to(torch.int8)


def _unpack4_i32(p2d_i32: torch.Tensor) -> torch.Tensor:
    """Packed (possibly summed) bytes back to the (.., block) int grid:
    ``lo = floormod(p + 8, 16) - 8``, ``hi = (p - lo) / 16``; exact while
    every nibble sum stays in [-7, 7] (the sum-safe headroom)."""
    lo = torch.remainder(p2d_i32 + 8, 16) - 8
    hi = torch.div(p2d_i32 - lo, 16, rounding_mode="floor")
    return torch.cat([lo, hi], dim=1)


def unpack_dequantize4_plain(p2d, scales) -> torch.Tensor:
    """B7's function: unpack, then ``float32(nibble) * scale``."""
    q = _unpack4_i32(p2d.to(torch.int32))
    return q.to(torch.float32) * scales[:, None]


# ---------------------------------------------------------------------------
# Kernel wrappers (B4-B7)
# ---------------------------------------------------------------------------

_lib = None
_Q_DTYPES = {torch.int8: 0, torch.int32: 1}


def _kernels():
    """The built library, with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load("quantization")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.hvd_quantize.argtypes = [p, p, p, i64, i32, i32, p]
        lib.hvd_dequantize.argtypes = [i32, p, p, p, i64, i32, p]
        lib.hvd_pack4.argtypes = [p, p, p, i64, i32, i32, p]
        lib.hvd_unpack4.argtypes = [p, p, p, i64, i32, p]
        for fn in (lib.hvd_quantize, lib.hvd_dequantize, lib.hvd_pack4,
                   lib.hvd_unpack4):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, vals: torch.Tensor, scales: torch.Tensor,
           dtypes) -> None:
    if vals.device.type not in ("cpu", "cuda"):
        raise HorovodTpuError(f"{name}: unsupported device {vals.device}")
    if vals.dtype not in dtypes:
        raise HorovodTpuError(
            f"{name}: values are {vals.dtype}, expected one of {dtypes}")
    if vals.dim() != 2 or scales.dim() != 1 \
            or scales.shape[0] != vals.shape[0]:
        raise HorovodTpuError(
            f"{name}: expected (nblocks, block) values and (nblocks,) "
            f"scales, got {tuple(vals.shape)} and {tuple(scales.shape)}")
    if scales.dtype != torch.float32 or scales.device != vals.device:
        raise HorovodTpuError(
            f"{name}: scales must be float32 on {vals.device}, got "
            f"{scales.dtype} on {scales.device}")
    if not (vals.is_contiguous() and scales.is_contiguous()):
        raise HorovodTpuError(f"{name}: tensors must be contiguous")


def _launch(name: str, fn, ref: torch.Tensor, *args) -> None:
    if ref.numel() == 0:
        return
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise HorovodTpuError(f"{name} kernel launch failed: CUDA error {rc}")
    _events.note_launch(LAUNCHES, "quantization", name)


def quantize_values(x2d, scales, qmax: int = _QMAX) -> torch.Tensor:
    """B4: int8 values of blocked float32 ``x2d`` under given per-block
    scales, ``(nblocks, block)``."""
    _check("quantize", x2d, scales, (torch.float32,))
    if x2d.device.type == "cpu":
        return quantize_plain(x2d, scales, qmax)
    fn, (nb, block) = _kernels().hvd_quantize, x2d.shape
    q = torch.empty((nb, block), dtype=torch.int8, device=x2d.device)
    _launch("quantize", fn, x2d, x2d.data_ptr(),
            scales.data_ptr(), q.data_ptr(), nb, block, int(qmax))
    return q


def dequantize_values(q2d, scales) -> torch.Tensor:
    """B5: float32 values of blocked int8 (or int32 partial-sum)
    ``q2d``."""
    _check("dequantize", q2d, scales, tuple(_Q_DTYPES))
    if q2d.device.type == "cpu":
        return dequantize_plain(q2d, scales)
    fn, (nb, block) = _kernels().hvd_dequantize, q2d.shape
    x = torch.empty((nb, block), dtype=torch.float32, device=q2d.device)
    _launch("dequantize", fn, q2d,
            _Q_DTYPES[q2d.dtype], q2d.data_ptr(), scales.data_ptr(),
            x.data_ptr(), nb, block)
    return x


def quantize_pack4_values(x2d, scales, qmax: int = _QMAX4) -> torch.Tensor:
    """B6: packed int4 wire bytes, ``(nblocks, block // 2)`` int8."""
    _check("pack4", x2d, scales, (torch.float32,))
    _check_int4_block(x2d.shape[1])
    if x2d.device.type == "cpu":
        return quantize_pack4_plain(x2d, scales, qmax)
    fn, (nb, block) = _kernels().hvd_pack4, x2d.shape
    p = torch.empty((nb, block // 2), dtype=torch.int8, device=x2d.device)
    _launch("pack4", fn, x2d, x2d.data_ptr(),
            scales.data_ptr(), p.data_ptr(), nb, block, int(qmax))
    return p


def unpack_dequantize4_values(p2d, scales) -> torch.Tensor:
    """B7: float32 values, ``(nblocks, 2 * half)``, of packed int4 bytes
    (or their sum-safe int8 sums)."""
    _check("unpack4", p2d, scales, (torch.int8,))
    if p2d.device.type == "cpu":
        return unpack_dequantize4_plain(p2d, scales)
    fn, (nb, half) = _kernels().hvd_unpack4, p2d.shape
    x = torch.empty((nb, 2 * half), dtype=torch.float32, device=p2d.device)
    _launch("unpack4", fn, p2d, p2d.data_ptr(),
            scales.data_ptr(), x.data_ptr(), nb, 2 * half)
    return x


# ---------------------------------------------------------------------------
# Standalone round trip (the compressors' compress / decompress)
# ---------------------------------------------------------------------------


def quantize_block_scaled(x, block_size: int | None = None,
                          qmax: int = _QMAX):
    """Local block-scaled quantization: ``(q2d int8, scales, meta)``;
    :func:`dequantize_block_scaled` undoes it within ``scale / 2`` per
    element."""
    block = resolve_block_size(block_size)
    x2d, length = _to_blocks(x, block)
    scales = _scales(block_absmax(x2d), qmax)
    q = quantize_values(x2d, scales, qmax)
    return q, scales, QuantMeta(tuple(x.shape), x.dtype, length, block)


def dequantize_block_scaled(q2d, scales, meta: QuantMeta):
    return _from_blocks(dequantize_values(q2d, scales), meta)


def quantize4_block_scaled(x, block_size: int | None = None,
                           qmax: int = _QMAX4):
    """The int4 round trip: ``(packed int8, scales, meta)``."""
    block = _check_int4_block(resolve_block_size(block_size))
    x2d, length = _to_blocks(x, block)
    scales = _scales(block_absmax(x2d), qmax)
    p = quantize_pack4_values(x2d, scales, qmax)
    return p, scales, QuantMeta(tuple(x.shape), x.dtype, length, block)


def dequantize4_block_scaled(p2d, scales, meta: QuantMeta):
    return _from_blocks(unpack_dequantize4_values(p2d, scales), meta)


# ---------------------------------------------------------------------------
# The wire: reductions over the world
# ---------------------------------------------------------------------------


def _codec(n: int, block: int, int4: bool):
    """``(qmax, encode, decode)`` of the int8 or packed int4 wire over
    ``n`` ranks."""
    if int4:
        _check_int4_block(block)
        return (sum_safe_qmax4(n), quantize_pack4_values,
                unpack_dequantize4_values)
    return sum_safe_qmax(n), quantize_values, dequantize_values


def _dense_psum_impl(x, block_size, with_error: bool, int4: bool, hop):
    """int8 (``int4=False``) or packed int4 allreduce of ``x`` over
    ``hop``, at the headroom of ``hop``'s size."""
    n = hop.size
    block = resolve_block_size(block_size)
    qmax, enc, dec = _codec(n, block, int4)
    if n == 1:
        err = (torch.zeros(x.shape, dtype=torch.float32, device=x.device)
               if with_error else None)
        return x, err
    x2d, length = _to_blocks(x, block)
    scales = _scales(hop.all_reduce(block_absmax(x2d), "max"), qmax)
    q = enc(x2d, scales, qmax)
    qsum = hop.all_reduce(q.clone() if with_error else q)  # int8 wire
    out = _from_blocks(dec(qsum, scales),
                       QuantMeta(tuple(x.shape), x.dtype, length, block))
    err = None
    if with_error:
        err = _from_blocks(x2d - dec(q, scales),
                           QuantMeta(tuple(x.shape), torch.float32, length,
                                     block))
    return out, err


def quantized_psum(x, block_size: int | None = None, axis_name=None):
    """Sum of ``x`` over ``axis_name`` on the int8 wire: one float
    ``MAX`` of the block absmaxes and one int8 ``SUM`` of the payload.
    Within ``n * scale / 2`` of the exact sum per element."""
    return _dense_psum_impl(x, block_size, False, False,
                            _pmesh.flat_hop(axis_name))[0]


def quantized_psum_with_error(x, block_size: int | None = None,
                              axis_name=None):
    """:func:`quantized_psum` and this rank's residual
    ``x - dequant(quant(x))`` (float32, shape of ``x``)."""
    return _dense_psum_impl(x, block_size, True, False,
                            _pmesh.flat_hop(axis_name))


def int4_psum(x, block_size: int | None = None, axis_name=None):
    """Sum over ``axis_name`` on the packed int4 wire (half int8's
    bytes)."""
    return _dense_psum_impl(x, block_size, False, True,
                            _pmesh.flat_hop(axis_name))[0]


def int4_psum_with_error(x, block_size: int | None = None, axis_name=None):
    return _dense_psum_impl(x, block_size, True, True,
                            _pmesh.flat_hop(axis_name))


def _dense_scatter_impl(seg, block_size, with_error: bool, int4: bool,
                        hop):
    n = hop.size
    block = resolve_block_size(block_size)
    qmax, enc, dec = _codec(n, block, int4)
    length = seg.shape[1]
    pad = (-length) % block
    if pad:
        seg = F.pad(seg, (0, pad))
    nb = seg.shape[1] // block
    x3 = seg.reshape(n, nb, block)
    absmax = hop.all_reduce(x3.abs().amax(dim=2), "max")    # (n, nb)
    scales = _scales(absmax, qmax)                           # shared
    q = enc(x3.reshape(n * nb, block), scales.reshape(-1), qmax)
    qsum = torch.empty((nb, q.shape[1]), dtype=torch.int8, device=q.device)
    hop.reduce_scatter(qsum, q)                              # int8 wire
    out = dec(qsum, scales[hop.index].contiguous()).reshape(-1)
    out = out[:length]
    err = None
    if with_error:
        local = dec(q, scales.reshape(-1))
        err = (x3.reshape(n, -1) - local.reshape(n, -1))[:, :length]
    return out, err


def quantized_psum_scatter_segments(seg, block_size: int | None = None,
                                    with_error: bool = False,
                                    axis_name=None):
    """Reduce-scatter an ``(n, L)`` float32 segment stack over
    ``axis_name`` on the int8 wire with per-(segment, block) shared
    scales: returns ``(shard, err)``, ``shard`` the ``(L,)`` sum of the
    segment at this rank's axis index and ``err`` (``with_error``) this
    rank's full ``(n, L)`` residual.  No world-1 shortcut of its own:
    the caller decides."""
    return _dense_scatter_impl(seg, block_size, with_error, False,
                               _pmesh.flat_hop(axis_name))


def int4_psum_scatter_segments(seg, block_size: int | None = None,
                               with_error: bool = False, axis_name=None):
    """The int4 sibling of :func:`quantized_psum_scatter_segments`."""
    return _dense_scatter_impl(seg, block_size, with_error, True,
                               _pmesh.flat_hop(axis_name))


# ---------------------------------------------------------------------------
# top-k: fixed-size index + value payloads
# ---------------------------------------------------------------------------


def resolve_topk_ratio(ratio: float | None = None) -> float:
    if ratio is None:
        ratio = float(_config.get("topk_ratio"))
    return min(max(float(ratio), 1e-6), 1.0)


def topk_k(length: int, ratio: float | None = None) -> int:
    """Payload size ``max(1, round(ratio * length))``, at most
    ``length``."""
    r = resolve_topk_ratio(ratio)
    return max(1, min(int(length), int(round(int(length) * r))))


def _topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest magnitudes along the last dimension,
    ties to the lower index as ``lax.top_k`` breaks them (``torch.topk``
    promises no order among equal values): a stable descending sort."""
    return torch.sort(x.abs(), dim=-1, descending=True,
                      stable=True).indices[..., :k]


def _topk_select(flat: torch.Tensor, k: int):
    """This rank's magnitude top-k of a flat float32 buffer: ``(int32
    indices, float32 values)``, each ``(k,)``."""
    idx = _topk_indices(flat, k)
    return idx.to(torch.int32), flat[idx]


def _all_gather(t: torch.Tensor, hop) -> torch.Tensor:
    """Every member of ``hop``'s ``t`` concatenated along dim 0."""
    out = torch.empty((hop.size * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    hop.all_gather(out, t.contiguous())
    return out


def _topk_psum_impl(x, ratio, with_error: bool, hop):
    n = hop.size
    shape, dtype = x.shape, x.dtype
    if n == 1:
        err = (torch.zeros(shape, dtype=torch.float32, device=x.device)
               if with_error else None)
        return x, err
    flat = x.to(torch.float32).reshape(-1)
    idx, vals = _topk_select(flat, topk_k(flat.numel(), ratio))
    # every rank's sparse pairs are the wire; the dense sum is local
    all_idx, all_vals = _all_gather(idx, hop), _all_gather(vals, hop)
    dense = torch.zeros_like(flat).index_add_(0, all_idx.long(), all_vals)
    out = dense.reshape(shape).to(dtype)
    err = None
    if with_error:
        # unselected entries stay in the residual
        err = flat.index_fill(0, idx.long(), 0.0).reshape(shape)
    return out, err


def topk_psum(x, ratio: float | None = None, axis_name=None):
    return _topk_psum_impl(x, ratio, False, _pmesh.flat_hop(axis_name))[0]


def topk_psum_with_error(x, ratio: float | None = None, axis_name=None):
    return _topk_psum_impl(x, ratio, True, _pmesh.flat_hop(axis_name))


def topk_psum_scatter_segments(seg, ratio: float | None = None,
                               with_error: bool = False, axis_name=None):
    """Reduce-scatter an ``(n, L)`` segment stack on the sparse wire: each
    row's magnitude top-k goes by one ``all_to_all`` to the rank owning
    that segment, which scatter-adds it.  Same ``(shard, err)`` contract
    as :func:`quantized_psum_scatter_segments`."""
    hop = _pmesh.flat_hop(axis_name)
    n = hop.size
    L = seg.shape[1]
    if n == 1:
        err = (torch.zeros(seg.shape, dtype=torch.float32, device=seg.device)
               if with_error else None)
        return seg.reshape(-1), err
    idx = _topk_indices(seg, topk_k(L, ratio))                    # (n, k)
    vals = torch.gather(seg, 1, idx)
    idx32 = idx.to(torch.int32).contiguous()
    ridx, rvals = torch.empty_like(idx32), torch.empty_like(vals)
    hop.all_to_all(ridx, idx32)
    hop.all_to_all(rvals, vals.contiguous())
    shard = torch.zeros(L, dtype=torch.float32, device=seg.device).index_add_(
        0, ridx.reshape(-1).long(), rvals.reshape(-1))
    err = seg.scatter(1, idx, 0.0) if with_error else None
    return shard, err


# ---------------------------------------------------------------------------
# Mode dispatch
# ---------------------------------------------------------------------------


def norm_mode(quantized) -> str:
    """``True -> "int8"``, ``False``/``None -> "none"``, strings pass."""
    if quantized is True:
        return "int8"
    if quantized is False or quantized is None:
        return "none"
    return str(quantized)


def _lossy_psum_impl(x, mode, block_size, ratio, with_error: bool,
                     axis_name=None):
    mode = norm_mode(mode)
    hop = _pmesh.flat_hop(axis_name)
    if mode == "int8":
        return _dense_psum_impl(x, block_size, with_error, False, hop)
    if mode == "int4":
        return _dense_psum_impl(x, block_size, with_error, True, hop)
    if mode == "topk":
        return _topk_psum_impl(x, ratio, with_error, hop)
    raise ValueError(f"unknown lossy wire mode {mode!r}; expected one of "
                     f"{LOSSY_MODES}")


def lossy_psum(x, mode: str, block_size: int | None = None,
               ratio: float | None = None, axis_name=None):
    """Sum of ``x`` over ``axis_name`` on the ``mode`` wire."""
    return _lossy_psum_impl(x, mode, block_size, ratio, False, axis_name)[0]


def lossy_psum_with_error(x, mode: str, block_size: int | None = None,
                          ratio: float | None = None, axis_name=None):
    """:func:`lossy_psum` and this rank's float32 residual."""
    return _lossy_psum_impl(x, mode, block_size, ratio, True, axis_name)


def lossy_psum_scatter_segments(seg, mode: str,
                                block_size: int | None = None,
                                with_error: bool = False,
                                ratio: float | None = None, axis_name=None):
    """Reduce-scatter an ``(n, L)`` segment stack over ``axis_name`` on
    the ``mode`` wire: ``(shard, err)``."""
    mode = norm_mode(mode)
    if mode == "int8":
        return quantized_psum_scatter_segments(seg, block_size, with_error,
                                               axis_name)
    if mode == "int4":
        return int4_psum_scatter_segments(seg, block_size, with_error,
                                          axis_name)
    if mode == "topk":
        return topk_psum_scatter_segments(seg, ratio, with_error, axis_name)
    raise ValueError(f"unknown lossy wire mode {mode!r}; expected one of "
                     f"{LOSSY_MODES}")


# ---------------------------------------------------------------------------
# Error feedback
# ---------------------------------------------------------------------------


def init_error_feedback(params):
    """One zero float32 residual per parameter (a list)."""
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]


def apply_error_feedback(grads, residuals):
    """Re-inject last step's error: ``g + r`` in ``g``'s dtype."""
    return [g + r.to(g.dtype) for g, r in zip(grads, residuals)]
