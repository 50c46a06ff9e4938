"""The overlap engine: bucketed gradient communication (counterpart of
``horovod_tpu/ops/overlap.py``).

A fused flat buffer is reduced in K buckets (``HOROVOD_OVERLAP_CHUNKS``)
instead of one end-of-step collective.  Buckets are *column* slices of
the buffer's ``(n, L)`` segment view, so the concatenation of a rank's
bucket shards is the same contiguous shard one reduce-scatter of the
whole buffer gives: ZeRO state does not depend on K or on the knob.
Every bucket spans all n segments, so a bucket is complete only once
the backward has produced the last gradient; what overlaps is one
bucket's transfer with another's math.

The schedule is the reference's software pipeline: bucket b+1's
reduce-scatter is issued before bucket b's math (the Average division,
the dequantize and residual of a lossy mode) and its all-gather.  Each
bucket's reduce-scatter or all-gather is one ``torch.distributed`` call
with ``async_op=True`` (NCCL runs it on the process group's stream and
``work.wait()`` orders the compute stream after it; gloo runs it on its
own thread).  The reference's ``ppermute`` rings have no counterpart:
one NCCL call is the bucket's transport.

Every schedule runs over the axis its ``axis_name`` resolves to
(:func:`horovod_tpu_torch.parallel.mesh.resolve_hops`).  Under a
hierarchical ``(cross, local)`` pair a bucket's reduce-scatter is the
local hop (full precision) then the cross hop (the only lossy one), and
its all-gather the cross then the local hop
(``horovod_tpu/ops/overlap.py:206-290``); those run synchronously.

Lossy modes compress each bucket on its own (per-bucket shared scales,
a top-k payload per bucket), so an error-feedback residual is the
bucket-aligned slices of one full-buffer residual, zeros where a
bucket's mode keeps none.  ``HOROVOD_BUCKET_COMPRESSION`` gives each
bucket its own mode (:func:`resolve_bucket_modes`).

Each bucket's collectives and math run under the reference's framework
scopes (``hvd_overlap_rs<b>``, ``hvd_overlap_math<b>``,
``hvd_overlap_ag<b>``; the ZeRO schedules pass theirs), which a
``torch.profiler`` capture records and the perf observatory resolves
device work to (``common.util.profiler_scope``).
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common.util import profiler_scope, true_divide
from horovod_tpu_torch.ops import compression as _compression
from horovod_tpu_torch.ops import quantization as _quant
from horovod_tpu_torch.parallel import mesh as _pmesh

# ReduceOp codes shared with collectives.py (which imports this module).
_AVERAGE, _SUM = 1, 2
_CAST_WIRES = {"fp16": torch.float16, "bf16": torch.bfloat16}


def enabled(explicit: bool | None = None) -> bool:
    """Overlap on or off: an explicit argument wins, else the
    ``HOROVOD_OVERLAP`` knob."""
    if explicit is not None:
        return bool(explicit)
    return bool(_config.get("overlap"))


def configured_chunks() -> int:
    return max(1, int(_config.get("overlap_chunks")))


def bucket_bounds(length: int, chunks: int | None = None) -> list:
    """Split a per-rank shard of ``length`` elements into K contiguous
    ``(start, end)`` buckets (K = ``HOROVOD_OVERLAP_CHUNKS`` unless
    given; at most ``length``, so no bucket is empty)."""
    k = configured_chunks() if chunks is None else max(1, int(chunks))
    k = min(k, length) if length > 0 else 1
    base, rem = divmod(max(length, 0), k)
    bounds, off = [], 0
    for i in range(k):
        size = base + (1 if i < rem else 0)
        bounds.append((off, off + size))
        off += size
    return bounds


# ---------------------------------------------------------------------------
# One bucket's collectives, started now and finished on wait()
# ---------------------------------------------------------------------------


class _Pending:
    """A bucket collective in flight.  ``wait()`` waits for its work
    (``None``: already done) and returns ``finish()``.  ``keep`` holds
    the tensors the collective reads until then."""

    def __init__(self, work, finish, keep=None):
        self.work, self.finish, self.keep = work, finish, keep

    def wait(self):
        if self.work is not None:
            self.work.wait()
        return self.finish()


def _done(value) -> _Pending:
    return _Pending(None, lambda: value)


def _zeros_err(buf: torch.Tensor, with_error: bool):
    return (torch.zeros(buf.shape, dtype=torch.float32, device=buf.device)
            if with_error else None)


def _seg_transpose(seg2d: torch.Tensor, nc: int, nl: int) -> torch.Tensor:
    """Re-order ``(n, L)`` segment rows from world (cross-major) order to
    local-major order, so that a local-then-cross two-stage scatter lands
    segment ``c*nl + l`` on rank ``(c, l)``."""
    L = seg2d.shape[1]
    return seg2d.reshape(nc, nl, L).transpose(0, 1).reshape(nc * nl, L)


def _seg_untranspose_flat(buf: torch.Tensor, nc: int,
                          nl: int) -> torch.Tensor:
    """Inverse of :func:`_seg_transpose` on a gathered flat buffer in
    local-major segment order."""
    L = buf.shape[0] // (nc * nl)
    return buf.reshape(nl, nc, L).transpose(0, 1).reshape(-1)


def _hier_scatter(buf, pair: _pmesh.HopPair, mode: str, with_error: bool,
                  block_size):
    """The two-level bucket scatter: segments re-ordered local-major
    (``_seg_transpose``), a full-precision reduce-scatter over the local
    hop, then the cross hop (lossy in a lossy mode), so segment ``c*nl +
    l`` lands on rank ``(c, l)``.  The residual is gathered over the
    local hop and pre-divided by ``nl``."""
    nc, nl = pair.cross.size, pair.local.size
    lossy = mode in _quant.LOSSY_MODES
    L = buf.shape[0] // (nc * nl)
    seg = buf.to(torch.float32) if lossy else buf
    seg = _seg_transpose(seg.reshape(nc * nl, L), nc, nl).reshape(-1)
    part = torch.empty(nc * L, dtype=seg.dtype, device=seg.device)
    pair.local.reduce_scatter(part, seg)                # (nc, L), local
    if lossy:
        out, err_part = _quant.lossy_psum_scatter_segments(
            part.reshape(nc, L), mode, block_size, with_error,
            axis_name=pair.cross)
        err = None
        if with_error:
            g = torch.empty(nl * nc * L, dtype=torch.float32,
                            device=buf.device)
            pair.local.all_gather(g, err_part.reshape(-1).contiguous())
            err = _seg_untranspose_flat(g, nc, nl)
            err = true_divide(err, nl) if nl > 1 else err
        return out.to(buf.dtype), err
    out = torch.empty(L, dtype=buf.dtype, device=buf.device)
    pair.cross.reduce_scatter(out, part)
    return out, None


def start_scatter(buf: torch.Tensor, quantized=False,
                  with_error: bool = False,
                  block_size: int | None = None, axis_name=None) -> _Pending:
    """Start the reduce-scatter of one 1-D bucket buffer of ``n * Lk``
    elements over ``axis_name``; ``wait()`` gives ``(shard, err)``: the
    ``(Lk,)`` sum of the segment at this rank's axis index and, with
    ``with_error`` in a lossy mode, this rank's ``(n * Lk,)`` float32
    residual.  ``quantized`` is ``False`` or a mode (``fp16 | bf16`` wrap
    a dense scatter in a cast, ``int8 | int4 | topk`` run the lossy
    segment scatter, which waits for its own collectives)."""
    hops = _pmesh.resolve_hops(axis_name)
    mode = _quant.norm_mode(quantized)
    n = _pmesh.flat_hop(hops).size
    if n == 1:
        return _done((buf, _zeros_err(buf, with_error)))
    if mode in _CAST_WIRES:
        shrinks = buf.is_floating_point() and buf.element_size() > 2
        inner = start_scatter(buf.to(_CAST_WIRES[mode]) if shrinks else buf,
                              axis_name=hops)
        err = _zeros_err(buf, with_error)
        return _Pending(inner.work,
                        lambda: (inner.finish()[0].to(buf.dtype), err),
                        inner.keep)
    if mode not in _quant.LOSSY_MODES and mode != "none":
        raise ValueError(f"unknown wire mode {mode!r}")
    if _pmesh.two_level(hops):
        return _done(_hier_scatter(buf, hops, mode, with_error, block_size))
    hop = _pmesh.flat_hop(hops)
    L = buf.shape[0] // n
    if mode in _quant.LOSSY_MODES:
        seg = buf.to(torch.float32).reshape(n, L)
        out, err2d = _quant.lossy_psum_scatter_segments(
            seg, mode, block_size, with_error, axis_name=hop)
        err = err2d.reshape(-1) if err2d is not None else None
        return _done((out.to(buf.dtype), err))
    src = buf.contiguous()
    out = torch.empty(L, dtype=buf.dtype, device=buf.device)
    work = hop.reduce_scatter(out, src, async_op=True)
    return _Pending(work, lambda: (out, None), src)


def start_gather(shard: torch.Tensor, axis_name=None) -> _Pending:
    """Start the all-gather of one bucket shard over ``axis_name``;
    ``wait()`` gives the ``(n * Lk,)`` buffer in segment order (under a
    hierarchical pair: the cross gather, then the local one, re-ordered
    back to cross-major segments)."""
    hops = _pmesh.resolve_hops(axis_name)
    n = _pmesh.flat_hop(hops).size
    if n == 1:
        return _done(shard)
    src = shard.contiguous()
    pair = _pmesh.two_level(hops)
    if pair:
        g = torch.empty(pair.cross.size * src.shape[0], dtype=src.dtype,
                        device=src.device)
        pair.cross.all_gather(g, src)
        out = torch.empty(n * src.shape[0], dtype=src.dtype,
                          device=src.device)
        pair.local.all_gather(out, g)
        return _done(_seg_untranspose_flat(out, pair.cross.size,
                                           pair.local.size))
    out = torch.empty(n * src.shape[0], dtype=src.dtype, device=src.device)
    work = _pmesh.flat_hop(hops).all_gather(out, src, async_op=True)
    return _Pending(work, lambda: out, src)


def scatter_bucket(buf, quantized=False, with_error: bool = False,
                   block_size: int | None = None, axis_name=None):
    """:func:`start_scatter`, waited for: ``(shard, err)``."""
    return start_scatter(buf, quantized, with_error, block_size,
                         axis_name).wait()


def gather_bucket(shard, axis_name=None):
    """:func:`start_gather`, waited for."""
    return start_gather(shard, axis_name).wait()


# ---------------------------------------------------------------------------
# The bucketed schedules
# ---------------------------------------------------------------------------


def _bucket_math(shard, op: int, n: int):
    """The bucket-local math after its reduce-scatter."""
    return true_divide(shard, n) if op == _AVERAGE else shard


def resolve_bucket_modes(k: int, quantized, dtype) -> list:
    """The wire mode of each of K buckets: for a floating payload
    ``HOROVOD_BUCKET_COMPRESSION`` with the call's own mode as the
    default; else the call's mode."""
    default = _quant.norm_mode(quantized)
    if not dtype.is_floating_point:
        return [default] * k
    return _compression.bucket_modes(k, default=default)


def _zero_errs(errs, bounds, n: int, device) -> list:
    """Buckets whose mode keeps no residual contribute zeros, so the
    full-buffer residual keeps one layout whatever the modes."""
    return [e if e is not None else
            torch.zeros(n * (hi - lo), dtype=torch.float32, device=device)
            for e, (lo, hi) in zip(errs, bounds)]


def concat_columns(flats, n: int) -> torch.Tensor:
    """Reassemble bucket results (each a flat ``(n * Lb,)`` buffer in
    segment order) into the full buffer's element order: buckets are
    column slices of the ``(n, L)`` view."""
    if len(flats) == 1:
        return flats[0]
    return torch.cat([f.reshape(n, -1) for f in flats], dim=1).reshape(-1)


def _piece(seg: torch.Tensor, s: int, e: int) -> torch.Tensor:
    """Bucket ``[s, e)`` of the ``(n, L)`` segment view as a contiguous
    ``(n * (e - s),)`` buffer (a copy unless it is the whole view)."""
    return seg[:, s:e].reshape(-1)


def overlapped_flat_reduce(buf, op: int = _SUM, quantized=False,
                           with_error: bool = False,
                           block_size: int | None = None,
                           chunks: int | None = None, axis_name=None):
    """Bucketed allreduce of a fused 1-D buffer: K column buckets, each
    reduce-scattered, divided (Average) or dequantized bucket-locally,
    and all-gathered, bucket b's reduce-scatter issued before bucket
    b-1's math and all-gather.  Returns ``(reduced, err)``; ``err``
    (``with_error``) is the full-buffer float32 residual, zeros for
    buckets whose mode keeps none.  An axis of one rank returns
    ``buf``."""
    hops = _pmesh.resolve_hops(axis_name)
    n = _pmesh.flat_hop(hops).size
    if n == 1:
        return buf, _zeros_err(buf, with_error)
    total = buf.shape[0]
    pad = (-total) % n
    flat = torch.cat([buf, buf.new_zeros(pad)]) if pad else buf
    L = flat.shape[0] // n
    seg = flat.reshape(n, L)
    bounds = bucket_bounds(L, chunks)
    bmodes = resolve_bucket_modes(len(bounds), quantized, buf.dtype)
    casts = buf.is_floating_point() and buf.element_size() > 2
    errs: list = [None] * len(bounds)
    gathers: list = []

    def finish(b, pending):
        shard, errs[b] = pending.wait()
        with profiler_scope(f"hvd_overlap_math{b}"):
            shard = _bucket_math(shard, op, n)
        with profiler_scope(f"hvd_overlap_ag{b}"):
            gathers.append(start_gather(shard, hops))

    pending = None
    for b, (s, e) in enumerate(bounds):
        piece, mode_b = _piece(seg, s, e), bmodes[b]
        if mode_b in _CAST_WIRES and casts:
            # the bucket rides the wire at its width through scatter,
            # math and gather, and widens only at reassembly
            piece, mode_b = piece.to(_CAST_WIRES[mode_b]), "none"
        with profiler_scope(f"hvd_overlap_rs{b}"):
            started = start_scatter(piece, mode_b, with_error, block_size,
                                    hops)
        if pending is not None:
            finish(*pending)
        pending = (b, started)
    finish(*pending)
    full = concat_columns([g.wait().to(buf.dtype) for g in gathers], n)
    err = None
    if with_error:
        err = concat_columns(_zero_errs(errs, bounds, n, buf.device), n)
    if pad:
        full = full[:total]
        err = err[:total] if err is not None else None
    return full, err


def overlapped_allreduce(tensor, op: int = _AVERAGE, quantized=False,
                         with_error: bool = False,
                         block_size: int | None = None, axis_name=None):
    """Tensor-shaped :func:`overlapped_flat_reduce`."""
    out, err = overlapped_flat_reduce(
        tensor.reshape(-1), op=op, quantized=quantized,
        with_error=with_error, block_size=block_size, axis_name=axis_name)
    out = out.reshape(tensor.shape).to(tensor.dtype)
    return out, (err.reshape(tensor.shape) if err is not None else None)


def overlapped_scatter_flat_buffer(buf, quantized=False,
                                   with_error: bool = False,
                                   block_size: int | None = None,
                                   axis_name=None):
    """``collectives._scatter_flat_buffer`` in K column buckets, bucket
    b+1's reduce-scatter issued before bucket b is waited for: the
    concatenation of the bucket shards is the same contiguous shard.
    Returns ``(shard, err)`` with the full-buffer residual layout."""
    hops = _pmesh.resolve_hops(axis_name)
    n = _pmesh.flat_hop(hops).size
    if n == 1:
        return buf, _zeros_err(buf, with_error)
    seg = buf.reshape(n, buf.shape[0] // n)
    bounds = bucket_bounds(seg.shape[1])
    bmodes = resolve_bucket_modes(len(bounds), quantized, buf.dtype)
    shards: list = [None] * len(bounds)
    errs: list = [None] * len(bounds)
    pending = None
    for b, (s, e) in enumerate(bounds):
        piece = _piece(seg, s, e)
        with profiler_scope(f"hvd_overlap_rs{b}"):
            started = start_scatter(piece, bmodes[b], with_error,
                                    block_size, hops)
        if pending is not None:
            pb, pw = pending
            shards[pb], errs[pb] = pw.wait()
        pending = (b, started)
    pb, pw = pending
    shards[pb], errs[pb] = pw.wait()
    shard = torch.cat([s.to(buf.dtype) for s in shards])
    err = None
    if with_error:
        err = concat_columns(_zero_errs(errs, bounds, n, buf.device), n)
    return shard, err


def prefetched_gather_flat_shard(shard: torch.Tensor,
                                 chunks: int | None = None, axis_name=None,
                                 scope: str = "hvd_zero3_ag"):
    """All-gather a rank's 1-D shard bucket by bucket, every bucket's
    gather started (under the framework scope ``<scope><k>``) before the
    first is waited for.  Returns ``(bucket_outs, bounds)``: bucket k's
    ``(n * Lb_k,)`` segment-order result stays its own tensor
    (``collectives.leaf_from_buckets`` slices leaves out of it), so no
    full-size buffer is assembled.  A world of one returns views of the
    shard."""
    hops = _pmesh.resolve_hops(axis_name)
    bounds = bucket_bounds(shard.shape[0], chunks)
    if _pmesh.flat_hop(hops).size == 1:
        return [shard[s:e] for s, e in bounds], bounds
    started = []
    for k, (s, e) in enumerate(bounds):
        with profiler_scope(f"{scope}{k}"):
            started.append(start_gather(shard[s:e], hops))
    return [p.wait() for p in started], bounds


def overlapped_gather_flat_shard(shard, axis_name=None):
    """``collectives._gather_flat_shard`` in K buckets: the full buffer
    in segment order."""
    hops = _pmesh.resolve_hops(axis_name)
    n = _pmesh.flat_hop(hops).size
    if n == 1:
        return shard
    return concat_columns(
        prefetched_gather_flat_shard(shard, axis_name=hops,
                                     scope="hvd_overlap_ag")[0], n)
