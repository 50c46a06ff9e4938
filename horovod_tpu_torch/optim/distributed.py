"""``DistributedOptimizer`` at ZeRO stages 0-3, and the broadcast helpers
(counterpart of ``horovod_tpu/optim/distributed.py``).

**Stage 0** reduces every gradient with one grouped allreduce per dtype
group (under ``overlap``, the bucketed schedule of
:mod:`horovod_tpu_torch.ops.overlap`), writes the reduced gradient back
to ``p.grad`` and then updates: through the fused tail
(``fused_update.fused_update_tree``: one kernel launch per dtype group)
when ``HOROVOD_FUSED_UPDATE=1`` and the wrapped optimizer is fusable,
else through the wrapped optimizer's own ``step()``.  Reduction is
synchronous, inside ``step()`` (or an explicit ``synchronize()``).
With a lossy compressor (int8, int4, top-k), ``backward_passes_per_step
== 1`` and an op other than Adasum, the wrapper keeps error feedback:
one float32 residual per parameter (``residuals``), zero at the start,
re-injected into the next step's gradient before the reduction.

**Stages 1-2** (``_make_sharded_fns``): the gradients of each dtype
group are fused into one flat buffer, padded to a multiple of the world
size n, and reduce-scattered (:class:`ShardLayout`: rank r owns
``[r*L, (r+1)*L)``); the update runs on the rank's shard only, its state
(``shard_state``) a 1/n flat shard per group; the update shards are
all-gathered and added to the parameters.  Stage 2 never builds the
full fused gradient buffer: ``HOROVOD_ZERO_PREFETCH_CHUNKS`` bucket
pieces are assembled span-wise from the gradient leaves and
reduce-scattered one by one, and the update comes back bucket by bucket,
each leaf reassembled from the bucket results.  The scatter returns the
sum; the tail divides by ``navg = n`` (Average).  Under a lossy
compressor the residual (``residual``) is one float32 buffer per float
group over the padded fused buffer.  The wrapped optimizer's own
full-size state is dropped: ``shard_state`` holds the state.

**Stage 3** shards the parameters too: :func:`zero3_shard_params` turns
a model into :class:`Zero3Params` (per-group flat shards), the forward
sees full parameters through :func:`zero3_full_params` (bucket-wise
all-gathers; its backward reduce-scatters the cotangents into summed
shard gradients), and the optimizer, built over ``zp.shards``, updates
the shards with no gather.

Every stage reduces over ``axis_name`` (default ``None``: the data
mesh's dp axis when ``HOROVOD_MESH`` names one, else the world; a
``(cross, local)`` pair under hierarchical mode): the shard count is
that axis's total and a rank's shard its cross-major index
(``collectives.shard_index``).  ``op=Adasum`` runs at stage 0 only.

By default the port runs the reference's in-trace regime (``shard_map``):
its collectives are direct NCCL/gloo calls.  At stages 2-3 the schedule
is bucketed already; ``overlap`` there chose the reference's
``ppermute`` ring over one ``psum_scatter`` per bucket, and one NCCL call
is the port's counterpart of both.

``eager=True`` runs the reference's eager regime instead (its ``update``
called outside ``jit``): every reduction is a negotiated op of the eager
plane (:mod:`horovod_tpu_torch.ops.eager`), so it gets the plane's
``join()``, response cache and coordinated abort.  Stage 0 submits one
fused allreduce per dtype group; stage 1 one reduce-scatter and one
all-gather per group; stages 2-3 one per bucket; the eager wire applies
``HOROVOD_COMPRESSION`` inside the negotiated response, without error
feedback, and applies the op itself (the tail divides by nothing at
stages 1-2).  The shards are cut over the world.

Under ``HOROVOD_HEALTH`` (``runtime/health.py``) ``step()`` taps this
rank's gradients before any reduction in the in-trace regime (one
verdict all-gather over the axis) and publishes the update-to-weight
ratio where the fused tail materializes the update; in the eager regime
the executor taps each response instead.  ``HOROVOD_HEALTH_SKIP_NONFINITE``
skips a step whose verdict holds a nonfinite without touching any state.
Under ``HOROVOD_ADAPTIVE_COMPRESSION`` the error-feedback paths publish
``hvd_compression_residual_ratio`` per bucket.  The host forms
(:func:`sharded_state_to_host`, :func:`zero3_params_to_host` and their
``_from_host``) carry the sharded stages' state across world sizes.
"""

from __future__ import annotations

import io
import pickle
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.common.util import profiler_scope, true_divide
from horovod_tpu_torch.ops import collectives as _coll
from horovod_tpu_torch.ops import eager as _eager
from horovod_tpu_torch.ops import overlap as _ovl
from horovod_tpu_torch.ops import quantization as _quant
from horovod_tpu_torch.ops.collectives import Adasum, Average, Sum
from horovod_tpu_torch.ops.compression import (Compression,
                                               active_compression,
                                               is_quantized, wire_mode)
from horovod_tpu_torch.optim import fused_update as _fused
from horovod_tpu_torch.parallel import mesh as _pmesh
from horovod_tpu_torch.runtime import faults as _faults
from horovod_tpu_torch.runtime import health as _health
from horovod_tpu_torch.runtime import metrics as _metrics

_M_FUSED_BYTES = _metrics.gauge(
    "hvd_fusion_buffer_bytes",
    "Flat fused-gradient buffer size per dtype group on the eager "
    "path.")
# ZeRO residency per chip (docs/zero.md), stamped from the layout after
# the first step, when the wrapped optimizer's state exists
_M_ZERO_STAGE = _metrics.gauge(
    "hvd_zero_stage",
    "Resolved ZeRO stage of the last-constructed DistributedOptimizer "
    "(0 = replicated update).")
_M_ZERO_PARAM_BYTES = _metrics.gauge(
    "hvd_zero_param_bytes_per_chip",
    "Resident parameter bytes per chip (1/world flat shards under "
    "zero_stage=3, full replicas below).")
_M_ZERO_GRAD_BYTES = _metrics.gauge(
    "hvd_zero_grad_bytes_per_chip",
    "Resident reduced-gradient bytes per chip (the rank-local shard "
    "under zero_stage>=2; the full fused buffer below).")
_M_ZERO_OPT_BYTES = _metrics.gauge(
    "hvd_zero_opt_state_bytes_per_chip",
    "Wrapped optimizer-state bytes per chip (shard-local from "
    "zero_stage>=1 on).")


_M_RESID_RATIO = _metrics.gauge(
    "hvd_compression_residual_ratio",
    "Per-bucket error-feedback residual-to-reduced-gradient norm "
    "ratio, published while HOROVOD_ADAPTIVE_COMPRESSION is on; the "
    "adaptive tuner's bounded-loss guardrail pins a bucket back to "
    "int8 when this exceeds "
    "HOROVOD_COMPRESSION_MAX_RESIDUAL_RATIO (docs/compression.md).")


def _publish_residual_ratios(ratios) -> None:
    """Host side of the guardrail signal: one gauge series per bucket
    index."""
    arr = np.asarray(ratios).reshape(-1)
    for b in range(arr.shape[0]):
        v = float(arr[b])
        if np.isfinite(v):
            _M_RESID_RATIO.set(v, bucket=str(b))


def _report_bucket_residual_ratios(err, ref, n, axis_name,
                                   chunks: int = 1) -> None:
    """The guardrail signal of adaptive compression: per bucket
    ``||EF residual|| / ||reduced gradient||``, published deferred
    (``health.flush``).  ``err`` is the full ``(n*L,)`` float32 residual
    in segment layout; ``ref`` either this rank's ``(L,)`` reduced shard
    (the ZeRO paths: bucket norms are summed over the axis) or the full
    ``(n*L,)`` reduced buffer (the replicated path: already global).
    Bucket bounds are :func:`overlap.bucket_bounds`', so the indices
    match :func:`overlap.resolve_bucket_modes`.  One small all-reduce
    over the axis; nothing unless ``HOROVOD_ADAPTIVE_COMPRESSION``."""
    if not _config.get("adaptive_compression"):
        return
    from horovod_tpu_torch.runtime import health as _health

    n = max(int(n), 1)
    L = err.numel() // n
    if L == 0:
        return
    hop = _pmesh.flat_hop(axis_name)
    bounds = _ovl.bucket_bounds(L, max(1, int(chunks)))
    e2d = err.reshape(n, L)
    full_ref = ref.numel() == err.numel()
    ref = ref.to(torch.float32)
    r2d = ref.reshape(n, L) if full_ref else None
    rvec = torch.stack([torch.linalg.vector_norm(e2d[:, s:e]).square()
                        for s, e in bounds])
    gvec = torch.stack([torch.linalg.vector_norm(
        r2d[:, s:e] if full_ref else ref[s:e]).square()
        for s, e in bounds])
    hop.all_reduce(rvec)  # residuals are per-rank local
    if not full_ref:
        hop.all_reduce(gvec)  # shard slices are 1/n each
    ratios = rvec.sqrt() / gvec.sqrt().clamp_min(1e-12)
    _health._deferred.add(_publish_residual_ratios, ratios)


def _ranges_sumsq(flats, ranges, k: int):
    """Per bucket the sum of squares of a virtual concatenation of the
    1-D ``flats`` over its ``ranges`` (``ranges[b]`` a list of ``[lo,
    hi)`` windows), from views of the members (one ``_foreach_norm``),
    never the concatenation."""
    offsets = _coll._offsets([f.numel() for f in flats])
    views, owner = [], []
    for b, wins in enumerate(ranges):
        for lo, hi in wins:
            for j, f in enumerate(flats):
                a, z = max(lo, offsets[j]), min(hi, offsets[j + 1])
                if a < z:
                    views.append(f[a - offsets[j]:z - offsets[j]])
                    owner.append(b)
    dev = flats[0].device
    out = torch.zeros(k, dtype=torch.float32, device=dev)
    if views:
        norms = torch.stack(torch._foreach_norm(views)).to(torch.float32)
        out.index_add_(0, torch.tensor(owner, device=dev), norms.square())
    return out


def _maybe_report_residual_ratio(new_res, reduced, axis_name,
                                 overlap=None) -> None:
    """The replicated path's guardrail signal: the fused float view the
    grouped lossy allreduce ran on (float leaves in leaf order, padded
    to the axis size) is read through views of the residual and reduced
    leaves (:func:`_ranges_sumsq`), per bucket of its ``(n, L)`` segment
    view; the residual sums are all-reduced over the axis."""
    if not _config.get("adaptive_compression"):
        return
    from horovod_tpu_torch.runtime import health as _health

    pairs = [(r.detach().reshape(-1), g.detach().reshape(-1))
             for r, g in zip(new_res, reduced) if g.is_floating_point()]
    if not pairs:
        return
    n = _pmesh.axis_total(axis_name)
    total = sum(r.numel() for r, _ in pairs)
    L = (total + (-total) % n) // n
    chunks = _ovl.configured_chunks() if _ovl.enabled(overlap) else 1
    bounds = _ovl.bucket_bounds(L, chunks)
    ranges = [[(i * L + s, i * L + e) for i in range(n)] for s, e in bounds]
    rvec = _ranges_sumsq([r for r, _ in pairs], ranges, len(bounds))
    gvec = _ranges_sumsq([g for _, g in pairs], ranges, len(bounds))
    _pmesh.flat_hop(axis_name).all_reduce(rvec)
    ratios = rvec.sqrt() / gvec.sqrt().clamp_min(1e-12)
    _health._deferred.add(_publish_residual_ratios, ratios)


def _resolve_compression(compression):
    return active_compression() if compression is None else compression


def allreduce_gradients(grads, op: int = Average, compression=None,
                        overlap: bool | None = None, axis_name=None):
    """Allreduce a list of gradients over ``axis_name``: leaves grouped
    by dtype, each group one flat buffer and one collective chain (a
    lossy compressor fuses every floating leaf into one float32
    buffer)."""
    return _coll.grouped_allreduce(list(grads), op=op,
                                   compression=_resolve_compression(
                                       compression), overlap=overlap,
                                   axis_name=axis_name)


def allreduce_gradients_with_feedback(grads, residuals, op: int = Average,
                                      compression=None,
                                      overlap: bool | None = None,
                                      axis_name=None):
    """Lossy gradient allreduce with error feedback: returns
    ``(reduced, new_residuals)``, lists like ``grads``.  Last step's
    ``residuals`` are added to the gradients before the reduction; the
    new ones carry this step's local compression error.
    ``compression=None`` reads the ``HOROVOD_COMPRESSION`` knob and takes
    int8 when it names a mode that is not lossy."""
    compression = _resolve_compression(compression)
    if not is_quantized(compression):
        compression = Compression.int8
    grads = list(grads)
    if not grads:
        return [], list(residuals)
    injected = _quant.apply_error_feedback(grads, residuals)
    return _coll.grouped_quantized_allreduce(
        injected, op=op, with_error=True, mode=wire_mode(compression),
        overlap=overlap, axis_name=axis_name)


# ---------------------------------------------------------------------------
# ZeRO: stage resolution and the fused-buffer layout
# ---------------------------------------------------------------------------


def _resolve_zero_stage(zero_stage, sharded) -> int:
    """An explicit ``zero_stage`` wins (and must agree with an explicit
    ``sharded``); the older ``sharded`` boolean pins stage 1 or 0;
    otherwise ``HOROVOD_ZERO_STAGE``, with ``HOROVOD_SHARDED_OPTIMIZER``
    as stage 1's older spelling."""
    if zero_stage is not None:
        stage = int(zero_stage)
        if stage not in (0, 1, 2, 3):
            raise HorovodTpuError(
                f"zero_stage must be 0..3, got {zero_stage!r} (0 "
                "replicated, 1 sharded optimizer state, 2 + sharded "
                "gradients, 3 + sharded parameters)")
        if sharded is not None and bool(sharded) != (stage >= 1):
            raise HorovodTpuError(
                f"conflicting DistributedOptimizer arguments: "
                f"sharded={sharded!r} but zero_stage={stage} "
                f"({'implies' if stage >= 1 else 'disables'} sharding); "
                "drop the legacy sharded= argument.")
        return stage
    if sharded is not None:
        return 1 if sharded else 0
    stage = int(_config.get("zero_stage"))
    if stage not in (0, 1, 2, 3):
        raise HorovodTpuError(
            f"HOROVOD_ZERO_STAGE must be 0..3, got {stage!r}")
    if stage == 0 and bool(_config.get("sharded_optimizer")):
        stage = 1
    return stage


def _zero_chunks(chunks=None) -> int:
    """Bucket count of the stage-2/3 pipelines."""
    if chunks is not None:
        return max(1, int(chunks))
    return max(1, int(_config.get("zero_prefetch_chunks")))


class ShardLayout(NamedTuple):
    """The fused-buffer layout of the sharded stages: per dtype group (in
    the leaves' first-appearance order) the member leaf indices and flat
    sizes, the length padded to a multiple of the world size, and the
    per-rank shard length."""
    keys: tuple      # torch dtypes
    idxs: tuple      # tuple[int, ...] per group
    sizes: tuple     # tuple[int, ...] per group
    padded: tuple    # int per group
    shard: tuple     # int per group (padded // world)


class ShardedState(NamedTuple):
    """A stage-1/2 ``DistributedOptimizer``'s shard-local state as one
    value (``DistributedOptimizer.sharded_state()``): per dtype group the
    state dict of this rank's shard (``inner``), the error-feedback
    residuals (or None) and the layout they were cut for.  ``resync``
    and ``broadcast_skipping_shards`` leave it alone."""
    inner: list
    residual: list | None
    layout: ShardLayout


def _shard_layout(leaves, n: int) -> ShardLayout:
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append(i)
    keys, idxs, sizes, padded, shard = [], [], [], [], []
    for key, ii in groups.items():
        sz = tuple(leaves[i].numel() for i in ii)
        total = sum(sz)
        p = total + (-total) % n
        keys.append(key)
        idxs.append(tuple(ii))
        sizes.append(sz)
        padded.append(p)
        shard.append(p // n)
    return ShardLayout(tuple(keys), tuple(idxs), tuple(sizes),
                       tuple(padded), tuple(shard))


def _shard_views(leaves, layout: ShardLayout, g: int, r: int) -> list:
    """The members of segment ``r`` of group ``g``'s fused buffer as
    views of the leaves (a leaf whole where the segment holds all of it;
    the padding left out): no copy of the segment is made."""
    L = layout.shard[g]
    lo, hi, off, out = r * L, (r + 1) * L, 0, []
    for i, sz in zip(layout.idxs[g], layout.sizes[g]):
        a, b = max(lo, off), min(hi, off + sz)
        if a < b:
            leaf = leaves[i].detach()
            out.append(leaf if b - a == sz
                       else leaf.reshape(-1)[a - off:b - off])
        off += sz
    return out


def _fuse_group(leaves, layout: ShardLayout, g: int) -> torch.Tensor:
    """Group ``g``'s whole flat buffer, zero-padded to its length."""
    return _coll.fuse_span(leaves, layout.idxs[g], layout.sizes[g], 0,
                           layout.padded[g], layout.keys[g])


def _rank_shard(leaves, layout: ShardLayout, g: int, r: int) -> torch.Tensor:
    """Segment ``r`` of group ``g``'s fused buffer, built span-wise."""
    L = layout.shard[g]
    return _coll.fuse_span(leaves, layout.idxs[g], layout.sizes[g], r * L,
                           (r + 1) * L, layout.keys[g])


def _bucketed_scatter_group(leaves, layout: ShardLayout, g: int, n: int,
                            quantized, with_error: bool, residual,
                            chunks=None, axis_name=None,
                            scope: str = "hvd_zero2_rs"):
    """The stage-2 gradient scatter of group ``g``: K bucket pieces
    (column slices of the ``(n, L)`` segment view) assembled span-wise
    from the leaves (``collectives.fuse_bucket_piece``, the residual's
    slice added in), each reduce-scattered, bucket k+1's started before
    bucket k is waited for, so at most two pieces are alive; the full
    fused buffer is never built.  Each bucket may carry its own mode
    (``HOROVOD_BUCKET_COMPRESSION``).  ``n`` is the total of
    ``axis_name``.  Bucket k's scatter runs under the framework scope
    ``<scope><k>``.  Returns ``(shard, err)`` in the layout of
    ``collectives._scatter_flat_buffer``."""
    L = layout.padded[g] // n
    bounds = _ovl.bucket_bounds(L, _zero_chunks(chunks))
    lossy = _quant.norm_mode(quantized) in _quant.LOSSY_MODES
    dtype = torch.float32 if lossy else layout.keys[g]
    bmodes = _ovl.resolve_bucket_modes(len(bounds), quantized, dtype)
    inject = None
    if residual is not None:
        inject = lambda lo, hi: residual[lo:hi]  # noqa: E731
    shards: list = [None] * len(bounds)
    errs: list = [None] * len(bounds)

    def finish(k, pending):
        shard, errs[k] = pending.wait()
        shards[k] = shard.to(dtype)

    pending = None
    for k, (s, e) in enumerate(bounds):
        piece = _coll.fuse_bucket_piece(
            leaves, layout.idxs[g], layout.sizes[g], layout.padded[g], n,
            s, e, dtype, inject=inject)
        with profiler_scope(f"{scope}{k}"):
            started = _ovl.start_scatter(piece, bmodes[k], with_error,
                                         axis_name=axis_name)
        if pending is not None:
            finish(*pending)
        pending = (k, started)
    finish(*pending)
    err = None
    if with_error:
        err = _ovl.concat_columns(
            _ovl._zero_errs(errs, bounds, n, shards[0].device), n)
    return torch.cat(shards), err


# ---------------------------------------------------------------------------
# The eager regime: the same collectives as negotiated ops
# ---------------------------------------------------------------------------


def _check_eager_mesh() -> None:
    """The eager wire is the flat world: with tp/pp/sp extents on the
    data mesh it would average model-sharded values across islands
    (``horovod_tpu/optim/distributed.py:175-186``)."""
    if _pmesh.model_parallel_size() > 1:
        raise HorovodTpuError(
            "eager collectives are flat-world and cannot honor a data "
            "mesh with model-parallel axes "
            f"({_pmesh.canonical_spec(_pmesh.active_spec())!r}); run the "
            "gradient reduction in-trace (eager=False) or drop the "
            "tp/pp/sp extents from HOROVOD_MESH")


def eager_fused_allreduce(leaves, op: int, compression=Compression.none,
                          scope: str | None = None) -> list:
    """One negotiated allreduce per dtype group of ``leaves``, each group
    raveled into one flat buffer named ``grad_buffer.<dtype>.<count>``
    (``localsgd.<scope>.<dtype>.<count>`` for a scoped reduction), all
    submitted before the first is waited for; the results split back
    (``_eager_fused_pytree_allreduce``).  A lossy ``compression`` is the
    wire's business (``HOROVOD_COMPRESSION``): it passes as none here."""
    if is_quantized(compression):
        compression = Compression.none
    prefix = "grad_buffer" if scope is None else f"localsgd.{scope}"
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append(i)
    handles = []
    for dtype, idxs in groups.items():
        flat = torch.cat([leaves[i].reshape(-1) for i in idxs])
        label = _health.dtype_label(dtype)
        _M_FUSED_BYTES.set(flat.numel() * flat.element_size(), dtype=label)
        handles.append((idxs, _eager.allreduce_async(
            flat, op=op, name=f"{prefix}.{label}.{len(idxs)}",
            compression=compression)))
    out: list = [None] * len(leaves)
    for idxs, h in handles:
        red = _eager.synchronize(h)
        off = 0
        for i in idxs:
            n = leaves[i].numel()
            out[i] = red[off:off + n].view(leaves[i].shape)
            off += n
    return out


def _eager_scatter(leaves, layout: ShardLayout, op: int, n: int,
                   chunks=None) -> list:
    """Every group's shard of the reduced gradient on the eager wire:
    one reduce-scatter per group (``chunks`` 1, stage 1) or one per
    bucket piece (stages 2-3, the pieces assembled span-wise as
    in-trace), named by group, padded length and bucket so every rank
    submits the same names (``_bucketed_eager_scatter``)."""
    handles = []
    for g, key in enumerate(layout.keys):
        bounds = _ovl.bucket_bounds(layout.shard[g], _zero_chunks(chunks))
        name = f"shard_rs.{_health.dtype_label(key)}.{layout.padded[g]}"
        if chunks == 1:
            handles.append([_eager.reducescatter_async(
                _fuse_group(leaves, layout, g), op=op, name=name)])
            continue
        handles.append([_eager.reducescatter_async(
            _coll.fuse_bucket_piece(leaves, layout.idxs[g],
                                    layout.sizes[g], layout.padded[g], n,
                                    s, e, key),
            op=op, name=f"{name}.{k}of{len(bounds)}")
            for k, (s, e) in enumerate(bounds)])
    return [torch.cat([_eager.synchronize(h) for h in hs])
            if len(hs) > 1 else _eager.synchronize(hs[0])
            for hs in handles]


def _eager_gather(shards, layout: ShardLayout, prefix: str,
                  chunks=None) -> list:
    """Every group's shard all-gathered on the eager wire, bucket by
    bucket: per group ``(bucket outputs, bounds)`` for
    ``collectives.leaf_from_buckets`` (``chunks`` 1: one all-gather of
    the whole shard, ``_bucketed_eager_gather``)."""
    handles = []
    for g, key in enumerate(layout.keys):
        shard = shards[g].detach()
        bounds = _ovl.bucket_bounds(int(shard.shape[0]),
                                    _zero_chunks(chunks))
        name = f"{prefix}.{_health.dtype_label(key)}.{layout.padded[g]}"
        if chunks != 1:
            handles.append(([_eager.allgather_async(
                shard[s:e], name=f"{name}.{k}of{len(bounds)}")
                for k, (s, e) in enumerate(bounds)], bounds))
        else:
            handles.append(([_eager.allgather_async(shard, name=name)],
                            bounds))
    return [([_eager.synchronize(h) for h in hs], bounds)
            for hs, bounds in handles]


# ---------------------------------------------------------------------------
# ZeRO-3: shard-resident parameters
# ---------------------------------------------------------------------------


class Zero3Params:
    """Stage-3 parameters: per dtype group, this rank's flat shard of the
    padded fused buffer (``shards``, leaf tensors with ``requires_grad``:
    the optimizer is built over them), the :class:`ShardLayout`, the
    parameters' names and shapes, and the axis they are sharded over."""

    def __init__(self, shards, layout: ShardLayout, names, shapes,
                 axis_name="hvd"):
        self.shards = list(shards)
        self.layout = layout
        self.names = tuple(names)
        self.shapes = tuple(tuple(s) for s in shapes)
        self.axis_name = axis_name


def _is_zero3_shard(t) -> bool:
    return bool(getattr(t, "_hvd_zero3", False))


def zero3_shard_params(params, axis_name=None) -> Zero3Params:
    """This rank's stage-3 form of ``params``, sharded over ``axis_name``
    (default: the data mesh's dp axis, else the world): a module (its
    ``named_parameters()``), a mapping of name to tensor, or ``(name,
    tensor)`` pairs.  A module's own parameters are released (their
    storage replaced by empty tensors): from here on only the 1/n
    shards are resident, and the forward sees full parameters through
    :func:`zero3_full_params` and ``torch.func.functional_call``."""
    axis_name = _pmesh.resolve_axis(axis_name)
    module = params if isinstance(params, torch.nn.Module) else None
    if module is not None:
        named = list(module.named_parameters())
    elif isinstance(params, dict):
        named = list(params.items())
    else:
        named = list(params)
    if not named:
        raise HorovodTpuError("zero3_shard_params: no parameters")
    names = [name for name, _ in named]
    leaves = [t.detach() for _, t in named]
    layout = _shard_layout(leaves, _pmesh.axis_total(axis_name))
    idx = _pmesh.shard_index(axis_name)
    shards = []
    for g in range(len(layout.keys)):
        shard = torch.nn.Parameter(
            _rank_shard(leaves, layout, g, idx).clone())
        shard._hvd_zero3 = True
        shard._hvd_zero3_layout = layout
        shards.append(shard)
    zp = Zero3Params(shards, layout, names,
                     [tuple(t.shape) for t in leaves], axis_name)
    if module is not None:
        for _, p in named:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
    return zp


def _leaves_from_buckets(bucket_sets, layout: ShardLayout, shapes,
                         n: int) -> list:
    """Every leaf from per-group ``(bucket_outs, bounds)`` results, leaf
    by leaf (``collectives.leaf_from_buckets``)."""
    out: list = [None] * len(shapes)
    for g, (outs, bounds) in enumerate(bucket_sets):
        off = 0
        for i, sz in zip(layout.idxs[g], layout.sizes[g]):
            out[i] = _coll.leaf_from_buckets(
                outs, bounds, n, layout.shard[g], off, sz).view(shapes[i])
            off += sz
    return out


class _Zero3Gather(torch.autograd.Function):
    """Forward: the shards all-gathered in K buckets per group, and each
    leaf sliced out of its buckets (at a world of one, views of the
    shard).  Backward: the leaves' cotangents reduce-scattered bucket by
    bucket into this rank's summed shard gradient (``_zero3_full_traced``'s
    ``bwd``); under a lossy wire without error feedback."""

    @staticmethod
    def forward(ctx, zp, qmode, chunks, axis, eager, *shards):
        ctx.zp, ctx.qmode, ctx.chunks, ctx.axis = zp, qmode, chunks, axis
        ctx.eager = eager
        if eager:
            sets = _eager_gather(shards, zp.layout, "zero3_ag", chunks)
            n = _eager.plane_place()[1]
        else:
            sets = [_ovl.prefetched_gather_flat_shard(s, chunks, axis)
                    for s in shards]
            n = _pmesh.axis_total(axis)
        return tuple(_leaves_from_buckets(sets, zp.layout, zp.shapes, n))

    @staticmethod
    def backward(ctx, *cts):
        zp, lay = ctx.zp, ctx.zp.layout
        n = _eager.plane_place()[1] if ctx.eager \
            else _pmesh.axis_total(ctx.axis)
        cts = list(cts)
        for g, key in enumerate(lay.keys):
            for i in lay.idxs[g]:
                if cts[i] is None:
                    cts[i] = torch.zeros(zp.shapes[i], dtype=key,
                                         device=zp.shards[g].device)
        if ctx.eager:
            # summed on the negotiated wire (its mode is the knob's)
            gshards = _eager_scatter(cts, lay, Sum, n, ctx.chunks)
            return (None,) * 5 + tuple(
                s.to(key) for s, key in zip(gshards, lay.keys))
        gshards = []
        for g, key in enumerate(lay.keys):
            q = ctx.qmode != "none" and key.is_floating_point
            shard, _ = _bucketed_scatter_group(
                cts, lay, g, n, ctx.qmode if q else False, False, None,
                chunks=ctx.chunks, axis_name=ctx.axis, scope="hvd_zero3_rs")
            gshards.append(shard.to(key))
        return (None, None, None, None, None, *gshards)


def zero3_full_params(zp: Zero3Params, compression=None,
                      chunks: int | None = None, axis_name=None,
                      eager: bool = False) -> dict:
    """The full parameters of ``zp`` for the forward, as a mapping of name
    to tensor (for ``torch.func.functional_call``): per group
    ``HOROVOD_ZERO_PREFETCH_CHUNKS`` bucket all-gathers, every one started
    before the first is waited for, each leaf sliced out of its buckets,
    no full fused parameter buffer.  Differentiating through it
    reduce-scatters the cotangents bucket by bucket into summed shard
    gradients (``zp.shards[g].grad``); under a lossy ``compression``
    that scatter rides the lossy wire, without error feedback.
    ``axis_name`` (default: the axis ``zp`` was sharded over) must span
    the ranks the shards were cut for.

    ``eager=True`` mirrors the stage-3 ``DistributedOptimizer(...,
    eager=True)``: the all-gathers and the backward's reduce-scatters
    are negotiated ops of the eager plane (``_zero3_full_eager`` and the
    scatter of the reference's eager update), one per bucket, over the
    plane's world and on the wire ``HOROVOD_COMPRESSION`` names, so it
    refuses a ``compression`` or ``axis_name``."""
    if eager and (compression is not None or axis_name is not None):
        raise HorovodTpuError(
            "zero3_full_params(eager=True) gathers over the eager plane's "
            "world on the wire HOROVOD_COMPRESSION names: pass no "
            "compression or axis_name")
    compression = _resolve_compression(compression)
    qmode = wire_mode(compression) if is_quantized(compression) else "none"
    axis = zp.axis_name if axis_name is None else axis_name
    eager = eager and _eager.plane_place()[1] > 1
    n = _eager.plane_place()[1] if eager else _pmesh.axis_total(axis)
    if n * zp.layout.shard[0] != zp.layout.padded[0]:
        raise HorovodTpuError(
            f"zero3_full_params over {axis!r}: the shards were cut for "
            f"{zp.layout.padded[0] // zp.layout.shard[0]} ranks "
            f"({zp.axis_name!r})")
    leaves = _Zero3Gather.apply(zp, qmode, _zero_chunks(chunks), axis,
                                eager, *zp.shards)
    return dict(zip(zp.names, leaves))


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------


def _hyperparameters(optimizer) -> dict:
    """The one set of hyperparameters of ``optimizer``'s groups: a shard
    spans groups, so groups that differ are refused."""
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in optimizer.param_groups]
    if any(h != hyper[0] for h in hyper[1:]):
        raise HorovodTpuError(
            "zero_stage >= 1 takes one set of hyperparameters: a shard "
            "spans parameter groups, and these differ "
            f"({hyper}); use one group")
    return hyper[0]


def optimizer_like(optimizer, params):
    """An optimizer of ``optimizer``'s class and hyperparameters over
    ``params`` (a ZeRO shard's flat tensors, or a group of leaves)."""
    spec = _fused.spec_of(optimizer)
    if isinstance(optimizer, _fused.SGD):
        return _fused.SGD(params, spec.lr,
                          None if spec.kind == "sgd" else spec.momentum)
    if isinstance(optimizer, _fused.Adam):
        return _fused.Adam(params, spec.lr, spec.b1, spec.b2, spec.eps,
                           spec.eps_root)
    inner = type(optimizer)(params, **optimizer.defaults)
    inner.param_groups[0].update(_hyperparameters(optimizer))
    return inner


def _state_bytes(states) -> int:
    return sum(v.numel() * v.element_size() for st in states
               for v in st.values() if isinstance(v, torch.Tensor))


class _DistributedOptimizer:
    """See :func:`DistributedOptimizer`.  Attributes not defined here
    (``param_groups``, ``state``, ``state_dict``, ...) are the wrapped
    optimizer's."""

    def __init__(self, optimizer, compression, backward_passes_per_step,
                 op, zero_stage, sharded, overlap, axis_name, eager=False):
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError("DistributedOptimizer expects a "
                            f"torch.optim.Optimizer (got {type(optimizer)!r})")
        self.eager = bool(eager)
        if self.eager:
            _check_eager_mesh()
        stage = _resolve_zero_stage(zero_stage, sharded)
        self.compression = _resolve_compression(compression)
        if is_quantized(self.compression):
            _coll._check_quantized_op(op)
        if op == Adasum and stage >= 1:
            raise HorovodTpuError(
                "zero_stage>=1 (sharded=True) does not compose with "
                "op=Adasum: the projection's dot/norm math needs the "
                "full reduction, not a scatter. Use op=Average/Sum "
                "with the sharded optimizer.")
        self.backward_passes_per_step = int(backward_passes_per_step)
        if self.backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        if stage >= 3 and self.backward_passes_per_step != 1:
            raise HorovodTpuError(
                "zero_stage=3 does not compose with "
                "backward_passes_per_step > 1: the accumulation holds "
                "full-gradient trees, exactly the residency stage 3 "
                "eliminates. Accumulate outside the optimizer and feed "
                "the mean instead.")
        self.optimizer = optimizer
        self.axis_name = _pmesh.resolve_axis(axis_name)
        self.op = op
        self.overlap = overlap
        self.zero_stage = stage
        self.fused_spec = _fused.resolve_spec(optimizer)
        self._stamped = False
        # the resolved schedule, as hvd.metrics() shows it (the knobs
        # record only the request)
        ovl = (bool(_config.get("overlap")) if overlap is None
               else bool(overlap))
        _metrics.gauge(
            "hvd_overlap_chunks",
            "Bucket count of the overlap ring schedule (0 = overlap "
            "off).").set(
                int(_config.get("overlap_chunks")) if ovl else 0)
        _metrics.gauge(
            "hvd_sharded_optimizer",
            "1 when the ZeRO-1 sharded weight update is active.").set(
                1 if stage >= 1 else 0)
        _M_ZERO_STAGE.set(stage)
        self._counter = 0
        self._accum: dict = {}
        self._health_on = False
        #: stage 0: parameter -> float32 error-feedback residual, or None
        #: when the wrapper reduces without feedback
        self.residuals = None
        #: stages 1-2 under a lossy compressor: one float32 residual per
        #: dtype group over its padded fused buffer (empty for a group
        #: that is not floating), else None
        self.residual = None
        self._params_all = [p for g in optimizer.param_groups
                            for p in g["params"]]
        if stage == 0:
            # the eager wire keeps no error feedback: its negotiated
            # response does not expose the local quantization error
            if is_quantized(self.compression) and not self.eager \
                    and self.backward_passes_per_step == 1:
                self.residuals = dict(zip(
                    self._params_all,
                    _quant.init_error_feedback(self._params_all)))
        elif stage <= 2:
            self._init_sharded()
        elif not self._params_all or not all(
                _is_zero3_shard(p) for p in self._params_all):
            raise HorovodTpuError(
                "zero_stage=3: DistributedOptimizer expects an optimizer "
                "built over the shard-resident parameters: call "
                "hvd.zero3_shard_params(model) once at setup and build the "
                "optimizer over the returned Zero3Params' shards, not over "
                "the full parameters.")

    def _n(self) -> int:
        """The shard count: the eager plane's world on the eager wire,
        else the total of ``axis_name``."""
        return _eager.plane_place()[1] if self.eager \
            else _pmesh.axis_total(self.axis_name)

    def _index(self) -> int:
        return _eager.plane_place()[0] if self.eager \
            else _pmesh.shard_index(self.axis_name)

    def _init_sharded(self) -> None:
        _hyperparameters(self.optimizer)
        leaves = self._params_all
        n = self._n()
        r = self._index()
        self.layout = lay = _shard_layout(leaves, n)
        dev = leaves[0].device
        if self.fused_spec is not None:
            self._inner = None
            self._shard_params = None
            self._group_state = _fused.init_group_state(
                self.fused_spec,
                [torch.empty(L, dtype=k, device=dev)
                 for L, k in zip(lay.shard, lay.keys)])
        else:
            self._shard_params = [
                _rank_shard(leaves, lay, g, r).detach().clone()
                for g in range(len(lay.keys))]
            self._inner = optimizer_like(self.optimizer,
                                         self._shard_params)
        # the shard state replaces the wrapped optimizer's full-size state
        self.optimizer.state.clear()
        if is_quantized(self.compression) and not self.eager:
            self.residual = [
                torch.zeros(p if k.is_floating_point else 0,
                            dtype=torch.float32, device=dev)
                for p, k in zip(lay.padded, lay.keys)]

    @property
    def shard_state(self) -> list:
        """Stages 1-2: the optimizer state of this rank's shard, one dict
        per dtype group (for the fused tail ``trace`` or ``mu``/``nu``/
        ``count``; else the inner optimizer's state of the shard)."""
        if self.zero_stage not in (1, 2):
            raise HorovodTpuError("shard_state exists at stages 1 and 2")
        if self._inner is None:
            return self._group_state
        return [self._inner.state[p] for p in self._shard_params]

    def sharded_state(self) -> ShardedState:
        """Stages 1-2: the shard-local state as a :class:`ShardedState`
        (the tensors themselves, not copies), for ``checkpoint.save(...,
        all_ranks=True)`` or :func:`sharded_state_to_host`."""
        return ShardedState(self.shard_state, self.residual, self.layout)

    @torch.no_grad()
    def load_sharded_state(self, state: ShardedState) -> None:
        """Stages 1-2: take ``state`` (restored, or re-cut for this world
        by :func:`sharded_state_from_host`) as this rank's shard state:
        tensors copied into place on their devices, other entries
        taken as they are.  A layout cut for another world is
        refused."""
        if state.layout.padded != self.layout.padded \
                or state.layout.shard != self.layout.shard:
            raise HorovodTpuError(
                f"load_sharded_state: the state was cut for padded "
                f"lengths {state.layout.padded} / shards "
                f"{state.layout.shard}, this optimizer's layout is "
                f"{self.layout.padded} / {self.layout.shard} (restore "
                "through sharded_state_from_host for another world size)")
        for cur, new in zip(self.shard_state, state.inner):
            for k, v in new.items():
                if isinstance(v, torch.Tensor) and isinstance(
                        cur.get(k), torch.Tensor):
                    cur[k].copy_(v)
                elif isinstance(v, torch.Tensor):
                    dev = self._params_all[0].device
                    cur[k] = v.to(dev)
                else:
                    cur[k] = v
        if self.residual is not None:
            for g, r in enumerate(self.residual):
                if state.residual is not None:
                    r.copy_(state.residual[g])
                else:
                    r.zero_()

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds (error-feedback
        residuals not counted)."""
        if self.zero_stage in (1, 2):
            return _state_bytes(self.shard_state)
        return _state_bytes(self.optimizer.state.values())

    def __getattr__(self, name):
        return getattr(self.__dict__["optimizer"], name)

    def _params(self):
        return [p for p in self._params_all if p.grad is not None]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def synchronize(self):
        """Reduce every gradient over the axis in place; returns the
        parameters that have one.  Stage 0 only: the sharded stages never
        hold full reduced gradients."""
        if self.zero_stage:
            raise HorovodTpuError(
                f"synchronize() reduces full gradients, which zero_stage="
                f"{self.zero_stage} never holds; step() scatters them")
        params = self._params()
        grads = [p.grad for p in params]
        if self.eager:
            reduced = eager_fused_allreduce(grads, self.op,
                                            self.compression)
        elif self.residuals is None:
            reduced = allreduce_gradients(grads, op=self.op,
                                          compression=self.compression,
                                          overlap=self.overlap,
                                          axis_name=self.axis_name)
        else:
            reduced, new = allreduce_gradients_with_feedback(
                grads, [self.residuals[p] for p in params], op=self.op,
                compression=self.compression, overlap=self.overlap,
                axis_name=self.axis_name)
            _maybe_report_residual_ratio(new, reduced, self.axis_name,
                                         self.overlap)
            self.residuals.update(zip(params, new))
        if params:
            torch._foreach_copy_(grads, reduced)
        return params

    @torch.no_grad()
    def _accumulate(self) -> bool:
        """backward_passes_per_step > 1: sum this pass's gradients; on
        the k-th pass put their mean in ``p.grad`` and return True
        (``_AccumulationState`` semantics: no update in between)."""
        k = self.backward_passes_per_step
        for p in self._params():
            acc = self._accum.get(p)
            self._accum[p] = p.grad.clone() if acc is None else acc.add_(
                p.grad)
        self._counter += 1
        if self._counter < k:
            return False
        for p, acc in self._accum.items():
            p.grad = true_divide(acc, k)
        self._accum = {}
        self._counter = 0
        return True

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._health_on = _health.enabled()
        if self._health_on and not self.eager and not self._health_tap():
            return loss
        if self.zero_stage == 3:
            self._zero3_step()
        elif self.backward_passes_per_step > 1 and not self._accumulate():
            return loss
        elif self.zero_stage:
            self._sharded_step()
        else:
            params = self.synchronize()
            if not self._skip_eager([p.grad for p in params]):
                self._update(params)
        if not self._stamped:
            self._stamp_zero_bytes()
        return loss

    # -- the training-health plane (``_health_wrap``) ----------------------

    @torch.no_grad()
    def _health_tap(self) -> bool:
        """The in-trace stat tap on this rank's gradients before any
        reduction (and before error feedback re-injects the residual):
        the ``nan:``/``inf:`` round-less rules poison ``grads.<dtype>``
        first, then one verdict all-gather over the reduction's axis.
        Under ``HOROVOD_HEALTH_SKIP_NONFINITE`` a verdict with a
        nonfinite from any rank skips the whole step, reductions
        included: every rank reads the same gathered verdict, so all
        skip together, and nothing (parameters, momenta, residuals,
        shard state, the accumulation counter) changes.  Returns whether
        the step goes on."""
        params = self._params()
        hop = _pmesh.flat_hop(self.axis_name)
        if _faults.data_rules():
            for p in params:
                if p.grad.is_floating_point():
                    p.grad = _faults.traced_poison(
                        p.grad, f"grads.{_health.dtype_label(p.grad.dtype)}",
                        hop.index)
        gathered = _health.tap_gradients([p.grad for p in params], hop)
        if gathered is None or not _health.skip_enabled() \
                or not _health.verdict_bad(gathered):
            return True
        _health.flush()
        _health.note_skip()
        return False

    def _skip_eager(self, tensors) -> bool:
        """The eager regime's skip verdict (``apply_skip_eager``): a
        nonfinite that rode the negotiated wire poisons the reduced
        ``tensors`` identically on every rank, so their finiteness is the
        verdict; one device-to-host read, under the skip knob only."""
        if not (self.eager and self._health_on and _health.skip_enabled()):
            return False
        cnt = _health.nonfinite_count(tensors)
        if cnt is None or not float(cnt) > 0:
            return False
        _health.note_skip()
        return True

    def _tap_ratio(self, updates, params) -> None:
        """The post-update update-to-weight ratio (advisory)."""
        if not self._health_on:
            return
        try:
            _health.tap_update_ratio(updates, params)
        except Exception:  # noqa: BLE001 -- a stat must never cost a step
            pass

    def _stamp_zero_bytes(self) -> None:
        """The residency gauges, once the state exists (advisory)."""
        self._stamped = True
        try:
            stage = self.zero_stage
            if stage in (1, 2):
                lay = self.layout
                pbytes = gbytes = 0
                for g, key in enumerate(lay.keys):
                    item = key.itemsize
                    pbytes += sum(lay.sizes[g]) * item
                    gbytes += (lay.shard[g] if stage >= 2
                               else lay.padded[g]) * item
            else:
                # stage 0 replicates, stage 3 holds only its shards
                pbytes = gbytes = _state_bytes(
                    [{"p": p} for p in self._params_all])
            _M_ZERO_PARAM_BYTES.set(pbytes)
            _M_ZERO_GRAD_BYTES.set(gbytes)
            _M_ZERO_OPT_BYTES.set(self.state_bytes())
        except Exception:  # noqa: BLE001 -- metrics never cost a step
            pass

    def _update(self, params) -> None:
        """Stage 0's update from the reduced ``p.grad`` of ``params``: the
        fused tail (one launch per dtype group) or the wrapped
        optimizer's ``step()``."""
        if self.fused_spec is None:
            self.optimizer.step()
            return
        with torch.no_grad():
            updates = _fused.fused_update_tree(
                self.fused_spec, [p.grad for p in params],
                [self.optimizer.state[p] for p in params])
            self._tap_ratio(updates, params)
            if params:
                torch._foreach_add_(params, updates)

    def _navg(self) -> int:
        return self._n() if self.op == Average else 1

    @torch.no_grad()
    def _sharded_step(self) -> None:
        """Stages 1-2: scatter, the tail on the shards, gather and apply."""
        lay, n = self.layout, self._n()
        leaves = self._params_all
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        if self.eager:
            # the wire applies the op: the tail divides by nothing
            gshards = _eager_scatter(grads, lay, self.op, n,
                                     self._eager_chunks())
        else:
            gshards = self._trace_scatter(grads, n)
        del grads
        navg = 1 if self.eager else self._navg()
        # the eager skip verdict comes from the gathered update, after the
        # tail has run on the shard: hold the state it overwrites
        held = self._hold_state() if self.eager and self._health_on \
            and _health.skip_enabled() else None
        if self._inner is None:
            upds = _fused.fused_update_groups(self.fused_spec, gshards,
                                              self._group_state, navg,
                                              lay.keys)
            if self._health_on:
                r = self._index()
                self._tap_ratio(upds, [v for g in range(len(lay.keys))
                                       for v in _shard_views(leaves, lay,
                                                             g, r)])
            self._apply_shards(upds, add=True, held=held)
            return
        # the wrapped optimizer's class on the shard: current values in,
        # the (divided, cast) shard gradient as its gradient
        r = self._index()
        hyper = _hyperparameters(self.optimizer)
        if not isinstance(self._inner, (_fused.SGD, _fused.Adam)):
            self._inner.param_groups[0].update(hyper)
        for g, (sp, s, key) in enumerate(zip(self._shard_params, gshards,
                                             lay.keys)):
            sp.copy_(_rank_shard(leaves, lay, g, r))
            sp.grad = (true_divide(s, navg) if navg > 1 else s).to(key)
        self._inner.step()
        for sp in self._shard_params:
            sp.grad = None
        self._apply_shards(self._shard_params, add=False, held=held)

    def _hold_state(self) -> list:
        """A copy of the shard state the tail overwrites (the eager skip
        contract's snapshot at stages 1-2)."""
        return [{k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in st.items()} for st in self.shard_state]

    def _restore_state(self, held) -> None:
        for st, old in zip(self.shard_state, held):
            st.clear()
            st.update(old)

    def _eager_chunks(self):
        """The eager wire's buckets: one per group at stage 1, the
        stage-2/3 pipeline's after (``_bucketed_eager_scatter``)."""
        return None if self.zero_stage >= 2 else 1

    def _trace_scatter(self, grads, n: int) -> list:
        """Every group's shard of the summed gradient, in-trace: the
        fused buffer at stage 1, bucket by bucket at stage 2; under a
        lossy compressor with the residual re-injected and updated."""
        lay = self.layout
        quantized = is_quantized(self.compression)
        qmode = wire_mode(self.compression) if quantized else "none"
        gshards = []
        for g, key in enumerate(lay.keys):
            q = quantized and key.is_floating_point
            res = self.residual[g] if q else None
            if self.zero_stage >= 2 and n > 1:
                shard, err = _bucketed_scatter_group(
                    grads, lay, g, n, qmode if q else False, q, res,
                    axis_name=self.axis_name)
            else:
                buf = _fuse_group(grads, lay, g)
                if q:
                    buf = buf.to(torch.float32) + res
                shard, err = _coll._scatter_flat_buffer(
                    buf, quantized=qmode if q else False, with_error=q,
                    overlap=self.overlap, axis_name=self.axis_name)
            if err is not None:
                self.residual[g] = err
                if self.zero_stage >= 2 and n > 1:
                    chunks = _zero_chunks()
                elif _ovl.enabled(self.overlap):
                    chunks = _ovl.configured_chunks()
                else:
                    chunks = 1
                _report_bucket_residual_ratios(err, shard, n,
                                               self.axis_name, chunks)
            gshards.append(shard)
        return gshards

    def _apply_shards(self, shards, add: bool, held=None) -> None:
        """Gather every group's update shards (``add``: added to the
        parameters) or new value shards (copied into them): at stage 1
        one all-gather per group, at stage 2 bucket by bucket with each
        leaf reassembled from the bucket results.  ``held`` (the eager
        skip contract): when the gathered result, the same on every
        rank, holds a nonfinite, nothing is applied and the shard state
        goes back to ``held``."""
        lay, n = self.layout, self._n()
        leaves = self._params_all
        sets = None
        if self.eager:
            sets = _eager_gather(shards, lay, "shard_ag",
                                 self._eager_chunks())
            if held is not None and self._skip_eager(
                    [t for outs, _ in sets for t in outs]):
                self._restore_state(held)
                return
        for g in range(len(lay.keys)):
            buckets = None
            if sets is not None:
                if self.zero_stage >= 2:
                    buckets = sets[g]
                else:
                    full = sets[g][0][0]
            elif self.zero_stage >= 2:
                buckets = _ovl.prefetched_gather_flat_shard(
                    shards[g], _zero_chunks(), self.axis_name,
                    scope="hvd_zero2_ag")
            else:
                full = _coll._gather_flat_shard(shards[g],
                                                overlap=self.overlap,
                                                axis_name=self.axis_name)
            off, dst, src = 0, [], []
            for i, sz in zip(lay.idxs[g], lay.sizes[g]):
                if buckets is not None:
                    flat = _coll.leaf_from_buckets(*buckets, n,
                                                   lay.shard[g], off, sz)
                else:
                    flat = full[off:off + sz]
                dst.append(leaves[i])
                src.append(flat.view(leaves[i].shape))
                off += sz
            if add:
                torch._foreach_add_(dst, src)
            else:
                torch._foreach_copy_(dst, src)

    @torch.no_grad()
    def _zero3_step(self) -> None:
        """Stage 3: the tail on the shard gradients (summed by
        ``zero3_full_params``'s backward); updates apply to the shards."""
        shards = self._params_all
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in shards]
        if self._skip_eager(grads):
            # the shard-local verdict, as the JAX package's eager update
            return
        navg = self._navg()
        if self.fused_spec is not None:
            upds = _fused.fused_update_groups(
                self.fused_spec, grads,
                [self.optimizer.state[p] for p in shards], navg,
                [p.dtype for p in shards])
            self._tap_ratio(upds, shards)
            torch._foreach_add_(shards, upds)
            return
        for p, g in zip(shards, grads):
            p.grad = (true_divide(g, navg) if navg > 1 else g).to(p.dtype)
        self.optimizer.step()


def DistributedOptimizer(optimizer, compression=None,
                         backward_passes_per_step: int = 1,
                         op: int = Average, zero_stage: int | None = None,
                         sharded: bool | None = None,
                         overlap: bool | None = None, axis_name=None,
                         eager: bool = False):
    """Wrap a ``torch.optim.Optimizer`` with cross-rank gradient
    averaging (Horovod's contract).  ``compression=None`` reads the
    ``HOROVOD_COMPRESSION`` knob.  With ``backward_passes_per_step=k``
    the update runs on every k-th ``step()`` with the mean of the k
    gradients, and ``step()`` leaves the parameters unchanged in
    between.

    ``zero_stage=None`` reads ``HOROVOD_ZERO_STAGE`` (``sharded=True``,
    or ``HOROVOD_SHARDED_OPTIMIZER``, is stage 1): 1 shards the optimizer
    state, 2 the gradients too, 3 the parameters too (build the
    optimizer over ``zero3_shard_params(model).shards`` and train through
    ``zero3_full_params``; no accumulation).  Stages 1-3 refuse Adasum
    and, with more than one parameter group, differing hyperparameters.
    ``overlap=None`` reads ``HOROVOD_OVERLAP``: the fused buffers are
    reduced in ``HOROVOD_OVERLAP_CHUNKS`` pipelined buckets.
    ``axis_name=None`` reduces over the data mesh's dp axis when one is
    named (``HOROVOD_MESH``), else over the world; the sharded stages
    cut one shard per rank of that axis.

    ``eager=True`` is the counterpart of calling the reference's
    ``update`` outside ``jit``: every reduction becomes a negotiated op
    of the eager plane (one fused allreduce per dtype group at stage 0,
    one reduce-scatter and all-gather per group at stage 1, one per
    bucket at stages 2-3; at stage 3 train through
    ``zero3_full_params(zp, eager=True)``), over the world, on the wire
    ``HOROVOD_COMPRESSION`` names and without error feedback.  It
    refuses a data mesh with model-parallel axes.  The default,
    ``False``, is the in-trace regime."""
    return _DistributedOptimizer(optimizer, compression,
                                 backward_passes_per_step, op, zero_stage,
                                 sharded, overlap, axis_name, eager)


# ---------------------------------------------------------------------------
# Host forms: the world-independent state of the sharded stages
# (``horovod_tpu/optim/distributed.py:1187-1470``)
# ---------------------------------------------------------------------------


class HostZero3Params:
    """Host form of a :class:`Zero3Params`: the FULL parameters by name
    as host arrays (``checkpoint.to_numpy``), independent of the world
    size, so :func:`zero3_params_from_host` re-cuts them for any world.
    Picklable; ``resync`` passes it through."""

    def __init__(self, tree: dict):
        self.tree = tree


class HostShardedState:
    """Host form of a :class:`ShardedState`: every shard-length tensor
    all-gathered into its full fused buffer (host arrays), with the
    layout it was cut for.  Picklable; ``resync`` passes it through."""

    def __init__(self, inner, layout: ShardLayout, had_residual: bool):
        self.inner = inner
        self.layout = layout
        self.had_residual = had_residual


def _default_gather(axis_name):
    def gather(t):
        return _quant._all_gather(t.detach().reshape(-1).contiguous(),
                                  _pmesh.flat_hop(axis_name))
    return gather


def _default_shard_world() -> int:
    """The shard count of the re-cut helpers: the dp extent when a data
    mesh is named, else the world size (1 before ``init``)."""
    if not _basics.state().initialized:
        return 1
    return _basics.data_parallel_size()


def zero3_params_to_host(zp: Zero3Params, gather=None) -> HostZero3Params:
    """All-gather stage-3 shards into the full parameters on the host
    (collective at a world > 1: every rank of ``zp.axis_name`` calls
    it).  ``gather(shard)`` overrides the all-gather (an emulated world,
    a test): it returns the full padded fused buffer of the shard's
    group."""
    from horovod_tpu_torch.checkpoint import to_numpy

    gather = _default_gather(zp.axis_name) if gather is None else gather
    lay = zp.layout
    tree = {}
    for g in range(len(lay.keys)):
        full = gather(zp.shards[g]).detach().reshape(-1)
        off = 0
        for i, sz in zip(lay.idxs[g], lay.sizes[g]):
            tree[zp.names[i]] = to_numpy(
                full[off:off + sz].reshape(zp.shapes[i]))
            off += sz
    return HostZero3Params(tree)


def zero3_params_from_host(host: HostZero3Params, world: int | None = None,
                           rank: int | None = None, axis_name=None,
                           device=None) -> Zero3Params:
    """Re-cut a :func:`zero3_params_to_host` form for ``world`` ranks
    (default: the dp extent, else the world): rank ``rank`` takes
    segment ``rank`` of the re-padded fused buffers, as ``requires_grad``
    shards on ``device`` (default: this rank's device, the CPU before
    ``init``)."""
    from horovod_tpu_torch.checkpoint import from_numpy

    st = _basics.state()
    n = world if world is not None else _default_shard_world()
    r = rank if rank is not None else (
        _pmesh.shard_index(axis_name) if st.initialized else 0)
    if device is None:
        device = st.device if st.initialized else "cpu"
    names = list(host.tree)
    leaves = [from_numpy(host.tree[k]) for k in names]
    layout = _shard_layout(leaves, n)
    shards = []
    for g in range(len(layout.keys)):
        shard = torch.nn.Parameter(
            _rank_shard(leaves, layout, g, r).clone().to(device))
        shard._hvd_zero3 = True
        shard._hvd_zero3_layout = layout
        shards.append(shard)
    return Zero3Params(shards, layout, names,
                       [tuple(t.shape) for t in leaves],
                       _pmesh.resolve_axis(axis_name))


def params_to_host(tree, gather=None):
    """Host form of a parameter tree: tensors become host arrays and
    :class:`Zero3Params` their :class:`HostZero3Params` (a collective at
    a world > 1)."""
    from horovod_tpu_torch.checkpoint import _map, to_numpy

    def one(x):
        if isinstance(x, Zero3Params):
            return zero3_params_to_host(x, gather)
        return to_numpy(x) if isinstance(x, torch.Tensor) else x

    return _map(one, tree, leaves=(Zero3Params,))


def params_from_host(tree, world: int | None = None,
                     rank: int | None = None):
    """The inverse of :func:`params_to_host`, re-cutting the stage-3
    parameters for ``world`` ranks (CPU tensors elsewhere)."""
    from horovod_tpu_torch.checkpoint import _from_host, _map

    def one(x):
        if isinstance(x, HostZero3Params):
            return zero3_params_from_host(x, world, rank)
        return _from_host(x)

    return _map(one, tree, leaves=(HostZero3Params,))


def sharded_state_to_host(state, gather=None, axis_name=None):
    """Host form of a stage-1/2 optimizer state: ``state`` is a
    ``DistributedOptimizer`` (its :meth:`sharded_state`, gathered over
    its axis) or a :class:`ShardedState`.  Every shard-length 1-D tensor
    is all-gathered into its full fused buffer (a collective at a world
    > 1), other entries go to the host as they are; error-feedback
    residuals are dropped (they restart at zero, as on the JAX
    package).  ``gather(shard)`` overrides the all-gather."""
    from horovod_tpu_torch.checkpoint import to_numpy

    if isinstance(state, _DistributedOptimizer):
        axis_name = state.axis_name if axis_name is None else axis_name
        state = state.sharded_state()
    gather = _default_gather(axis_name) if gather is None else gather
    lens = {s for s in state.layout.shard if s > 0}

    def g(v):
        if isinstance(v, torch.Tensor):
            if v.dim() == 1 and v.shape[0] in lens:
                return to_numpy(gather(v))
            return to_numpy(v)
        return v

    inner = [{k: g(v) for k, v in st.items()} for st in state.inner]
    return HostShardedState(inner, state.layout, state.residual is not None)


def sharded_state_from_host(host: HostShardedState, world: int | None = None,
                            rank: int | None = None, axis_name=None
                            ) -> ShardedState:
    """Re-cut a :func:`sharded_state_to_host` form for ``world`` ranks
    (default: the dp extent, else the world): each full buffer is trimmed
    to its group's true size, re-padded to the new world and segment
    ``rank`` taken (CPU tensors; :meth:`load_sharded_state` moves them).
    Residuals restart at zero."""
    from horovod_tpu_torch.checkpoint import from_numpy

    st = _basics.state()
    n = world if world is not None else _default_shard_world()
    r = rank if rank is not None else (
        _pmesh.shard_index(axis_name) if st.initialized else 0)
    old = host.layout
    totals = tuple(sum(sz) for sz in old.sizes)
    padded = tuple(t + (-t) % n for t in totals)
    new = ShardLayout(old.keys, old.idxs, old.sizes, padded,
                      tuple(p // n for p in padded))

    def cut(gi, v):
        if not isinstance(v, (np.ndarray, dict)):
            return v
        t = from_numpy(v)
        if not isinstance(t, torch.Tensor) or t.dim() != 1 \
                or t.shape[0] != old.padded[gi]:
            return t
        buf = torch.zeros(new.padded[gi], dtype=t.dtype)
        buf[:totals[gi]] = t[:totals[gi]]
        return buf[r * new.shard[gi]:(r + 1) * new.shard[gi]].clone()

    inner = [{k: cut(gi, v) for k, v in d.items()}
             for gi, d in enumerate(host.inner)]
    residual = None
    if host.had_residual:
        residual = [torch.zeros(new.padded[gi] if k.is_floating_point else 0,
                                dtype=torch.float32)
                    for gi, k in enumerate(new.keys)]
    return ShardedState(inner, residual, new)


# ---------------------------------------------------------------------------
# Broadcast helpers
# ---------------------------------------------------------------------------


def _tensors_of(params):
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if isinstance(params, dict):
        return list(params.values())
    out = []
    for item in params:
        out.append(item[1] if isinstance(item, tuple) else item)
    return out


def _refuse_zero3(what: str) -> None:
    raise HorovodTpuError(
        f"{what} called on zero_stage=3 shard-resident parameters "
        "(Zero3Params): every rank holds a DIFFERENT 1/world segment, so "
        "a broadcast would corrupt all but the root and a full gather "
        "would defeat the residency contract.")


def _refuse_model_parallel() -> None:
    """The broadcast helpers run on the reference's eager plane, which
    refuses a data mesh with model-parallel axes
    (``horovod_tpu/ops/eager.py:126-133``): a broadcast from one root
    would overwrite every tp/pp/sp shard with the root's."""
    if _pmesh.model_parallel_size() > 1:
        raise HorovodTpuError(
            "eager collectives reduce over the whole world and cannot "
            "honor a data mesh with model-parallel axes "
            f"({_pmesh.canonical_spec(_pmesh.active_spec())!r}); run "
            "the collective over a named axis (axis_name=) or drop the "
            "tp/pp/sp extents from HOROVOD_MESH")


def broadcast_parameters(params, root_rank: int = 0):
    """Overwrite ``params`` in place with ``root_rank``'s values, fused
    per dtype.  ``params`` is a module (its ``state_dict()``, buffers
    included), a mapping of name to tensor, or an iterable of tensors or
    ``(name, tensor)`` pairs.  Returns ``params``.  Stage-3 shards
    (:class:`Zero3Params`) and a data mesh with model-parallel axes are
    refused."""
    if isinstance(params, Zero3Params):
        _refuse_zero3("broadcast_parameters")
    tensors = _tensors_of(params)
    if any(_is_zero3_shard(t) for t in tensors):
        _refuse_zero3("broadcast_parameters")
    _refuse_model_parallel()
    _coll.broadcast_(tensors, root_rank)
    return params


def broadcast_skipping_shards(optimizer, root_rank: int = 0):
    """Overwrite the optimizer's state with ``root_rank``'s, except the
    state that is shard-local by construction: a ``DistributedOptimizer``
    at stage 1 or 2 keeps it apart (``shard_state``), and at stage 3 it
    is the state of the :class:`Zero3Params` shards.  Tensors in place,
    other entries (step counts, hyperparameters) by object broadcast."""
    if isinstance(optimizer, Zero3Params):
        _refuse_zero3("broadcast_skipping_shards")
    _refuse_model_parallel()
    opt = getattr(optimizer, "optimizer", optimizer)
    params = [p for g in opt.param_groups for p in g["params"]]
    tensors, others = [], {}
    for i, p in enumerate(params):
        if _is_zero3_shard(p):
            continue
        for k, v in opt.state[p].items():
            if isinstance(v, torch.Tensor):
                tensors.append(v)
            else:
                others[(i, k)] = v
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in opt.param_groups]
    _coll.broadcast_(tensors, root_rank)
    others, hyper = broadcast_object((others, hyper), root_rank)
    for (i, k), v in others.items():
        opt.state[params[i]][k] = v
    for g, h in zip(opt.param_groups, hyper):
        g.update(h)
    return optimizer


def broadcast_optimizer_state(optimizer, root_rank: int = 0):
    """:func:`broadcast_skipping_shards`: shard-local state stays each
    rank's own."""
    return broadcast_skipping_shards(optimizer, root_rank)


def broadcast_object(obj, root_rank: int = 0):
    """Broadcast a picklable object from ``root_rank`` (length, then
    payload, as uint8 tensors on this rank's device) over the world; a
    data mesh with model-parallel axes is refused."""
    _refuse_model_parallel()
    dev = _basics.device()
    if _basics.rank() == root_rank:
        buf = io.BytesIO()
        pickle.dump(obj, buf)
        payload = torch.from_numpy(
            np.frombuffer(buf.getvalue(), dtype=np.uint8).copy()).to(dev)
        length = torch.tensor([payload.numel()], dtype=torch.int64,
                              device=dev)
    else:
        payload = None
        length = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(length, src=root_rank)
    if payload is None:
        payload = torch.empty(int(length.item()), dtype=torch.uint8,
                              device=dev)
    dist.broadcast(payload, src=root_rank)
    return pickle.loads(payload.cpu().numpy().tobytes())
