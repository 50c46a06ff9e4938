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
from horovod_tpu_torch.common.util import true_divide
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
                            chunks=None, axis_name=None):
    """The stage-2 gradient scatter of group ``g``: K bucket pieces
    (column slices of the ``(n, L)`` segment view) assembled span-wise
    from the leaves (``collectives.fuse_bucket_piece``, the residual's
    slice added in), each reduce-scattered, bucket k+1's started before
    bucket k is waited for, so at most two pieces are alive; the full
    fused buffer is never built.  Each bucket may carry its own mode
    (``HOROVOD_BUCKET_COMPRESSION``).  ``n`` is the total of
    ``axis_name``.  Returns ``(shard, err)`` in the layout of
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


def _dtype_label(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


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
        _M_FUSED_BYTES.set(flat.numel() * flat.element_size(),
                           dtype=_dtype_label(dtype))
        handles.append((idxs, _eager.allreduce_async(
            flat, op=op, name=f"{prefix}.{_dtype_label(dtype)}.{len(idxs)}",
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
        name = f"shard_rs.{_dtype_label(key)}.{layout.padded[g]}"
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
        name = f"{prefix}.{_dtype_label(key)}.{layout.padded[g]}"
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
                chunks=ctx.chunks, axis_name=ctx.axis)
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
        _config.refuse_not_ported()
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
        if self.zero_stage == 3:
            self._zero3_step()
        elif self.backward_passes_per_step > 1 and not self._accumulate():
            return loss
        elif self.zero_stage:
            self._sharded_step()
        else:
            self._update(self.synchronize())
        if not self._stamped:
            self._stamp_zero_bytes()
        return loss

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
        if self._inner is None:
            upds = _fused.fused_update_groups(self.fused_spec, gshards,
                                              self._group_state, navg,
                                              lay.keys)
            self._apply_shards(upds, add=True)
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
        self._apply_shards(self._shard_params, add=False)

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
            gshards.append(shard)
        return gshards

    def _apply_shards(self, shards, add: bool) -> None:
        """Gather every group's update shards (``add``: added to the
        parameters) or new value shards (copied into them): at stage 1
        one all-gather per group, at stage 2 bucket by bucket with each
        leaf reassembled from the bucket results."""
        lay, n = self.layout, self._n()
        leaves = self._params_all
        sets = None
        if self.eager:
            sets = _eager_gather(shards, lay, "shard_ag",
                                 self._eager_chunks())
        for g in range(len(lay.keys)):
            buckets = None
            if sets is not None:
                if self.zero_stage >= 2:
                    buckets = sets[g]
                else:
                    full = sets[g][0][0]
            elif self.zero_stage >= 2:
                buckets = _ovl.prefetched_gather_flat_shard(
                    shards[g], _zero_chunks(), self.axis_name)
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
        navg = self._navg()
        if self.fused_spec is not None:
            upds = _fused.fused_update_groups(
                self.fused_spec, grads,
                [self.optimizer.state[p] for p in shards], navg,
                [p.dtype for p in shards])
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
