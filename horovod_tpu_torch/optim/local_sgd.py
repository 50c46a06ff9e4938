"""Local SGD / DiLoCo, the in-trace regime (counterpart of
``horovod_tpu/optim/local_sgd.py``).

Inner steps reduce the gradients over the LOCAL hop of a ``(cross,
local)`` axis pair only, in full precision; every H-th step an outer
sync sends each rank's parameter delta since the last sync (its
pseudo-gradient) over the CROSS hop, through the outer wire's compressor
with a persistent error-feedback residual for the lossy modes, and
applies it with outer Nesterov momentum (DiLoCo, arXiv:2311.08105).
Between syncs nothing crosses the cross hop.  The H boundary is the
caller's: ``maybe_outer_sync(step)`` after each inner step, as the
reference's bench loop fires its compiled sync program
(``bench.py:806-810``).

ZeRO 0-3 compose over the local hop: the inner ``DistributedOptimizer``
gets ``axis_name=<local>``, so its state shards 1/L per slice, and the
outer anchor, velocity and residual shard the same way (local shard
``l`` holds the same segment on every slice, so the per-shard cross
reduction is exact and the new parameters come back from one all-gather
over the local hop).  Stage 3 trains on ``zero3_shard_params(model,
axis_name=<local>)`` and the sync works on the shard buffers with no
gather.

The optimizer object carries the state (the reference threads a
``LocalSGDState`` through its pure functions): ``inner`` (the inner
``DistributedOptimizer``), ``outer`` (:class:`OuterState`, ``None`` when
the regime is off or degenerate) and ``inner_steps``.  BatchNorm running
statistics are buffers, not parameters: the outer sync leaves each
rank's own, as the reference's does.

Without an axis pair, an active regime over several slices runs the
reference's eager regime (``horovod_tpu/optim/local_sgd.py:283-305,
430-453``) on the negotiated plane instead: each inner step submits one
``localsgd.local.``-scoped fused allreduce per dtype group (the executor
reduces it over the eager plane's local hop only, in full precision) and
then the raw inner update; the outer sync submits one
``localsgd.cross.``-scoped fused allreduce of the float32 deltas (over
the cross hop only, on the wire ``HOROVOD_LOCAL_SGD_COMPRESSION`` or
``HOROVOD_COMPRESSION`` names, without error feedback) and then the
Nesterov step.  It runs at stage 0 only.  The eager plane builds its
(cross, local) groups at ``init()`` when ``HOROVOD_LOCAL_SGD_H >= 2``.
The ``hvd_local_sgd_h`` gauge and the goodput ledger's outer-sync
accounting wait for the runtime planes (ROADMAP.md Queue A item 12).
"""

from __future__ import annotations

import warnings

import torch

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.ops import collectives as _coll
from horovod_tpu_torch.ops import eager as _eager
from horovod_tpu_torch.ops import quantization as _quant
from horovod_tpu_torch.ops.collectives import Average, Sum
from horovod_tpu_torch.ops.compression import Compression, is_quantized
from horovod_tpu_torch.optim import distributed as _dist
from horovod_tpu_torch.parallel import mesh as _pmesh

__all__ = ["LocalSGD", "LocalSGDOptimizer", "OuterState", "resolved_h",
           "outer_compression", "local_sgd_topology", "is_local_sgd_state",
           "inner_window_position"]

def resolved_h(h=None) -> int:
    """The outer-sync period: an explicit ``h`` wins, else the
    ``HOROVOD_LOCAL_SGD_H`` knob.  ``<= 1`` means the regime is off."""
    v = int(_config.get("local_sgd_h") if h is None else h)
    return max(v, 0)


def outer_compression(compression=None):
    """The outer sync's cross-hop compressor: an explicit compressor
    wins; else ``HOROVOD_LOCAL_SGD_COMPRESSION`` when set; else
    ``HOROVOD_COMPRESSION``."""
    if compression is not None:
        return compression
    name = str(_config.get("local_sgd_compression") or "").strip()
    if name:
        return Compression.lookup(name)
    return _dist._resolve_compression(None)


def _hier_local_size() -> int:
    """The local group size when this job's layout has a (cross, local)
    split, else 0 (:func:`~horovod_tpu_torch.parallel.mesh.
    hier_admissibility`, the rule the eager plane's groups follow)."""
    st = _basics._state
    return _pmesh.hier_admissibility(st.size, st.rank, st.local_size,
                                     st.cross_size, st.cross_rank,
                                     st.local_rank)[0]


def local_sgd_topology():
    """The ``(cross, local)`` shape of this job's layout, or ``None``
    when it has no two-level split (every rank its own slice).  It does
    not read ``HOROVOD_HIERARCHICAL_ALLREDUCE``: the regime implies the
    topology."""
    local = _hier_local_size()
    if local <= 1:
        return None
    return (_basics._state.size // local, local)


class OuterState:
    """The outer loop's state: per dtype group a flat ``anchor`` (the
    parameters at the last sync, in the group's dtype), a float32
    Nesterov ``velocity`` and a float32 error-feedback ``residual``
    (``None`` on a lossless wire), over the shared ``layout``
    (:class:`~horovod_tpu_torch.optim.distributed.ShardLayout`).
    ``kind`` is the residency: ``"full"`` (stage 0, whole fused buffers),
    ``"local"`` (stages 1-2, this rank's 1/L shard over the local hop,
    the inner ZeRO state's layout) or ``"zero3"`` (the ``Zero3Params``
    shard buffers)."""

    def __init__(self, anchor, velocity, residual, layout, kind: str):
        self.anchor = list(anchor)
        self.velocity = list(velocity)
        self.residual = None if residual is None else list(residual)
        self.layout = layout
        self.kind = kind

    def nbytes(self) -> int:
        """Bytes this rank holds for the outer loop."""
        bufs = self.anchor + self.velocity + (self.residual or [])
        return sum(b.numel() * b.element_size() for b in bufs)

    def __repr__(self) -> str:
        return (f"OuterState(kind={self.kind!r}, "
                f"groups={list(self.layout.keys)})")


def is_local_sgd_state(x) -> bool:
    """True for a :class:`LocalSGDOptimizer` (the object carrying the
    regime's state)."""
    return isinstance(x, LocalSGDOptimizer)


def inner_window_position(opt) -> int | None:
    """Inner steps since the last outer sync (0 at a boundary), or
    ``None`` when ``opt`` is not a local-SGD optimizer or its regime is
    off or degenerate."""
    if not is_local_sgd_state(opt) or opt.outer is None:
        return None
    return int(opt.inner_steps)


def _is_pair(axis) -> bool:
    return isinstance(axis, _pmesh.HopPair) or (
        isinstance(axis, (tuple, list)) and len(axis) == 2)


class LocalSGDOptimizer:
    """See :func:`LocalSGD`.  ``step()`` is the inner step;
    ``outer_sync()`` / ``maybe_outer_sync(step)`` the outer loop.
    Attributes not defined here (``param_groups``, ``state``,
    ``shard_state``, ``state_bytes``, ...) are the inner
    ``DistributedOptimizer``'s."""

    def __init__(self, optimizer, h=None, axis_name=None, outer_lr=None,
                 outer_momentum=None, compression=None, op: int = Average,
                 overlap=None, sharded=None, zero_stage=None,
                 backward_passes_per_step: int = 1):
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError("LocalSGD expects a torch.optim.Optimizer "
                            f"(got {type(optimizer)!r})")
        self.h = resolved_h(h)
        self.active = self.h > 1
        self.outer_lr = float(_config.get("outer_lr")
                              if outer_lr is None else outer_lr)
        self.outer_momentum = float(_config.get("outer_momentum")
                                    if outer_momentum is None
                                    else outer_momentum)
        self.op = op
        self.zero_stage = _dist._resolve_zero_stage(zero_stage, sharded)
        self.degenerate = False
        #: the eager regime (no axis pair over several slices)
        self.eager = False
        self.inner_steps = 0
        self.outer = None
        resolved = _pmesh.resolve_axis(axis_name)
        self.pair = resolved if _is_pair(resolved) else None

        if not self.active:
            # the synchronous regime: a DistributedOptimizer, bit for bit
            self.compression = _dist._resolve_compression(compression)
            self.inner = _dist.DistributedOptimizer(
                optimizer, compression=compression, op=op,
                axis_name=axis_name, overlap=overlap,
                zero_stage=self.zero_stage,
                backward_passes_per_step=backward_passes_per_step)
            self.inner_axis = resolved
            return

        if int(backward_passes_per_step) != 1:
            raise HorovodTpuError(
                "local-SGD (HOROVOD_LOCAL_SGD_H > 1) does not compose "
                "with backward_passes_per_step > 1: the inner window IS "
                "the accumulation -- raise H instead")
        if op not in (Average, Sum):
            raise HorovodTpuError(
                "local-SGD supports op=Average/Sum: the pseudo-gradient "
                f"exchange has no Adasum projection (got op={op})")
        self.compression = outer_compression(compression)

        # the cross extent, where it is known here: a world of one slice
        # has nothing to sync with, and trains synchronously
        cross_extent = None
        if self.pair is not None:
            if not isinstance(self.pair, _pmesh.HopPair) \
                    and tuple(self.pair) == _pmesh.HIER_DATA_AXES:
                spec = _pmesh.active_spec() or {}
                cross_extent = spec.get(_pmesh.HIER_DATA_AXES[0])
        elif _eager.plane_pair() is not None:
            cross_extent = _eager.plane_pair().cross.size
        else:
            topo = local_sgd_topology()
            cross_extent = 1 if topo is None else topo[0]
        if cross_extent is not None and int(cross_extent) <= 1:
            warnings.warn(
                "HOROVOD_LOCAL_SGD_H=%d but the world is a single slice "
                "(no cross hop to sync over): the outer sync is a no-op "
                "and training runs as plain synchronous SGD over the "
                "local axis" % self.h, stacklevel=3)
            self.degenerate = True
        elif self.pair is None:
            # the eager regime: the scoped reductions of the negotiated
            # plane stand in for the pair
            if self.zero_stage != 0:
                raise HorovodTpuError(
                    "eager local-SGD composes with zero_stage=0 only; run "
                    "the step in-trace (over a (cross, local) axis pair) "
                    "for ZeRO 1-3")
            _dist._check_eager_mesh()
            if _eager.plane_pair() is None:
                raise HorovodTpuError(
                    f"eager local-SGD with H={self.h} over {cross_extent} "
                    "slices needs the eager plane's (cross, local) "
                    "groups, which init() builds when HOROVOD_LOCAL_SGD_H "
                    ">= 2: set the knob before init()")
            self.eager = True

        # the inner wire is the local hop in full precision: the
        # compressor belongs to the cross hop
        if self.pair is None:
            self.inner_axis = resolved
        elif isinstance(self.pair, _pmesh.HopPair):
            self.inner_axis = self.pair.local
        else:
            self.inner_axis = self.pair[1]
        self.inner = _dist.DistributedOptimizer(
            optimizer, compression=Compression.none, op=op,
            axis_name=self.inner_axis, overlap=overlap,
            zero_stage=self.zero_stage)
        if not self.degenerate:
            self.outer = self._outer_init()

    def __getattr__(self, name):
        return getattr(self.__dict__["inner"], name)

    # -- the inner step --------------------------------------------------

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def step(self, closure=None):
        """One inner step: the inner ``DistributedOptimizer``'s (the
        local hop only when the regime is active); in the eager regime
        one ``localsgd.local.``-scoped fused allreduce per dtype group,
        then the raw inner update."""
        if self.eager:
            loss = None
            if closure is not None:
                with torch.enable_grad():
                    loss = closure()
            self._eager_inner_step()
        else:
            loss = self.inner.step(closure)
        if self.active:
            self.inner_steps += 1
        return loss

    @torch.no_grad()
    def _eager_inner_step(self) -> None:
        params = self.inner._params()
        grads = [p.grad for p in params]
        reduced = _dist.eager_fused_allreduce(grads, self.op, scope="local")
        if params:
            torch._foreach_copy_(grads, reduced)
        self.inner._update(params)

    # -- the outer loop --------------------------------------------------

    def _params(self) -> list:
        return self.inner._params_all

    @torch.no_grad()
    def _outer_init(self) -> OuterState:
        params = self._params()
        lossy = is_quantized(self.compression)
        if self.zero_stage == 3:
            anchors = [p.detach().clone() for p in params]
            layout = getattr(params[0], "_hvd_zero3_layout", None)
            kind = "zero3"
        else:
            bad = sorted({str(p.dtype) for p in params
                          if not p.is_floating_point()})
            if bad:
                raise HorovodTpuError(
                    "local-SGD pseudo-gradients need floating parameters; "
                    f"got leaves of dtype {bad}")
            leaves = [p.detach() for p in params]
            if self.zero_stage >= 1:
                layout = _dist._shard_layout(
                    leaves, _pmesh.axis_total(self.inner_axis))
                idx = _pmesh.shard_index(self.inner_axis)
                anchors = [_dist._rank_shard(leaves, layout, g, idx).clone()
                           for g in range(len(layout.keys))]
                kind = "local"
            else:
                layout = _dist._shard_layout(leaves, 1)
                anchors = [_dist._fuse_group(leaves, layout, g).clone()
                           for g in range(len(layout.keys))]
                kind = "full"

        def zeros():
            return [torch.zeros(a.shape, dtype=torch.float32,
                                device=a.device) for a in anchors]

        # the eager wire keeps no error feedback
        return OuterState(anchors, zeros(),
                          zeros() if lossy and not self.eager else None,
                          layout, kind)

    def _current_bufs(self) -> list:
        """The current parameters in the outer state's residency."""
        outer, params = self.outer, self._params()
        if outer.kind == "zero3":
            return [p.detach() for p in params]
        leaves = [p.detach() for p in params]
        lay = outer.layout
        if outer.kind == "local":
            idx = _pmesh.shard_index(self.inner_axis)
            return [_dist._rank_shard(leaves, lay, g, idx)
                    for g in range(len(lay.keys))]
        return [_dist._fuse_group(leaves, lay, g)
                for g in range(len(lay.keys))]

    def _nesterov(self, red: torch.Tensor, g: int):
        """Outer Nesterov over group ``g``: the new anchor (group dtype)
        and velocity (float32)."""
        outer, mu = self.outer, self.outer_momentum
        v = mu * outer.velocity[g] + red
        upd = red + mu * v
        anchor = (outer.anchor[g].to(torch.float32) - self.outer_lr * upd) \
            .to(outer.anchor[g].dtype)
        return anchor, v

    @torch.no_grad()
    def outer_sync(self) -> None:
        """One outer DiLoCo step, in place: the pseudo-gradient (anchor
        minus parameters, plus the residual on a lossy wire) averaged
        over the cross hop by one ``cross_allreduce`` per dtype group,
        applied to the anchor with outer Nesterov momentum; the
        parameters become the new anchor and the inner window restarts.
        Only the window restarts when the regime is off or degenerate."""
        if not self.active or self.degenerate or self.outer is None:
            self.inner_steps = 0
            return
        outer = self.outer
        if self.eager:
            self._outer_sync_eager()
            return
        with_err = outer.residual is not None
        cur = self._current_bufs()
        for g in range(len(outer.anchor)):
            delta = outer.anchor[g].to(torch.float32) \
                - cur[g].to(torch.float32)
            if with_err:
                delta = delta + outer.residual[g]
            out = _coll.cross_allreduce(
                delta, axis_name=self.pair, op=self.op,
                compression=self.compression, with_error=with_err)
            del delta
            red, err = out if with_err else (out, None)
            outer.anchor[g], outer.velocity[g] = self._nesterov(red, g)
            if with_err:
                outer.residual[g] = err
            del red, err
        del cur
        self._write_back()
        self.inner_steps = 0

    def _outer_sync_eager(self) -> None:
        """The eager outer sync: one ``localsgd.cross.``-scoped fused
        allreduce of every group's float32 delta, then Nesterov."""
        outer = self.outer
        cur = self._current_bufs()
        deltas = [a.to(torch.float32) - c.to(torch.float32)
                  for a, c in zip(outer.anchor, cur)]
        del cur
        reds = _dist.eager_fused_allreduce(deltas, self.op, scope="cross")
        del deltas
        for g, red in enumerate(reds):
            outer.anchor[g], outer.velocity[g] = self._nesterov(red, g)
        del reds
        self._write_back()
        self.inner_steps = 0

    def _write_back(self) -> None:
        """The parameters take the new anchor: stage 0 splits it, stages
        1-2 gather it over the local hop (one all-gather per group),
        stage 3 copies it into the shards."""
        outer, params = self.outer, self._params()
        if outer.kind == "zero3":
            torch._foreach_copy_(params, outer.anchor)
            return
        lay = outer.layout
        for g in range(len(lay.keys)):
            buf = outer.anchor[g]
            if outer.kind == "local":
                buf = _quant._all_gather(buf, _pmesh.flat_hop(
                    self.inner_axis))
            off, dst, src = 0, [], []
            for i, sz in zip(lay.idxs[g], lay.sizes[g]):
                dst.append(params[i])
                src.append(buf[off:off + sz].view(params[i].shape))
                off += sz
            torch._foreach_copy_(dst, src)

    def outer_state_bytes(self) -> int:
        """Bytes of outer state this rank holds (0 when there is none)."""
        return 0 if self.outer is None else self.outer.nbytes()

    # -- the host-side boundary ------------------------------------------

    def should_sync(self, step: int) -> bool:
        """True when ``step`` (1-based, counted in inner steps) lands on
        an outer-sync boundary."""
        return (self.active and not self.degenerate
                and step > 0 and step % self.h == 0)

    def maybe_outer_sync(self, step: int, sync_fn=None) -> bool:
        """Run :meth:`outer_sync` (or ``sync_fn()``, a caller's form of
        it) when ``step`` is a boundary; returns whether it ran."""
        if not self.should_sync(step):
            return False
        (self.outer_sync if sync_fn is None else sync_fn)()
        return True


def LocalSGD(optimizer, h=None, axis_name=None, outer_lr=None,
             outer_momentum=None, compression=None, op: int = Average,
             overlap=None, sharded=None, zero_stage=None,
             backward_passes_per_step: int = 1) -> LocalSGDOptimizer:
    """Wrap a ``torch.optim.Optimizer`` in the local-SGD / DiLoCo regime
    over ``axis_name``, a ``(cross, local)`` pair (default: the data
    mesh's ``(dpc, dpl)`` split under ``HOROVOD_MESH`` with
    ``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` and
    ``HOROVOD_HIERARCHICAL_LOCAL_SIZE``)::

        opt = hvd.LocalSGD(hvd.fused_update.sgd(model.parameters(), 0.1,
                                                momentum=0.9), h=2)
        for step in range(1, steps + 1):
            train_step(model, opt, images, labels)     # inner step
            opt.maybe_outer_sync(step)

    ``h=None`` reads ``HOROVOD_LOCAL_SGD_H``; ``h <= 1`` is a plain
    :func:`~horovod_tpu_torch.optim.distributed.DistributedOptimizer`,
    bit for bit.  ``outer_lr``/``outer_momentum`` default to
    ``HOROVOD_OUTER_LR``/``HOROVOD_OUTER_MOMENTUM`` (0.7/0.9);
    ``compression`` defaults to ``HOROVOD_LOCAL_SGD_COMPRESSION``, else
    ``HOROVOD_COMPRESSION``, and applies to the cross hop only.  At
    stage 3 the optimizer is built over ``zero3_shard_params(model,
    axis_name=<the local hop>).shards``."""
    return LocalSGDOptimizer(
        optimizer, h=h, axis_name=axis_name, outer_lr=outer_lr,
        outer_momentum=outer_momentum, compression=compression, op=op,
        overlap=overlap, sharded=sharded, zero_stage=zero_stage,
        backward_passes_per_step=backward_passes_per_step)
