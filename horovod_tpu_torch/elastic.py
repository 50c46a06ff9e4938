"""Elastic training: survivor-continue with dynamic world size (the copy
of ``horovod_tpu/elastic.py``; docs/elastic.md).

Survivors of a dead or preempted rank KEEP their processes, re-form the
communicator at the new world size, resync state from the last commit
point, and keep training; a replacement process (a joiner, respawned by
``python -m horovod_tpu_torch.run --elastic``) is admitted at a commit
boundary and grows the world back.

Public surface (Horovod's elastic API):

* :class:`ElasticState` — the parameters (an ``nn.Module``, a dict of
  tensors, or a tree holding ``Zero3Params``: read them from
  ``state.params`` after a restore, it holds new shards), the
  ``DistributedOptimizer`` as ``opt_state``, the step counter and batch
  offset, with ``commit()`` / ``restore()``.  ``commit()`` snapshots to
  host memory (ZeRO stage-1/2 shard state and stage-3 parameters in
  their re-cuttable host forms) and doubles as the admission boundary
  for joiners.
* :func:`run` — decorator / driver: runs ``train_fn(state, ...)``,
  catches :class:`RanksDownError` (and a collective that failed because
  the liveness sweep confirms a peer is dead), and drives the
  coordinated re-form instead of dying.

The re-form ("generation" bump) protocol rides the launcher's
rendezvous KV server, the only piece of the control plane that outlives
a generation:

1. every survivor posts presence under the NEXT generation's namespace;
2. the lowest surviving rank (leader) waits ``HOROVOD_ELASTIC_SETTLE_
   SECONDS`` for the expected survivors, folds in pending joiners, and
   publishes the roster: dense new ranks, local/cross topology, a fresh
   coordinator address, the generation number;
3. everyone tears the old world down (bounded: on NCCL the
   communicators are aborted first, since a group with a dead member can
   hang a plain destroy), calls ``init()`` again on the fresh epoch ==
   generation (every process keeps the card of its first ``init()``),
   and resyncs state: the commit snapshot broadcasts from the new rank
   0, ZeRO shard state is re-cut for the new world size, error-feedback
   residuals restart at zero.

Known limitation: the death of the OLD rank 0 cannot be survived
in-process — its process holds the default group's ``torch.distributed``
store — so ``python -m horovod_tpu_torch.run --restart-attempts`` is the
way back for that slice of failures, as in the JAX package.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import socket
import time

import numpy as np
import torch

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.common.types import HorovodTpuError, RanksDownError
from horovod_tpu_torch.runtime import flight as _flight

# Module state: generation statistics and the lazily-created rendezvous
# transport.  ``_transport_factory`` is the test hook: single-process
# tests drive the whole admission protocol over an in-memory fake wire.
_stats = {"reforms": 0, "last_reform_s": None, "total_reform_s": 0.0,
          "dead_total": 0, "grown_total": 0, "preempt_drains": 0}
_rendezvous = None
_transport_factory = None
# the leader's hold on the next generation's coordinator port, released
# once its init() bound the store there
_held_coord = None


class HostsUpdatedInterrupt(Exception):
    """Raised out of ``ElasticState.commit()`` when the commit boundary
    admits joiners (Horovod's elastic uses the same name).  ``run``
    catches it, drives the grow re-form, and re-enters ``train_fn``
    from the just-committed state — EVERY rank restarts the loop at the
    same point, survivor and joiner alike; a survivor resuming
    mid-commit while the joiner enters at the loop top would sit one
    commit apart and deadlock.  Do not swallow it in ``train_fn``."""


def enabled() -> bool:
    """True when elastic mode is on (``HOROVOD_ELASTIC`` /
    ``python -m horovod_tpu_torch.run --elastic``)."""
    return bool(_config.get("elastic"))


def is_joiner() -> bool:
    """True in a replacement process spawned by the launcher to grow a
    running job back toward its original size."""
    return os.environ.get("HOROVOD_ELASTIC_JOINER") == "1"


def generation() -> int:
    """The current communicator generation — the KV epoch the world was
    (re)formed on.  Starts at 1; each re-form increments it."""
    return _basics.state().epoch


def stats() -> dict:
    """Re-form statistics: count, last and total re-form latency, ranks
    lost, ranks grown back, preemption drains."""
    out = dict(_stats)
    out["generation"] = generation()
    return out


def poll() -> None:
    """Raise :class:`RanksDownError` promptly if a peer is down, and
    drive the graceful-preemption drain protocol
    (:mod:`horovod_tpu_torch.runtime.preemption` — may raise
    :class:`~horovod_tpu_torch.runtime.preemption.PreemptionInterrupt`).

    Call this between training steps — at the SAME loop points on every
    rank, which is also what lets the preemption plane agree on one
    drain boundary fleet-wide — so the re-form starts within the
    heartbeat deadline either way."""
    from horovod_tpu_torch.ops import eager as _eager
    from horovod_tpu_torch.runtime import preemption as _preempt

    _eager.check_liveness()
    _preempt.maybe_interrupt()


# ---------------------------------------------------------------------------
# Rendezvous transport (outlives generations)
# ---------------------------------------------------------------------------


# the longest a rendezvous wait goes without a deadline or liveness check
_WAIT_SLICE_S = 0.05


def _rv():
    global _rendezvous
    if _rendezvous is None:
        if _transport_factory is not None:
            _rendezvous = _transport_factory()
        else:
            addr = _config.get("rendezvous_addr")
            port = _config.get("rendezvous_port")
            if not addr or not port:
                raise HorovodTpuError(
                    "elastic mode needs the launcher's rendezvous KV "
                    "server to outlive re-forms (python -m "
                    "horovod_tpu_torch.run --elastic exports "
                    "HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT); rank 0's "
                    "torch.distributed store dies with the generation "
                    "it served. See docs/elastic.md.")
            from horovod_tpu_torch.runtime.kvstore import KVStoreClient

            _rendezvous = KVStoreClient(addr, port)
    return _rendezvous


def _bounded_get(t, key: str, timeout_s: float, liveness: bool = False):
    """Wait for ``key`` until present or ``timeout_s``; with ``liveness``,
    also sweep peer heartbeats so a coordinator dying mid-wait raises
    :class:`RanksDownError` instead of riding out the deadline.  The
    wait is the transport's blocking get, in slices of ``_WAIT_SLICE_S``
    that return as soon as the key is set."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return t.get_blocking(key, _WAIT_SLICE_S)
        except TimeoutError:
            pass
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"elastic: rendezvous key {key} not published within "
                f"{timeout_s:.0f}s")
        if liveness:
            # Heartbeat sweep only — NOT poll(): the preemption drain
            # protocol counts poll() calls as step boundaries, and this
            # wait loop runs a variable number of iterations per rank.
            from horovod_tpu_torch.ops import eager as _eager

            _eager.check_liveness()


def _uid() -> str:
    return os.environ.get("HOROVOD_ELASTIC_UID") or \
        f"{socket.gethostname()}-{os.getpid()}"


# ---------------------------------------------------------------------------
# Join registration / admission (KV-only: the store has no listing, so
# joiners claim dense slots under el/join/<i> via set_once)
# ---------------------------------------------------------------------------


def _join_cursor(t) -> int:
    """First join slot that can still hold a pending joiner — slots
    below it are all consumed, so the per-commit registry scan costs
    O(pending joiners), not O(all-time joiners)."""
    try:
        return int(t.try_get("el/join_cursor") or 0)
    except (TypeError, ValueError):
        return 0


def register_join(t, uid: str, host: str) -> int:
    """Announce a joiner on the rendezvous; returns its join slot."""
    rec = json.dumps({"uid": uid, "host": host})
    start = _join_cursor(t)
    for i in range(start, start + 4096):
        t.set_once(f"el/join/{i}", rec)
        if t.try_get(f"el/join/{i}") == rec:
            return i
    raise HorovodTpuError("elastic: join registry full (4096 slots)")


def scan_joiners(t, limit: int = 4096,
                 advance_cursor: bool = False) -> list:
    """Pending (unadmitted) joiners, in registration order.  With
    ``advance_cursor`` (rank 0 / the re-form leader) the shared scan
    cursor moves past the leading run of consumed slots so future scans
    skip them."""
    start = _join_cursor(t)
    out = []
    prefix = start
    prefix_consumed = True
    for i in range(start, start + limit):
        v = t.try_get(f"el/join/{i}")
        if v is None:
            break
        rec = json.loads(v)
        consumed = t.try_get(f"el/admitted/{rec['uid']}") is not None
        if consumed and prefix_consumed:
            prefix = i + 1
        else:
            prefix_consumed = False
            if not consumed:
                out.append((rec["uid"], rec["host"]))
    if advance_cursor and prefix > start:
        try:
            t.set_overwrite("el/join_cursor", str(prefix))
        except Exception:  # noqa: BLE001 -- scan-cost optimization only
            pass
    return out


# ---------------------------------------------------------------------------
# Roster planning (pure, unit-testable)
# ---------------------------------------------------------------------------


def plan_reform(survivors: list, joiners: list) -> dict:
    """Dense renumbering + local/cross topology for a new generation.

    ``survivors``: ``[(old_rank, uid, host)]`` — keep their relative
    order (so the lowest surviving old rank becomes new rank 0, the
    state-resync root).  ``joiners``: ``[(uid, host)]`` — numbered after
    the survivors, sorted by uid for determinism."""
    members = [{"uid": u, "host": h, "old_rank": r}
               for r, u, h in sorted(survivors)]
    members += [{"uid": u, "host": h, "old_rank": -1}
                for u, h in sorted(joiners)]
    hosts = [m["host"] for m in members]
    uniq = sorted(set(hosts), key=hosts.index)
    counts = {h: hosts.count(h) for h in uniq}
    seen: dict = {}
    for r, m in enumerate(members):
        h = m["host"]
        m["rank"] = r
        m["local_rank"] = seen.get(h, 0)
        seen[h] = m["local_rank"] + 1
        m["local_size"] = counts[h]
        m["cross_rank"] = uniq.index(h)
        m["cross_size"] = len(uniq)
    return {"size": len(members), "members": members,
            "homogeneous": len(set(counts.values())) == 1}


# ---------------------------------------------------------------------------
# Host forms of the parameters and the optimizer
# ---------------------------------------------------------------------------


def _params_to_host(params):
    """Host form of ``params``: a module's state dict (its buffers too,
    so BatchNorm's running statistics resume bit for bit) as host
    arrays, else the tree through ``params_to_host`` (stage-3
    ``Zero3Params`` gathered into their full form: a collective)."""
    from horovod_tpu_torch.checkpoint import to_numpy
    from horovod_tpu_torch.optim import distributed as _dist

    if isinstance(params, torch.nn.Module):
        return {"module": {k: to_numpy(v)
                           for k, v in params.state_dict().items()}}
    return {"tree": _dist.params_to_host(params)}


@torch.no_grad()
def _copy_into(cur, host):
    """Copy a host tree into the live tensors of ``cur`` in place (the
    optimizer keeps its references); a leaf that is not a tensor, or
    a stage-3 subtree, is replaced."""
    from horovod_tpu_torch.optim import distributed as _dist

    if isinstance(host, _dist.HostZero3Params):
        return _dist.params_from_host(host)
    if isinstance(cur, dict) and isinstance(host, dict):
        return {k: _copy_into(cur.get(k), v) for k, v in host.items()}
    if isinstance(cur, (list, tuple)) and isinstance(host, (list, tuple)) \
            and len(cur) == len(host):
        return type(cur)(_copy_into(c, h) for c, h in zip(cur, host))
    if not isinstance(host, (np.ndarray, dict, torch.Tensor)):
        return host
    new = _tensor(host)
    if isinstance(cur, torch.Tensor) and isinstance(new, torch.Tensor) \
            and cur.shape == new.shape and cur.dtype == new.dtype:
        cur.copy_(new)
        return cur
    return new


def _tensor(x):
    """A host leaf as a tensor: a snapshot in memory holds host arrays,
    one read back by ``checkpoint.restore`` CPU tensors."""
    from horovod_tpu_torch.checkpoint import from_numpy

    return x if isinstance(x, torch.Tensor) else from_numpy(x)


def _params_from_host(params, host):
    if "module" in host:
        dev = next(iter(params.state_dict().values())).device \
            if params.state_dict() else None
        params.load_state_dict({k: _tensor(v).to(dev)
                                for k, v in host["module"].items()})
        return params
    return _copy_into(params, host["tree"])


def _opt_to_host(opt):
    """Host form of the optimizer: stage-1/2 shard state, and at stage 3
    the state of the shard parameters, all-gathered into full buffers
    (``sharded_state_to_host``: a collective), else the wrapped
    optimizer's state dict as host arrays.  Error-feedback residuals
    are not kept: they restart at zero."""
    from horovod_tpu_torch.checkpoint import _map, to_numpy
    from horovod_tpu_torch.optim import distributed as _dist

    if opt is None:
        return None
    if isinstance(opt, torch.optim.Optimizer):
        return {"state_dict": _map(
            lambda x: to_numpy(x) if isinstance(x, torch.Tensor) else x,
            opt.state_dict())}
    if not isinstance(opt, _dist._DistributedOptimizer):
        raise HorovodTpuError(
            "ElasticState(opt_state=...) wants the DistributedOptimizer "
            f"or a torch optimizer (got {type(opt).__name__})")
    if opt.zero_stage in (1, 2):
        return {"sharded": _dist.sharded_state_to_host(opt)}
    if opt.zero_stage >= 3:
        shards = opt._params_all
        state = _dist.ShardedState(
            [opt.optimizer.state.get(p, {}) for p in shards], None,
            shards[0]._hvd_zero3_layout)
        return {"zero3": _dist.sharded_state_to_host(
            state, axis_name=opt.axis_name)}
    sd = opt.optimizer.state_dict()
    return {"state_dict": _map(
        lambda x: to_numpy(x) if isinstance(x, torch.Tensor) else x, sd)}


def _zero3_of(tree):
    """The one ``Zero3Params`` in a parameter tree."""
    from horovod_tpu_torch.checkpoint import _nodes
    from horovod_tpu_torch.optim import distributed as _dist

    found = [x for x in _nodes(tree) if isinstance(x, _dist.Zero3Params)]
    if len(found) != 1:
        raise HorovodTpuError(
            "ElasticState with a stage-3 DistributedOptimizer wants its "
            "Zero3Params (the one the optimizer was built over) in "
            f"params; found {len(found)}")
    return found[0]


@torch.no_grad()
def _opt_from_host(opt, host, params=None) -> None:
    from horovod_tpu_torch.checkpoint import _from_host
    from horovod_tpu_torch.optim import distributed as _dist

    if opt is None or host is None:
        return
    if isinstance(opt, torch.optim.Optimizer):
        opt.load_state_dict(_from_host(host["state_dict"]))
        return
    if "zero3" in host:
        # the restored Zero3Params are new shard parameters, cut for the
        # current world: the optimizer is re-pointed at them, and their
        # state is the commit's, re-cut the same way
        new = list(_zero3_of(params).shards)
        swap = {id(o): n for o, n in zip(opt._params_all, new)}
        for group in opt.optimizer.param_groups:
            group["params"] = [swap.get(id(p), p) for p in group["params"]]
        opt._params_all = new
        opt.optimizer.state.clear()
        cut = _dist.sharded_state_from_host(host["zero3"],
                                            axis_name=opt.axis_name)
        for p, st in zip(new, cut.inner):
            opt.optimizer.state[p] = {
                k: v.to(p.device) if isinstance(v, torch.Tensor) else v
                for k, v in st.items()}
        return
    opt._counter = 0
    opt._accum = {}
    if "sharded" in host:
        # the layout is cut for the CURRENT world: re-cut it, then load
        # this rank's segment (residuals restart at zero)
        opt._init_sharded()
        opt.load_sharded_state(_dist.sharded_state_from_host(
            host["sharded"], axis_name=opt.axis_name))
        return
    opt.optimizer.load_state_dict(_from_host(host["state_dict"]))
    if opt.residuals is not None:
        for r in opt.residuals.values():
            r.zero_()


# ---------------------------------------------------------------------------
# ElasticState
# ---------------------------------------------------------------------------


class ElasticState:
    """Training state that survives re-forms: the parameters
    (``params``: an ``nn.Module``, a dict of tensors or a tree with
    ``Zero3Params``), the ``DistributedOptimizer`` (``opt_state``), the
    step counter and batch offset (plus arbitrary ``extra`` host-side
    values).  ``commit()`` snapshots everything to host memory — the
    point a re-form (or a joiner) resumes from — and ``restore()`` loads
    it back onto this rank's device, re-cutting ZeRO shard state for the
    current world size.

    ``commit()`` is a collective call in elastic mode: it is also the
    admission boundary where every rank agrees (via rank 0's verdict on
    the rendezvous) whether pending joiners trigger a grow re-form, and
    where sharded optimizer state is all-gathered.  Call it at the same
    loop points on every rank.  With ``checkpoint_dir`` set, each commit
    also lands a durable snapshot (rank 0, ``checkpoint.save``) so
    ``--restart-attempts`` — the fallback when a re-form is impossible —
    resumes from the same point the elastic layer would have.
    """

    def __init__(self, params=None, opt_state=None, step: int = 0,
                 batch_offset: int = 0, checkpoint_dir: str | None = None,
                 **extra):
        self.params = params
        self.opt_state = opt_state
        self.step = int(step)
        self.batch_offset = int(batch_offset)
        self.extra = dict(extra)
        self.checkpoint_dir = checkpoint_dir
        self.commits = 0
        self._commit = None
        # Health-plane counters at the previous commit, so the verdict
        # stamped on each durable snapshot reflects what happened SINCE
        # the last one.
        self._health_marks = (0, 0)
        #: wall seconds of the last commit's snapshot (durable save
        #: included)
        self.last_commit_s = None

    def commit(self) -> None:
        self._snapshot()
        _autopilot_tick(self)
        _commit_boundary(self)

    def _snapshot(self) -> None:
        """The state-capture half of :meth:`commit` — collective, but
        without the admission boundary.  The preemption drain uses it
        directly (an emergency commit must not race a grow decision
        while ranks are leaving)."""
        from horovod_tpu_torch.optim import local_sgd as _lsgd

        t0 = time.monotonic()
        self.commits += 1
        # Local-SGD regime contract (docs/local-sgd.md): commits happen
        # at outer-sync boundaries, where params == anchor.  A commit
        # taken MID-window still works — but the mid-window params
        # become the new anchor on restore, silently discarding the
        # outer-momentum trajectory the window would have produced.
        pos = _lsgd.inner_window_position(self.opt_state)
        if pos:
            _log.warning(
                f"elastic commit #{self.commits} taken {pos} inner "
                "step(s) into a local-SGD window — the regime contract "
                "is to commit at outer-sync boundaries; a re-form will "
                "restore these mid-window params as the new anchor "
                "(docs/local-sgd.md)")
            _flight.record("elastic", event="localsgd_midwindow_commit",
                           commit=self.commits, inner_steps=int(pos),
                           step=int(self.step))
        snap = {
            "params": _params_to_host(self.params),
            "opt_state": _opt_to_host(self.opt_state),
            "step": int(self.step),
            "batch_offset": int(self.batch_offset),
            "extra": dict(self.extra),
            "commits": self.commits,
        }
        st = _basics.state()
        bg = st.background
        if st.peer_down or (bg is not None and bg.aborted()):
            # a collective of the capture ran against a dead peer: NCCL's
            # abort released it with whatever the buffers held, so the
            # last good commit stays the one to resume from
            raise RanksDownError(
                (bg._error if bg is not None else None)
                or "RanksDownError: a peer died during the commit")
        if st.device.type == "cpu":
            # a CPU tensor's host array aliases its storage: the
            # snapshot must not move with the training that follows
            snap = copy.deepcopy(snap)
        self._commit = snap
        if self.checkpoint_dir:
            from horovod_tpu_torch import checkpoint as _ckpt

            # The FULL snapshot, optimizer state included (in its
            # re-cuttable host form): the --restart-attempts fallback
            # must resume from the same point a re-form would have.
            try:
                _ckpt.save(self.checkpoint_dir, self._commit,
                           step=self.step,
                           verdict=_commit_verdict(self))
            except OSError as exc:
                _log.warning(f"elastic commit checkpoint failed: {exc}")
        self.last_commit_s = time.monotonic() - t0

    def restore(self) -> None:
        snap = self._commit
        if snap is None:
            raise HorovodTpuError(
                "ElasticState.restore() without a commit: call "
                "state.commit() at least once before a failure can be "
                "survived.")
        self.params = _params_from_host(self.params, snap["params"])
        _opt_from_host(self.opt_state, snap["opt_state"], self.params)
        self.step = int(snap["step"])
        self.batch_offset = int(snap["batch_offset"])
        self.extra = dict(snap["extra"])
        self.commits = int(snap["commits"])

    def load(self, snap: dict) -> None:
        """Take a snapshot (``checkpoint.restore`` of a durable commit)
        as the last commit and restore it: how a job launched again on
        the same ``checkpoint_dir`` resumes."""
        self._commit = snap
        self.restore()

    def rollback_to_healthy(self) -> int:
        """Load the newest durable commit whose stamped health verdict
        is not ``"poisoned"``, broadcast it from rank 0 so every rank
        rewinds to the SAME snapshot, and restore device state from it.
        Returns the step rolled back to; raises ``HorovodTpuError`` when
        no durable commit exists or none is healthy -- on every rank: rank
        0's finding is broadcast, so no peer is left waiting in the
        broadcast of a snapshot that never comes."""
        if not self.checkpoint_dir:
            raise HorovodTpuError(
                "rollback_to_healthy() needs "
                "ElasticState(checkpoint_dir=...): only durable "
                "commits carry health verdicts.")
        from horovod_tpu_torch import checkpoint as _ckpt
        from horovod_tpu_torch.optim.distributed import broadcast_object

        st = _basics.state()
        multi = st.initialized and st.size > 1
        snap = missing = None
        if not multi or st.rank == 0:
            try:
                snap = _ckpt.restore(self.checkpoint_dir,
                                     healthy_only=True)
            except FileNotFoundError as exc:
                missing = str(exc)
        if multi:
            snap, missing = broadcast_object((snap, missing), root_rank=0)
        if missing is not None:
            raise HorovodTpuError(f"rollback_to_healthy(): {missing}")
        step = int(snap["step"])
        _flight.record("elastic", event="rollback_to_healthy",
                       step=step, commits=int(snap.get("commits", 0)))
        _log.warning(
            f"elastic: rolled back to last healthy commit (step {step},"
            f" commit {snap.get('commits')})", rank=st.rank)
        self.load(snap)
        return step


def _commit_verdict(state: ElasticState) -> str | None:
    """Health verdict stamped into a durable commit's DONE marker:
    ``None`` when the health plane is off, ``"poisoned"`` when an alert
    is active or new nonfinite events / alert trips landed since the
    previous commit, else ``"healthy"``."""
    if not bool(_config.get("health")):
        return None
    try:
        from horovod_tpu_torch.runtime import health as _health

        # On the card a tap's verdict reaches the monitor at the next tap
        # (a pinned copy behind an event): publish every queued one, so
        # the commit right after a poisoned step is stamped poisoned and
        # a rollback never lands on it
        _health.flush()
        snap = _health.monitor().snapshot()
    except Exception:  # noqa: BLE001
        return None
    marks = (int(snap.get("nonfinite_events") or 0),
             int(snap.get("alerts_total") or 0))
    prev = state._health_marks
    state._health_marks = marks
    if snap.get("active_alerts") or marks[0] > prev[0] \
            or marks[1] > prev[1]:
        return "poisoned"
    return "healthy"


def _autopilot_tick(state: ElasticState) -> None:
    """Rank-side autopilot hook, evaluated once per commit under
    ``HOROVOD_AUTOPILOT``: rank 0 judges the health and comm rules, its
    decision reaches every rank, and every rank rolls back (or retunes)
    together.  Advisory, except for the package's own errors: a
    rollback that finds no checkpoint directory or no healthy commit
    raises ``HorovodTpuError`` to the caller; anything else warns and
    leaves the commit standing -- unless it is the decision's exchange
    failing on a dead peer (a reset gloo pair, an aborted NCCL
    communicator), which the heartbeat sweep confirms: that is the
    world's failure, raised as the ``RanksDownError`` the elastic driver
    re-forms on, as for any other collective of the step."""
    if not bool(_config.get("autopilot")):
        return
    try:
        from horovod_tpu_torch.runtime import autopilot as _ap

        _ap.rank_tick(state)
    except HorovodTpuError:
        raise
    except Exception as exc:  # noqa: BLE001
        if _basics.state().size > 1:
            down = _confirmed_down(exc)
            if down is not None:
                raise down from exc
        _log.warning(f"autopilot rank tick failed: {exc}")


# ---------------------------------------------------------------------------
# run(): the elastic driver
# ---------------------------------------------------------------------------


def run(*args, **kwargs):
    """``hvd.elastic.run`` — decorator or direct driver.

    Decorator form (Horovod parity)::

        @hvd.elastic.run
        def train(state):
            while state.step < total: ...

        train(state)

    Direct form: ``hvd.elastic.run(state, train_fn, *args, **kwargs)``.

    Either way: runs ``train_fn(state, ...)``; on
    :class:`RanksDownError` the survivors re-form the world at the new
    size, ``state`` is restored from the last commit, and ``train_fn``
    is called again.  A joiner process first blocks for admission and
    enters the loop already resynced."""
    if len(args) == 1 and callable(args[0]) \
            and not isinstance(args[0], ElasticState):
        fn = args[0]

        @functools.wraps(fn)
        def wrapper(state, *a, **k):
            return _run_elastic(state, fn, a, k)

        return wrapper
    if len(args) < 2:
        raise TypeError(
            "hvd.elastic.run takes (train_fn) as a decorator or "
            "(state, train_fn, *args) directly")
    return _run_elastic(args[0], args[1], args[2:], kwargs)


def _confirmed_down(exc: Exception):
    """A collective that failed on a dead peer (gloo: a reset
    connection; NCCL: an aborted communicator) is a death only once the
    heartbeat sweep confirms it: wait up to the heartbeat timeout (plus
    a margin) for the sweep's verdict.  Returns the
    :class:`RanksDownError`, or None when every peer stays alive (the
    failure is the caller's own)."""
    from horovod_tpu_torch.ops import eager as _eager

    hb = float(_config.get("heartbeat_timeout") or 0)
    if hb <= 0 or float(_config.get("heartbeat_interval") or 0) <= 0:
        return None
    deadline = time.monotonic() + hb + max(1.0, hb / 2)
    while time.monotonic() < deadline:
        try:
            _eager.check_liveness()
        except RanksDownError as down:
            _log.warning(f"elastic: {type(exc).__name__} ({exc}) is a "
                         f"dead peer: {down}", rank=_basics.state().rank)
            return down
        time.sleep(0.05)
    return None


def _run_elastic(state: ElasticState, fn, args, kwargs):
    if not enabled():
        raise HorovodTpuError(
            "hvd.elastic.run requires elastic mode (HOROVOD_ELASTIC=1 / "
            "python -m horovod_tpu_torch.run --elastic); see "
            "docs/elastic.md.")
    if not _basics.state().initialized:
        raise HorovodTpuError("hvd.init() must run before hvd.elastic.run")
    _rv()  # fail fast when no rendezvous outlives the generation
    from horovod_tpu_torch.runtime import preemption as _preempt

    if _preempt.enabled():
        _preempt.install_signal_handlers()
    if is_joiner():
        _join(state)
    while True:
        try:
            return fn(state, *args, **kwargs)
        except RanksDownError as exc:
            _down(state, exc)
        except HostsUpdatedInterrupt:
            _reform_with_retry(state, dead=(), reason="grow")
        except _preempt.PreemptionInterrupt as exc:
            _drain(state, exc)
        except Exception as exc:  # noqa: BLE001 -- a dead peer's shapes
            # (a reset gloo pair, an aborted NCCL communicator, torch's
            # group registry cleared under the caller) are confirmed
            # below; anything else is raised as it is
            if isinstance(exc, HorovodTpuError) \
                    or _basics.state().size <= 1:
                raise
            down = _confirmed_down(exc)
            if down is None:
                raise
            _down(state, down)


def _down(state: ElasticState, exc: RanksDownError) -> None:
    _log.warning(
        f"elastic: rank(s) {list(exc.ranks)} down at generation "
        f"{generation()}; re-forming instead of aborting",
        rank=_basics.state().rank)
    _reform_with_retry(state, dead=exc.ranks, reason="failure")


def _reform_with_retry(state: ElasticState, dead, reason: str,
                       attempts: int = 5) -> None:
    """Drive a re-form, retrying when ANOTHER rank dies mid-re-form: a
    RanksDownError raised from inside _reform names dead ranks in the
    CURRENT numbering, so each retry starts over against the current
    world with only the newest dead set.  Bounded: cascading deaths
    eventually hit --min-ranks or exhaust the attempts and fall back to
    restart."""
    for attempt in range(attempts):
        try:
            _reform(state, dead=dead, reason=reason)
            return
        except RanksDownError as exc:
            if attempt + 1 >= attempts:
                raise
            dead = exc.ranks
            reason = "failure"
            _log.warning(
                f"elastic: rank(s) {list(dead)} died during the re-form "
                f"itself; retrying ({attempt + 2}/{attempts})",
                rank=_basics.state().rank)


# ---------------------------------------------------------------------------
# Graceful-preemption drain
# ---------------------------------------------------------------------------


def _drain(state: ElasticState, interrupt) -> None:
    """Notice-driven drain (docs/fault-tolerance.md): every rank raised
    :class:`~horovod_tpu_torch.runtime.preemption.PreemptionInterrupt`
    at the same agreed step boundary, so one emergency snapshot
    (collective, durable when ``checkpoint_dir`` is set) captures the
    CURRENT state.  The noticed rank(s) then exit cleanly (the launcher
    reads their ``el/preempt/u/<uid>`` marker: no blacklist, no death)
    and the survivors re-form proactively, skipping the
    heartbeat-timeout settle cushion."""
    st = _basics.state()
    ranks = sorted(int(r) for r in interrupt.ranks)
    me = st.rank in ranks
    gen = generation()
    _log.warning(
        f"elastic: draining preempted rank(s) {ranks} at generation "
        f"{gen}: emergency commit, then "
        f"{'clean exit' if me else 'proactive re-form'}", rank=st.rank)
    _flight.record("preempt", event="drain_start", gen=gen, ranks=ranks,
                   rank=st.rank, step=int(state.step),
                   deadline=interrupt.order.get("deadline"))
    state._snapshot()
    wall0 = interrupt.order.get("wall")
    drain_s = max(0.0, time.time() - float(wall0)) if wall0 else 0.0
    beat_grace = (interrupt.order.get("deadline") is None
                  or time.time() <= float(interrupt.order["deadline"]))
    _stats["preempt_drains"] += 1
    try:
        from horovod_tpu_torch.runtime import metrics as _metrics

        _metrics.counter(
            "hvd_preempt_drains_total",
            "Emergency preemption drains this process took part "
            "in.").inc()
        _metrics.histogram(
            "hvd_preempt_drain_seconds",
            "Notice received -> emergency commit landed (the drain "
            "must beat HOROVOD_PREEMPT_GRACE_SECONDS).").observe(drain_s)
    except Exception:  # noqa: BLE001
        pass
    _flight.record("preempt", event="drain_commit", gen=gen,
                   step=int(state.step), commit=int(state.commits),
                   drain_s=round(drain_s, 3), beat_grace=beat_grace)
    if me:
        _log.warning(
            f"elastic: rank {st.rank} drained at commit step "
            f"{state.step} ({drain_s:.1f}s after notice); exiting "
            "cleanly for preemption", rank=st.rank)
        _flight.record("preempt", event="drain_exit", gen=gen,
                       rank=st.rank)
        _flight.dump(f"preempt:g{gen}")
        try:
            _basics.shutdown()
            _basics.teardown_distributed()
        except Exception:  # noqa: BLE001
            pass
        raise SystemExit(0)
    _reform_with_retry(state, dead=ranks, reason="preempt")


# ---------------------------------------------------------------------------
# The re-form itself
# ---------------------------------------------------------------------------


def _reform(state: ElasticState, dead=(), reason: str = "failure") -> None:
    """Coordinated generation bump: presence → roster → teardown →
    re-init on the fresh epoch → state resync."""
    st = _basics.state()
    t0 = time.monotonic()
    old_rank, old_size = st.rank, st.size
    gen = st.epoch + 1
    # Dump the OLD generation's ring before teardown scrambles it (the
    # launcher sweeps re-form dumps), then clear it: round numbers and
    # rank identities restart with the new generation.
    _flight.record("elastic", event="reform_start", gen=gen,
                   dead=sorted(int(r) for r in dead), reason=reason,
                   old_rank=old_rank, old_size=old_size)
    _flight.dump(f"reform:g{gen}:{reason}")
    _flight.recorder().clear()
    _flight.record("elastic", event="reform_start", gen=gen,
                   dead=sorted(int(r) for r in dead), reason=reason,
                   old_rank=old_rank, old_size=old_size)
    # Tear the old world down first: a survivor still blocked in a
    # collective with a live peer (gloo waits on a pair the dead rank
    # never fed) sees the peer's connections close and joins the
    # re-form, instead of holding the roster up until its own timeout.
    teardown_s = _teardown()
    t = _rv()
    dead = {int(r) for r in dead}
    uid = _uid()
    t_rv0 = time.monotonic()
    t.set_overwrite(
        f"el/g{gen}/s/{old_rank}",
        json.dumps({"uid": uid, "host": socket.gethostname(),
                    "old_rank": old_rank}))
    expected = sorted(set(range(old_size)) - dead)
    # Effective settle floor: a survivor blocked in a collective
    # notices the death within the heartbeat timeout, so the leader
    # must wait at least that long for stragglers.
    settle = max(float(_config.get("elastic_settle")),
                 float(_config.get("heartbeat_timeout") or 0), 0.5)
    if reason == "preempt":
        # Announced departure: every survivor raised at the SAME agreed
        # drain boundary, so presence skew is one step, not a detection
        # window.
        settle = max(float(_config.get("elastic_settle")), 0.5)
    if expected and old_rank == expected[0]:
        roster = _lead_reform(t, gen, expected, dead, settle, reason)
    else:
        roster = json.loads(_bounded_get(
            t, f"el/g{gen}/roster", settle + 60.0))
        if roster.get("error"):
            raise HorovodTpuError(
                f"elastic re-form to generation {gen} refused: "
                f"{roster['error']}")
    rendezvous_s = time.monotonic() - t_rv0
    mine = next((m for m in roster["members"] if m["uid"] == uid), None)
    if mine is None:
        raise HorovodTpuError(
            f"elastic: this rank (old rank {old_rank}) was dropped from "
            f"generation {roster['gen']} — its presence arrived after "
            "the settle window. A full restart (--restart-attempts) is "
            "the only way back in.")
    phases = _apply_roster(state, roster, mine, teardown_s)
    phases["rendezvous_s"] = round(rendezvous_s, 3)
    dt = time.monotonic() - t0
    _stats["reforms"] += 1
    _stats["last_reform_s"] = round(dt, 2)
    _stats["total_reform_s"] = round(_stats["total_reform_s"] + dt, 2)
    _stats["dead_total"] += len(roster.get("dead") or ())
    _stats["grown_total"] += sum(
        1 for m in roster["members"] if m["old_rank"] < 0)
    _record_reform_metrics(roster, dt)
    _flight.record("elastic", event="reform_done", gen=roster["gen"],
                   size=roster["size"], rank=mine["rank"],
                   dead=sorted(roster.get("dead") or []),
                   reform_s=round(dt, 2), **phases)
    # Goodput ledger: the re-init() booked its own span on the "init"
    # phase, so only the remainder lands on "reform".
    try:
        from horovod_tpu_torch.perf import goodput as _goodput

        _goodput.observe(
            "reform",
            max(0.0, dt - float(phases.get("init_s") or 0.0)),
            split=phases)
    except Exception:  # noqa: BLE001
        pass
    if mine["rank"] == 0:
        try:
            t.set_overwrite("el/status", json.dumps(dict({
                "gen": roster["gen"], "size": roster["size"],
                "dead": roster.get("dead") or [],
                "grown": [m["uid"] for m in roster["members"]
                          if m["old_rank"] < 0],
                "reforms": _stats["reforms"],
                "reform_s": round(dt, 3), "reason": reason}, **phases)))
        except Exception:  # noqa: BLE001 -- observability only
            pass
    _log.warning(
        f"elastic: re-formed generation {roster['gen']} in {dt:.1f}s — "
        f"size {old_size} -> {roster['size']} (rank {old_rank} -> "
        f"{mine['rank']}), dead={sorted(roster.get('dead') or [])}, "
        f"resumed from commit step {state.step}",
        rank=mine["rank"])


def _record_reform_metrics(roster: dict, dt: float) -> None:
    """Mirror re-form statistics into the metrics plane; the
    generation/world gauges were refreshed by the re-init."""
    from horovod_tpu_torch.runtime import metrics as _metrics

    _metrics.counter(
        "hvd_elastic_reforms_total",
        "Elastic re-forms this process survived.").inc()
    _metrics.histogram(
        "hvd_elastic_reform_seconds",
        "Re-form latency: failure caught -> resynced at the new world "
        "size.").observe(dt)
    _metrics.counter(
        "hvd_elastic_dead_ranks_total",
        "Ranks lost across all re-forms.").inc(
            len(roster.get("dead") or ()))
    _metrics.counter(
        "hvd_elastic_joiner_admissions_total",
        "Replacement ranks folded into a roster across all "
        "re-forms.").inc(
            sum(1 for m in roster["members"] if m["old_rank"] < 0))


def _lead_reform(t, gen: int, expected: list, dead: set, settle: float,
                 reason: str) -> dict:
    """Leader (lowest expected survivor): collect presence, fold in
    joiners, publish the roster + joiner admissions."""
    global _held_coord
    deadline = time.monotonic() + settle
    present: dict = {}
    while len(present) < len(expected):
        for r in expected:
            if r not in present:
                v = t.try_get(f"el/g{gen}/s/{r}")
                if v is not None:
                    present[r] = json.loads(v)
        if len(present) >= len(expected) or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    missing = sorted(set(expected) - set(present))
    if missing:
        _log.warning(
            f"elastic: rank(s) {missing} never announced for generation "
            f"{gen} within the {settle:.0f}s settle window; treating "
            "them as dead", rank=expected[0])
    survivors = [(r, present[r]["uid"], present[r]["host"])
                 for r in sorted(present)]
    joiners = scan_joiners(t, advance_cursor=True)
    roster = plan_reform(survivors, joiners)
    min_ranks = max(1, int(_config.get("min_ranks")))
    if roster["size"] < min_ranks:
        err = (f"only {roster['size']} rank(s) would remain, below "
               f"--min-ranks {min_ranks}")
        t.set_overwrite(f"el/g{gen}/roster",
                        json.dumps({"gen": gen, "error": err}))
        raise HorovodTpuError(f"elastic re-form refused: {err}")
    hosts = {m["host"] for m in roster["members"]}
    if len(hosts) > 1:
        from horovod_tpu_torch.common.util import free_port

        coord = f"{socket.gethostname()}:{free_port()}"
    else:
        # the new rank 0 is this process: hold the port until its
        # init() binds the store there
        from horovod_tpu_torch.common.util import reserve_port

        _held_coord, port = reserve_port()
        coord = f"127.0.0.1:{port}"
    roster.update({
        "gen": gen,
        "coord": coord,
        "dead": sorted(dead | set(missing)),
        "reason": reason,
    })
    for m in roster["members"]:
        if m["old_rank"] < 0:
            t.set_overwrite(f"el/admitted/{m['uid']}", str(gen))
    t.set_overwrite(f"el/g{gen}/roster", json.dumps(roster))
    for m in roster["members"]:
        if m["old_rank"] < 0:
            t.set_overwrite(f"el/admit/{m['uid']}",
                            json.dumps({"gen": gen}))
    return roster


def _teardown() -> float:
    """Stop the eager runtime and tear every process group down
    (bounded; a no-op when already down); its wall seconds."""
    t0 = time.monotonic()
    _basics.shutdown()                # background runtime + heartbeats
    _basics.teardown_distributed()
    return time.monotonic() - t0


def _apply_roster(state: ElasticState, roster: dict, mine: dict,
                  teardown_s: float | None = None) -> dict:
    """Everyone: tear the old world down (unless the caller did),
    re-init on the roster's generation (on the same device: a process
    keeps its card), resync state from the new rank 0.  Returns the
    phase split (teardown / init / resync seconds) for the reform_done
    record."""
    global _held_coord
    n, gen = int(roster["size"]), int(roster["gen"])
    st = _basics.state()
    device = st.device
    if teardown_s is None:
        teardown_s = _teardown()
    env = os.environ
    env["HOROVOD_RANK"] = str(mine["rank"])
    env["HOROVOD_SIZE"] = str(n)
    env["HOROVOD_LOCAL_RANK"] = str(mine["local_rank"])
    env["HOROVOD_LOCAL_SIZE"] = str(mine["local_size"])
    env["HOROVOD_CROSS_RANK"] = str(mine["cross_rank"])
    env["HOROVOD_CROSS_SIZE"] = str(mine["cross_size"])
    env["HOROVOD_IS_HOMOGENEOUS"] = "1" if roster["homogeneous"] else "0"
    env["HOROVOD_COORDINATOR_ADDR"] = roster["coord"]
    if env.get("HOROVOD_ELASTIC_JOINER") == "1":
        env["HOROVOD_ELASTIC_JOINER"] = "0"  # admitted: a survivor now
    st.epoch = gen - 1  # init() increments: fresh KV epoch == generation
    t_init = time.monotonic()
    try:
        _basics.init(device=device)
    finally:
        if _held_coord is not None:
            _held_coord.close()
            _held_coord = None
    t_resync = time.monotonic()
    _resync(state)
    return {
        "teardown_s": round(teardown_s, 3),
        "init_s": round(t_resync - t_init, 3),
        "resync_s": round(time.monotonic() - t_resync, 3),
    }


def _resync(state: ElasticState) -> None:
    """Broadcast the commit snapshot from the new rank 0 (the lowest
    surviving old rank — survivors all hold the same commit, but one
    authoritative copy keeps joiners and any raced commit honest), then
    restore device state from it at the new world size."""
    from horovod_tpu_torch.optim.distributed import broadcast_object

    snap = state._commit
    if _basics.size() > 1:
        payload = snap if _basics.rank() == 0 else None
        snap = broadcast_object(payload, root_rank=0)
    if snap is None:
        raise HorovodTpuError(
            "elastic re-form without a committed state: call "
            "ElasticState.commit() before failures can be survived.")
    state._commit = snap
    state.restore()


# ---------------------------------------------------------------------------
# Commit boundary: grow admission
# ---------------------------------------------------------------------------


# (generation, count) of the values rank 0 shared with share_from_rank0
_shared = [0, 0]


def share_from_rank0(value):
    """Rank 0's ``value`` (JSON data) on every rank of the world, over the
    rendezvous KV: rank 0 publishes it under a key of this generation's
    n-th call and returns at once; every other rank waits for the key
    with the commit boundary's liveness-checked wait, so a dead peer
    raises :class:`RanksDownError` within the heartbeat timeout.  (A gloo
    collective whose root has left on a dead peer instead waits out the
    gloo op timeout, past the re-form's settle window.)  Call it at the
    same loop points on every rank."""
    st = _basics.state()
    gen = generation()
    if _shared[0] != gen:
        _shared[:] = [gen, 0]
    _shared[1] += 1
    n = _shared[1]
    t = _rv()
    if st.rank == 0:
        t.set_overwrite(f"el/share/g{gen}/{n}", json.dumps(value))
        if n > 2:
            # every rank read n - 2 before its step n - 1 collectives,
            # which rank 0's step n - 1 completed against
            t.delete(f"el/share/g{gen}/{n - 2}")
        return value
    from horovod_tpu_torch.runtime.controller import wire_timeout

    return json.loads(_bounded_get(t, f"el/share/g{gen}/{n}",
                                   wire_timeout(), liveness=True))


# (generation, count) of this process's commit boundaries
_boundaries = [0, 0]


def _boundary_key(gen: int, n: int) -> str:
    return f"el/c/g{gen}/{n}"


def _commit_boundary(state: ElasticState) -> None:
    """All ranks agree — via rank 0's verdict for THIS boundary — whether
    pending joiners trigger a grow re-form now.  The per-boundary key
    makes the decision deterministic across ranks: without it, two ranks
    could observe the join registry around different commits and re-form
    one step apart, deadlocking the stragglers.

    The key counts boundaries within the generation (every rank passes
    one per ``commit()``), not ``state.commits``: a rollback or restore
    rewinds ``commits``, and a peer keyed by it could read the verdict of
    an earlier boundary -- a stale "grow" -- before rank 0 overwrote it,
    and raise alone.  A joiner enters at a new generation, where every
    count starts at 0; a restart attempt gets a fresh rendezvous
    server."""
    if not enabled():
        return
    st = _basics.state()
    if not st.initialized:
        return
    t = _rv()
    gen = generation()
    prev = None
    if _boundaries[0] != gen:
        prev = list(_boundaries)
        _boundaries[:] = [gen, 0]
    _boundaries[1] += 1
    n = _boundaries[1]
    c = state.commits
    if st.rank == 0:
        target = int(os.environ.get("HOROVOD_ELASTIC_NP", "0") or 0)
        joiners = scan_joiners(t, advance_cursor=True) \
            if (target <= 0 or st.size < target) else []
        t.set_overwrite(_boundary_key(gen, n), "grow" if joiners else "ok")
        if n > 2:
            t.delete(_boundary_key(gen, n - 2))
        elif prev is not None and prev[0]:
            # every rank left the old generation before this one formed
            pg, pn = prev
            for k in range(max(pn - 1, 1), pn + 1):
                t.delete(_boundary_key(pg, k))
        grow = bool(joiners)
    else:
        from horovod_tpu_torch.runtime.controller import wire_timeout

        grow = _bounded_get(t, _boundary_key(gen, n), wire_timeout(),
                            liveness=True) == "grow"
    if grow:
        _log.info(
            f"elastic: joiner(s) pending at commit {c}; growing the "
            f"world (generation {generation()} -> {generation() + 1})",
            rank=st.rank)
        # Raise instead of re-forming inline: run() re-enters train_fn
        # from this commit on EVERY rank, so survivors and the admitted
        # joiner restart their loops at the same point.
        raise HostsUpdatedInterrupt(
            f"joiners admitted at commit {c}")


# ---------------------------------------------------------------------------
# Joiner admission
# ---------------------------------------------------------------------------


def _join(state: ElasticState) -> None:
    """Replacement-process path: register on the rendezvous, block until
    a commit boundary admits us into a generation, then enter that
    world resynced.  On timeout the registration is RETRACTED (via the
    same ``el/admitted`` mark the leader uses to consume it) before
    failing — a later grow re-form must never fold a ghost joiner into
    the roster and hang every survivor's re-init on it."""
    t = _rv()
    uid = _uid()
    register_join(t, uid, socket.gethostname())
    _log.info(f"elastic: joiner {uid} registered; waiting for admission "
              "at the next commit boundary", rank=_basics.state().rank)
    timeout = max(float(_config.get("elastic_join_timeout")), 1.0)
    try:
        admit = json.loads(_bounded_get(t, f"el/admit/{uid}", timeout))
    except TimeoutError:
        try:
            t.set_overwrite(f"el/admitted/{uid}", "timeout")
        except Exception:  # noqa: BLE001
            pass
        raise HorovodTpuError(
            f"elastic: joiner {uid} was not admitted within "
            f"HOROVOD_ELASTIC_JOIN_TIMEOUT_SECONDS={timeout:.0f}s — the "
            "survivors' commit cadence must be shorter than this "
            "deadline; registration retracted.")
    gen = int(admit["gen"])
    roster = json.loads(_bounded_get(t, f"el/g{gen}/roster", 60.0))
    mine = next(m for m in roster["members"] if m["uid"] == uid)
    _flight.record("elastic", event="joiner_admitted", gen=gen,
                   rank=mine["rank"], size=roster["size"])
    _apply_roster(state, roster, mine)
    _log.warning(
        f"elastic: joiner {uid} admitted as rank {mine['rank']} of "
        f"{roster['size']} (generation {gen}), resynced at commit step "
        f"{state.step}", rank=mine["rank"])
