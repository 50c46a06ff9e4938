"""Deterministic in-process fleet simulator (docs/control-plane.md;
this package's copy of ``horovod_tpu/runtime/simfleet.py``: the same
scenarios, signatures and outputs).

No card run reaches 1024 ranks, so the scaling claims of the
hierarchical control plane are proven on the host instead: hundreds of
simulated ranks, each a cooperative thread driving a **real**
:class:`~horovod_tpu_torch.runtime.controller.KVController` (not a
mock) over a simulated KV wire, through negotiation rounds, elastic
re-form storms, and coordinated aborts at 256–4096 ranks.

Determinism contract: same ``(world, fanout, seed, fault_spec)`` →
identical round trace, down to per-store message counts and simulated
latencies.  The trick is that nothing *observed* depends on thread
interleaving:

* The simulated stores count only **charged** ops — writes, deletes,
  and *successful* reads (the one observation that resolves a waiter
  or a fair-poll slot).  Poll misses are free: their count varies with
  scheduling, the set of charged ops does not.
* Per-op charges are attributed to the negotiation round parsed from
  the key (:func:`horovod_tpu_torch.runtime.faults.round_of`), so no
  barrier between rounds is needed — threads may run ahead.
* Simulated round latency is computed *analytically* from the charged
  counts (hop depth × RTT + store service time × queue length +
  injected virtual delays + seeded jitter), never from wall clocks.
* Fault injection rides the ``HOROVOD_FAULT_SPEC`` grammar
  (:mod:`horovod_tpu_torch.runtime.faults`) with simulation semantics:
  ``delay`` and ``slow`` charge virtual seconds to the acting rank
  instead of sleeping, ``drop`` swallows writes, ``die`` raises
  :class:`SimRankDied` in the rank's thread instead of ``os._exit``,
  and ``preempt`` records an advance notice in ``fleet.preempted``
  (the rank keeps negotiating — a noticed rank drains gracefully, it
  does not crash).

The coordinated-abort scenario is the one deliberate exception: it
exercises the *real* heartbeat sweep / abort broadcast machinery,
which is wall-clock based — its assertion is "every survivor raises
RanksDownError naming the victim", not a bit-exact trace.

The rollback drill's pseudo-trainer keeps its float64 parameters in a
tensor on ``device`` (the card unless the caller names another); its
update is two elementwise ops, so the final parameters are the same
bits on every device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import random
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common.types import RanksDownError, dtype_code
from horovod_tpu_torch.runtime import faults as _faults
from horovod_tpu_torch.runtime.controller import (KVController, Request,
                                                  control_topology)

_F32 = dtype_code(torch.float32)


class SimRankDied(Exception):
    """A ``die:`` fault rule fired for this simulated rank — the sim
    analog of ``os._exit(137)``: the rank's thread unwinds and stops
    participating (its heartbeat freezes, crash-style)."""


class SimStore:
    """One simulated KV server: dict + condition variable, counting
    charged ops per negotiation round.  ``set_once`` mirrors the real
    stores' at-most-once semantics (an existing key wins silently);
    plain ``set`` refuses overwrites (stricter than the card's wire,
    whose torch store overwrites silently: a key the controller writes
    twice shows here), ``overwrite=True`` is the heartbeat path."""

    def __init__(self, name: str):
        self.name = name
        self._kv: dict[str, str] = {}
        self._cv = threading.Condition()
        # round (None = non-round keys: hb, abort) -> op -> count
        self._ops: dict[int | None, dict[str, int]] = {}
        self.total_ops = 0

    def _charge(self, op: str, key: str) -> None:
        rnd = _faults.round_of(_faults.strip_epoch(key))
        per = self._ops.setdefault(rnd, {})
        per[op] = per.get(op, 0) + 1
        self.total_ops += 1

    def set(self, key: str, value: str, overwrite: bool = False,
            once: bool = False) -> None:
        with self._cv:
            if key in self._kv and not overwrite:
                if once:
                    return
                raise KeyError(f"sim kv: {key} already exists")
            self._kv[key] = value
            self._charge("set", key)
            self._cv.notify_all()

    def get_blocking(self, key: str, timeout_s: float) -> str:
        with self._cv:
            deadline = time.monotonic() + timeout_s
            while key not in self._kv:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"sim kv: {key}")
                self._cv.wait(remaining)
            self._charge("get", key)
            return self._kv[key]

    def try_get(self, key: str):
        with self._cv:
            value = self._kv.get(key)
            if value is not None:
                # Only the successful observation is charged: the poll
                # *misses* leading up to it vary with thread timing,
                # the observations do not.
                self._charge("get", key)
            return value

    def delete(self, key: str) -> None:
        with self._cv:
            self._kv.pop(key, None)
            self._charge("delete", key)

    def ops_for_round(self, rnd: int) -> int:
        with self._cv:
            return sum(self._ops.get(rnd, {}).values())

    def ops_by_round(self) -> dict:
        with self._cv:
            return {r: dict(v) for r, v in self._ops.items()}


class SimTransport:
    """Per-rank transport routing controller keys to the fleet's
    stores and applying this rank's fault rules.  Matches the
    controller-facing surface of the real transports (``set`` /
    ``set_once`` / ``set_overwrite`` / ``get_blocking`` / ``try_get``
    / ``delete``)."""

    def __init__(self, fleet: "SimFleet", rank: int):
        self.fleet = fleet
        self.rank = rank
        # Per-rank rule state, like each real process parsing its own
        # env: drop budgets and die triggers are scoped to this rank.
        self._rules = _faults.parse_spec(fleet.fault_spec) \
            if fleet.fault_spec else []

    def _fault(self, key: str, write: bool) -> bool:
        """Apply die/delay/drop rules to one charged op on (stripped)
        ``key``; returns True when a drop rule swallowed a write."""
        stripped = _faults.strip_epoch(key)
        rnd = _faults.round_of(stripped)
        for rule in self._rules:
            if rule.kind == "die" and rule.rank == self.rank \
                    and rnd is not None and rnd >= rule.round \
                    and rule.take():
                raise SimRankDied(
                    f"rank {self.rank} died at round {rnd} ({stripped})")
            if rule.kind == "preempt" and rule.rank == self.rank \
                    and rnd is not None and rnd >= rule.round \
                    and rule.take():
                # Advance notice, not a death: record it and keep
                # going.  Deterministic because the rank's own charged
                # ops happen in program order within its thread.
                self.fleet.preempted.setdefault(self.rank, rnd)
        import fnmatch

        for rule in self._rules:
            if rule.kind == "slow":
                # Chronic straggler: every charged op of the scoped
                # rank pays the virtual tax, key-independent.
                if rule.rank == self.rank:
                    self.fleet.charge_delay(self.rank, rnd, rule.delay_s)
                continue
            if rule.only_rank not in (-1, self.rank):
                continue
            if rule.kind == "delay" \
                    and fnmatch.fnmatch(stripped, rule.pattern):
                # Virtual time, not a sleep: the charge feeds the
                # analytic latency model deterministically.
                self.fleet.charge_delay(self.rank, rnd, rule.delay_s)
            elif write and rule.kind == "drop" \
                    and fnmatch.fnmatch(stripped, rule.pattern) \
                    and rule.take():
                return True
        return False

    def set(self, key: str, value: str) -> None:
        if not self._fault(key, write=True):
            self.fleet.store_for(key).set(key, value)

    def set_once(self, key: str, value: str) -> None:
        if not self._fault(key, write=True):
            self.fleet.store_for(key).set(key, value, once=True)

    def set_overwrite(self, key: str, value: str) -> None:
        if not self._fault(key, write=True):
            self.fleet.store_for(key).set(key, value, overwrite=True)

    def get_blocking(self, key: str, timeout_s: float) -> str:
        self._fault(key, write=False)
        return self.fleet.store_for(key).get_blocking(key, timeout_s)

    def try_get(self, key: str):
        # No fault hook here: try_get is the *polled* op — a die/delay
        # applied per poll would fire a scheduling-dependent number of
        # times and break the determinism contract.  die rules still
        # trigger on the poller's own writes/blocking gets.
        return self.fleet.store_for(key).try_get(key)

    def delete(self, key: str) -> None:
        self._fault(key, write=True)
        self.fleet.store_for(key).delete(key)


@dataclass
class LatencyModel:
    """Analytic wire model: round-trip times, per-message store
    service time, and a seeded jitter amplitude.

    ``ici_rtt_ms``/``dcn_rtt_ms`` split the round trip by hop kind —
    intra-slice (slice store, the ICI analog) vs cross-slice (root
    store, the DCN analog) — so regimes that trade DCN rounds for ICI
    rounds (local-SGD, docs/local-sgd.md) price out honestly.  Both
    default to the legacy single ``rtt_ms``, so every pre-split
    construction (``LatencyModel(rtt_ms=...)``) keeps its exact
    numbers."""

    rtt_ms: float = 0.5
    per_msg_ms: float = 0.02
    jitter_ms: float = 0.2
    ici_rtt_ms: float | None = None
    dcn_rtt_ms: float | None = None

    def ici(self) -> float:
        return self.rtt_ms if self.ici_rtt_ms is None \
            else self.ici_rtt_ms

    def dcn(self) -> float:
        return self.rtt_ms if self.dcn_rtt_ms is None \
            else self.dcn_rtt_ms


@dataclass
class RoundTrace:
    round: int
    digest: str            # agreed NegotiationResult digest, all ranks
    root_ops: int          # charged ops at the root store this round
    slice_ops_max: int     # busiest slice store (0 in flat mode)
    latency_ms: float      # simulated, analytic

    def to_dict(self) -> dict:
        return {"round": self.round, "digest": self.digest,
                "root_ops": self.root_ops,
                "slice_ops_max": self.slice_ops_max,
                "latency_ms": round(self.latency_ms, 4)}


def default_requests(rnd: int, rank: int) -> list:
    """Two small allreduces per round, identical on every rank — the
    steady-state gradient-push shape.  Round 0 negotiates slow, later
    rounds resolve via the cache bitvector fast path, so both
    coordinator paths are exercised."""
    return [Request(f"sim_g{i}", "allreduce", 2, _F32, (4,))
            for i in range(2)]


def _digest(result) -> str:
    blob = json.dumps(
        {"resp": [p.wire() for p in result.responses],
         "aj": result.all_joined, "lj": result.last_joined,
         "x": result.should_stop}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class SimFleet:
    """``world`` simulated ranks over a simulated KV wire, driving
    real KVControllers.  ``fanout=0`` forces flat mode; ``fanout>=2``
    with ``world > fanout`` builds the hierarchical plane (the same
    :func:`control_topology` the real controller uses)."""

    def __init__(self, world: int, fanout: int = 0, seed: int = 0,
                 fault_spec: str | None = None,
                 latency: LatencyModel | None = None,
                 hb_interval: float = 0.0, hb_timeout: float = 0.0,
                 wire_timeout_s: float = 60.0, epoch: int = 0):
        self.world = world
        self.fanout = fanout
        self.seed = seed
        self.fault_spec = (str(_config.get("fault_spec"))
                           if fault_spec is None else fault_spec)
        self.latency = latency or LatencyModel()
        self.hb_interval = hb_interval
        self.hb_timeout = hb_timeout
        self.wire_timeout_s = wire_timeout_s
        self.epoch = epoch
        self.topo = control_topology(world, fanout)
        self.root = SimStore("root")
        self.slices = ([SimStore(f"slice{s}")
                        for s in range(self.topo.n_slices)]
                       if self.topo is not None else [])
        self._delay_lock = threading.Lock()
        # round -> rank -> accumulated virtual delay seconds
        self._delays: dict[int | None, dict[int, float]] = {}
        self.dead: set[int] = set()
        # rank -> round its preempt: notice was delivered (the sim
        # analog of runtime/preemption.notice — the rank stays alive).
        self.preempted: dict[int, int] = {}
        self.errors: dict[int, BaseException] = {}
        # Ranks that observed a coordinated abort as an error
        # ResponseList (the fan-down path) rather than an exception.
        self.abort_stops: set[int] = set()

    # -- wiring ------------------------------------------------------------

    def store_for(self, key: str) -> SimStore:
        """Slice-scoped keys (sq/sp/sk, member heartbeats) live on
        their slice's store; everything else (q/p/k, gq, abort, rank
        0's beat) on the root store — so the root counter measures
        exactly the traffic a real root rendezvous server would
        serve."""
        if self.topo is None:
            return self.root
        parts = _faults.strip_epoch(key).split("/")
        if parts[0] in ("sq", "sp", "sk") and len(parts) >= 2 \
                and parts[1].isdigit():
            return self.slices[int(parts[1])]
        if parts[0] == "hb" and len(parts) >= 2 and parts[1].isdigit():
            rank = int(parts[1])
            if rank != 0:
                return self.slices[self.topo.slice_of(rank)]
        return self.root

    def charge_delay(self, rank: int, rnd: int | None,
                     delay_s: float) -> None:
        with self._delay_lock:
            per = self._delays.setdefault(rnd, {})
            per[rank] = per.get(rank, 0.0) + delay_s

    def rank_delays(self, rnd: int | None) -> dict[int, float]:
        """Accumulated virtual delay seconds per rank for one round —
        the coordinator-clock lateness signal the autopilot's
        straggler rule consumes."""
        with self._delay_lock:
            return dict(self._delays.get(rnd, {}))

    def make_controller(self, rank: int) -> KVController:
        ctl = KVController(SimTransport(self, rank), rank, self.world,
                           epoch=self.epoch, fanout=self.fanout)
        # Sim-scoped overrides, attr-level so no env/config mutation
        # leaks between fleets living in one process.
        ctl._timeout = self.wire_timeout_s
        ctl._hb_interval = self.hb_interval
        ctl._hb_timeout = self.hb_timeout
        return ctl

    # -- scenarios ---------------------------------------------------------

    def _rank_main(self, rank: int, n_rounds: int, requests_fn,
                   digests: list, heartbeats: bool) -> None:
        ctl = self.make_controller(rank)
        if heartbeats:
            ctl.start_heartbeat()
        try:
            for r in range(n_rounds):
                res = ctl.negotiate(requests_fn(r, rank), False, False)
                digests[rank].append(_digest(res))
                if res.should_stop:
                    if any(p.kind == "error" and p.error
                           and RanksDownError.WIRE_PREFIX in p.error
                           for p in res.responses):
                        self.abort_stops.add(rank)
                    break
        except SimRankDied:
            self.dead.add(rank)
            # Crash-style: freeze the beat (stop publishing, do NOT
            # delete the key) so peers observe staleness, exactly like
            # a SIGKILLed process.
            hb = ctl._heartbeat
            if hb is not None:
                hb._stop.set()
            return
        except BaseException as exc:  # timeout, RanksDownError, ...
            self.errors[rank] = exc
            hb = ctl._heartbeat
            if hb is not None:
                hb._stop.set()
            return
        if heartbeats:
            ctl.close()

    def run_rounds(self, n_rounds: int, requests_fn=None,
                   heartbeats: bool = False) -> list[RoundTrace]:
        """Drive every rank through ``n_rounds`` negotiations; returns
        the deterministic per-round trace.  Raises if any rank failed
        for a reason other than a scripted death."""
        requests_fn = requests_fn or default_requests
        digests: list[list[str]] = [[] for _ in range(self.world)]
        old_stack = threading.stack_size(512 * 1024)
        try:
            threads = [
                threading.Thread(
                    target=self._rank_main,
                    args=(rank, n_rounds, requests_fn, digests,
                          heartbeats),
                    name=f"sim-rank-{rank}", daemon=True)
                for rank in range(self.world)]
            for t in threads:
                t.start()
        finally:
            threading.stack_size(old_stack)
        for t in threads:
            t.join()
        return self._traces(n_rounds, digests)

    def _traces(self, n_rounds: int,
                digests: list[list[str]]) -> list[RoundTrace]:
        lm = self.latency
        # q↑p↓ on the root (DCN) flat; sq↑sp↓ intra-slice (ICI) +
        # gq↑p↓ on the root (DCN) hierarchical.  With the legacy
        # single-rtt model both spellings reduce to hops * rtt_ms.
        base_rtt = (2 * lm.dcn() if self.topo is None
                    else 2 * lm.ici() + 2 * lm.dcn())
        out: list[RoundTrace] = []
        for r in range(n_rounds):
            per_rank = {d[r] for rank, d in enumerate(digests)
                        if rank not in self.dead and len(d) > r}
            if not per_rank:
                break
            if len(per_rank) > 1:
                raise AssertionError(
                    f"round {r}: ranks disagree on the negotiated "
                    f"result ({sorted(per_rank)})")
            root_ops = self.root.ops_for_round(r)
            slice_ops = max((s.ops_for_round(r) for s in self.slices),
                            default=0)
            with self._delay_lock:
                inj = max(self._delays.get(r, {}).values(), default=0.0)
            jitter = random.Random(
                (self.seed << 20) ^ r).random() * lm.jitter_ms
            latency = (base_rtt
                       + (root_ops + slice_ops) * lm.per_msg_ms
                       + inj * 1000.0 + jitter)
            out.append(RoundTrace(r, per_rank.pop(), root_ops,
                                  slice_ops, latency))
        return out


# ---------------------------------------------------------------------------
# Canned scenarios (ci.sh `simfleet` stage, bench --sim-ranks, docs recipe)
# ---------------------------------------------------------------------------


def measure_scaling(world: int = 1024, fanout: int = 32,
                    rounds: int = 4, seed: int = 0) -> dict:
    """Root-store messages per steady-state round, flat vs
    hierarchical — the CI scaling assertion's data source.  The
    steady-state figure is the last round's (GC active, cache fast
    path warm)."""
    flat = SimFleet(world, fanout=0, seed=seed).run_rounds(rounds)
    hier = SimFleet(world, fanout=fanout, seed=seed).run_rounds(rounds)
    flat_ops = flat[-1].root_ops
    hier_ops = hier[-1].root_ops
    return {
        "world": world, "fanout": fanout, "rounds": rounds,
        "flat_root_ops_per_round": flat_ops,
        "hier_root_ops_per_round": hier_ops,
        "ratio": round(flat_ops / max(hier_ops, 1), 2),
        "flat_latency_ms": [t.to_dict()["latency_ms"] for t in flat],
        "hier_latency_ms": [t.to_dict()["latency_ms"] for t in hier],
    }


def local_sgd_scaling(world: int = 256, fanout: int = 16, h: int = 4,
                      windows: int = 2, seed: int = 0) -> dict:
    """Cross-slice round economy of the local-SGD regime
    (docs/local-sgd.md) at fleet scale: the synchronous fleet
    negotiates a cross-slice gradient round EVERY step, while a
    local-SGD fleet's inner steps are compiled intra-slice reductions
    that never touch the negotiated cross-slice wire — only every
    H-th step's outer pseudo-gradient sync does.  Simulates
    ``windows * h`` training steps both ways over the REAL controller
    with the split ICI/DCN latency model and reports the >= H× round
    reduction.  Deterministic: same inputs → byte-identical dict."""
    h = max(int(h), 2)
    steps = windows * h
    lm = LatencyModel(ici_rtt_ms=0.05, dcn_rtt_ms=2.5)
    sync = SimFleet(world, fanout=fanout, seed=seed,
                    latency=lm).run_rounds(steps)

    def outer_requests(rnd: int, rank: int) -> list:
        # The outer sync's negotiated shape: pseudo-gradient
        # allreduces under the cross-scope name contract
        # (controller.reduction_scope).
        return [Request(f"localsgd.cross.sim_g{i}", "allreduce", 2,
                        _F32, (4,)) for i in range(2)]

    outer = SimFleet(world, fanout=fanout, seed=seed,
                     latency=lm).run_rounds(windows,
                                            requests_fn=outer_requests)
    # Inner steps price at the ICI hop only — no negotiated round.
    inner_ms = 2 * lm.ici()
    sync_wall = sum(t.latency_ms for t in sync)
    lsgd_wall = sum(t.latency_ms for t in outer) + steps * inner_ms
    return {
        "world": world, "fanout": fanout, "h": h, "steps": steps,
        "ici_rtt_ms": lm.ici(), "dcn_rtt_ms": lm.dcn(),
        "sync_cross_rounds": len(sync),
        "localsgd_cross_rounds": len(outer),
        "cross_round_ratio": round(len(sync) / max(len(outer), 1), 2),
        "sync_wall_ms": round(sync_wall, 4),
        "localsgd_wall_ms": round(lsgd_wall, 4),
        "outer_trace": [t.to_dict() for t in outer],
    }


def reform_storm(world: int = 256, fanout: int = 16,
                 kill: int = 8, pre_rounds: int = 3,
                 post_rounds: int = 3, seed: int = 0) -> dict:
    """Elastic re-form storm: run ``pre_rounds`` at full strength,
    kill ``kill`` ranks simultaneously (scattered across slices, rank
    0's slice included), re-form the roster through the REAL
    :func:`horovod_tpu_torch.elastic.plan_reform`, and run the survivor
    fleet.  Returns the plan + both traces; the roster must come out
    dense and deterministic."""
    from horovod_tpu_torch.elastic import plan_reform

    fleet = SimFleet(world, fanout=fanout, seed=seed)
    pre = fleet.run_rounds(pre_rounds)
    stride = max(world // kill, 1)
    victims = sorted((1 + i * stride) % world for i in range(kill))
    hosts_of = (fleet.topo.slice_of if fleet.topo is not None
                else lambda r: r // 8)
    survivors = [(r, f"uid-{r:04d}", f"host-{hosts_of(r)}")
                 for r in range(world) if r not in set(victims)]
    plan = plan_reform(survivors, [])
    new_ranks = sorted(m["rank"] for m in plan["members"])
    if new_ranks != list(range(len(survivors))):
        raise AssertionError(f"re-formed roster not dense: {new_ranks}")
    post_fleet = SimFleet(plan["size"], fanout=fanout, seed=seed,
                          epoch=1)
    post = post_fleet.run_rounds(post_rounds)
    return {
        "world": world, "victims": victims, "new_world": plan["size"],
        "roster_digest": hashlib.sha256(json.dumps(
            plan["members"], sort_keys=True).encode()).hexdigest()[:16],
        "pre": [t.to_dict() for t in pre],
        "post": [t.to_dict() for t in post],
    }


def coordinated_abort(world: int = 32, fanout: int = 8,
                      victim: int = 5, seed: int = 0) -> dict:
    """Kill one rank mid-negotiation (``die:`` rule) with real
    heartbeats at sim-scale intervals; every survivor must observe
    the coordinated abort and raise RanksDownError naming the victim.
    Wall-clock based by design — excluded from determinism traces."""
    fleet = SimFleet(world, fanout=fanout, seed=seed,
                     fault_spec=f"die:rank{victim}:round1",
                     hb_interval=0.05, hb_timeout=1.0,
                     wire_timeout_s=30.0)
    fleet.run_rounds(3, heartbeats=True)
    survivors = [r for r in range(world) if r != victim]
    raised = [r for r in survivors
              if isinstance(fleet.errors.get(r), RanksDownError)]
    naming = [r for r in raised
              if victim in (fleet.errors[r].ranks or [])]
    # A survivor observes the abort either as a raised RanksDownError
    # or as the broadcast error ResponseList (should_stop fan-down).
    observed = set(raised) | fleet.abort_stops
    return {
        "world": world, "victim": victim,
        "died": sorted(fleet.dead),
        "survivors_aborted": len(observed),
        "survivors_raised": len(raised),
        "survivors_naming_victim": len(naming),
        "survivors_total": len(survivors),
    }


def straggler_drill(world: int = 256, fanout: int = 16,
                    straggler: int = 3, delay: str = "200ms",
                    rounds: int = 4, post_rounds: int = 2,
                    seed: int = 0, dry_run: bool = False) -> dict:
    """Autopilot drill (docs/autopilot.md): a chronic straggler
    (``slow:`` rule) accumulates virtual lateness round after round;
    the preemptive-blacklist rule must trip on the sustained breach
    and shed the host BEFORE any rank dies — the whole point of acting
    on lateness instead of on death.  The shrink re-forms the roster
    through the real :func:`horovod_tpu_torch.elastic.plan_reform`.
    Deterministic: same (world, fanout, seed, delay) → byte-identical
    output, actions included (the engine runs on the virtual round
    clock)."""
    from horovod_tpu_torch.elastic import plan_reform
    from horovod_tpu_torch.runtime import autopilot as _autopilot

    fleet = SimFleet(world, fanout=fanout, seed=seed,
                     fault_spec=f"slow:{straggler}:{delay}")
    pre = fleet.run_rounds(rounds)
    hosts = {r: f"host-{r:04d}" for r in range(world)}
    blacklisted: list[str] = []
    ap = _autopilot.Autopilot(
        dry_run=dry_run, clock=lambda: 0.0,
        cooldown_s=float(rounds), rate_limit=4, rate_window_s=3600.0,
        trip_ticks=2, straggler_factor=4.0, straggler_floor_s=0.05,
        burn_threshold=2.0, comm_fraction=0.25,
        actuators={
            "straggler_blacklist": lambda a: blacklisted.append(
                a.target)})
    for r in range(rounds):
        delays = fleet.rank_delays(r)
        lateness = {k: delays.get(k, 0.0) for k in range(world)}
        ap.observe_stragglers(lateness, hosts=hosts, now=float(r))
    if fleet.dead:
        raise AssertionError(
            f"slow: rule must never kill a rank, got {fleet.dead}")
    survivors = [(r, f"uid-{r:04d}", hosts[r]) for r in range(world)
                 if hosts[r] not in blacklisted]
    plan = plan_reform(survivors, [])
    post_fleet = SimFleet(plan["size"], fanout=fanout, seed=seed,
                          epoch=1)
    post = post_fleet.run_rounds(post_rounds)
    return {
        "world": world, "straggler": straggler, "delay": delay,
        "dry_run": dry_run,
        "straggler_lateness_s": [
            round(fleet.rank_delays(r).get(straggler, 0.0), 6)
            for r in range(rounds)],
        "actions": [a.to_dict() for a in ap.actions],
        "blacklisted": blacklisted,
        "deaths": sorted(fleet.dead),
        "world_after": plan["size"],
        "roster_digest": hashlib.sha256(json.dumps(
            plan["members"], sort_keys=True).encode()).hexdigest()[:16],
        "pre_latency_ms": [t.to_dict()["latency_ms"] for t in pre],
        "post_latency_ms": [t.to_dict()["latency_ms"] for t in post],
    }


def preempt_storm(world: int = 256, fanout: int = 16, kill: int = 8,
                  rounds: int = 4, post_rounds: int = 2, seed: int = 0,
                  dry_run: bool = False) -> dict:
    """Autopilot drill (docs/fault-tolerance.md): ``kill`` ranks
    scattered across slices receive advance preemption notices
    (``preempt:`` rules) mid-run.  None of them may die and none of
    their hosts may be blacklisted — an announced departure is not a
    fault — instead the autopilot's ungated ``preempt_drain`` rule
    fires once per notice and the fleet sheds the noticed ranks
    proactively through the real
    :func:`horovod_tpu_torch.elastic.plan_reform`.  Deterministic: same
    (world, fanout, kill, seed) → byte-identical output, actions and
    roster digest included."""
    from horovod_tpu_torch.elastic import plan_reform
    from horovod_tpu_torch.runtime import autopilot as _autopilot

    stride = max(world // max(kill, 1), 1)
    victims = sorted({(1 + i * stride) % world for i in range(kill)}
                     - {0})
    spec = ",".join(f"preempt:rank{v}:round1" for v in victims)
    fleet = SimFleet(world, fanout=fanout, seed=seed, fault_spec=spec)
    pre = fleet.run_rounds(rounds)
    if fleet.dead:
        raise AssertionError(
            f"preempt: rule must never kill a rank, got {fleet.dead}")
    if sorted(fleet.preempted) != victims:
        raise AssertionError(
            f"notices {sorted(fleet.preempted)} != victims {victims}")
    hosts = {r: f"host-{r:04d}" for r in range(world)}
    drained: list[int] = []
    ap = _autopilot.Autopilot(
        dry_run=dry_run, clock=lambda: 0.0,
        cooldown_s=3600.0, rate_limit=1, rate_window_s=3600.0,
        trip_ticks=2, straggler_factor=4.0, straggler_floor_s=0.05,
        burn_threshold=2.0, comm_fraction=0.25,
        actuators={"preempt_drain": lambda a: drained.append(
            int(a.target[len("rank"):]))})
    # Punitive cooldown/rate-limit settings above are the point of the
    # drill: preempt_drain is ungated, so every notice must still land.
    for v in victims:
        ap.observe_preemption(
            v, host=hosts[v], source="fault",
            now=float(fleet.preempted[v]))
    if not dry_run and sorted(drained) != victims:
        raise AssertionError(
            f"drained {sorted(drained)} != victims {victims}")
    shed = set(drained)
    survivors = [(r, f"uid-{r:04d}", hosts[r]) for r in range(world)
                 if r not in shed]
    plan = plan_reform(survivors, [])
    new_ranks = sorted(m["rank"] for m in plan["members"])
    if new_ranks != list(range(len(survivors))):
        raise AssertionError(f"re-formed roster not dense: {new_ranks}")
    post_fleet = SimFleet(plan["size"], fanout=fanout, seed=seed,
                          epoch=1)
    post = post_fleet.run_rounds(post_rounds)
    return {
        "world": world, "kill": kill, "victims": victims,
        "dry_run": dry_run, "fault_spec": spec,
        "notices": {str(r): fleet.preempted[r]
                    for r in sorted(fleet.preempted)},
        "actions": [a.to_dict() for a in ap.actions],
        "drained": sorted(drained),
        # The no-blacklist invariant: announced departures shed, their
        # (healthy) hosts stay eligible for re-join.
        "blacklisted": [],
        "deaths": sorted(fleet.dead),
        "world_after": plan["size"],
        "roster_digest": hashlib.sha256(json.dumps(
            plan["members"], sort_keys=True).encode()).hexdigest()[:16],
        "pre_latency_ms": [t.to_dict()["latency_ms"] for t in pre],
        "post_latency_ms": [t.to_dict()["latency_ms"] for t in post],
    }


def slo_burn_drill(world: int = 8, victim: int = 2, slo: float = 0.9,
                   ticks: int = 12, degrade_at: int = 3,
                   recover_at: int = 7, seed: int = 0,
                   dry_run: bool = False) -> dict:
    """Autopilot drill: one rank's exposed-comm stall drags windowed
    fleet goodput under the SLO; the sustained burn must shrink the
    fleet (shedding the dominant bottleneck), and the post-shrink
    recovery must grow it back — the full burn → shrink → recover →
    grow loop through a real
    :class:`~horovod_tpu_torch.perf.goodput.FleetGoodput` on a virtual
    clock.  In ``dry_run`` the victim is
    never shed (no side effects), so the degradation ends only at
    ``recover_at``."""
    from horovod_tpu_torch.perf.goodput import FleetGoodput
    from horovod_tpu_torch.runtime import autopilot as _autopilot

    rng = random.Random(seed)
    events: list = []

    def _shrink(action) -> None:
        events.append(["shrink", action.evidence.get("bottleneck_rank")])

    def _grow(action) -> None:
        events.append(["grow", None])

    ap = _autopilot.Autopilot(
        dry_run=dry_run, clock=lambda: 0.0,
        cooldown_s=15.0, rate_limit=8, rate_window_s=3600.0,
        trip_ticks=2, straggler_factor=4.0, straggler_floor_s=0.05,
        burn_threshold=1.5, comm_fraction=0.25,
        actuators={"slo_burn_shrink": _shrink,
                   "slo_recover_grow": _grow})
    fleet_gp = FleetGoodput(slo=slo, window_s=30.0, clock=lambda: 0.0)
    cum = {r: {"elapsed": 0.0, "compute": 0.0, "exposed": 0.0}
           for r in range(world)}
    shed: set[int] = set()
    timeline: list[dict] = []
    for i in range(ticks):
        t = 10.0 * i
        degraded = degrade_at <= i < recover_at and victim not in shed
        snaps = []
        for r in range(world):
            if r in shed:
                continue
            c = cum[r]
            c["elapsed"] += 10.0
            jit = rng.random() * 0.05
            if r == victim and degraded:
                c["compute"] += 0.5 + jit
                c["exposed"] += 9.5 - jit
            else:
                c["compute"] += 9.5 + jit
                c["exposed"] += 0.5 - jit
            snaps.append({"rank": r, "elapsed_s": c["elapsed"],
                          "phases": {"compute": c["compute"],
                                     "comm_exposed": c["exposed"]},
                          "unattributed_s": 0.0})
        report = fleet_gp.update(snaps, now=t)
        before = len(events)
        ap.observe_goodput(report, now=t)
        if len(events) > before and events[-1][0] == "shrink" \
                and events[-1][1] is not None:
            shed.add(int(events[-1][1]))
        alert = report.get("alert") or {}
        timeline.append({
            "tick": i,
            "goodput": report["window"].get("goodput"),
            "burn": alert.get("burn_rate"),
            "firing": bool(alert.get("firing"))})
    return {
        "world": world, "victim": victim, "slo": slo,
        "dry_run": dry_run, "timeline": timeline,
        "actions": [a.to_dict() for a in ap.actions],
        "events": events, "shed": sorted(shed),
        "world_after": world - len(shed),
    }


def rollback_drill(steps: int = 12, poison_round: int = 7,
                   keep: int = 4, seed: int = 0,
                   dry_run: bool = False, device=None) -> dict:
    """Autopilot drill: an injected ``nan:`` fault (the real
    ``HOROVOD_FAULT_SPEC`` grammar, budget semantics included) poisons
    one training step; the health sentinel trips on the nonfinite
    loss, the commit is stamped ``poisoned`` in the checkpoint ring,
    and the autopilot rolls the pseudo-trainer back to the newest
    HEALTHY commit.  The resumed run must end **bit-exact** with a
    never-poisoned reference (same seed, same grad stream): every
    update surviving in the final params came from clean data.  In
    ``dry_run`` the verdict is recorded but nothing acts, so the NaN
    keeps the params poisoned and ``bit_exact`` is False — the shadow
    -mode parity check.  The parameters and the gradient stream live on
    ``device`` (default: the card); the digest is of their float64
    bytes."""
    import fnmatch as _fnmatch
    import os as _os
    import tempfile

    from horovod_tpu_torch import checkpoint as _ckpt
    from horovod_tpu_torch.common.util import resolve_device
    from horovod_tpu_torch.runtime import autopilot as _autopilot
    from horovod_tpu_torch.runtime.health import HealthMonitor

    dev = resolve_device(device)
    spec = f"nan:grad*:round{poison_round}"

    def train(fault_spec: str, ckpt: str, ap=None,
              commit_log: list | None = None) -> torch.Tensor:
        rules = [r for r in _faults.parse_spec(fault_spec)
                 if r.kind in _faults.DATA_KINDS] if fault_spec else []
        mon = HealthMonitor(clock=lambda: 0.0)
        marks = [0, 0]

        def verdict() -> str:
            nf, al = mon.nonfinite_events, mon.alerts_total()
            poisoned = bool(mon.active_alerts()) \
                or nf > marks[0] or al > marks[1]
            marks[0], marks[1] = nf, al
            return "poisoned" if poisoned else "healthy"

        rolled: list = []
        if ap is not None:
            ap.actuators["health_rollback"] = rolled.append
        grads = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (steps, 4)).astype(np.float64)).to(dev)
        params = torch.zeros(4, dtype=torch.float64, device=dev)
        step = 0
        while step < steps:
            grad = grads[step].clone()
            for rule in rules:
                if rule.round and step < rule.round:
                    continue
                if not _fnmatch.fnmatch("grad", rule.pattern):
                    continue
                if not rule.take():
                    continue
                grad[0] = (float("nan") if rule.kind == "nan"
                           else float("inf"))
            params = params + 0.01 * grad
            mon.observe_loss(float(params @ params), step=step)
            if step % 2 == 1:
                v = verdict()
                _ckpt.save(ckpt, {"params": params, "step": step},
                           step=step, verdict=v)
                if commit_log is not None:
                    commit_log.append({"step": step, "verdict": v})
                # The rank_tick analogue: the autopilot evaluates at
                # the commit boundary, so the poisoned commit is
                # already in the ring when the rollback verdict lands
                # — exactly the state latest_healthy must skip over.
                if ap is not None:
                    ap.observe_health(mon.active_alerts(),
                                      mon.nonfinite_events,
                                      culprits=mon.culprits,
                                      now=float(step))
                    if rolled:
                        rolled.clear()
                        snap = _ckpt.restore(ckpt, healthy_only=True)
                        params = torch.as_tensor(snap["params"]).to(dev)
                        step = int(snap["step"])
            step += 1
        return params

    def digest(params: torch.Tensor) -> str:
        return hashlib.sha256(
            params.cpu().numpy().tobytes()).hexdigest()[:16]

    prev_keep = _os.environ.get("HOROVOD_CHECKPOINT_KEEP")
    _config.set_knob("checkpoint_keep", keep)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ap = _autopilot.Autopilot(
                dry_run=dry_run, clock=lambda: 0.0,
                cooldown_s=1e9, rate_limit=4, rate_window_s=1e9,
                trip_ticks=1, straggler_factor=4.0,
                straggler_floor_s=0.05, burn_threshold=2.0,
                comm_fraction=0.25)
            commits: list = []
            poisoned_dir = _os.path.join(tmp, "run")
            final = train(spec, poisoned_dir, ap=ap,
                          commit_log=commits)
            ring = _ckpt._complete_steps(poisoned_dir)
            ring_verdicts = {str(s): _ckpt.verdict_of(poisoned_dir, s)
                             for s in ring}
            reference = train("", _os.path.join(tmp, "ref"))
    finally:
        if prev_keep is None:
            _os.environ.pop("HOROVOD_CHECKPOINT_KEEP", None)
        else:
            _os.environ["HOROVOD_CHECKPOINT_KEEP"] = prev_keep
    rollbacks = [a for a in ap.actions
                 if a.rule == "health_rollback"
                 and a.outcome in ("applied", "dry_run")]
    return {
        "steps": steps, "fault_spec": spec, "keep": keep,
        "dry_run": dry_run, "commits": commits,
        "actions": [a.to_dict() for a in ap.actions],
        "rollbacks": len(rollbacks),
        "ring_steps": ring, "ring_verdicts": ring_verdicts,
        "final_finite": bool(torch.isfinite(final).all()),
        "final_digest": digest(final),
        "reference_digest": digest(reference),
        "bit_exact": digest(final) == digest(reference),
    }


def run_trace(world: int, fanout: int, rounds: int, seed: int,
              fault_spec: str = "") -> list[dict]:
    """One deterministic negotiation trace — the shape the determinism
    test replays twice."""
    fleet = SimFleet(world, fanout=fanout, seed=seed,
                     fault_spec=fault_spec)
    return [t.to_dict() for t in fleet.run_rounds(rounds)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runtime.simfleet",
        description="Deterministic in-process fleet simulator "
                    "(docs/control-plane.md).")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("trace", help="negotiation rounds -> round trace")
    t.add_argument("--world", type=int, default=256)
    t.add_argument("--fanout", type=int, default=16)
    t.add_argument("--rounds", type=int, default=4)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--fault-spec", default="")
    s = sub.add_parser("scaling", help="flat vs hierarchical root load")
    s.add_argument("--world", type=int, default=1024)
    s.add_argument("--fanout", type=int, default=32)
    s.add_argument("--rounds", type=int, default=4)
    s.add_argument("--seed", type=int, default=0)
    ls = sub.add_parser(
        "localsgd", help="local-SGD cross-slice round economy")
    ls.add_argument("--world", type=int, default=256)
    ls.add_argument("--fanout", type=int, default=16)
    ls.add_argument("--h", type=int, default=4)
    ls.add_argument("--windows", type=int, default=2)
    ls.add_argument("--seed", type=int, default=0)
    r = sub.add_parser("storm", help="elastic re-form storm")
    r.add_argument("--world", type=int, default=256)
    r.add_argument("--fanout", type=int, default=16)
    r.add_argument("--kill", type=int, default=8)
    r.add_argument("--seed", type=int, default=0)
    a = sub.add_parser("abort", help="coordinated abort drill")
    a.add_argument("--world", type=int, default=32)
    a.add_argument("--fanout", type=int, default=8)
    a.add_argument("--victim", type=int, default=5)
    g = sub.add_parser(
        "straggler", help="autopilot preemptive-blacklist drill")
    g.add_argument("--world", type=int, default=256)
    g.add_argument("--fanout", type=int, default=16)
    g.add_argument("--straggler", type=int, default=3)
    g.add_argument("--delay", default="200ms")
    g.add_argument("--rounds", type=int, default=4)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--dry-run", action="store_true")
    pe = sub.add_parser(
        "preempt", help="autopilot graceful-preemption storm drill")
    pe.add_argument("--world", type=int, default=256)
    pe.add_argument("--fanout", type=int, default=16)
    pe.add_argument("--kill", type=int, default=8)
    pe.add_argument("--rounds", type=int, default=4)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--dry-run", action="store_true")
    b = sub.add_parser(
        "burn", help="autopilot SLO-burn shrink/grow drill")
    b.add_argument("--world", type=int, default=8)
    b.add_argument("--victim", type=int, default=2)
    b.add_argument("--slo", type=float, default=0.9)
    b.add_argument("--ticks", type=int, default=12)
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--dry-run", action="store_true")
    rb = sub.add_parser(
        "rollback", help="autopilot nan -> rollback -> bit-exact drill")
    rb.add_argument("--steps", type=int, default=12)
    rb.add_argument("--poison-round", type=int, default=7)
    rb.add_argument("--keep", type=int, default=4)
    rb.add_argument("--seed", type=int, default=0)
    rb.add_argument("--dry-run", action="store_true")
    rb.add_argument("--device", default=None,
                    help="where the pseudo-trainer's parameters live "
                         "(default: the card)")
    args = p.parse_args(argv)
    if args.cmd == "trace":
        out = run_trace(args.world, args.fanout, args.rounds,
                        args.seed, args.fault_spec)
    elif args.cmd == "scaling":
        out = measure_scaling(args.world, args.fanout, args.rounds,
                              args.seed)
    elif args.cmd == "localsgd":
        out = local_sgd_scaling(args.world, args.fanout, args.h,
                                args.windows, args.seed)
    elif args.cmd == "storm":
        out = reform_storm(args.world, args.fanout, args.kill,
                           seed=args.seed)
    elif args.cmd == "straggler":
        out = straggler_drill(args.world, args.fanout, args.straggler,
                              args.delay, args.rounds, seed=args.seed,
                              dry_run=args.dry_run)
    elif args.cmd == "preempt":
        out = preempt_storm(args.world, args.fanout, args.kill,
                            args.rounds, seed=args.seed,
                            dry_run=args.dry_run)
    elif args.cmd == "burn":
        out = slo_burn_drill(args.world, args.victim, args.slo,
                             args.ticks, seed=args.seed,
                             dry_run=args.dry_run)
    elif args.cmd == "rollback":
        out = rollback_drill(args.steps, args.poison_round, args.keep,
                             args.seed, dry_run=args.dry_run,
                             device=args.device)
    else:
        out = coordinated_abort(args.world, args.fanout, args.victim)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
