"""The port's autopilot (``horovod_tpu_torch/runtime/autopilot.py``)
against the JAX package's (``horovod_tpu/runtime/autopilot.py``).

1. The policy engine is host code on plain Python data: the same
   observation sequences, on an injected clock, go to both engines, and
   every verdict's ``to_dict()``, the ``stats()`` and the gates' state
   must be equal.  Covered: every case of ``tests/test_autopilot.py``
   that needs no fleet simulator (the engine's gates, ``from_env``, the
   flight evidence, ``launcher_observe``, lines 132-330; the elastic
   integration, 452-528; the ``slow:`` rule's tax, 54-70 -- its grammar
   and the checkpoint ring of 38-130 are held in
   ``test_torch_faults.py`` and ``test_torch_checkpoint.py``), the
   ungated ``preempt_drain`` (``tests/test_preemption.py:273``), the
   ``local_sgd_h`` proposal (``tests/test_local_sgd.py:550-570``), and
   seeded random sequences over every rule.
2. The rank side at world 1: ``_commit_verdict``, ``rollback_to_healthy``,
   the commit hook's advisory split, and a small BatchNorm model rolled
   back in process to bit-exact parity with its unpoisoned run.
3. Two real processes on the negotiated plane over gloo
   (``test_autopilot_rollback_2proc``): rank 1's gradient buffer poisoned
   once, every rank restores the newest healthy commit, and the final
   ``w`` equals optax's unpoisoned trajectory bit for bit.
4. The elastic launcher (``python -m horovod_tpu_torch.run --elastic
   --autopilot``) over gloo: a ``slow:`` rank's host blacklisted by
   ``straggler_blacklist`` before any rank dies, a ``slow:`` rank shed by
   ``slo_burn_shrink`` on one host at the default straggler floor,
   ``--preempt`` through the ungated rule (the engaged line, the flight
   dump of the verdict), and the dry run.

The fleet simulator's drills of ``tests/test_autopilot.py`` are held in
``tests/test_torch_simfleet.py``.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu.common import config as jconfig
from horovod_tpu.runtime import autopilot as JAP
from horovod_tpu.runtime import faults as JF
from horovod_tpu.runtime import flight as jflight

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch import elastic
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.runtime import autopilot as AP
from horovod_tpu_torch.runtime import faults as F
from horovod_tpu_torch.runtime import flight
from horovod_tpu_torch.runtime import health as H
from horovod_tpu_torch.runtime import metrics as M

from _torch_collectives_worker import spawn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "_torch_elastic_train_script.py")

BASE = dict(dry_run=False, clock=lambda: 0.0, cooldown_s=60.0,
            rate_limit=4, rate_window_s=600.0, trip_ticks=3,
            straggler_factor=4.0, straggler_floor_s=0.05,
            burn_threshold=2.0, comm_fraction=0.25, record=False)


# ---------------------------------------------------------------------------
# 1. The engine, both packages side by side
# ---------------------------------------------------------------------------


class Pair:
    """One engine of each package, with the same thresholds and
    actuators, driven by the same calls.  An ``observe_*`` call returns
    the port's verdict as ``to_dict()`` (or None) once it equals the JAX
    package's.  ``actuators`` maps a rule to ``"record"`` (append the
    target) or ``"raise"`` (a RuntimeError)."""

    def __init__(self, actuators=None, **kw):
        cfg = dict(BASE, **kw)
        self.fired = {"jax": [], "torch": []}

        def acts(side):
            out = {}
            for rule, how in (actuators or {}).items():
                def fn(action, side=side, how=how):
                    if how == "raise":
                        raise RuntimeError("no")
                    self.fired[side].append((action.rule, action.target))
                out[rule] = fn
            return out

        self.j = JAP.Autopilot(actuators=acts("jax"), **cfg)
        self.t = AP.Autopilot(actuators=acts("torch"), **cfg)

    def __getattr__(self, name):
        if not name.startswith("observe_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            got = getattr(self.t, name)(*args, **kwargs)
            want = getattr(self.j, name)(*args, **kwargs)
            got = None if got is None else got.to_dict()
            want = None if want is None else want.to_dict()
            assert got == want, (name, args, kwargs, got, want)
            return got
        return call

    def check(self) -> None:
        assert [a.to_dict() for a in self.t.actions] == \
            [a.to_dict() for a in self.j.actions]
        assert self.t.stats() == self.j.stats()
        for attr in ("_streak", "_last_fired", "_fire_times", "_shrunk"):
            assert getattr(self.t, attr) == getattr(self.j, attr), attr
        assert self.fired["torch"] == self.fired["jax"]


def test_straggler_hysteresis_requires_sustained_breach():
    p = Pair(actuators={"straggler_blacklist": "record"})
    late = {0: 0.0, 1: 0.0, 2: 3.0}
    hosts = {2: "hostC"}
    assert p.observe_stragglers(late, hosts, now=0.0) is None
    assert p.observe_stragglers(late, hosts, now=1.0) is None
    act = p.observe_stragglers(late, hosts, now=2.0)
    assert act["outcome"] == "applied" and act["target"] == "hostC"
    assert act["evidence"]["rank"] == 2 and act["evidence"]["streak"] == 3
    assert p.fired["torch"] == [("straggler_blacklist", "hostC")]
    p.check()


def test_straggler_streak_resets_on_candidate_change():
    p = Pair(trip_ticks=2, actuators={"straggler_blacklist": "record"})
    assert p.observe_stragglers({0: 0.0, 1: 3.0}, now=0.0) is None
    assert p.observe_stragglers({0: 3.0, 1: 0.0}, now=1.0) is None
    assert p.observe_stragglers({0: 3.0, 1: 0.0}, now=2.0) is not None
    p.check()


def test_straggler_clean_tick_disarms():
    p = Pair(trip_ticks=2)
    assert p.observe_stragglers({0: 0.0, 1: 3.0}, now=0.0) is None
    assert p.observe_stragglers({0: 0.0, 1: 0.0}, now=1.0) is None
    assert p.observe_stragglers({0: 0.0, 1: 3.0}, now=2.0) is None
    assert p.observe_stragglers({0: 0.0, 1: 3.0}, now=3.0) is not None
    p.check()


def test_cooldown_suppresses_refire():
    p = Pair(trip_ticks=1, cooldown_s=10.0)
    outcomes = [p.observe_health(["loss_nonfinite"], now=t)["outcome"]
                for t in (0.0, 5.0, 10.0)]
    assert outcomes == ["no_actuator", "suppressed:cooldown", "no_actuator"]
    p.check()


def test_global_rate_limit_spans_rules():
    p = Pair(trip_ticks=1, cooldown_s=0.0, rate_limit=2,
             rate_window_s=100.0)
    a1 = p.observe_health(["nonfinite"], now=0.0)
    a2 = p.observe_stragglers({0: 0.0, 1: 9.0}, now=1.0)
    a3 = p.observe_health(["nonfinite"], now=2.0)
    assert [a["outcome"] for a in (a1, a2, a3)] == [
        "no_actuator", "no_actuator", "suppressed:rate_limit"]
    assert p.observe_health(["nonfinite"], now=101.0)["outcome"] == \
        "no_actuator"
    p.check()


def test_dry_run_records_but_never_acts():
    p = Pair(dry_run=True, trip_ticks=1,
             actuators={"health_rollback": "record"})
    act = p.observe_health(["nonfinite"], now=0.0)
    assert act["outcome"] == "dry_run" and act["dry_run"]
    assert p.fired["torch"] == []
    p.check()


def test_actuator_failure_is_an_outcome_not_a_crash():
    p = Pair(trip_ticks=1, actuators={"health_rollback": "raise"})
    assert p.observe_health(["nonfinite"], now=0.0)["outcome"] == \
        "failed:RuntimeError"
    p.check()


def _report(firing, burn, rank=5):
    return {"window": {"goodput": 0.5,
                       "dominant_bottleneck": {"phase": "comm_exposed",
                                               "rank": rank,
                                               "fleet_seconds": 9.0,
                                               "rank_seconds": 8.0}},
            "alert": {"slo": 0.9, "firing": firing,
                      "reason": "comm_exposed", "burn_rate": burn}}


def test_goodput_shrink_then_recover_grow():
    p = Pair(trip_ticks=2, cooldown_s=1.0,
             actuators={"slo_burn_shrink": "record",
                        "slo_recover_grow": "record"})
    assert p.observe_goodput(_report(True, 3.0), now=0.0) is None
    act = p.observe_goodput(_report(True, 3.0), now=1.0)
    assert act["outcome"] == "applied" and act["kind"] == "shrink"
    assert act["evidence"]["bottleneck_rank"] == 5
    assert p.observe_goodput(_report(False, 0.5), now=10.0) is None
    grow = p.observe_goodput(_report(False, 0.5), now=11.0)
    assert grow["outcome"] == "applied" and grow["kind"] == "grow"
    assert [r for r, _ in p.fired["torch"]] == ["slo_burn_shrink",
                                                "slo_recover_grow"]
    assert p.observe_goodput(_report(False, 0.5), now=20.0) is None
    assert p.observe_goodput(_report(False, 0.5), now=21.0) is None
    p.check()


def test_goodput_grow_needs_prior_shrink():
    p = Pair(trip_ticks=1)
    rep = {"window": {"goodput": 0.95},
           "alert": {"slo": 0.9, "firing": False, "reason": "none",
                     "burn_rate": 0.5}}
    assert p.observe_goodput(rep, now=0.0) is None
    assert p.observe_goodput(rep, now=1.0) is None
    p.check()


def test_comm_retune_proposes_within_autotune_bounds(monkeypatch):
    monkeypatch.delenv("HOROVOD_LOCAL_SGD_H", raising=False)
    monkeypatch.setenv("HOROVOD_OVERLAP_CHUNKS", "4")
    p = Pair(trip_ticks=1)
    act = p.observe_comm(exposed_s=5.0, compute_s=5.0, now=0.0)
    assert act["evidence"]["proposal"] == {"overlap_chunks": 8}
    monkeypatch.setenv("HOROVOD_OVERLAP_CHUNKS", "32")
    assert p.observe_comm(5.0, 5.0, now=100.0) is None   # at the cap
    p.check()


def test_comm_retune_quiet_below_budget():
    p = Pair(trip_ticks=1)
    assert p.observe_comm(exposed_s=1.0, compute_s=9.0, now=0.0) is None
    assert p.observe_comm(exposed_s=0.0, compute_s=0.0, now=1.0) is None
    p.check()


def test_comm_retune_proposes_h_doubling(monkeypatch):
    """``tests/test_local_sgd.py:550-570``: under local SGD the proposal
    doubles H, capped at 64; ``apply_params`` exports it."""
    from horovod_tpu_torch.runtime import parameter_manager as PM

    monkeypatch.setenv("HOROVOD_LOCAL_SGD_H", "4")
    p = Pair(trip_ticks=1)
    act = p.observe_comm(exposed_s=5.0, compute_s=5.0, now=0.0)
    assert act["evidence"]["proposal"] == {"local_sgd_h": 8}
    monkeypatch.setenv("HOROVOD_LOCAL_SGD_H", "64")
    assert p.observe_comm(5.0, 5.0, now=100.0) is None
    p.check()
    monkeypatch.setenv("HOROVOD_LOCAL_SGD_H", "4")
    PM.apply_params({"local_sgd_h": 8})
    assert int(_config.get("local_sgd_h")) == 8 == \
        int(jconfig.get("local_sgd_h"))


def test_preempt_drain_is_ungated():
    """``tests/test_preemption.py:273``: a punitive cooldown and rate
    limit, yet every notice lands, and none enters the rate window."""
    p = Pair(cooldown_s=3600.0, rate_limit=1, rate_window_s=3600.0,
             actuators={"preempt_drain": "record"})
    assert "preempt_drain" in AP.RULES and AP.RULES == JAP.RULES
    a1 = p.observe_preemption(3, host="h3", source="signal", grace_s=30.0,
                              now=0.0)
    a2 = p.observe_preemption(4, source="kv", now=1.0)
    assert a1["outcome"] == a2["outcome"] == "applied"
    assert [t for _, t in p.fired["torch"]] == ["rank3", "rank4"]
    assert a1["evidence"]["grace_s"] == 30.0 and a1["evidence"]["host"] == "h3"
    assert p.t._fire_times == []
    assert p.observe_preemption(None) is None
    p.check()


def test_from_env_gate_and_overrides():
    for env in ({}, {"HOROVOD_AUTOPILOT": "0"}):
        assert AP.Autopilot.from_env(env) is None
        assert JAP.Autopilot.from_env(env) is None
    env = {"HOROVOD_AUTOPILOT": "1", "HOROVOD_AUTOPILOT_DRY_RUN": "true",
           "HOROVOD_AUTOPILOT_TRIP_TICKS": "5",
           "HOROVOD_AUTOPILOT_COOLDOWN_SECONDS": "7.5",
           "HOROVOD_AUTOPILOT_RATE_LIMIT": "bogus"}   # falls back to the knob
    t = AP.Autopilot.from_env(env, record=False)
    j = JAP.Autopilot.from_env(env, record=False)
    assert t.dry_run and t.trip_ticks == 5 and t.cooldown_s == 7.5
    assert t.rate_limit == int(_config.get("autopilot_rate_limit"))
    for attr in ("dry_run", "cooldown_s", "rate_limit", "rate_window_s",
                 "trip_ticks", "straggler_factor", "straggler_floor_s",
                 "burn_threshold", "comm_fraction"):
        assert getattr(t, attr) == getattr(j, attr), attr


@pytest.mark.parametrize("name", [
    "autopilot", "autopilot_dry_run", "autopilot_cooldown",
    "autopilot_rate_limit", "autopilot_rate_window", "autopilot_trip_ticks",
    "autopilot_straggler_factor", "autopilot_straggler_floor",
    "autopilot_burn_threshold", "autopilot_comm_fraction"])
def test_knobs_match_the_jax_package(name):
    mine, ref = _config._KNOBS[name], jconfig._KNOBS[name]
    assert (mine.env, mine.default, mine.cli, mine.config_key) == \
        (ref.env, ref.default, ref.cli, ref.config_key)
    for raw in ("1", "0", "yes", "2.5", "7"):
        try:
            want = ref.parse(raw)
        except ValueError:
            with pytest.raises(ValueError):
                mine.parse(raw)
        else:
            assert mine.parse(raw) == want


def test_stats_and_flight_evidence():
    flight.reset()
    jflight.reset()
    cfg = dict(BASE, trip_ticks=1, cooldown_s=0.0, record=True)
    t, j = AP.Autopilot(**cfg), JAP.Autopilot(**cfg)
    counter = M.counter("hvd_autopilot_actions_total")
    before = counter.value(rule="health_rollback", outcome="no_actuator")
    for ap in (t, j):
        ap.observe_health(["nonfinite"], nonfinite_events=2, now=0.0)
    assert t.stats() == j.stats()
    st = t.stats()
    assert st["actions_total"] == 1 and st["rollbacks"] == 0
    assert st["by_rule"] == {"health_rollback": 1}

    def events(rec):
        return [{k: e[k] for k in ("rule", "act", "target", "outcome",
                                   "evidence")}
                for e in rec.recorder().snapshot() if e["kind"] == "autopilot"]
    assert events(flight) == events(jflight)
    assert events(flight)[-1]["evidence"]["nonfinite_events"] == 2
    assert counter.value(rule="health_rollback",
                         outcome="no_actuator") == before + 1
    gauge = M.gauge("hvd_autopilot_cooldown_active")
    t.refresh_gauges(now=0.0)
    assert gauge.value(rule="health_rollback") == 0   # cooldown 0 s


def _stale_snap(rank, host, peers):
    return {"meta": {"rank": rank, "host": host},
            "metrics": {"hvd_heartbeat_staleness_seconds": {
                "kind": "gauge",
                "series": [{"labels": {"peer": str(p)}, "value": v}
                           for p, v in peers.items()]}}}


def test_launcher_observe_staleness_rankings():
    p = Pair(trip_ticks=2, actuators={"straggler_blacklist": "record"})
    snaps = [_stale_snap(0, "h0", {1: 0.1, 3: 6.0}),
             _stale_snap(3, "h3", {}),
             _stale_snap(1, "h1", {3: 4.0})]
    for now in (0.0, 1.0):
        AP.launcher_observe(p.t, snaps, now=now)
        JAP.launcher_observe(p.j, snaps, now=now)
    assert len(p.t.actions) == 1
    act = p.t.actions[0]
    assert act.rule == "straggler_blacklist" and act.target == "h3"
    assert act.evidence["lateness_s"] == 6.0   # the worst observer wins
    p.check()


def _goodput_snap(rank, elapsed, compute, exposed):
    return {"meta": {"rank": rank, "host": "h"},
            "metrics": {
                "hvd_goodput_elapsed_seconds": {
                    "kind": "gauge",
                    "series": [{"labels": {}, "value": elapsed}]},
                "hvd_wallclock_seconds_total": {
                    "kind": "counter",
                    "series": [{"labels": {"phase": "compute"},
                                "value": compute},
                               {"labels": {"phase": "comm_exposed"},
                                "value": exposed}]}}}


def test_launcher_observe_goodput_burn():
    from horovod_tpu.perf.goodput import FleetGoodput as JFleet
    from horovod_tpu_torch.perf.goodput import FleetGoodput

    p = Pair(trip_ticks=1, burn_threshold=1.5)
    fleets = (FleetGoodput(slo=0.9, window_s=10.0, clock=lambda: 0.0),
              JFleet(slo=0.9, window_s=10.0, clock=lambda: 0.0))
    for now, snaps in ((0.0, [_goodput_snap(0, 10, 2, 7),
                              _goodput_snap(1, 10, 9, 0.5)]),
                       (5.0, [_goodput_snap(0, 20, 3, 16),
                              _goodput_snap(1, 20, 18, 1.0)])):
        AP.launcher_observe(p.t, snaps, fleet=fleets[0], now=now)
        JAP.launcher_observe(p.j, snaps, fleet=fleets[1], now=now)
    shrinks = [a for a in p.t.actions if a.rule == "slo_burn_shrink"]
    assert shrinks and shrinks[0].evidence["bottleneck_rank"] == 0
    assert shrinks[0].evidence["bottleneck_phase"] == "comm_exposed"
    p.check()


def test_launcher_observe_port_keywords():
    """The port's launcher's keywords: ``hosts`` names the blacklist's
    target in place of the snapshots' meta; ``stragglers=False`` leaves
    the rule unfed; ``stepped_only`` keeps a rank out of the SLO evidence
    until it has booked compute and judges no report before its window
    spans two samples, so a start booked outside any span fires
    nothing."""
    from horovod_tpu_torch.perf.goodput import FleetGoodput

    snaps = [_stale_snap(0, "node", {1: 0.1, 3: 6.0}),
             _stale_snap(3, "node", {}), _stale_snap(1, "node", {3: 4.0})]
    ap = AP.Autopilot(**dict(BASE, trip_ticks=1))
    AP.launcher_observe(ap, snaps, now=0.0, stragglers=False)
    assert ap.actions == []
    AP.launcher_observe(ap, snaps, now=1.0, hosts={3: "127.0.0.1"})
    assert [(a.rule, a.target) for a in ap.actions] == [
        ("straggler_blacklist", "127.0.0.1")]

    ap = AP.Autopilot(**dict(BASE, trip_ticks=1, burn_threshold=1.5))
    fleet = FleetGoodput(slo=0.9, window_s=10.0, clock=lambda: 0.0)
    # the start: nothing computed on rank 1 yet, rank 0 one step in
    AP.launcher_observe(ap, [_goodput_snap(0, 10, 0.5, 0),
                             _goodput_snap(1, 10, 0, 0)], fleet=fleet,
                        now=0.0, stepped_only=True)
    assert ap.actions == [] and fleet.last["window"]["seconds"] == 0.0
    assert fleet.last["alert"]["firing"]
    assert [r["rank"] for r in fleet.last["ranks"]] == [0]
    # the same start judged as the JAX package's sweep judges it
    ref = AP.Autopilot(**dict(BASE, trip_ticks=1, burn_threshold=1.5))
    AP.launcher_observe(ref, [_goodput_snap(0, 10, 0.5, 0),
                              _goodput_snap(1, 10, 0, 0)],
                        fleet=FleetGoodput(slo=0.9, window_s=10.0,
                                           clock=lambda: 0.0), now=0.0)
    assert [a.rule for a in ref.actions] == ["slo_burn_shrink"]
    # a window over steps: rank 0 burns comm, and is judged
    AP.launcher_observe(ap, [_goodput_snap(0, 20, 2.5, 7),
                             _goodput_snap(1, 20, 9, 0)], fleet=fleet,
                        now=5.0, stepped_only=True)
    assert [(a.rule, a.evidence["bottleneck_rank"]) for a in ap.actions] \
        == [("slo_burn_shrink", 0)]


def test_shed_label_never_names_rank0():
    """``slo_burn_shrink``'s actuator sheds the live process at the
    evidence's bottleneck rank, and refuses (the verdict is ``failed:*``)
    rank 0's process, an evidence without a rank and a rank with no live
    process: it never falls back to another process."""
    from horovod_tpu_torch.run.launcher import _shed_label

    seed = {0: "0", 1: "1", 2: "2"}.get
    assert _shed_label(2, seed) == "2"
    with pytest.raises(RuntimeError, match="rank 0"):
        _shed_label(0, seed)
    with pytest.raises(LookupError):
        _shed_label(None, seed)
    with pytest.raises(LookupError):
        _shed_label(5, seed)
    # after a re-form the seed's rank 1 holds rank 0
    reformed = {0: "1", 1: "2"}.get
    assert _shed_label(1, reformed) == "2"
    with pytest.raises(RuntimeError):
        _shed_label(0, reformed)


def _random_calls(seed: int, n: int = 160) -> list:
    """A seeded sequence of observations over every rule, on a clock
    that advances by random steps."""
    rng = random.Random(seed)
    now, calls = 0.0, []
    for _ in range(n):
        now += rng.choice((0.5, 1.0, 2.0, 7.0, 31.0))
        kind = rng.randrange(5)
        if kind == 0:
            world = rng.randrange(1, 6)
            late = {r: rng.choice((0.0, 0.01, 0.2, 1.5, 9.0))
                    for r in range(world)}
            hosts = {r: f"h{r % 3}" for r in late if rng.random() < 0.7}
            calls.append(("observe_stragglers", (late,),
                          {"hosts": hosts, "now": now}))
        elif kind == 1:
            firing = rng.random() < 0.5
            rep = _report(firing, rng.choice((0.5, 1.9, 2.0, 3.5)),
                          rank=rng.choice((None, 0, 2)))
            if rng.random() < 0.1:
                rep = {}
            calls.append(("observe_goodput", (rep,), {"now": now}))
        elif kind == 2:
            alerts = rng.choice(([], ["nonfinite"],
                                 ["loss_divergence", "nonfinite"]))
            calls.append(("observe_health", (alerts, rng.randrange(4)),
                          {"culprits": rng.choice((None, {1: 2})),
                           "now": now}))
        elif kind == 3:
            calls.append(("observe_comm", (rng.choice((0.0, 1.0, 6.0)),
                                           rng.choice((0.0, 2.0, 9.0))),
                          {"now": now}))
        else:
            calls.append(("observe_preemption",
                          (rng.choice((None, 0, 3)),),
                          {"source": "kv", "grace_s": rng.choice((None, 5)),
                           "now": now}))
    return calls


@pytest.mark.parametrize("seed", range(6))
def test_random_sequences_give_the_same_verdicts(seed, monkeypatch):
    monkeypatch.delenv("HOROVOD_LOCAL_SGD_H", raising=False)
    monkeypatch.setenv("HOROVOD_OVERLAP_CHUNKS", "2")
    rng = random.Random(1000 + seed)
    kw = {"trip_ticks": rng.choice((1, 2, 3)),
          "cooldown_s": rng.choice((0.0, 5.0, 60.0)),
          "rate_limit": rng.choice((1, 2, 4)),
          "rate_window_s": rng.choice((10.0, 600.0)),
          "dry_run": seed == 5}
    acts = {r: rng.choice(("record", "raise")) for r in AP.RULES}
    p = Pair(actuators=acts, **kw)
    for name, args, kwargs in _random_calls(seed):
        getattr(p, name)(*args, **kwargs)
    p.check()
    assert p.t.actions, "the sequence fired nothing"


def test_slow_rule_taxes_every_op_of_scoped_rank():
    """``tests/test_autopilot.py:54-70`` on both packages' transports."""
    class T:
        def set(self, key, value):
            return None

        def try_get(self, key):
            return None

    fired = []
    for mod in (F, JF):
        rules = mod.parse_spec("slow:1:1ms")
        slow = mod.FaultyTransport(T(), rank=1, rules=rules)
        fast = mod.FaultyTransport(T(), rank=0,
                                   rules=mod.parse_spec("slow:1:1ms"))
        slow.set("q/0/1", "x")
        slow.try_get("p/0")
        slow.set("hb/1", "beat")   # key-independent: non-round keys too
        fast.set("q/0/0", "x")
        fired.append((rules[0].fired, fast.rules[0].fired))
    assert fired == [(3, 0), (3, 0)]


# ---------------------------------------------------------------------------
# 2. The rank side at world 1
# ---------------------------------------------------------------------------


@pytest.fixture()
def world1(monkeypatch):
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK", "HOROVOD_MESH"):
        monkeypatch.delenv(k, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    AP.reset()
    H.reset()
    yield hvd
    AP.reset()
    H.reset()
    hvd.shutdown()


class _MarksOnly:
    _health_marks = (0, 0)


def test_commit_verdict_none_when_health_off(monkeypatch):
    from horovod_tpu import elastic as jelastic

    monkeypatch.delenv("HOROVOD_HEALTH", raising=False)
    assert elastic._commit_verdict(_MarksOnly()) is None
    assert jelastic._commit_verdict(_MarksOnly()) is None


def test_commit_verdict_tracks_monitor(monkeypatch):
    from horovod_tpu import elastic as jelastic
    from horovod_tpu.runtime import health as JH

    monkeypatch.setenv("HOROVOD_HEALTH", "1")
    H.reset()
    JH.reset()
    try:
        got, want = [], []
        for mon, el, out in ((H, elastic, got), (JH, jelastic, want)):
            state = _MarksOnly()
            out.append(el._commit_verdict(state))
            mon.monitor().observe_loss(float("nan"), step=3)
            out.append(el._commit_verdict(state))
            out.append(el._commit_verdict(state))   # the alert still active
        assert got == want == ["healthy", "poisoned", "poisoned"]
    finally:
        H.reset()
        JH.reset()


def test_commit_verdict_publishes_queued_verdicts(monkeypatch):
    """On the card a tap's verdict waits, copied behind an event, until
    the next tap or a flush; the commit must publish it before stamping,
    or the commit right after a poisoned step reads healthy and a
    rollback lands on it.  The queue is forced here on the CPU."""
    monkeypatch.setenv("HOROVOD_HEALTH", "1")
    H.reset()

    class Pending:
        def query(self):
            return False

        def synchronize(self):
            return None

    def queue(self, fn, t):
        with self._lock:
            self._items.append((fn, t.detach().clone(), Pending()))

    monkeypatch.setattr(H._Deferred, "add", queue)
    try:
        state = _MarksOnly()
        assert elastic._commit_verdict(state) == "healthy"
        H._deferred.add(lambda arr: H.monitor().observe_loss(
            float(arr[0]), step=1), torch.tensor([float("nan")]))
        assert H.monitor().snapshot()["nonfinite_events"] == 0   # queued
        assert elastic._commit_verdict(state) == "poisoned"
    finally:
        H._deferred.clear()
        H.reset()


def test_rollback_to_healthy_restores_newest_healthy(world1, tmp_path,
                                                     monkeypatch):
    monkeypatch.delenv("HOROVOD_HEALTH", raising=False)
    w = torch.arange(4.0)
    state = elastic.ElasticState(params={"w": w}, step=4,
                                 checkpoint_dir=str(tmp_path))
    state.commit()   # health off: no verdict, healthy on read
    ckpt.save(str(tmp_path), {"params": {"tree": {"w": np.zeros(4)}},
                              "opt_state": None, "step": 6,
                              "batch_offset": 0, "extra": {}, "commits": 2},
              step=6, verdict="poisoned")
    w.fill_(9.0)
    state.step = 99
    assert state.rollback_to_healthy() == 4
    assert state.step == 4
    assert torch.equal(state.params["w"], torch.arange(4.0))
    assert state.params["w"] is w   # restored in place


def test_rollback_to_healthy_needs_checkpoint_dir(world1):
    state = elastic.ElasticState(params={})
    with pytest.raises(HorovodTpuError, match="checkpoint_dir"):
        state.rollback_to_healthy()


def test_rollback_without_healthy_commit_raises(world1, tmp_path):
    ckpt.save(str(tmp_path), {"params": {"tree": {}}, "step": 2},
              step=2, verdict="poisoned")
    state = elastic.ElasticState(params={}, checkpoint_dir=str(tmp_path))
    with pytest.raises(HorovodTpuError, match="healthy"):
        state.rollback_to_healthy()


def test_autopilot_tick_disabled_by_default(monkeypatch):
    from horovod_tpu import elastic as jelastic

    monkeypatch.delenv("HOROVOD_AUTOPILOT", raising=False)
    AP.reset()
    JAP.reset()
    elastic._autopilot_tick(_MarksOnly())   # a no-op
    jelastic._autopilot_tick(_MarksOnly())
    assert AP._rank_ap is None and JAP._rank_ap is None


def test_rank_tick_decision_shape(monkeypatch):
    monkeypatch.setenv("HOROVOD_AUTOPILOT", "1")
    AP.reset()
    JAP.reset()
    try:
        class S:
            checkpoint_dir = None

        assert AP.rank_tick(S()) == JAP.rank_tick(S()) == {
            "rollback": False, "retune": None}
    finally:
        AP.reset()
        JAP.reset()


def test_tick_raises_package_errors_and_warns_on_others(world1, tmp_path,
                                                        monkeypatch,
                                                        caplog):
    """The commit hook's split, as the JAX package's
    (``horovod_tpu/elastic.py:457-470``): a ``HorovodTpuError`` -- the
    decided rollback finding no healthy commit -- reaches the caller;
    any other failure warns and the commit stands."""
    monkeypatch.setenv("HOROVOD_AUTOPILOT", "1")
    monkeypatch.setenv("HOROVOD_HEALTH", "1")
    state = elastic.ElasticState(params={"w": torch.zeros(2)}, step=0,
                                 checkpoint_dir=str(tmp_path))
    H.monitor().observe_loss(float("nan"), step=0)   # an active alert
    with pytest.raises(HorovodTpuError, match="healthy"):
        state.commit()   # this commit is poisoned: nothing to roll to
    assert AP.rank_autopilot().stats()["by_outcome"] == {"applied": 1}

    def boom(state):
        raise ValueError("evidence store gone")

    monkeypatch.setattr(AP, "rank_tick", boom)
    state.commit()   # warned, not raised
    assert state.commits == 2


def test_share_from_rank0_over_the_rendezvous(monkeypatch):
    """The elastic decision's path: rank 0 publishes under a key of this
    generation's n-th call and drops the key two calls back; a peer waits
    with the liveness-checked wait, so a dead peer raises
    ``RanksDownError`` instead of a collective that would wait out the
    gloo op timeout."""
    import types

    from horovod_tpu_torch.common.types import RanksDownError
    from horovod_tpu_torch.ops import eager

    class Rendezvous:
        def __init__(self):
            self.data = {}

        def set_overwrite(self, key, value):
            self.data[key] = value

        def delete(self, key):
            self.data.pop(key, None)

        def get_blocking(self, key, timeout_s):
            if key not in self.data:
                raise TimeoutError(key)
            return self.data[key]

    store = Rendezvous()
    st = types.SimpleNamespace(rank=0, epoch=7)
    shared = {0: [0, 0], 1: [0, 0]}
    monkeypatch.setattr(elastic, "_rv", lambda: store)
    monkeypatch.setattr(elastic._basics, "state", lambda: st)

    def as_rank(r, value):
        st.rank = r
        monkeypatch.setattr(elastic, "_shared", shared[r])
        return elastic.share_from_rank0(value)

    for n in range(1, 5):
        d = {"rollback": n == 2, "retune": {"overlap_chunks": n}}
        assert as_rank(0, d) == d
        assert as_rank(1, None) == d
    assert sorted(store.data) == ["el/share/g7/3", "el/share/g7/4"]
    st.epoch = 8   # a re-form: every rank counts afresh
    assert as_rank(0, [1]) == [1] == as_rank(1, None)
    assert "el/share/g8/1" in store.data

    def dead():
        raise RanksDownError('RanksDownError: {"ranks": [0]} gone')

    monkeypatch.setattr(eager, "check_liveness", dead)
    with pytest.raises(RanksDownError):
        as_rank(1, None)   # rank 0 never publishes call 2


RB_STEPS, RB_EVERY, RB_POISON = 10, 2, 5


def _small_bn_run(poison_step=None, autopilot=True, ckdir=None):
    """A small conv + BatchNorm model at world 1 through the in-trace
    ``DistributedOptimizer`` (fused momentum SGD), a commit every
    ``RB_EVERY`` steps; ``poison_step``'s first run carries
    ``nan:grads*``.  The final state dict, momentum traces, the engine's
    stats and the steps that ran."""
    from horovod_tpu_torch.models import layers as LY
    from horovod_tpu_torch.optim import fused_update as TF

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = LY.Conv(3, 8, 3, dtype=torch.float32)
            self.bn = LY.BatchNorm(8)
            self.fc = LY.Dense(8, 5)

        def forward(self, x):
            return self.fc(torch.relu(self.bn(self.conv(x))).mean((1, 2)))

    gen = torch.Generator().manual_seed(1)
    model = Net()
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    opt = hvd.DistributedOptimizer(TF.sgd(model.parameters(), 0.1,
                                          momentum=0.9))
    x = torch.randn(4, 6, 6, 3, generator=gen)
    y = torch.randint(0, 5, (4,), generator=gen)
    AP.reset()
    H.reset()
    state = elastic.ElasticState(params=model, opt_state=opt,
                                 checkpoint_dir=ckdir)
    ran, poisoned = [], False
    while state.step < RB_STEPS:
        assert len(ran) < 4 * RB_STEPS, "the rollback loop never ended"
        if state.step % RB_EVERY == 0:
            state.commit()
        spec = "nan:grads*" if (state.step == poison_step
                                and not poisoned) else ""
        poisoned = poisoned or bool(spec)
        os.environ["HOROVOD_FAULT_SPEC"] = spec
        try:
            opt.zero_grad()
            loss = torch.nn.functional.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
        finally:
            os.environ.pop("HOROVOD_FAULT_SPEC", None)
        ran.append(state.step)
        state.step += 1
    traces = [opt.optimizer.state[p]["trace"].clone()
              for p in model.parameters()]
    return ({k: v.clone() for k, v in model.state_dict().items()}, traces,
            AP.rank_autopilot().stats(), ran)


@pytest.mark.parametrize("dry_run", [False, True])
def test_world1_rollback_replays_to_the_unpoisoned_bits(world1, tmp_path,
                                                        monkeypatch,
                                                        dry_run):
    """Phase 26a of ``chip_smoke.py`` at a small size on the CPU: the
    poisoned step trips the nonfinite sentinel, the next commit is
    stamped poisoned, the tick rolls back to the newest healthy commit
    and the loop replays; the parameters, BatchNorm buffers and momentum
    traces then equal an unpoisoned run bit for bit.  Under
    ``HOROVOD_AUTOPILOT_DRY_RUN`` the verdict is ``dry_run`` and nothing
    is restored (``tests/test_autopilot.py:435-450``)."""
    monkeypatch.setenv("HOROVOD_FUSED_UPDATE", "1")
    monkeypatch.setenv("HOROVOD_CHECKPOINT_KEEP", "4")
    monkeypatch.setenv("HOROVOD_AUTOPILOT", "1")
    monkeypatch.setenv("HOROVOD_AUTOPILOT_DRY_RUN", "1" if dry_run else "0")
    monkeypatch.delenv("HOROVOD_HEALTH", raising=False)
    clean, clean_tr, _, clean_ran = _small_bn_run()
    monkeypatch.setenv("HOROVOD_HEALTH", "1")
    flight.reset()
    sd, tr, stats, ran = _small_bn_run(RB_POISON, ckdir=str(tmp_path))
    events = [e for e in flight.recorder().snapshot()
              if e["kind"] == "autopilot"]
    verdicts = {s: ckpt.verdict_of(str(tmp_path), s)
                for s in ckpt._complete_steps(str(tmp_path))}
    assert "poisoned" in verdicts.values(), verdicts
    # the alert stays latched a commit or more: its later verdicts are
    # paced off by the cooldown
    assert set(stats["by_outcome"]) <= {"applied", "dry_run",
                                        "suppressed:cooldown"}, stats
    if dry_run:
        assert stats["rollbacks"] == 0
        assert stats["by_outcome"]["dry_run"] == 1 and not any(
            e["outcome"] == "applied" for e in events)
        assert ran == clean_ran
        assert not all(torch.isfinite(v).all() for v in sd.values()
                       if v.is_floating_point())
        return
    assert stats["rollbacks"] == 1, stats
    applied = [e for e in events if e["outcome"] == "applied"]
    assert len(applied) == 1 and applied[0]["rule"] == "health_rollback"
    assert applied[0]["evidence"]["alerts"] == ["nonfinite"]
    # the poisoned step's commit (RB_POISON + 1) rolled back to the one
    # before it, and the steps between ran twice
    back = RB_POISON - RB_POISON % RB_EVERY
    assert ran == clean_ran[:RB_POISON + 1] + clean_ran[back:], ran
    assert sd.keys() == clean.keys()
    for k in sd:
        assert torch.equal(sd[k], clean[k]), k
    for a, b in zip(tr, clean_tr):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# 3. Two processes on the negotiated plane
# ---------------------------------------------------------------------------


def test_autopilot_rollback_2proc(tmp_path):
    """``tests/test_autopilot.py::test_autopilot_rollback_2proc`` on the
    port: rank 1's gradient buffer is nan-poisoned once (a rule with a
    round, budget 1), the nonfinite sentinel trips, the poisoned commit
    is stamped, rank 0's tick broadcasts the rollback, every rank
    restores the newest healthy commit, and the replayed steps land on
    ``w`` bit-identical to optax's unpoisoned trajectory."""
    import jax.numpy as jnp
    import optax

    d = str(tmp_path / "ring")
    outs = spawn(2, "cpu", timeout=120, mode="autopilot_rollback",
                 env_extra={"HOROVOD_HEALTH": "1", "HOROVOD_AUTOPILOT": "1",
                            "HOROVOD_CHECKPOINT_KEEP": "4",
                            "HOROVOD_FUSED_UPDATE": "1",
                            "HOROVOD_FAULT_SPEC":
                                "nan@rank1:grad_buffer*:round4",
                            "APX_CKPT": d})
    r0, r1 = outs
    # rank 0 judged: one applied rollback; the latched alert's later
    # verdicts paced off by the cooldown
    assert r0["rollbacks"] == 1, r0
    assert set(r0["outcomes"]) <= {"applied", "suppressed:cooldown"}
    applied = [e for e in r0["events"] if e["outcome"] == "applied"]
    assert len(applied) == 1 and applied[0]["act"] == "rollback"
    assert r1["events"] == []   # rank 1 acts on the broadcast decision
    assert r0["w"] == r1["w"]
    target = jnp.arange(1.0, 5.0)
    opt = optax.sgd(0.1, momentum=0.9)
    params = {"w": jnp.zeros((4,), jnp.float32)}
    s = opt.init(params)
    for t in range(10):
        g = {"w": (params["w"] - target) * (0.5 + 0.1 * t)}
        upd, s = opt.update(g, s, params)
        params = optax.apply_updates(params, upd)
    assert r0["w"] == np.asarray(params["w"]).tolist()
    verdicts = [ckpt.verdict_of(d, st) for st in ckpt._complete_steps(d)]
    assert "poisoned" in verdicts, verdicts


# ---------------------------------------------------------------------------
# 4. The elastic launcher
# ---------------------------------------------------------------------------


def _launch(np_: int, args=(), timeout: float = 120, **env_extra):
    env = dict(os.environ)
    env.update({"PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                "HOROVOD_PLATFORM": "cpu",
                "HOROVOD_HEARTBEAT_INTERVAL": "0.2",
                "HOROVOD_HEARTBEAT_TIMEOUT_SECONDS": "2",
                "HOROVOD_ELASTIC_SETTLE_SECONDS": "1",
                "HOROVOD_SHUTDOWN_TIMEOUT_SECONDS": "5",
                "HOROVOD_METRICS_PUBLISH_INTERVAL": "0"})
    env.update(env_extra)
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
         "--elastic", "--autopilot", *args, "--", sys.executable, SCRIPT],
        env=env, capture_output=True, text=True, timeout=timeout)
    events = []
    for ln in out.stdout.splitlines():
        _, _, rest = ln.partition(">:")
        if rest.startswith("{"):
            events.append(json.loads(rest))
    return out, events


def _flight_autopilot(d) -> list:
    """The ``autopilot`` events of the launcher's dump (the one dump
    without an ``initialized`` rank in its meta)."""
    found = []
    for name in os.listdir(d):
        if not (name.startswith("flight-") and name.endswith(".jsonl")):
            continue
        with open(os.path.join(d, name)) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        if not lines or "initialized" in lines[0]["meta"]:
            continue
        found += [e for e in lines if e.get("kind") == "autopilot"]
    return found


def test_autopilot_flags_reach_the_ranks():
    """The launcher's ``--autopilot*`` flags export their knobs to every
    rank, as the other knobs' flags do."""
    prog = ("import os, json; print(json.dumps({k: v for k, v in "
            "os.environ.items() if k.startswith('HOROVOD_AUTOPILOT')}))")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         "--autopilot", "--autopilot-dry-run", "--autopilot-trip-ticks",
         "5", "--autopilot-cooldown-seconds", "7.5",
         "--autopilot-straggler-floor", "0.2", "--", sys.executable, "-c",
         prog], env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = [json.loads(ln.partition(">:")[2]) for ln in
            out.stdout.splitlines() if ">:{" in ln]
    assert len(seen) == 2
    for knobs in seen:
        assert knobs == {"HOROVOD_AUTOPILOT": "1",
                         "HOROVOD_AUTOPILOT_DRY_RUN": "1",
                         "HOROVOD_AUTOPILOT_TRIP_TICKS": "5",
                         "HOROVOD_AUTOPILOT_COOLDOWN_SECONDS": "7.5",
                         "HOROVOD_AUTOPILOT_STRAGGLER_FLOOR": "0.2"}


def test_straggler_host_blacklisted_before_any_death(tmp_path):
    """Item 7 of the autopilot's slice: three gloo ranks on two launcher
    hosts (``localhost`` x 2, ``127.0.0.1`` x 1), rank 2 slowed by
    ``slow:2:1s`` (its heartbeats come late).  The sweeping rank 0
    publishes the lateness as ``hvd_heartbeat_staleness_seconds{peer=
    "2"}``; the launcher's sweep reads it from the KV snapshots, and
    ``straggler_blacklist`` names ``127.0.0.1`` (each rank publishes the
    launcher's name of its host) and kills its process before any rank
    died of a heartbeat timeout; the survivors re-form to 2 and finish
    on the closed form."""
    fl = tmp_path / "fl"
    out, ev = _launch(
        3, ("-H", "localhost:2,127.0.0.1:1", "--min-ranks", "2",
            "--blacklist-cooldown-seconds", "600"), timeout=150,
        HOROVOD_FAULT_SPEC="slow:2:1s",
        HOROVOD_HEARTBEAT_TIMEOUT_SECONDS="6",
        HOROVOD_METRICS_PUBLISH_INTERVAL="0.5",
        HOROVOD_AUTOPILOT_TRIP_TICKS="1",
        HOROVOD_AUTOPILOT_STRAGGLER_FLOOR="0.6",
        HOROVOD_FLIGHT_DIR=str(fl),
        ELX_TOTAL="60", ELX_STEP_SLEEP="0.1")
    err = out.stderr
    assert out.returncode == 0, err[-4000:]
    assert err.count("[hvdrun autopilot] engaged: rules") == 1
    assert "preemptive blacklist of straggler host 127.0.0.1: killed " \
        "['2']" in err, err[-4000:]
    # the blacklist came first: no heartbeat timeout named a dead rank
    # before it, and the launcher saw rank 2's death only as its kill
    cut = err.index("preemptive blacklist of straggler host")
    assert "missed heartbeats" not in err[:cut]
    assert "rank 2 on 127.0.0.1 died" in err[cut:]
    acts = _flight_autopilot(fl)
    bl = [a for a in acts if a["rule"] == "straggler_blacklist"
          and a["outcome"] == "applied"]
    assert len(bl) == 1, acts
    evd = bl[0]["evidence"]
    assert evd["host"] == "127.0.0.1" and evd["rank"] == 2
    assert evd["lateness_s"] > evd["threshold_s"] >= 0.6
    final = [e for e in ev if e["event"] == "final"]
    assert sorted((e["uid"], e["size"]) for e in final) == [
        ("rank0", 2), ("rank1", 2)]
    for e in final:
        assert e["params"] == e["closed"]
    print(f"[autopilot] straggler evidence {evd}")


def test_slo_shrink_on_one_host_at_the_default_floor(tmp_path):
    """Two gloo ranks on one host at the straggler rule's default floor
    (0.05 s, below the heartbeat's 0.2 s period) and a rate limit of one
    action: rank 1 is slowed by ``slow:1:0.3s``, each step's update runs
    inside a ``trace_step`` span and the slowed commit and poll outside
    it, and every rank publishes its metrics from ``init()`` on.  On one
    host the sweep leaves the straggler rule unfed: its blacklist could
    only shed the whole job, and the refused verdict would spend the one
    action the limit allows.  So that action is the SLO's:
    ``slo_burn_shrink`` sheds rank 1 (not on the start, which no rank
    has stepped through), and rank 0 re-forms alone and finishes on the
    closed form."""
    fl = tmp_path / "fl"
    out, ev = _launch(
        2, ("--min-ranks", "1"), timeout=150,
        HOROVOD_FAULT_SPEC="slow:1:0.3s",
        HOROVOD_METRICS_PUBLISH_INTERVAL="0.5",
        HOROVOD_GOODPUT_SLO="0.95", HOROVOD_GOODPUT_WINDOW_SECONDS="4",
        HOROVOD_AUTOPILOT_TRIP_TICKS="2", HOROVOD_AUTOPILOT_RATE_LIMIT="1",
        HOROVOD_FLIGHT_DIR=str(fl), ELX_TRACE="1", ELX_TOTAL="60")
    err = out.stderr
    assert out.returncode == 0, err[-4000:]
    acts = _flight_autopilot(fl)
    assert not [a for a in acts if a["rule"] == "straggler_blacklist"], acts
    applied = [a for a in acts if a["outcome"] == "applied"]
    assert [a["rule"] for a in applied] == ["slo_burn_shrink"], acts
    evd = applied[0]["evidence"]
    assert evd["bottleneck_rank"] == 1 and evd["killed"] == ["1"], evd
    assert "SLO-burn shrink: shed rank 1 on localhost" in err
    final = [e for e in ev if e["event"] == "final"]
    assert [(e["uid"], e["size"]) for e in final] == [("rank0", 1)]
    for e in final:
        assert e["params"] == e["closed"]
    print(f"[autopilot] SLO evidence {evd}; verdicts "
          f"{sorted((a['rule'], a['outcome']) for a in acts)}")


def test_preempt_request_goes_through_the_ungated_rule(tmp_path):
    """``--preempt 1`` from inside the job, autopilot engaged: the
    launcher's ``preempt_drain`` verdict is applied ungated, rank 1
    drains with one emergency commit and exits 0, the survivor re-forms
    and finishes; the launcher's flight dump holds the verdict with its
    rank, uid and source."""
    fl = tmp_path / "fl"
    out, ev = _launch(2, ("--min-ranks", "1"), HOROVOD_FLIGHT_DIR=str(fl),
                      ELX_TOTAL="40", ELX_STEP_SLEEP="0.1",
                      ELX_PREEMPT_STEP="4", ELX_PREEMPT_RANK="1")
    err = out.stderr
    assert out.returncode == 0, err[-4000:]
    assert err.count("[hvdrun autopilot] engaged: rules") == 1
    assert "graceful drain ordered for rank 1 (uid rank1)" in err
    assert "exited after graceful preemption drain (rc=0)" in err
    assert "[hvdrun autopilot] 1 verdict(s): {'applied': 1}" in err
    acts = _flight_autopilot(fl)
    assert len(acts) == 1 and acts[0]["rule"] == "preempt_drain", acts
    assert acts[0]["outcome"] == "applied"
    assert {k: acts[0]["evidence"][k] for k in ("rank", "uid", "source")} \
        == {"rank": 1, "uid": "rank1", "source": "cli"}
    final = [e for e in ev if e["event"] == "final"]
    assert [(e["uid"], e["size"]) for e in final] == [("rank0", 1)]
    assert final[0]["params"] == final[0]["closed"]


def test_dry_run_records_the_drain_and_orders_none(tmp_path):
    out, ev = _launch(1, ("--autopilot-dry-run",), ELX_TOTAL="24",
                      ELX_STEP_SLEEP="0.1", ELX_PREEMPT_STEP="3",
                      ELX_PREEMPT_RANK="0")
    err = out.stderr
    assert out.returncode == 0, err[-4000:]
    assert err.count("[hvdrun autopilot] engaged (dry-run): rules") == 1
    assert "[hvdrun autopilot] 1 verdict(s): {'dry_run': 1}" in err
    assert "graceful drain ordered" not in err
    assert "preemption drain" not in err
    final = [e for e in ev if e["event"] == "final"]
    assert [(e["uid"], e["step"]) for e in final] == [("rank0", 24)]
