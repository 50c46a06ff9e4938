"""The port's graceful-preemption plane
(``horovod_tpu_torch/runtime/preemption.py``) against the JAX package's.

1. The unit cases of ``tests/test_preemption.py:59-270,295``, each driven
   through both packages over the same in-memory rendezvous: the notice
   surfaces (API, fault rule, KV address, metadata stub, signals and
   their escalation), the drain-order protocol (rank 0 orders the drain
   one boundary ahead), the launcher's exit disposition.
2. A world of three emulated ranks ticking the protocol over one fake
   rendezvous, with the same notices: both packages give the same drain
   boundary and raise ``PreemptionInterrupt`` on every rank at that same
   boundary, in the same order.
3. Spawned gloo worlds started by ``python -m horovod_tpu_torch.run``:
   a ``preempt:rank1:round<n>`` rule on a world of 2, and a SIGTERM drain
   on a world of 3 — one emergency commit at the same step on every rank,
   the noticed rank exits 0 as ``preempted`` (not blacklisted), the
   survivors re-form to 2 and finish on the closed form.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from horovod_tpu import elastic as jelastic
from horovod_tpu.run import launcher as jlauncher
from horovod_tpu.runtime import faults as jfaults
from horovod_tpu.runtime import preemption as jpre

from horovod_tpu_torch import elastic as telastic
from horovod_tpu_torch.run import launcher as tlauncher
from horovod_tpu_torch.runtime import faults as tfaults
from horovod_tpu_torch.runtime import preemption as tpre

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "_torch_elastic_train_script.py")

PKGS = {"jax": (jpre, jelastic, jfaults, jlauncher),
        "port": (tpre, telastic, tfaults, tlauncher)}


class FakeStore:
    def __init__(self):
        self.cond = threading.Condition()
        self.data: dict[str, str] = {}


class FakeTransport:
    """The rendezvous surface of a KVStoreClient over a dict."""

    def __init__(self, store: FakeStore):
        self.store = store

    def set(self, key, value):
        with self.store.cond:
            self.store.data[key] = value
            self.store.cond.notify_all()

    set_overwrite = set

    def set_once(self, key, value):
        with self.store.cond:
            self.store.data.setdefault(key, value)

    def get_blocking(self, key, timeout_s):
        deadline = time.monotonic() + timeout_s
        with self.store.cond:
            while key not in self.store.data:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(key)
                self.store.cond.wait(remaining)
            return self.store.data[key]

    def try_get(self, key):
        with self.store.cond:
            return self.store.data.get(key)

    def delete(self, key):
        with self.store.cond:
            self.store.data.pop(key, None)


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    pre = PKGS[request.param][0]
    pre.reset()
    pre.set_metadata_source(None)
    yield PKGS[request.param]
    pre.reset()
    pre.set_metadata_source(None)


class _WorldStub:
    initialized = True

    def __init__(self, rank, size):
        self.rank = rank
        self.size = size


def _stub_world(monkeypatch, pkg, store, rank, size, gen=None):
    pre, el = pkg[0], pkg[1]
    gen = gen or {"v": 1}
    t = FakeTransport(store)
    monkeypatch.setattr(pre._basics, "state", lambda: _WorldStub(rank, size))
    monkeypatch.setattr(el, "generation", lambda: gen["v"])
    monkeypatch.setattr(el, "_rv", lambda: t)
    monkeypatch.setattr(el, "_uid", lambda: f"rank{rank}")
    monkeypatch.setattr(el, "enabled", lambda: True)
    monkeypatch.setattr(pre, "grace_seconds", lambda: 30.0)
    return t


# ---------------------------------------------------------------------------
# Notice surfaces
# ---------------------------------------------------------------------------


def test_notice_is_once_per_process(pkg):
    pre = pkg[0]
    assert not pre.noticed()
    assert pre.notice(source="test", grace_s=12.0) is True
    assert pre.noticed()
    assert pre.notice(source="test2") is False
    pre.reset()
    assert not pre.noticed()


def test_request_drain_and_drain_requested(pkg):
    pre = pkg[0]
    t = FakeTransport(FakeStore())
    assert pre.drain_requested(t, "rank3") is False
    pre.request_drain(t, "rank3", grace_s=12.0, source="launcher")
    assert pre.drain_requested(t, "rank3") is True
    assert pre.drain_requested(t, "rank4") is False
    rec = json.loads(t.try_get("el/preempt/u/rank3"))
    assert rec["source"] == "launcher" and rec["grace_s"] == 12.0

    class Broken:
        def try_get(self, key):
            raise OSError("wire down")

    assert pre.drain_requested(Broken(), "rank0") is False


def test_fault_spec_preempt_parse(pkg):
    faults = pkg[2]
    r = faults.parse_spec("preempt:rank1:round4:grace30s")[0]
    assert (r.kind, r.rank, r.round, r.delay_s, r.remaining) == \
        ("preempt", 1, 4, 30.0, 1)
    r = faults.parse_spec("preempt:rank3:grace500ms")[0]
    assert (r.rank, r.round, r.delay_s) == (3, 0, 0.5)
    for bad in ("preempt:rank1:bogus", "preempt:nope", "zap:rank1"):
        with pytest.raises(faults.FaultSpecError, match="preempt"):
            faults.parse_spec(bad)


def test_fault_rule_delivers_notice_not_death(pkg):
    pre, faults = pkg[0], pkg[2]
    ft = faults.FaultyTransport(None, 1, faults.parse_spec("preempt:rank1"))
    assert not pre.noticed()
    assert ft._intercept("ar/somekey", True) is False  # the op proceeds
    assert pre.noticed()
    ft._intercept("ar/somekey", True)
    assert ft.rules[0].remaining == 0
    pre.reset()
    other = faults.FaultyTransport(None, 0, faults.parse_spec("preempt:rank1"))
    other._intercept("ar/somekey", True)
    assert not pre.noticed()


def test_metadata_source_stub(pkg, monkeypatch):
    pre = pkg[0]
    store = FakeStore()
    _stub_world(monkeypatch, pkg, store, rank=0, size=1)
    pre.set_metadata_source(lambda: {"grace_s": 7.0})
    pre.maybe_interrupt()
    assert pre.noticed()
    rec = json.loads(store.data["el/preempt/g1/0"])
    assert rec["source"] == "metadata" and rec["grace_s"] == 7.0


def test_signal_delivers_notice(pkg, monkeypatch):
    pre = pkg[0]
    monkeypatch.setattr(pre, "enabled", lambda: True)
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    assert pre.install_signal_handlers()
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 5.0
        while pre._pending_signal is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pre._pending_signal == "SIGUSR1"
        assert not pre.noticed()
        pre._adopt_pending_signal()
        assert pre.noticed() and pre._pending_signal is None
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
        pre._handlers_installed = False
        pre._prev_handlers.clear()


def test_second_signal_escalates_to_previous_handler(pkg, monkeypatch):
    pre = pkg[0]
    monkeypatch.setattr(pre, "enabled", lambda: True)
    pre.notice(source="test")
    calls = []
    monkeypatch.setitem(pre._prev_handlers, signal.SIGUSR1,
                        lambda s, f: calls.append(s))
    pre._on_notice_signal(signal.SIGUSR1, None)
    assert calls == [signal.SIGUSR1]


# ---------------------------------------------------------------------------
# The drain-order protocol
# ---------------------------------------------------------------------------


def test_rank0_orders_drain_one_boundary_ahead(pkg, monkeypatch):
    pre = pkg[0]
    store = FakeStore()
    _stub_world(monkeypatch, pkg, store, rank=0, size=2)
    store.data["el/preempt/g1/1"] = json.dumps(
        {"rank": 1, "source": "signal:SIGTERM", "grace_s": 30.0,
         "wall": 1000.0})
    store.data["el/preempt_any/g1"] = "1"
    pre.maybe_interrupt()
    order = json.loads(store.data["el/drain/g1"])
    assert order["boundary"] == 2 and order["ranks"] == [1]
    assert order["deadline"] == 1030.0
    with pytest.raises(pre.PreemptionInterrupt) as ei:
        pre.maybe_interrupt()
    assert ei.value.ranks == [1] and ei.value.order["deadline"] == 1030.0


def test_noticed_rank_publishes_then_raises_on_order(pkg, monkeypatch):
    pre = pkg[0]
    store = FakeStore()
    t = _stub_world(monkeypatch, pkg, store, rank=1, size=2)
    pre.notice(source="test", grace_s=12.0)
    pre.maybe_interrupt()
    rec = json.loads(store.data["el/preempt/g1/1"])
    assert rec["rank"] == 1 and rec["gen"] == 1 and rec["uid"] == "rank1"
    assert rec["source"] == "test" and rec["grace_s"] == 12.0
    assert store.data["el/preempt_any/g1"] == "1"
    assert pre.drain_requested(t, "rank1")
    store.data["el/drain/g1"] = json.dumps(
        {"gen": 1, "boundary": 2, "ranks": [1], "wall": None,
         "deadline": None})
    with pytest.raises(pre.PreemptionInterrupt):
        pre.maybe_interrupt()


def test_external_kv_notice_full_loop(pkg, monkeypatch):
    pre = pkg[0]
    store = FakeStore()
    t = _stub_world(monkeypatch, pkg, store, rank=0, size=1)
    pre.request_drain(t, "rank0", grace_s=5.0, source="launcher")
    pre.maybe_interrupt()
    assert pre.noticed()
    rec = json.loads(store.data["el/preempt/g1/0"])
    assert rec["source"] == "launcher" and rec["grace_s"] == 5.0
    with pytest.raises(pre.PreemptionInterrupt) as ei:
        pre.maybe_interrupt()
    assert ei.value.ranks == [0]


def test_notice_republished_after_generation_roll(pkg, monkeypatch):
    pre = pkg[0]
    store = FakeStore()
    gen = {"v": 1}
    _stub_world(monkeypatch, pkg, store, rank=1, size=2, gen=gen)
    pre.notice(source="test")
    pre.maybe_interrupt()
    assert "el/preempt/g1/1" in store.data
    gen["v"] = 2
    pre.maybe_interrupt()
    assert "el/preempt/g2/1" in store.data


def test_protocol_noop_when_plane_disabled(pkg, monkeypatch):
    pre = pkg[0]
    store = FakeStore()
    _stub_world(monkeypatch, pkg, store, rank=0, size=2)
    monkeypatch.setattr(pre, "enabled", lambda: False)
    store.data["el/preempt_any/g1"] = "1"
    store.data["el/preempt/g1/1"] = json.dumps({"rank": 1, "wall": 1.0})
    pre.maybe_interrupt()
    assert "el/drain/g1" not in store.data


def test_launcher_exit_disposition_preempted_is_not_a_death(pkg):
    disp = pkg[3]._exit_disposition
    assert disp(0) == "finished"
    assert disp(1) == "died"
    assert disp(1, cancelled=True) == "cancelled"
    assert disp(1, joiner_gave_up=True) == "join_timeout"
    assert disp(0, preempted=True) == "preempted"
    assert disp(1, preempted=True, cancelled=True) == "preempted"


_RANK_GLOBALS = ("_notice", "_pending_signal", "_published", "_boundary",
                 "_boundary_gen")


def _world_trace(pkg, monkeypatch, notices: dict, boundaries: int = 8):
    """Three emulated ranks tick the protocol in lockstep over one fake
    rendezvous (each rank's module globals swapped in around its tick);
    ``notices`` maps rank -> the boundary at which it gets a notice.
    Returns (the drain order, [(boundary, rank, ranks raised)...])."""
    pre, el = pkg[0], pkg[1]
    store = FakeStore()
    t = FakeTransport(store)
    size = 3
    per_rank = [{k: getattr(pre, k) for k in _RANK_GLOBALS}
                for _ in range(size)]
    monkeypatch.setattr(el, "generation", lambda: 1)
    monkeypatch.setattr(el, "_rv", lambda: t)
    monkeypatch.setattr(el, "enabled", lambda: True)
    monkeypatch.setattr(pre, "grace_seconds", lambda: 30.0)
    raised, done = [], set()
    for b in range(1, boundaries + 1):
        for r in range(size):
            if r in done:
                continue
            for k, v in per_rank[r].items():
                setattr(pre, k, v)
            monkeypatch.setattr(pre._basics, "state",
                                lambda r=r: _WorldStub(r, size))
            monkeypatch.setattr(el, "_uid", lambda r=r: f"rank{r}")
            if notices.get(r) == b:
                pre.notice(source="test", grace_s=10.0)
            try:
                pre.maybe_interrupt()
            except pre.PreemptionInterrupt as exc:
                raised.append((b, r, exc.ranks))
                done.add(r)
            per_rank[r] = {k: getattr(pre, k) for k in _RANK_GLOBALS}
    order = json.loads(store.data["el/drain/g1"])
    return {k: order[k] for k in ("boundary", "ranks", "gen")}, raised


@pytest.mark.parametrize("notices", [{2: 2}, {1: 3, 2: 3}, {0: 1}])
def test_three_rank_drain_boundary_matches_the_jax_package(notices,
                                                           monkeypatch):
    out = {}
    for name, pkg in PKGS.items():
        pkg[0].reset()
        out[name] = _world_trace(pkg, monkeypatch, notices)
        pkg[0].reset()
    assert out["port"] == out["jax"]
    order, raised = out["port"]
    # every rank raised once, at the ordered boundary, naming the same
    # ranks: nobody a step apart
    assert sorted(r for _, r, _ in raised) == [0, 1, 2]
    assert {b for b, _, _ in raised} == {order["boundary"]}
    assert all(rs == sorted(notices) for _, _, rs in raised)


# ---------------------------------------------------------------------------
# Spawned worlds
# ---------------------------------------------------------------------------


def _launch(np_: int, extra_args=(), **env_extra):
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
         *extra_args, "--", sys.executable, SCRIPT],
        env=env, capture_output=True, text=True, timeout=120)
    events = []
    for ln in out.stdout.splitlines():
        _, _, rest = ln.partition(">:")
        if rest.startswith("{"):
            events.append(json.loads(rest))
    return out, events


def test_preempt_fault_rule_drains_a_world_of_two():
    """``preempt:rank1:round3`` on the eager wire: rank 1 gets its notice
    at its first op of round 3, both ranks raise at the same boundary,
    rank 1 exits 0 as preempted and rank 0 finishes alone."""
    out, ev = _launch(2, ("--elastic", "--blacklist-cooldown-seconds",
                          "600"),
                      HOROVOD_FAULT_SPEC="preempt:rank1:round3",
                      ELX_EAGER="1", ELX_TOTAL="8")
    assert out.returncode == 0, out.stderr[-4000:]
    assert "[fault] preempt:rank1:round3 delivering notice" in out.stderr
    inter = [e for e in ev if e["event"] == "interrupt"]
    assert sorted(e["rank"] for e in inter) == [0, 1]
    assert {e["kind"] for e in inter} == {"PreemptionInterrupt"}
    assert len({(e["step"], e["commits"]) for e in inter}) == 1
    final = [e for e in ev if e["event"] == "final"]
    assert [(e["uid"], e["size"]) for e in final] == [("rank0", 1)]
    assert final[0]["params"] == final[0]["closed"]
    assert "exited after graceful preemption drain" in out.stderr
    assert "blacklisting" not in out.stderr


def test_sigterm_drain_world_of_three():
    out, ev = _launch(3, ("--elastic", "--min-ranks", "2",
                          "--blacklist-cooldown-seconds", "600"),
                      ELX_TOTAL="8", ELX_NOTICE_UID="rank2",
                      ELX_NOTICE_STEP="3")
    assert out.returncode == 0, out.stderr[-4000:]
    inter = [e for e in ev if e["event"] == "interrupt"]
    assert sorted(e["rank"] for e in inter) == [0, 1, 2]
    # one emergency commit, at the same step and commit index everywhere
    assert len({(e["step"], e["commits"]) for e in inter}) == 1
    assert "rank 2 drained at commit step" in out.stderr
    assert "exited after graceful preemption drain (rc=0)" in out.stderr
    assert "blacklisting" not in out.stderr
    assert 'reason="preempt"' in out.stderr
    final = sorted((e["uid"], e["size"], e["gen"]) for e in ev
                   if e["event"] == "final")
    assert final == [("rank0", 2, 2), ("rank1", 2, 2)]
    for e in ev:
        if e["event"] == "final":
            assert e["params"] == e["closed"]
