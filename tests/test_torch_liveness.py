"""Liveness and the coordinated abort of the port's eager plane, against
the JAX package's (``tests/test_fault_tolerance.py:198-283``,
``tests/test_control_plane.py:261-292``).

1. In one process, the port's ``KVController`` and
   ``horovod_tpu.runtime.controller.KVController`` over the same kind of
   in-memory transport (``FakeTransport``): with an injected clock and
   the same scripted beats, the same sweep rings and budgets, the same
   dead set, the same abort text and the same abort keys; on the real
   clock (the reference's short knobs), a survivor picks up a broadcast
   abort, a dead coordinator is detected, an idle rank notices through
   ``should_participate``, and the coordinator blocked on a dead rank
   raises within the heartbeat deadline.
2. A gloo world of 3 running a loop of eager allreduces with
   ``HOROVOD_HEARTBEAT_INTERVAL=0.2`` and
   ``HOROVOD_HEARTBEAT_TIMEOUT_SECONDS=2``: rank 2 SIGKILLs itself, and
   ranks 0 and 1 raise ``RanksDownError`` naming ``[2]`` within the
   timeout plus 5 s (``tests/test_fault_tolerance.py:599``).
"""

import json
import os
import subprocess
import sys
import time

import pytest

from horovod_tpu.common.types import RanksDownError as JRanksDown
from horovod_tpu.runtime import controller as jctl

from horovod_tpu_torch.common.types import RanksDownError
from horovod_tpu_torch.runtime import controller as tctl

from test_fault_tolerance import FakeStore, FakeTransport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODS = {"jax": jctl, "port": tctl}
ERRS = {"jax": JRanksDown, "port": RanksDownError}


def _liveness_env(monkeypatch, interval="0.05", timeout="0.3", wire="20"):
    monkeypatch.setenv("HOROVOD_HEARTBEAT_INTERVAL", interval)
    monkeypatch.setenv("HOROVOD_HEARTBEAT_TIMEOUT_SECONDS", timeout)
    monkeypatch.setenv("HOROVOD_WIRE_TIMEOUT_SECONDS", wire)


class _Clock:
    """The controllers' ``time`` module with a scripted monotonic clock."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return 1.7e9 + self.t

    def sleep(self, s: float) -> None:
        self.t += s

    perf_counter = monotonic


class _Beating:
    """Stands in for a started heartbeat publisher (liveness on, no
    thread)."""

    def stop(self) -> None:
        pass


# ---------------------------------------------------------------------------
# 1. In one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fanout", [0, 2, 3, 4, 8])
@pytest.mark.parametrize("world", [2, 5, 9, 12, 33])
def test_sweep_ring_and_budget_match_jax(monkeypatch, world, fanout):
    _liveness_env(monkeypatch, interval="1.5")
    ctls = {k: [m.KVController(FakeTransport(FakeStore()), r, world,
                               epoch=1, fanout=fanout)
                for r in range(world)] for k, m in MODS.items()}
    for r in range(world):
        ring = ctls["port"][r]._sweep_ring()
        assert ring == ctls["jax"][r]._sweep_ring(), (world, fanout, r)
        assert r not in ring and ring
        for n in (1, len(ring), 8, 40, 4096):
            assert ctls["port"][r]._sweep_budget_s(n) == \
                ctls["jax"][r]._sweep_budget_s(n)


def _scripted_sweep(mod, clock, monkeypatch):
    """Rank 0 of a world of 4 on ``clock``: ranks 1 and 2 beat at t=0,
    rank 3 never does; at t=2 rank 1 beats again; at t=5 rank 1 beats
    again.  Returns the dead sets of the first two sweeps, the exception
    of the third and the store."""
    monkeypatch.setattr(mod, "time", clock)
    store = FakeStore()
    ctl = mod.KVController(FakeTransport(store), 0, 4, epoch=9)
    ctl._heartbeat = _Beating()
    store.data["hvd9/hb/1"] = "1:0.5"
    store.data["hvd9/hb/2"] = "1:0.5"
    dead = [ctl._sweep_peers()]
    clock.t += 2.0
    store.data["hvd9/hb/1"] = "2:2.5"
    dead.append(ctl._sweep_peers())
    clock.t += 3.0
    store.data["hvd9/hb/1"] = "3:5.5"
    ctl._last_sweep = -1e9
    with pytest.raises(Exception) as ei:
        ctl.check_liveness()
    return dead, ei.value, dict(store.data)


def test_dead_set_and_abort_text_match_jax(monkeypatch):
    _liveness_env(monkeypatch, interval="1", timeout="4")
    got = {k: _scripted_sweep(m, _Clock(), monkeypatch)
           for k, m in MODS.items()}
    (jdead, jexc, jstore), (tdead, texc, tstore) = got["jax"], got["port"]
    assert tdead == jdead == [[], []]
    assert isinstance(texc, RanksDownError) and isinstance(jexc, JRanksDown)
    assert str(texc) == str(jexc)
    assert texc.ranks == jexc.ranks == (2, 3)
    assert texc.round == 0 and texc.elapsed == pytest.approx(5.0)
    assert "rank(s) [2, 3] missed heartbeats for 5.0s" in str(texc)
    # the abort key and the error response list at p/0, byte for byte
    assert tstore == jstore
    assert tstore["hvd9/a"] == str(texc)
    resp = tctl._wire.loads_resp(tstore["hvd9/p/0"])
    assert resp["x"] and resp["resp"][0]["k"] == "error"
    assert resp["resp"][0]["n"] == [tctl.JOIN_NAME]


def test_abort_message_matches_jax(monkeypatch):
    _liveness_env(monkeypatch, timeout="20")
    for dead in ([(1, 12.3)], [(3, 4.04), (2, 7.96)], [(0, 21.0)]):
        msgs = [m.KVController(FakeTransport(FakeStore()), 0, 4,
                               epoch=2)._abort_message(dead)
                for m in (jctl, tctl)]
        assert msgs[0] == msgs[1]
        e = RanksDownError(msgs[1])
        assert e.ranks == tuple(sorted(r for r, _ in dead))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_coordinator_aborts_on_dead_rank(monkeypatch, pkg):
    _liveness_env(monkeypatch)
    mod = MODS[pkg]
    store = FakeStore()
    ctl = mod.KVController(FakeTransport(store), rank=0, world=2, epoch=7)
    ctl.start_heartbeat()
    try:
        t0 = time.monotonic()
        with pytest.raises(ERRS[pkg]) as ei:
            ctl.negotiate([mod.Request("t", "allreduce", 2, 8, (2,))],
                          False, False)
        assert time.monotonic() - t0 < 5
        assert ei.value.ranks == (1,) and ei.value.round == 0
        assert ei.value.elapsed > 0
        assert "rank(s) [1]" in str(ei.value)
        assert store.data.get("hvd7/a", "").startswith("RanksDownError:")
        assert "hvd7/p/0" in store.data
    finally:
        ctl.close()
    # the beat was withdrawn at close
    assert "hvd7/hb/0" not in store.data


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_survivor_observes_broadcast_abort(monkeypatch, pkg):
    _liveness_env(monkeypatch, timeout="30")
    mod = MODS[pkg]
    store = FakeStore()
    view = mod.KVController(FakeTransport(store), rank=0, world=2, epoch=3)
    store.data["hvd3/a"] = view._abort_message([(1, 12.3)])
    store.data["hvd3/hb/0"] = "1"
    ctl = mod.KVController(FakeTransport(store), rank=1, world=2, epoch=3)
    ctl.start_heartbeat()
    try:
        t0 = time.monotonic()
        with pytest.raises(ERRS[pkg]) as ei:
            ctl.negotiate([], False, False)
        assert time.monotonic() - t0 < 5
        assert ei.value.ranks == (1,)
        assert ei.value.elapsed == pytest.approx(12.3)
    finally:
        ctl.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_survivor_detects_dead_coordinator(monkeypatch, pkg):
    _liveness_env(monkeypatch)
    mod = MODS[pkg]
    store = FakeStore()
    ctl = mod.KVController(FakeTransport(store), rank=1, world=2, epoch=5)
    ctl.start_heartbeat()
    try:
        t0 = time.monotonic()
        with pytest.raises(ERRS[pkg]) as ei:
            ctl.negotiate([], False, False)
        assert time.monotonic() - t0 < 5
        assert ei.value.ranks == (0,)
        note = store.data.get("hvd5/a", "")
        assert note.startswith("RanksDownError:")
        assert json.loads(note.split(" ", 1)[1].split(" — ")[0])["by"] == 1
    finally:
        ctl.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_idle_rank_notices_abort_via_should_participate(monkeypatch, pkg):
    _liveness_env(monkeypatch)
    mod = MODS[pkg]
    store = FakeStore()
    ctl = mod.KVController(FakeTransport(store), rank=1, world=2, epoch=2)
    ctl.start_heartbeat()
    try:
        store.data["hvd2/hb/0"] = "1"
        assert ctl.should_participate(False) is False
        other = mod.KVController(FakeTransport(store), rank=0, world=2,
                                 epoch=2)
        store.data["hvd2/a"] = other._abort_message([(0, 9.9)])
        time.sleep(0.06)
        with pytest.raises(ERRS[pkg]):
            ctl.should_participate(False)
    finally:
        ctl.close()


def test_liveness_off_without_knobs(monkeypatch):
    """Interval 0: no beat, no sweep; ``check_liveness`` of the eager API
    is a no-op before the runtime starts."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import eager

    monkeypatch.setenv("HOROVOD_HEARTBEAT_INTERVAL", "0")
    store = FakeStore()
    ctl = tctl.KVController(FakeTransport(store), rank=0, world=2, epoch=4)
    ctl.start_heartbeat()
    assert ctl._heartbeat is None and not ctl._liveness_enabled()
    ctl.check_liveness()
    assert store.data == {}
    if not hvd.is_initialized():
        eager.check_liveness()


# ---------------------------------------------------------------------------
# 2. SIGKILL in a gloo world of 3
# ---------------------------------------------------------------------------

KILL_SCRIPT = r"""
import json, os, signal, sys, time
import torch
import horovod_tpu_torch as hvd

hvd.init(device="cpu")
rank = hvd.rank()
done = 0
for i in range(400):
    if rank == 2 and i == 6:
        time.sleep(0.3)          # every rank is past step 5's collective
        print(json.dumps({"rank": 2, "killed_at": time.time()}), flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
    try:
        out = hvd.allreduce(torch.ones(4) * (rank + 1), op=hvd.Sum,
                            name="loop")
        assert torch.equal(out, torch.full((4,), 6.0)), out
        done += 1
    except hvd.RanksDownError as e:
        print(json.dumps({"rank": rank, "raised_at": time.time(),
                          "ranks": list(e.ranks), "done": done,
                          "msg": str(e)}), flush=True)
        os._exit(0)
    time.sleep(0.02)
print(json.dumps({"rank": rank, "no_error": True}), flush=True)
os._exit(0)
"""


def test_sigkill_rank_raises_ranks_down_on_survivors():
    from horovod_tpu_torch.common.util import reserve_port

    timeout_s = 2.0
    held, port = reserve_port()
    procs = []
    try:
        for r in range(3):
            env = dict(os.environ)
            env.update({
                "HOROVOD_RANK": str(r), "HOROVOD_SIZE": "3",
                "HOROVOD_LOCAL_RANK": str(r), "HOROVOD_LOCAL_SIZE": "3",
                "HOROVOD_COORDINATOR_ADDR": f"127.0.0.1:{port}",
                "HOROVOD_HEARTBEAT_INTERVAL": "0.2",
                "HOROVOD_HEARTBEAT_TIMEOUT_SECONDS": str(timeout_s),
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
            })
            procs.append(subprocess.Popen(
                [sys.executable, "-c", KILL_SCRIPT], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = []
        for r, p in enumerate(procs):
            so, se = p.communicate(timeout=180)
            outs.append((p.returncode, so, se))
    finally:
        held.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rc2, so2, se2 = outs[2]
    assert rc2 == -9, (rc2, se2[-2000:])
    killed_at = json.loads(so2.strip().splitlines()[-1])["killed_at"]
    for r in (0, 1):
        rc, so, se = outs[r]
        assert rc == 0, se[-3000:]
        res = json.loads(so.strip().splitlines()[-1])
        assert "no_error" not in res, (r, se[-3000:])
        assert res["ranks"] == [2], res
        assert res["done"] == 6, res
        assert "rank(s) [2] missed heartbeats" in res["msg"], res
        assert res["raised_at"] - killed_at < timeout_s + 5, res
