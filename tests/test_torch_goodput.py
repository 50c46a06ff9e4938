"""The port's goodput ledger (``horovod_tpu_torch/perf/goodput.py``)
against the JAX package's (``tests/test_goodput.py``).

* The same sequence of ``observe``, ``observe_step``, ``span`` and
  ``record_outer_sync`` calls under an injected clock gives equal
  ``snapshot()``, ``fleet_report``, ``dominant_bottleneck``,
  ``FleetGoodput`` windows and ``format_report`` text in both packages.
* Phase conservation over a seeded random sequence, a data wait outside
  a step, the dump-then-CLI round trip (``python -m
  horovod_tpu_torch.perf goodput``), the not-ported subcommands.
* A gloo world of 2 under ``delay@rank1:q/*:0.5s,delay@rank1:p/*:0.5s``:
  the fleet report names ``comm_exposed`` (both ranks wait the
  synchronous collective out; see the test).
* The observers change no bit: a small ResNet with the fused momentum
  tail takes three steps on the CPU under ``trace_step``, its batches
  through ``wrap_data_loader`` and the flight and goodput directories
  set, and three bare; the weights are equal bit for bit.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from horovod_tpu.perf import goodput as jgp

from horovod_tpu_torch.perf import goodput as tgp

MODS = {"jax": jgp, "port": tgp}


@pytest.fixture(autouse=True)
def _fresh_ledgers():
    jgp.reset()
    tgp.reset()
    yield
    jgp.reset()
    tgp.reset()


def _fake_clock():
    t = [0.0]

    def clock():
        return t[0]

    clock.advance = lambda dt: t.__setitem__(0, t[0] + dt)
    return clock


def _script(led, clock, rank: int):
    """The call sequence both packages' ledgers take."""
    led.start()
    clock.advance(2.0)
    led.observe("init", 1.75)
    with led.span("compile"):
        clock.advance(0.5)
    for i in range(4):
        clock.advance(1.0 + 0.25 * rank)
        led.observe_step(1.0 + 0.25 * rank, compute=0.6,
                         comm_exposed=0.2 + 0.25 * rank,
                         input_wait=0.1 * (i % 2))
    clock.advance(0.75)
    led.observe("reform", 0.5, split={"teardown_s": 0.2,
                                      "compile_s": 0.1})
    led.observe("checkpoint", 0.125)


#: fields that stamp the process, not the ledger: the wall clock, the
#: rank and generation each package reads from its own world state, and
#: the split of each package's process-wide compile counter (the JAX
#: package's other tests in the same worker move it)
_STAMPS = ("time", "wall_start", "rank", "generation", "compile_cold_s",
           "compile_warm_s")


def _stable(snap: dict) -> dict:
    return {k: v for k, v in snap.items() if k not in _STAMPS}


def test_snapshots_fleet_and_report_match_jax(monkeypatch):
    monkeypatch.delenv("HOROVOD_GOODPUT_SLO", raising=False)
    snaps = {}
    for name, mod in MODS.items():
        per_rank = []
        for rank in (0, 1):
            clock = _fake_clock()
            led = mod.GoodputLedger(clock=clock)
            _script(led, clock, rank)
            s = _stable(led.snapshot())
            s["rank"] = rank
            per_rank.append(s)
        snaps[name] = per_rank
    for a, b in zip(snaps["port"], snaps["jax"]):
        assert a == b
        assert tgp.dominant_bottleneck(a) == jgp.dominant_bottleneck(b)
    rep = {n: MODS[n].fleet_report(snaps[n]) for n in MODS}
    assert rep["port"] == rep["jax"]
    assert rep["port"]["dominant_bottleneck"]["rank"] == 1
    for r in rep.values():
        r["source"] = "dir"
    assert tgp.format_report(rep["port"]) == jgp.format_report(rep["jax"])
    # the launcher-side window and SLO burn
    wins = []
    for name, mod in MODS.items():
        fleet = mod.FleetGoodput(slo=0.9, window_s=60.0,
                                 clock=lambda: 0.0)
        fleet.update(snaps[name][:1], now=0.0)
        wins.append(fleet.update(snaps[name], now=30.0))
    assert wins[0] == wins[1] and wins[0]["alert"]["firing"]


def test_record_outer_sync_matches_jax():
    from horovod_tpu.runtime import metrics as jm
    from horovod_tpu_torch.runtime import metrics as tm

    out = {}
    for name, mod, reg in (("jax", jgp, jm), ("port", tgp, tm)):
        clock = _fake_clock()
        mod._ledger = mod.GoodputLedger(clock=clock)
        c0 = reg.counter("hvd_outer_sync_total").total()
        s0 = reg.gauge("hvd_outer_sync_seconds_total").total()
        mod.start()
        clock.advance(3.0)
        mod.record_outer_sync(0.25)
        mod.record_outer_sync(0.5)
        out[name] = (_stable(mod.ledger().snapshot()),
                     reg.counter("hvd_outer_sync_total").total() - c0,
                     reg.gauge("hvd_outer_sync_seconds_total").total() - s0)
    assert out["port"] == out["jax"]
    assert out["port"][1] == 2 and out["port"][2] == 0.75
    assert out["port"][0]["phases"]["comm_exposed"] == 0.75


@pytest.mark.parametrize("seed", [0, 1])
def test_phases_conserve_wall_clock(seed):
    rng = np.random.default_rng(seed)
    clock = _fake_clock()
    led = tgp.GoodputLedger(clock=clock)
    led.start()
    for _ in range(200):
        clock.advance(float(rng.uniform(0, 1)))
        if rng.uniform() < 0.5:
            w = float(rng.uniform(0, 2))
            led.observe_step(w, compute=float(rng.uniform(0, 2)),
                             comm_exposed=float(rng.uniform(0, 1)),
                             input_wait=float(rng.uniform(0, 1)))
        else:
            led.observe(str(rng.choice(tgp.PHASES)),
                        float(rng.uniform(0, 1)))
    snap = led.snapshot()
    total = sum(snap["phases"].values()) + snap["unattributed_s"]
    assert total == pytest.approx(snap["elapsed_s"], rel=1e-6)
    assert snap["steps"] > 0


def test_data_wait_outside_a_step_lands_on_the_ledger():
    import time

    from horovod_tpu_torch.runtime import metrics as tm

    with tm.data_wait("prefetch"):
        time.sleep(0.02)
    snap = tgp.ledger().snapshot()
    assert snap["phases"]["input_wait"] >= 0.02
    assert snap["steps"] == 0


def test_dump_and_cli_round_trip(tmp_path, capsys):
    from horovod_tpu_torch.perf.__main__ import main

    for rank, exposed in ((0, 1.0), (1, 6.0)):
        clock = _fake_clock()
        led = tgp.GoodputLedger(clock=clock)
        led.start()
        clock.advance(10.0)
        led.observe_step(9.0, compute=9.0 - exposed, comm_exposed=exposed)
        path = led.dump("shutdown", directory=str(tmp_path / "raw"))
        assert os.path.basename(path).startswith("goodput-r")
        snap = json.loads(open(path).read())
        os.remove(path)
        assert snap["reason"] == "shutdown"
        snap["rank"] = rank
        (tmp_path / f"goodput-r{rank}-g1.json").write_text(json.dumps(snap))
    assert main(["goodput", str(tmp_path)]) == 0
    human = capsys.readouterr().out
    assert "rank 0" in human and "rank 1" in human
    assert "dominant bottleneck: comm_exposed" in human
    assert main(["goodput", str(tmp_path), "--json", "--slo", "0.9"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["world"] == 2 and rep["dominant_bottleneck"]["rank"] == 1
    assert rep["alert"]["firing"] is True
    assert rep == json.loads(json.dumps(jgp.load_report(str(tmp_path),
                                                         slo=0.9)))
    empty = tmp_path / "empty"
    empty.mkdir()
    assert main(["goodput", str(empty)]) == 1
    capsys.readouterr()
    # report is the perf observatory's now: a goodput dir holds no
    # capture, and the JAX package's CLI says so with the same exit
    from horovod_tpu.perf.__main__ import main as jmain

    assert main(["report", str(tmp_path)]) == 1 == jmain(
        ["report", str(tmp_path)])
    assert "no captures found" in capsys.readouterr().out


GOODPUT_SCRIPT = r"""
import json
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.perf import goodput as gp

hvd.init(device="cpu")
for i in range(2):
    with hvd.trace_step(step=i):
        out = hvd.allreduce(torch.ones(8) * (i + 1), op=hvd.Sum,
                            name="gp%d" % i)
    assert torch.equal(out, torch.full((8,), 2.0 * (i + 1))), out
snap = gp.ledger().snapshot()
print("GOODPUT-JSON:" + json.dumps(snap), flush=True)
hvd.shutdown()
"""


def test_delay_fault_exposes_comm_on_both_ranks():
    """``delay@rank1:q/*:0.5s,delay@rank1:p/*:0.5s``: rank 1 submits
    late and reads its response late.  The fleet report names
    ``comm_exposed`` as the dominant phase, every ledger conserves its
    wall, and the report equals the JAX package's over the same ledgers.

    Where the JAX package's test also names rank 1 as the worst rank
    (``tests/test_goodput.py:526-560``), its dispatch is asynchronous: a
    handle completes when the collective is enqueued, so rank 0 never
    waits out rank 1's late response read.  A gloo collective completes
    on the background thread, so rank 0's handle waits for rank 1 in the
    collective as long as rank 1 waits in the negotiation: the two
    ranks' exposed communication is equal to within a poll, and the
    straggler is named by the flight analyzer instead
    (``tests/test_torch_trace.py``)."""
    from test_torch_liveness import _spawn, _world_report

    outs = _spawn(GOODPUT_SCRIPT, 2, {
        "HOROVOD_FAULT_SPEC": "delay@rank1:q/*:0.5s,delay@rank1:p/*:0.5s",
        "HOROVOD_HEARTBEAT_TIMEOUT_SECONDS": "120"}, timeout=120)
    report = _world_report(outs)
    snaps = []
    for rc, so, _ in outs:
        assert rc == 0, report
        lines = [ln for ln in so.splitlines()
                 if ln.startswith("GOODPUT-JSON:")]
        assert lines, report
        snaps.append(json.loads(lines[0].split(":", 1)[1]))
    for s in snaps:
        tot = sum(s["phases"].values()) + s["unattributed_s"]
        assert abs(tot - s["elapsed_s"]) <= 0.02 * s["elapsed_s"] + 1e-6, s
    rep = tgp.fleet_report(snaps)
    assert rep == jgp.fleet_report(snaps)
    assert rep["world"] == 2
    assert rep["dominant_bottleneck"]["phase"] == "comm_exposed", rep
    exposed = {s["rank"]: s["phases"]["comm_exposed"] for s in snaps}
    # two steps, each with at least 1 s of injected delay on its path
    assert min(exposed.values()) > 1.6, exposed
    assert abs(exposed[0] - exposed[1]) < 0.25, exposed


# ---------------------------------------------------------------------------
# The observers change no bit
# ---------------------------------------------------------------------------


def _train(observed: bool, tmp_path, monkeypatch) -> list:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet as tres
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    if observed:
        monkeypatch.setenv("HOROVOD_FLIGHT_DIR", str(tmp_path / "fl"))
        monkeypatch.setenv("HOROVOD_GOODPUT_DIR", str(tmp_path / "gp"))
    else:
        monkeypatch.delenv("HOROVOD_FLIGHT_DIR", raising=False)
        monkeypatch.delenv("HOROVOD_GOODPUT_DIR", raising=False)
    torch.manual_seed(0)
    model = tres.ResNet(stage_sizes=[1, 1, 1, 1],
                        block_cls=tres.BottleneckBlock, num_classes=10,
                        num_filters=8, dtype=torch.float32, device="cpu")
    opt = hvd.DistributedOptimizer(TF.sgd(model.parameters(), 0.1,
                                          momentum=0.9))
    assert TF.active()
    batches = [synthetic_batch(4, 32, 10, seed=s, device="cpu")
               for s in range(3)]
    if observed:
        for i, (x, y) in enumerate(hvd.wrap_data_loader(batches)):
            with hvd.trace_step(step=i):
                train_step(model, opt, x, y)
        hvd.dump_flight_recorder()
    else:
        for x, y in batches:
            train_step(model, opt, x, y)
    return [p.detach().clone() for p in model.parameters()]


def test_observers_change_no_bit(tmp_path, monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runtime import flight
    from horovod_tpu_torch.trace import merge as tmerge

    for k in ("HOROVOD_SIZE", "HOROVOD_RANK", "HOROVOD_LOCAL_RANK",
              "HOROVOD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_FUSED_UPDATE", "1")
    hvd.init(device="cpu")
    try:
        flight.reset()
        steps0 = hvd.metrics()["metrics"]["hvd_steps_total"]["series"]
        bare = _train(False, tmp_path, monkeypatch)
        seen = _train(True, tmp_path, monkeypatch)
        steps1 = hvd.metrics()["metrics"]["hvd_steps_total"]["series"]
    finally:
        hvd.shutdown()
    for a, b in zip(bare, seen):
        assert torch.equal(a, b)
    total = (lambda ser: ser[0]["value"] if ser else 0)
    assert total(steps1) - total(steps0) == 3
    d = tmerge.load_dumps(str(tmp_path / "fl"))[0]
    ends = [e for e in d.events if e["kind"] == "step" and e["ph"] == "E"]
    assert [e["step"] for e in ends] == [0, 1, 2]
    assert len([e for e in d.events if e["kind"] == "data_wait"]) >= 3
    assert os.listdir(tmp_path / "gp")   # the shutdown's ledger dump
