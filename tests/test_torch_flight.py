"""The port's flight recorder (``horovod_tpu_torch/runtime/flight.py``)
against the JAX package's (``tests/test_flight.py``): ring order and
bounds, a zero-capacity ring, the no-syscall hot path, the dump's JSONL
round trip and its cross-package reading (a port dump loads through the
JAX package's ``trace.merge.load_dump`` and a JAX dump through the
port's, to equal records), the ``HOROVOD_FLIGHT_*`` knobs, a SIGTERM
dumping the ring with the process ending by the signal, and a failure
dump flushing the terminal metrics."""

from __future__ import annotations

import builtins
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from horovod_tpu.runtime import flight as jflight
from horovod_tpu.trace import merge as jmerge

from horovod_tpu_torch.runtime import flight
from horovod_tpu_torch.trace import merge as tmerge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ring_is_bounded_and_ordered():
    r = flight.FlightRecorder(4)
    for i in range(10):
        r.record("ev", i=i)
    snap = r.snapshot()
    assert [e["i"] for e in snap] == [6, 7, 8, 9]
    assert [e["seq"] for e in snap] == [6, 7, 8, 9]
    assert r.recorded_total() == 10 and len(r._slots) == 4


def test_partial_fill_carries_both_clocks():
    r = flight.FlightRecorder(8)
    w0, m0 = time.time(), time.monotonic()
    r.record("a", ph="B", round=1)
    r.record("b")
    snap = r.snapshot()
    assert [(e["kind"], e["ph"]) for e in snap] == [("a", "B"), ("b", "i")]
    assert snap[0]["round"] == 1
    for e in snap:
        assert e["wall"] >= w0 - 1 and e["mono"] >= m0


def test_zero_capacity_records_nothing(monkeypatch):
    r = flight.FlightRecorder(0)
    r.record("x", i=1)
    assert r.snapshot() == [] and r.recorded_total() == 0
    monkeypatch.setenv("HOROVOD_FLIGHT_EVENTS", "0")
    flight.reset()
    flight.record("k")
    assert flight.recorder().snapshot() == []
    monkeypatch.setenv("HOROVOD_FLIGHT_EVENTS", "5")
    flight.reset()
    for i in range(9):
        flight.record("k", i=i)
    assert len(flight.recorder().snapshot()) == 5
    flight.reset()


def test_record_is_syscall_free_and_reentrant():
    r = flight.FlightRecorder(64)
    real_open, real_socket = builtins.open, socket.socket

    def no_open(*a, **k):
        raise AssertionError("open() on the flight-recorder hot path")

    class NoSocket(socket.socket):
        def __init__(self, *a, **k):
            raise AssertionError("socket() on the flight-recorder hot path")

    builtins.open, socket.socket = no_open, NoSocket
    try:
        t0 = time.perf_counter()
        for i in range(30000):
            r.record("hot", round=i, n_req=2)
        dt = time.perf_counter() - t0
    finally:
        builtins.open, socket.socket = real_open, real_socket
    assert r.recorded_total() == 30000 and len(r._slots) == 64
    assert dt < 5.0, f"hot path too slow: {dt:.2f}s for 30k records"
    # a signal landing mid-record re-enters the lock
    with r._lock:
        r.record("signal", sig="SIGTERM")
    assert r.snapshot()[-1]["kind"] == "signal"


def _fill(rec):
    rec.record("round", ph="B", round=0, n_req=1, names=["t"])
    rec.record("arrive", peer=1, round=0)
    rec.record("round", ph="E", round=0, path="slow", n_resp=1)
    rec.record("clk", peer=1, peer_wall=123.5)
    rec.record("abort", ranks=[1], round=3, observed=False)


def _stable(dump):
    """A dump's comparable content (the stamps differ run to run)."""
    return ({k: v for k, v in dump.meta.items()
             if k not in ("dump_wall", "dump_mono")},
            [{k: v for k, v in e.items() if k not in ("wall", "mono")}
             for e in dump.events])


def test_dump_round_trip_reads_in_both_packages(tmp_path):
    meta = {"rank": 1, "size": 2, "generation": 3, "reason": "test"}
    paths = {}
    for name, mod in (("port", flight), ("jax", jflight)):
        rec = mod.FlightRecorder(32)
        _fill(rec)
        d = tmp_path / name
        d.mkdir()
        paths[name] = rec.dump(str(d / "flight-r1-g3-p9.jsonl"), meta)
        assert not [n for n in os.listdir(d) if ".tmp" in n]
    loaded = {}
    for name, path in paths.items():
        t, j = tmerge.load_dump(path), jmerge.load_dump(path)
        assert (t.rank, t.generation, t.size) == (1, 3, 2)
        assert _stable(t) == _stable(j)
        assert t.meta["events"] == 5 and t.meta["recorded_total"] == 5
        loaded[name] = _stable(t)
    assert loaded["port"] == loaded["jax"]
    # idempotent: a later trigger overwrites the same file
    rec = flight.FlightRecorder(32)
    _fill(rec)
    rec.record("dump", reason="later")
    rec.dump(paths["port"], dict(meta, reason="later"))
    d = tmerge.load_dumps(os.path.dirname(paths["port"]))[0]
    assert d.meta["reason"] == "later" and len(d.events) == 6


def test_global_dump_respects_env_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("HOROVOD_FLIGHT_DIR", raising=False)
    flight.reset()
    flight.record("x")
    assert flight.dump("nodir") is None
    monkeypatch.setenv("HOROVOD_FLIGHT_DIR", str(tmp_path / "sub"))
    path = flight.dump("explicit")
    assert path and os.path.basename(path).startswith("flight-r")
    d = tmerge.load_dumps(os.path.dirname(path))[0]
    assert d.meta["reason"] == "explicit"
    assert d.events[-1]["kind"] == "dump"
    assert flight.sweep(str(tmp_path / "sub")) == [path]
    flight.reset()


def test_sigterm_dumps_ring(tmp_path):
    """SIGTERM dumps the ring, then the process dies by the signal."""
    script = (
        "import os, signal, time\n"
        "from horovod_tpu_torch.runtime import flight\n"
        "assert flight.install_signal_handlers()\n"
        "flight.record('round', ph='B', round=7)\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "time.sleep(10)\n")
    env = dict(os.environ)
    env.update({"HOROVOD_FLIGHT_DIR": str(tmp_path),
                "HOROVOD_RANK": "3", "HOROVOD_SIZE": "4",
                "PYTHONPATH": REPO + os.pathsep
                + env.get("PYTHONPATH", "")})
    p = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == -signal.SIGTERM, (p.returncode, p.stderr)
    dumps = tmerge.load_dumps(str(tmp_path))
    assert len(dumps) == 1, os.listdir(tmp_path)
    d = dumps[0]
    assert d.rank == 3 and d.size == 4
    assert d.meta["reason"] == "signal:SIGTERM"
    kinds = [e["kind"] for e in d.events]
    assert kinds[0] == "round" and "signal" in kinds


def test_failure_dump_flushes_terminal_metrics(tmp_path, monkeypatch):
    from horovod_tpu_torch.common import basics

    published = []

    class FakePublisher:
        def publish(self):
            published.append(1)

    monkeypatch.setattr(basics.state(), "metrics_publisher",
                        FakePublisher())
    monkeypatch.setenv("HOROVOD_FLIGHT_DIR", str(tmp_path))
    flight.reset()
    path = flight.dump_on_failure("ranks_down")
    assert path and os.path.exists(path)
    assert published == [1]
    # the deferred form: the caller flushes after failing its handles
    assert flight.dump_on_failure("ranks_down", flush_metrics=False)
    assert published == [1]
    flight.flush_terminal_metrics()
    assert published == [1, 1]
    monkeypatch.setattr(basics.state(), "metrics_publisher", None)
    assert flight.dump_on_failure("ranks_down") is not None
    flight.reset()


def test_failure_dump_carries_the_goodput_ledger(tmp_path, monkeypatch):
    """A failure dump writes the goodput ledger beside the ring and a
    ``goodput`` event into it."""
    from horovod_tpu_torch.perf import goodput

    monkeypatch.setenv("HOROVOD_FLIGHT_DIR", str(tmp_path))
    monkeypatch.delenv("HOROVOD_GOODPUT_DIR", raising=False)
    flight.reset()
    goodput.reset()
    try:
        goodput.ledger().start(now=time.monotonic() - 2.0)
        goodput.observe("init", 0.5)
        path = flight.dump_on_failure("background_failure")
        d = tmerge.load_dump(path)
        ev = [e for e in d.events if e["kind"] == "goodput"]
        assert ev and ev[0]["reason"] == "background_failure"
        assert ev[0]["init_s"] == 0.5
        assert [n for n in os.listdir(tmp_path)
                if n.startswith("goodput-r")]
    finally:
        goodput.reset()
        flight.reset()


@pytest.mark.parametrize("kind", ["init", "shutdown"])
def test_init_and_shutdown_record(kind, monkeypatch):
    """World 1 on the CPU: ``init()`` records ``init`` with the topology
    gauges; ``shutdown()`` records ``shutdown``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runtime import metrics

    hvd.shutdown()   # no-op unless a world is up
    flight.reset()
    hvd.init(device="cpu")
    try:
        gauges = hvd.metrics()["metrics"]
        assert gauges["hvd_world_size"]["series"][0]["value"] == 1
        assert gauges["hvd_generation"]["series"][0]["value"] >= 1
    finally:
        hvd.shutdown()
    evs = [e for e in flight.recorder().snapshot() if e["kind"] == kind]
    assert evs and evs[-1]["rank"] == 0
    assert metrics.gauge("hvd_world_size").value() == 1
    flight.reset()
