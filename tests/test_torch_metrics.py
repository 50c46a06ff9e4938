"""The port's metrics plane (``horovod_tpu_torch/runtime/metrics.py``)
against the JAX package's (``tests/test_metrics.py``).

* The same counter, gauge and histogram operations, with values from a
  seeded numpy generator, go into a fresh registry of each package: the
  Prometheus text is byte-identical, the snapshots equal, the log2
  bucket bounds and indices equal; the fleet aggregate over a fake KV
  renders the same page.
* Kind conflicts, the lock-cheap hot path (no ``open``/``socket`` in a
  burst), the endpoint knob on and off (on a held port), ``trace_step``'s
  histogram and phase split, ``data_wait`` and ``wrap_data_loader``.
* A name test: every metric the JAX package's counterparts of the
  ported modules register is registered by the port with the same kind
  and help (an AST scan of both packages' sources); the ones left out
  are listed with the ROADMAP item that brings each.
"""

from __future__ import annotations

import ast
import bisect
import builtins
import json
import os
import socket
import time
import urllib.request

import numpy as np
import pytest

from horovod_tpu.runtime import metrics as JM

from horovod_tpu_torch.runtime import metrics as TM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _drive(reg, seed: int) -> list:
    """A seeded mix of counter/gauge/histogram operations on ``reg``;
    returns the observed histogram values (for the bucket check)."""
    rng = np.random.default_rng(seed)
    c = [reg.counter("t_requests_total", "Requests, labeled op."),
         reg.counter("t_bytes_total", 'Bytes "sent"\nby kind.')]
    g = [reg.gauge("t_depth", "Queue depth."),
         reg.gauge("t_stale_seconds", "Staleness per peer.")]
    h = [reg.histogram("t_latency_seconds", "Latency."),
         reg.histogram("t_sizes", "Sizes.", lo=0, hi=12)]
    labels = [{}, {"op": "get"}, {"op": "set", "peer": "3"},
              {"kind": 'a"b\\c'}]
    observed = []
    for _ in range(400):
        which = int(rng.integers(0, 3))
        lab = labels[int(rng.integers(0, len(labels)))]
        if which == 0:
            c[int(rng.integers(0, 2))].inc(float(rng.integers(1, 9)), **lab)
        elif which == 1:
            g[int(rng.integers(0, 2))].set(float(rng.uniform(-5, 5)), **lab)
        else:
            k = int(rng.integers(0, 2))
            v = (float(rng.lognormal(-5, 3)) if k == 0
                 else float(rng.integers(0, 5000)))
            h[k].observe(v, **lab)
            observed.append((k, v))
    g[0].replace([({"peer": str(i)}, float(i) / 3) for i in range(4)])
    return observed


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_is_byte_identical_to_jax(seed):
    jreg, treg = JM.MetricsRegistry(), TM.MetricsRegistry()
    obs = _drive(jreg, seed)
    assert _drive(treg, seed) == obs
    assert treg.render() == jreg.render()
    assert treg.snapshot() == jreg.snapshot()
    # the log2 bounds and the bucket each value lands in
    for k, (lo, hi) in enumerate(((-14, 9), (0, 12))):
        jb = JM.Histogram("x", lo=lo, hi=hi).bounds
        tb = TM.Histogram("x", lo=lo, hi=hi).bounds
        assert tb == jb
        for kk, v in obs:
            if kk == k:
                assert bisect.bisect_left(tb, v) == bisect.bisect_left(jb, v)


def test_aggregate_render_matches_jax():
    """The fleet merge over a fake KV: rank/host labels, the snapshot
    ages and the generation/size gauges render the same page."""
    kv = {}
    for r in range(2):
        reg = TM.MetricsRegistry()
        _drive(reg, 10 + r)
        kv[f"hvd3/metrics/{r}"] = json.dumps({
            "meta": {"rank": r, "host": f"h{r}", "size": 2,
                     "generation": 3, "time": 1000.0 + r},
            "metrics": reg.snapshot()})
    kv["metrics/index"] = json.dumps({"epoch": 3, "size": 2})
    snaps_t, idx_t = TM.aggregate_snapshots(kv.get)
    snaps_j, idx_j = JM.aggregate_snapshots(kv.get)
    assert (snaps_t, idx_t) == (snaps_j, idx_j) and len(snaps_t) == 2
    assert TM.snapshot_age_snapshot(snaps_t, now=1005.0) == \
        JM.snapshot_age_snapshot(snaps_j, now=1005.0)
    page = TM.render_snapshots(snaps_t)
    assert page == JM.render_snapshots(snaps_j)
    assert 'rank="1"' in page and 'host="h0"' in page
    assert "hvd_fleet_generation 3" in TM.aggregate_render(kv.get)


def test_kind_conflict_rejected_with_jax_text():
    errs = []
    for mod in (JM, TM):
        reg = mod.MetricsRegistry()
        reg.counter("x_total")
        with pytest.raises(ValueError) as ei:
            reg.gauge("x_total")
        errs.append(str(ei.value))
    assert errs[0] == errs[1] == \
        "metric x_total already registered as counter, not gauge"


def test_increment_is_free_of_syscalls():
    """A burst of increments and observations opens no file and no
    socket and runs fast (one lock + dict op each)."""
    reg = TM.MetricsRegistry()
    c = reg.counter("hot_total")
    h = reg.histogram("hot_seconds")
    real_open, real_socket = builtins.open, socket.socket

    def no_open(*a, **k):
        raise AssertionError("open() on the metrics hot path")

    class NoSocket(socket.socket):
        def __init__(self, *a, **k):
            raise AssertionError("socket() on the metrics hot path")

    builtins.open, socket.socket = no_open, NoSocket
    try:
        t0 = time.perf_counter()
        for _ in range(20000):
            c.inc()
            c.inc(2, op="set")
            h.observe(0.001)
        dt = time.perf_counter() - t0
    finally:
        builtins.open, socket.socket = real_open, real_socket
    assert c.value() == 20000 and c.value(op="set") == 40000
    assert h.value() == 20000
    assert dt < 5.0, f"hot path too slow: {dt:.2f}s for 60k records"


def _scrape(port: int, path: str = "/metrics") -> str:
    return urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=10).read().decode()


def test_rank_endpoint_knob_on_off(monkeypatch):
    from horovod_tpu_torch.common.util import reserve_port

    monkeypatch.delenv("HOROVOD_METRICS_PORT", raising=False)
    assert TM.start_rank_endpoint(0) is None  # default: off
    held, port = reserve_port()
    try:
        monkeypatch.setenv("HOROVOD_METRICS_PORT", str(port - 1))
        srv = TM.start_rank_endpoint(1)  # base + rank
    finally:
        held.close()
    assert srv is not None and srv.port == port
    try:
        TM.counter("torch_endpoint_knob_total").inc()
        text = _scrape(port)
        assert "torch_endpoint_knob_total 1" in text
        assert "# TYPE hvd_step_time_seconds histogram" in text
        snap = json.loads(_scrape(port, "/metrics.json"))
        assert snap["metrics"]["torch_endpoint_knob_total"]["series"][0][
            "value"] == 1
    finally:
        srv.close()
    with pytest.raises(Exception):
        _scrape(port)


def test_kv_publisher_waits_for_the_kv_store(monkeypatch):
    """The publisher runs over the launcher's KV store: with no
    rendezvous exported there is nothing to publish to (the publishing
    case is in tests/test_torch_kvstore.py)."""
    monkeypatch.setenv("HOROVOD_METRICS_PUBLISH_INTERVAL", "0.5")
    monkeypatch.delenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", raising=False)
    monkeypatch.delenv("HOROVOD_GLOO_RENDEZVOUS_PORT", raising=False)
    assert TM.maybe_start_kv_publisher(0, 2, 1) is None


def _series(name: str) -> dict:
    snap = TM.metrics()["metrics"][name]
    return {s["labels"].get("phase", ""): s for s in snap["series"]}


def test_trace_step_records_histogram_and_phases():
    hist = TM.registry().histogram("hvd_step_time_seconds")
    before = hist.total()
    blocked = TM.counter("hvd_handle_wait_seconds_total")
    with TM.trace_step(step=7):
        time.sleep(0.02)
        blocked.inc(0.005)   # a handle wait inside the step
    assert hist.total() == before + 1
    last = {k: v["value"] for k, v in _series("hvd_step_last_seconds")
            .items()}
    assert last["wall"] >= 0.02
    assert abs(last["blocked"] - 0.005) < 1e-9
    assert abs(last["compute"] - (last["wall"] - 0.005)) < 1e-9
    assert last["input_wait"] == 0.0


def test_data_wait_and_wrap_data_loader_split_the_step():
    dw = TM.counter("hvd_data_wait_seconds_total")
    before = dw.value(source="loader")

    def slow():
        for i in range(3):
            time.sleep(0.01)
            yield i

    got = []
    with TM.trace_step(step=1):
        for item in TM.wrap_data_loader(slow(), source="loader"):
            got.append(item)
    assert got == [0, 1, 2]
    waited = dw.value(source="loader") - before
    assert waited >= 0.03
    last = {k: v["value"] for k, v in _series("hvd_step_last_seconds")
            .items()}
    assert abs(last["input_wait"] - waited) < 1e-6
    assert last["compute"] <= last["wall"] - waited + 1e-9


# ---------------------------------------------------------------------------
# The name test
# ---------------------------------------------------------------------------

#: The JAX package's counterparts of the port's ported modules.
PORTED = ("runtime/controller.py", "runtime/background.py",
          "runtime/stall.py", "runtime/wire.py", "runtime/metrics.py",
          "ops/eager.py", "optim/distributed.py", "optim/fused_update.py",
          "optim/local_sgd.py", "perf/goodput.py", "common/basics.py",
          "runtime/health.py", "checkpoint.py", "runtime/kvstore.py",
          "runtime/preemption.py", "elastic.py", "run/launcher.py")

#: Metrics those modules register that the port leaves out, each with
#: the ROADMAP.md Queue A item that brings it.
LEFT_OUT: dict = {}

_KINDS = ("counter", "gauge", "histogram")


def _registrations(path: str) -> dict:
    """``name -> (kind, help)`` of every ``counter/gauge/histogram(
    "name", "help")`` call in the source file at ``path``."""
    out = {}
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        fn = node.func
        kind = fn.attr if isinstance(fn, ast.Attribute) else \
            getattr(fn, "id", None)
        if kind not in _KINDS:
            continue
        a0 = node.args[0]
        if not (isinstance(a0, ast.Constant) and isinstance(a0.value, str)
                and a0.value.startswith("hvd_")):
            continue
        help_ = ""
        if len(node.args) > 1 and isinstance(node.args[1], ast.Constant):
            help_ = node.args[1].value
        prev = out.get(a0.value)
        if prev is None or (help_ and not prev[1]):
            out[a0.value] = (kind, help_)
    return out


def _package_registrations(pkg: str, rels) -> dict:
    out = {}
    for rel in rels:
        for name, (kind, help_) in _registrations(
                os.path.join(REPO, pkg, rel)).items():
            prev = out.get(name)
            if prev is None or (help_ and not prev[1]):
                out[name] = (kind, help_)
    return out


def test_port_registers_the_jax_metrics_of_its_modules():
    jax_all = {}
    for root, _, files in os.walk(os.path.join(REPO, "horovod_tpu")):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f),
                                      os.path.join(REPO, "horovod_tpu"))
                for name, (kind, help_) in _package_registrations(
                        "horovod_tpu", [rel]).items():
                    prev = jax_all.get(name)
                    if prev is None or (help_ and not prev[1]):
                        jax_all[name] = (kind, help_)
    jax_ported = set(_package_registrations("horovod_tpu", PORTED))
    port_rels = [os.path.relpath(os.path.join(root, f),
                                 os.path.join(REPO, "horovod_tpu_torch"))
                 for root, _, files in os.walk(
                     os.path.join(REPO, "horovod_tpu_torch"))
                 for f in files if f.endswith(".py")]
    port = _package_registrations("horovod_tpu_torch", port_rels)
    assert set(LEFT_OUT) <= jax_ported
    assert set(port) == (jax_ported - set(LEFT_OUT)) | \
        {"hvd_compile_seconds_total"}, sorted(
            set(port) ^ (jax_ported - set(LEFT_OUT)))
    for name, (kind, help_) in port.items():
        jkind, jhelp = jax_all[name]
        assert kind == jkind, name
        assert help_ == jhelp, name
