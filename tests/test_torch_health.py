"""The training-health plane of the port (``horovod_tpu_torch/runtime/
health.py``, the taps of ``DistributedOptimizer`` and the eager executor)
against the JAX package's (``horovod_tpu/runtime/health.py``), on the
CPU.

1. Knobs and the handshake: the knobs' names and defaults, the round-0
   entries (``HOROVOD_HEALTH``, ``_SKIP_NONFINITE``,
   ``HOROVOD_ADAPTIVE_COMPRESSION``, ``HOROVOD_CHECKPOINT_REPLICAS``)
   equal to the JAX package's, and a rank whose knob differs failing the
   round-0 handshake as the JAX package's controller does.
2. The fault grammar's in-trace form (``traced_poison``) against the JAX
   package's under ``shard_map``.
3. The host side: the same loss, norm and verdict sequences through both
   packages' ``Sentinel`` / ``HealthMonitor`` on a fake clock trip and
   clear the same alerts on the same samples (``tests/test_health.py``'s
   scenarios), and the port's publication, dump and report surfaces
   (``tests/test_health.py``'s unit tests, ported).
4. On a spawned gloo world of four ranks (``_torch_health_worker``,
   mode ``health``): the gathered verdict of the port's tap against the
   JAX package's ``tap_gradients`` under ``shard_map`` on four CPU
   devices for the same per-rank gradients (clean, NaN, +-Inf; counts
   and max-abs exact, norms within 1e-6 relative); the skip step at
   stages 0-3 and under int8 error feedback (parameters and state bit
   for bit); stats on against off at stages 0-3 x overlap x {none, int8,
   int4, topk} (bit for bit); one step's recorded collectives (one
   all-gather of the verdict's size added) and its largest buffer (no
   new full-size one).
5. On a spawned gloo world of two ranks (mode ``health_culprit``):
   ``nan@rank1:grad_buffer*:round2`` on the eager wire and
   ``nan@rank1:grads*`` in-trace, under the skip knob: both ranks name
   rank 1 / float32, the merged flight trace's health section names it,
   the weights stay finite and equal, one step skipped per regime.
6. The residual-ratio gauge (``HOROVOD_ADAPTIVE_COMPRESSION``) and the
   handshake's mode-scoped checks (``tests/test_adaptive_compression.py
   :875,917,969,988``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from horovod_tpu.common import config as jconfig
from horovod_tpu.ops import xla_exec as jxla
from horovod_tpu.runtime import controller as jctl
from horovod_tpu.runtime import faults as jfaults
from horovod_tpu.runtime import health as JH

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import config as tconfig
from horovod_tpu_torch.ops import eager_exec as TX
from horovod_tpu_torch.optim import distributed as TD
from horovod_tpu_torch.parallel import mesh as PM
from horovod_tpu_torch.runtime import controller as tctl
from horovod_tpu_torch.runtime import faults as F
from horovod_tpu_torch.runtime import flight
from horovod_tpu_torch.runtime import health as H
from horovod_tpu_torch.runtime import metrics as M

sys.path.insert(0, os.path.dirname(__file__))
from _torch_collectives_worker import spawn  # noqa: E402
from _torch_health_worker import (OPT_LEAVES, SKIP_CASES,  # noqa: E402
                                  VERDICT_CASES, VERDICT_LEAVES, WIRES,
                                  verdict_grads)
from test_torch_control_plane import (_assert_round0_failed,  # noqa: E402
                                      _plain, _round0_pair, MODS)
from test_torch_quantization import _mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4


@pytest.fixture(autouse=True)
def _fresh_monitor():
    for mod, fm in ((H, F), (JH, jfaults)):
        mod.reset()
        fm._data_cache = ("", [])
    yield
    for mod, fm in ((H, F), (JH, jfaults)):
        mod.reset()
        fm._data_cache = ("", [])


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn(N, "cpu", timeout=120, mode="health")


@pytest.fixture(scope="module")
def culprit2(tmp_path_factory):
    fd = str(tmp_path_factory.mktemp("flight"))
    outs = spawn(2, "cpu", timeout=120, mode="health_culprit",
                 env_extra={"HOROVOD_HEALTH": "1",
                            "HOROVOD_HEALTH_SKIP_NONFINITE": "1",
                            "HOROVOD_FLIGHT_DIR": fd})
    return outs, fd


# ---------------------------------------------------------------------------
# 1. Knobs and the handshake
# ---------------------------------------------------------------------------

KNOBS = ("health", "health_skip_nonfinite", "health_ewma_alpha",
         "health_sentinel_ratio", "health_trip_steps", "health_clear_steps",
         "health_dir", "adaptive_compression", "checkpoint_keep",
         "checkpoint_verify", "checkpoint_replicas")


def test_health_knobs_registered():
    jk = jconfig.knobs()
    for name in KNOBS:
        k = tconfig._KNOBS[name]
        assert (k.env, k.default) == (jk[name].env, jk[name].default), name
    for name in ("health", "health_skip_nonfinite", "adaptive_compression",
                 "checkpoint_replicas"):
        assert any(m in tconfig._KNOBS[name].help.lower()
                   for m in ("round-0 handshake",
                             "must agree on every rank")), name
    # nothing is refused any more
    assert not hasattr(tconfig, "refuse_not_ported")


@pytest.mark.parametrize("env,value", [
    ("HOROVOD_HEALTH", "1"), ("HOROVOD_HEALTH_SKIP_NONFINITE", "1"),
    ("HOROVOD_ADAPTIVE_COMPRESSION", "1"),
    ("HOROVOD_CHECKPOINT_REPLICAS", "3")])
def test_round0_cfg_carries_health(monkeypatch, env, value):
    for e in ("HOROVOD_HEALTH", "HOROVOD_HEALTH_SKIP_NONFINITE",
              "HOROVOD_ADAPTIVE_COMPRESSION", "HOROVOD_CHECKPOINT_REPLICAS"):
        monkeypatch.delenv(e, raising=False)
    assert tctl.ROUND0_KNOB_ENVS == jctl.ROUND0_KNOB_ENVS
    i = tctl.ROUND0_KNOB_ENVS.index(env)
    base = tctl.round0_cfg()
    assert base == jctl.round0_cfg()
    monkeypatch.setenv(env, value)
    on = tctl.round0_cfg()
    assert on == jctl.round0_cfg() and on[i] == int(value) != base[i]


@pytest.mark.parametrize("knob,env", [
    ("health", "HOROVOD_HEALTH"),
    ("health_skip_nonfinite", "HOROVOD_HEALTH_SKIP_NONFINITE"),
    ("adaptive_compression", "HOROVOD_ADAPTIVE_COMPRESSION"),
    ("checkpoint_replicas", "HOROVOD_CHECKPOINT_REPLICAS")])
def test_knob_mismatch_fails_round0(monkeypatch, knob, env):
    """A rank whose knob differs fails round 0 on both ranks, with the
    JAX package's message (``tests/test_health.py:95``)."""
    values = (True, False) if knob != "checkpoint_replicas" else (2, 0)
    results = {k: _round0_pair(m, _plain, {knob: values}, monkeypatch)
               for k, m in MODS.items()}
    _assert_round0_failed(results, env)


def test_health_cfg_joins_program_key(monkeypatch):
    monkeypatch.delenv("HOROVOD_HEALTH", raising=False)
    monkeypatch.delenv("HOROVOD_HEALTH_SKIP_NONFINITE", raising=False)
    assert TX.health_cfg() is None is jxla.health_cfg()
    monkeypatch.setenv("HOROVOD_HEALTH", "1")
    assert TX.health_cfg() == (1, 0) == jxla.health_cfg()
    monkeypatch.setenv("HOROVOD_HEALTH_SKIP_NONFINITE", "1")
    assert TX.health_cfg() == (1, 1) == jxla.health_cfg()


def test_knobs_run_through_the_entry_points(monkeypatch):
    """The health, skip and adaptive knobs run through an in-trace
    reduction, the optimizer and the eager op path at a world of one."""
    from horovod_tpu_torch.optim import fused_update as TF

    for k in ("HOROVOD_SIZE", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    for env in ("HOROVOD_HEALTH", "HOROVOD_HEALTH_SKIP_NONFINITE",
                "HOROVOD_ADAPTIVE_COMPRESSION"):
        monkeypatch.setenv(env, "1")
    hvd.init(device="cpu")
    try:
        x = torch.arange(4.0)
        assert torch.equal(hvd.collectives.allreduce(x), x)
        assert torch.equal(hvd.allreduce(x), x)
        w = torch.nn.Parameter(torch.ones(4))
        opt = hvd.DistributedOptimizer(TF.sgd([w], 0.5),
                                       compression=hvd.Compression.int8)
        w.grad = torch.full((4,), 2.0)
        opt.step()
        assert torch.equal(w.detach(), torch.zeros(4))
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# 2. The in-trace poisoning hook
# ---------------------------------------------------------------------------


def test_traced_poison_rank_scoped(monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_SPEC", "nan@rank3:grads*")
    x = np.arange(N * 4, dtype=np.float32).reshape(N, 4) + 1

    def body(b):
        return jfaults.traced_poison(b, "grads.float32",
                                     jax.lax.axis_index("hvd"))

    want = np.asarray(jax.jit(shard_map(
        body, mesh=_mesh(N), check_vma=False, in_specs=P("hvd"),
        out_specs=P("hvd")))(jnp.asarray(x)))
    got = np.stack([F.traced_poison(torch.from_numpy(x[r]),
                                    "grads.float32", r).numpy()
                    for r in range(N)])
    np.testing.assert_array_equal(got, want)
    # the caller's tensor is untouched, round-scoped rules never apply
    t = torch.ones(3)
    assert F.traced_poison(t, "grads.float32", 3) is not t
    assert torch.equal(t, torch.ones(3))
    monkeypatch.setenv("HOROVOD_FAULT_SPEC", "nan@rank3:grads*:round2")
    assert F.traced_poison(t, "grads.float32", 3) is t
    # layout is kept: element 0 of the logical order, channels-last too
    monkeypatch.setenv("HOROVOD_FAULT_SPEC", "inf:grads*")
    cl = torch.ones(2, 3, 2, 2).to(memory_format=torch.channels_last)
    p = F.traced_poison(cl, "grads.float32", 0)
    assert p.is_contiguous(memory_format=torch.channels_last)
    assert torch.isinf(p[0, 0, 0, 0]) and torch.isfinite(p).sum() == 23


# ---------------------------------------------------------------------------
# 3. The host side: both packages on the same sequences
# ---------------------------------------------------------------------------


def _sentinel_trace(mod, seq, **kw):
    s = mod.Sentinel("loss_divergence", **kw)
    return [(s.observe(v), s.active, s.mean) for v in seq]


SENTINEL_CASES = {
    "warmup_trip_clear": (dict(alpha=0.5, ratio=2.0, trip_steps=3,
                               clear_steps=4),
                          [1.0] * 5 + [10.0, 10.0, 1.0] + [10.0] * 3
                          + [1.0] * 4),
    "nonfinite_breaches": (dict(alpha=0.1, ratio=4.0, trip_steps=1,
                                clear_steps=2),
                           [float("nan"), 1.0, 1.0, float("inf"), 2.0]),
    "negative_baseline": (dict(alpha=0.3, ratio=4.0, trip_steps=1,
                               clear_steps=2),
                          [-120.0] * 5 + [-80.0, -10.0, -0.001, 0.002,
                                          0.0]),
    "random_walk": (dict(alpha=0.2, ratio=1.5, trip_steps=2,
                         clear_steps=3),
                    list(np.random.RandomState(3).lognormal(0, 0.6, 80))),
}


@pytest.mark.parametrize("case", sorted(SENTINEL_CASES))
def test_sentinel_parity(case):
    kw, seq = SENTINEL_CASES[case]
    assert _sentinel_trace(H, seq, **kw) == _sentinel_trace(JH, seq, **kw)


def test_sentinel_warmup_and_trip_and_clear():
    s = H.Sentinel("loss_divergence", alpha=0.5, ratio=2.0,
                   trip_steps=3, clear_steps=4)
    for _ in range(H.WARMUP_SAMPLES):
        assert s.observe(1.0) is None
    assert s.observe(10.0) is None and s.observe(10.0) is None
    assert s.observe(1.0) is None and not s.active
    assert s.observe(10.0) is None and s.observe(10.0) is None
    assert s.observe(10.0) == "trip" and s.active
    assert s.mean == pytest.approx(1.0)
    for _ in range(3):
        assert s.observe(1.0) is None and s.active
    assert s.observe(1.0) == "clear" and not s.active


def _monitor_trace(mod, events, clock):
    """Feed ``events`` (``(kind, args)``) to a fresh monitor of ``mod``
    on the fake ``clock``; the active alerts and lifetime count after
    each, and the final snapshot without its clock-free fields."""
    m = mod.HealthMonitor(clock=lambda: clock[0])
    out = []
    for i, (kind, args) in enumerate(events):
        clock[0] = 100.0 + i
        getattr(m, kind)(*args)
        out.append((m.active_alerts(), m.alerts_total()))
    snap = m.snapshot()
    return out, {k: snap[k] for k in ("culprits", "first_nonfinite",
                                      "alert_log", "sentinels",
                                      "skipped_steps", "loss_observed")}


MONITOR_CASES = {
    "loss_sentinel": [("observe_loss", (2.0,))] * 5
    + [("observe_loss", (50.0,))] * 2 + [("observe_loss", (2.0,))] * 3,
    "nonfinite_loss": [("observe_loss", (float("nan"),))]
    + [("observe_loss", (1.0,))] * 4,
    "persistent_poison": [("note_nonfinite", (1.0, "float32", 1)),
                          ("observe_loss", (1.0,))] * 6
    + [("observe_loss", (1.0,))] * 3,
    "clean_verdicts": [("note_nonfinite", (2.0, "bfloat16", 3))]
    + [("note_verdict", (False,))] * 3 + [("note_verdict", (True,))]
    + [("note_verdict", (False,))] * 3,
    "wire_rounds": [("note_wire_round", (0,)),
                    ("note_nonfinite", (1.0, "float32", 1))]
    + [("note_wire_round", (r,)) for r in (1, 2, 3, 4)]
    + [("note_nonfinite", (1.0, "float32", 1)), ("note_wire_round", (5,))],
    "grad_norm": [("observe_grad_norm", (1.0,))] * 6
    + [("observe_grad_norm", (9.0,))] * 3 + [("observe_grad_norm", (1.0,))]
    * 4 + [("note_skip", ())],
}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_monitor_parity(case, monkeypatch):
    """Both packages' monitors, on the same events and fake clock, trip
    and clear the same alerts on the same samples."""
    monkeypatch.setenv("HOROVOD_HEALTH_TRIP_STEPS", "2")
    monkeypatch.setenv("HOROVOD_HEALTH_CLEAR_STEPS", "3")
    monkeypatch.setenv("HOROVOD_HEALTH_SENTINEL_RATIO", "3.0")
    got = _monitor_trace(H, MONITOR_CASES[case], [0.0])
    want = _monitor_trace(JH, MONITOR_CASES[case], [0.0])
    assert got == want
    assert any(a for a, _ in got[0])  # every case trips something


def test_monitor_loss_sentinel_with_fake_clock(monkeypatch):
    monkeypatch.setenv("HOROVOD_HEALTH_TRIP_STEPS", "2")
    monkeypatch.setenv("HOROVOD_HEALTH_CLEAR_STEPS", "3")
    monkeypatch.setenv("HOROVOD_HEALTH_SENTINEL_RATIO", "3.0")
    t = [100.0]
    m = H.HealthMonitor(clock=lambda: t[0])
    for _ in range(H.WARMUP_SAMPLES):
        m.observe_loss(2.0)
    t[0] = 123.0
    m.observe_loss(50.0)
    assert m.alerts_total() == 0
    m.observe_loss(50.0)
    assert m.active_alerts() == ["loss_divergence"]
    assert m.snapshot()["alert_log"][0]["time"] == 123.0
    for _ in range(3):
        m.observe_loss(2.0)
    assert m.active_alerts() == [] and m.alerts_total() == 1


def test_nonfinite_alert_clears_after_clean_verdicts(monkeypatch):
    monkeypatch.setenv("HOROVOD_HEALTH_CLEAR_STEPS", "8")
    H.reset()
    poisoned = np.array([[1.0, 4.0, 2.0, 5.0]])
    clean = np.array([[0.0, 4.0, 2.0, 0.0], [1.0, 4.0, 2.0, 0.0]])
    H.publish_verdict(poisoned, idx=None, groups=("float32",))
    m = H.monitor()
    assert "nonfinite" in m.active_alerts()
    for _ in range(H.WARMUP_SAMPLES):
        m.observe_loss(1.0)
    assert H.loss_guard()["diverged"] is True
    for _ in range(7):
        H.publish_verdict(clean, idx=0, groups=("float32",))
        assert "nonfinite" in m.active_alerts()
    H.publish_verdict(clean, idx=0, groups=("float32",))
    assert "nonfinite" not in m.active_alerts()
    assert H.loss_guard()["diverged"] is False
    H.publish_verdict(poisoned, idx=None, groups=("float32",))
    assert "nonfinite" in m.active_alerts() and m.alerts_total() == 2


def test_publish_verdict_attribution_and_idx_gate():
    rows = np.array([[0.0, 4.0, 2.0, 0.0],
                     [1.0, 9.0, 3.0, 0.0],
                     [2.0, 1.0, 1.0, 5.0]])
    H.publish_verdict(rows, idx=0, groups=("float32",))
    JH.publish_verdict(rows, idx=0, groups=("float32",))
    snap = H.monitor().snapshot()
    assert snap["culprits"] == [{"rank": 2, "group": "float32",
                                 "count": 5.0}]
    assert snap["culprits"] == JH.monitor().snapshot()["culprits"]
    assert snap["first_nonfinite"]["rank"] == 2
    assert "nonfinite" in H.monitor().active_alerts()
    assert M.gauge("hvd_grad_norm").value(group="all") == \
        pytest.approx(np.sqrt(14.0))
    assert M.gauge("hvd_grad_max_abs").value(group="float32") == 3.0
    assert M.counter("hvd_nonfinite_total").value(
        group="float32", rank="2") == 5.0
    # another emulated rank's publication of the same verdict: a no-op
    H.publish_verdict(rows, idx=7, groups=("float32",))
    assert M.counter("hvd_nonfinite_total").value(
        group="float32", rank="2") == 5.0
    evs = [e for e in flight.recorder().snapshot()
           if e.get("kind") == "health"]
    assert any(e.get("event") == "first_nonfinite"
               and e.get("culprit") == 2 for e in evs)


def test_wire_tap_verdict_does_not_feed_grad_sentinel():
    m = H.monitor()
    for _ in range(H.WARMUP_SAMPLES + 3):
        H.publish_verdict(np.array([[0.0, 1.0, 1.0, 0.0]]), idx=0,
                          groups=("bfloat16",), sentinel=False)
        H.publish_verdict(np.array([[0.0, 1e6, 1e3, 0.0]]), idx=0,
                          groups=("float32",), sentinel=False)
    assert m.grad.samples == 0 and m.active_alerts() == []
    assert M.gauge("hvd_grad_norm").value(group="float32") == 1e3
    m.note_nonfinite(1.0, "float32", 0)
    for _ in range(100):
        H.publish_verdict(np.array([[0.0, 1.0, 1.0, 0.0]]), idx=0,
                          groups=("float32",), sentinel=False)
    assert "nonfinite" in m.active_alerts()


def test_healthy_run_publishes_no_phantom_alert_series(monkeypatch):
    monkeypatch.setenv("HOROVOD_HEALTH_CLEAR_STEPS", "2")
    H.reset()
    m = H.monitor()
    for _ in range(10):
        m.observe_loss(1.0)
        H.publish_verdict(np.array([[0.0, 1.0, 1.0, 0.0]]), idx=0,
                          groups=("float32",))
    m.refresh()
    assert M.gauge("hvd_health_alert").series() == []
    view = H.from_metrics_snapshot(M.metrics())
    assert view["alerts_total"] == 0 and view["active_alerts"] == []


def test_load_report_does_not_world_fold_culprits(tmp_path):
    H.monitor().note_nonfinite(1.0, "float32", 1)
    snap = H.monitor().snapshot()
    for rank in (0, 1):
        per = dict(snap)
        per["meta"] = {"rank": rank, "size": 2, "generation": 1,
                       "reason": "test"}
        with open(tmp_path / f"health-r{rank}-g1.json", "w") as f:
            json.dump(per, f)
    rep = H.load_report(str(tmp_path))
    assert rep == JH.load_report(str(tmp_path))
    assert rep["culprits"] == [{"rank": 1, "group": "float32",
                                "count": 1.0}]
    assert len(rep["ranks"]) == 2 and rep["alerts_total"] == 1


def test_data_rules_raise_on_malformed_spec(monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_SPEC", "nan:grads*:round_x")
    with pytest.raises(F.FaultSpecError):
        F.data_rules()


def test_update_ratio_publish():
    H.tap_update_ratio([torch.full((4,), 0.5)], [torch.full((4,), 5.0)])
    JH.tap_update_ratio({"w": jnp.full((4,), 0.5)},
                        {"w": jnp.full((4,), 5.0)})
    got = M.gauge("hvd_update_ratio").value(group="float32")
    assert got == pytest.approx(0.1)
    assert got == pytest.approx(JH._M_UPDATE_RATIO.value(group="float32"),
                                rel=1e-6)


def test_dump_load_report_cli_round_trip(tmp_path, monkeypatch):
    """The port's dump reads in both packages' report, and ``python -m
    horovod_tpu_torch.perf health`` prints it."""
    monkeypatch.setenv("HOROVOD_HEALTH_DIR", str(tmp_path))
    m = H.monitor()
    m.note_nonfinite(3.0, "float32", 1)
    m.observe_grad_norm(12.5)
    m.observe_loss(0.7)
    path = H.dump("test")
    assert path and os.path.exists(path)
    rep = H.load_report(str(tmp_path))
    assert rep == JH.load_report(str(tmp_path))
    assert rep["ranks"][0]["last_grad_norm"] == 12.5
    text = H.format_report(rep)
    assert text == JH.format_report(rep)
    assert "rank 1 / float32" in text and "3 nonfinite" in text
    env = dict(os.environ, PYTHONPATH=REPO)
    for args, want in ((["--json"], 0), ([], 0)):
        r = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.perf",
                            "health", str(tmp_path), *args],
                           capture_output=True, text=True, env=env,
                           timeout=120)
        assert r.returncode == want, r.stderr[-800:]
    assert "culprit attribution" in r.stdout
    empty = tmp_path / "empty"
    empty.mkdir()
    r = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.perf",
                        "health", str(empty)], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 1 and "no health data" in r.stdout


def test_from_metrics_snapshot():
    H.publish_verdict(np.array([[1.0, 4.0, 2.0, 7.0]]), idx=None,
                      groups=("bfloat16",))
    H.observe_loss(0.5)
    view = H.from_metrics_snapshot(M.metrics())
    assert view["last_loss"] == 0.5
    assert any(c["rank"] == 1 and c["group"] == "bfloat16"
               and c["count"] == 7.0 for c in view["culprits"])
    assert "nonfinite" in view["active_alerts"]


def test_loss_guard_primary_signal(monkeypatch):
    """``loss_guard()``: None before the warm-up, then the loss verdict;
    a nonfinite alert pins it diverged (the JAX package's ``pm._guard``
    cases, ``tests/test_health.py:455,563,589``, read it; its tuner
    comes with ROADMAP.md Queue A item 12h)."""
    assert H.loss_guard() is None
    for _ in range(H.WARMUP_SAMPLES + 1):
        H.observe_loss(1.0)
        JH.observe_loss(1.0)
    assert H.loss_guard() == {"diverged": False,
                              "ratio": pytest.approx(1.0),
                              "samples": H.WARMUP_SAMPLES + 1}
    assert H.loss_guard() == JH.loss_guard()
    H.monitor().note_nonfinite(1.0, "float32", 0)
    JH.monitor().note_nonfinite(1.0, "float32", 0)
    assert H.loss_guard()["diverged"] is True
    assert H.loss_guard() == JH.loss_guard()


def test_flight_dump_carries_health_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_FLIGHT_DIR", str(tmp_path))
    flight.reset()
    H.monitor().note_nonfinite(2.0, "float32", 1)
    path = flight.dump_on_failure("test", flush_metrics=False)
    with open(path) as f:
        evs = [json.loads(ln) for ln in f][1:]
    cps = [e for e in evs if e.get("kind") == "health"
           and e.get("event") == "checkpoint"]
    assert cps and cps[0]["nonfinite_events"] == 1
    assert any(n.startswith("health-r") for n in os.listdir(tmp_path))


def test_analyzer_health_section(tmp_path):
    """The port's ring, merged and analyzed: the health section names
    the culprit (``tests/test_health.py:767``)."""
    from horovod_tpu_torch.trace.analyze import analyze, format_report
    from horovod_tpu_torch.trace import merge_dumps

    r0 = flight.FlightRecorder(64)
    r0.record("round", ph="B", round=0, n_req=1)
    r0.record("round", ph="E", round=0, path="slow", n_resp=1)
    r0.record("round", ph="B", round=1, n_req=1)
    r0.record("health", event="first_nonfinite", culprit=1,
              group="float32", count=2.0)
    r0.record("health", event="sentinel_trip", reason="loss_divergence")
    r0.dump(os.path.join(tmp_path, "flight-r0-g1-p1.jsonl"),
            {"rank": 0, "size": 2, "generation": 1, "reason": "t"})
    r1 = flight.FlightRecorder(64)
    r1.record("round", ph="B", round=0, n_req=1)
    r1.dump(os.path.join(tmp_path, "flight-r1-g1-p2.jsonl"),
            {"rank": 1, "size": 2, "generation": 1})
    _, dumps, offsets = merge_dumps(str(tmp_path))
    hl = analyze(dumps, offsets)["health"]
    assert hl["first_nonfinite"][0]["culprit"] == 1
    assert hl["first_nonfinite"][0]["round"] == 1
    assert "culprit rank 1 / float32" in format_report(
        analyze(dumps, offsets))


# ---------------------------------------------------------------------------
# 4. The taps on a gloo world of four ranks
# ---------------------------------------------------------------------------


def _jax_verdict(case: str) -> np.ndarray:
    """The JAX package's gathered verdict for ``case``: its
    ``tap_gradients`` under ``shard_map`` on four CPU devices, the
    array its host callback receives."""
    got = []
    real = JH.publish_verdict
    JH.publish_verdict = lambda g, idx=None, **kw: got.append(
        (np.asarray(g), int(np.asarray(idx))))
    try:
        per = [verdict_grads(r, case) for r in range(N)]
        stacked = [np.stack([p[n] for p in per]) for n, _, _ in
                   VERDICT_LEAVES]

        def body(*blocks):
            leaves = [b[0].astype(jnp.bfloat16) if d == "bfloat16"
                      else b[0] for b, (_, _, d) in
                      zip(blocks, VERDICT_LEAVES)]
            bad, _ = JH.tap_gradients(leaves, "hvd")
            return bad

        jax.jit(shard_map(body, mesh=_mesh(N), check_vma=False,
                          in_specs=(P("hvd"),) * len(stacked),
                          out_specs=P()))(*map(jnp.asarray, stacked))
        jax.effects_barrier()
    finally:
        JH.publish_verdict = real
    assert len({i for _, i in got}) == N  # one call per device
    return got[0][0]


@pytest.mark.parametrize("case", [c for c, _ in VERDICT_CASES])
def test_verdict_matches_jax(world4, case):
    """Equal verdicts: rank, max-abs and nonfinite columns exact, the
    finite-part sums of squares within 1e-6 relative."""
    want = _jax_verdict(case)
    for o in world4:
        got = np.asarray(o["verdict"][case], np.float64)
        assert got.shape == want.shape
        exact = [c for c in range(got.shape[1]) if c % 3 != 1]
        np.testing.assert_array_equal(got[:, exact], want[:, exact])
        np.testing.assert_allclose(got[:, 1::3], want[:, 1::3], rtol=1e-6)
    assert (want[:, 3::3].sum() > 0) == (case != "clean")


@pytest.mark.parametrize("stage,wire", SKIP_CASES)
def test_skip_step_holds_everything(world4, stage, wire):
    """A poisoned step (``nan@rank1:grads*``) under the skip knob leaves
    the parameters and every state tensor (trace, residuals, shard
    state) bit for bit as before it, on every rank; the next clean step
    moves them; rank 1 / float32 is named."""
    for o in world4:
        r = o["skip"][f"{stage} {wire}"]
        assert r["before"] == r["after"], (stage, wire)
        assert r["moved"][0] != r["after"][0]
        assert r["skipped"] == 1 and r["finite"]
        assert [c["rank"] for c in r["culprits"]] == [1]
        assert {c["group"] for c in r["culprits"]} == {"float32"}
    assert len({o["skip"][f"{stage} {wire}"]["after"][0]
                for o in world4}) in (1, N)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("overlap", [0, 1])
@pytest.mark.parametrize("wire", WIRES)
def test_stats_on_off_parity_bit_exact(world4, stage, overlap, wire):
    """Health on changes no trained bit (``tests/test_health.py:685``):
    weights and optimizer state after three steps."""
    for o in world4:
        on, off = o["parity"][f"{stage} {overlap} {wire}"]
        assert on == off


@pytest.mark.parametrize("stage", [0, 2])
def test_one_small_allgather_no_full_buffer(world4, stage):
    """The tap adds exactly one collective, an all-gather of the
    verdict's size (1 + 3 x one group), and no buffer of the fused
    length (``tests/test_health.py:721,753``)."""
    total = sum(int(np.prod(s)) for _, s in OPT_LEAVES)
    for o in world4:
        off, on = o["record"][f"{stage} 0"], o["record"][f"{stage} 1"]
        added = list(on["calls"])
        for c in off["calls"]:
            added.remove(c)
        assert added == [["all_gather_into_tensor", 4]]
        assert on["max_numel"] == off["max_numel"]
        if stage == 2:  # stage 2 never builds the fused buffer
            assert on["max_numel"] < total


# ---------------------------------------------------------------------------
# 5. Culprit attribution, two processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("regime", ["eager", "intrace"])
def test_culprit_attribution_2proc(culprit2, regime):
    outs, _ = culprit2
    ws = []
    for o in outs:
        r = o[regime]
        assert r["nonfinite"] == [["1", "float32", 1.0]], (o["rank"], r)
        assert r["alert"] and r["skipped"] == 1
        assert np.isfinite(r["w"]).all()
        ws.append(r["w"])
    assert ws[0] == ws[1]
    # five updates of 0.1 x mean(0.5, 1.5) from 1: the skipped one is gone
    np.testing.assert_allclose(ws[0], 0.5, rtol=1e-6)


def test_culprit_in_merged_trace_and_reports(culprit2):
    from horovod_tpu_torch.trace.analyze import analyze, format_report
    from horovod_tpu_torch.trace.merge import compute_offsets, load_dumps

    _, fd = culprit2
    dumps = load_dumps(fd)
    rep = analyze(dumps, compute_offsets(dumps))
    firsts = rep["health"]["first_nonfinite"]
    assert firsts and all(f["culprit"] == 1 and f["group"] == "float32"
                          for f in firsts)
    assert "culprit rank 1 / float32" in format_report(rep)
    # the per-rank health dumps landed beside the rings
    rep2 = H.load_report(fd)
    assert {r["meta"]["rank"] for r in rep2["ranks"]} == {0, 1}
    assert rep2["culprits"] == [{"rank": 1, "group": "float32",
                                 "count": 1.0}]


# ---------------------------------------------------------------------------
# 6. The residual-ratio gauge and the handshake's mode set
# ---------------------------------------------------------------------------


def test_handshake_validates_quant_knobs_under_adaptive(monkeypatch):
    monkeypatch.setenv("HOROVOD_COMPRESSION", "none")
    monkeypatch.delenv("HOROVOD_ADAPTIVE_COMPRESSION", raising=False)
    assert tctl._active_wire_modes() == {"none"}
    monkeypatch.setenv("HOROVOD_ADAPTIVE_COMPRESSION", "1")
    assert tctl._active_wire_modes() == jctl._active_wire_modes()
    assert {"int8", "int4", "topk"} <= tctl._active_wire_modes()


def test_handshake_codes_for_new_knobs(monkeypatch):
    monkeypatch.setenv("HOROVOD_BUCKET_COMPRESSION", "Int8: int4")
    normalized = tctl._bucket_modes_code()
    monkeypatch.setenv("HOROVOD_BUCKET_COMPRESSION", "int8:int4")
    assert tctl._bucket_modes_code() == normalized
    assert normalized == jctl._bucket_modes_code()
    assert {"int8", "int4"} <= tctl._active_wire_modes()


def test_residual_ratio_matches_jax_with_integer_leaf(monkeypatch):
    """The replicated path's gauge with an integer leaf in the tree
    (``tests/test_adaptive_compression.py:988``): the float pair still
    publishes, the same ratios as the JAX package's on one device."""
    monkeypatch.setenv("HOROVOD_ADAPTIVE_COMPRESSION", "1")
    monkeypatch.setenv("HOROVOD_OVERLAP", "1")
    monkeypatch.setenv("HOROVOD_OVERLAP_CHUNKS", "3")
    rng = np.random.RandomState(14)
    res = rng.standard_normal(250).astype(np.float32) * 0.1
    red = rng.standard_normal(250).astype(np.float32)
    TD._M_RESID_RATIO.reset()
    TD._maybe_report_residual_ratio(
        [torch.from_numpy(res), torch.zeros(4)],
        [torch.from_numpy(red), torch.zeros(4, dtype=torch.int32)],
        PM.Hop([0], 0), overlap=None)
    got = {s["labels"]["bucket"]: s["value"]
           for s in TD._M_RESID_RATIO.series()}
    from horovod_tpu.optim import distributed as JD

    JD._M_RESID_RATIO.reset()

    def body(r, g):
        JD._maybe_report_residual_ratio(
            {"w": r[0], "step": jnp.zeros((4,), jnp.float32)},
            {"w": g[0], "step": jnp.zeros((4,), jnp.int32)}, "hvd")
        return g

    jax.jit(shard_map(body, mesh=_mesh(1), check_vma=False,
                      in_specs=(P("hvd"), P("hvd")), out_specs=P("hvd")))(
        jnp.asarray(res[None]), jnp.asarray(red[None]))
    jax.effects_barrier()
    want = {s["labels"]["bucket"]: s["value"]
            for s in JD._M_RESID_RATIO.series()}
    assert sorted(got) == sorted(want) == ["0", "1", "2"]
    for b in got:
        assert got[b] == pytest.approx(want[b], rel=1e-6)
    TD._M_RESID_RATIO.reset()
    JD._M_RESID_RATIO.reset()


def test_bucket_ratio_shard_path_matches_jax(monkeypatch):
    """The ZeRO paths' gauge (a shard reference) at one rank against the
    JAX package's ``_report_bucket_residual_ratios``."""
    monkeypatch.setenv("HOROVOD_ADAPTIVE_COMPRESSION", "1")
    rng = np.random.RandomState(7)
    err = rng.standard_normal(96).astype(np.float32)
    shard = rng.standard_normal(96).astype(np.float32)
    TD._M_RESID_RATIO.reset()
    TD._report_bucket_residual_ratios(torch.from_numpy(err),
                                      torch.from_numpy(shard)[:96], 1,
                                      PM.Hop([0], 0), chunks=4)
    got = {s["labels"]["bucket"]: s["value"]
           for s in TD._M_RESID_RATIO.series()}
    from horovod_tpu.optim import distributed as JD

    JD._M_RESID_RATIO.reset()

    def body(e, s):
        JD._report_bucket_residual_ratios(e[0], s[0], 1, "hvd", chunks=4)
        return e

    jax.jit(shard_map(body, mesh=_mesh(1), check_vma=False,
                      in_specs=(P("hvd"), P("hvd")), out_specs=P("hvd")))(
        jnp.asarray(err[None]), jnp.asarray(shard[None]))
    jax.effects_barrier()
    want = {s["labels"]["bucket"]: s["value"]
            for s in JD._M_RESID_RATIO.series()}
    assert sorted(got) == sorted(want) and len(got) == 4
    for b in got:
        assert got[b] == pytest.approx(want[b], rel=1e-6)
    TD._M_RESID_RATIO.reset()
    JD._M_RESID_RATIO.reset()


def test_eager_lossy_publishes_guard_signal(monkeypatch):
    """The eager wire keeps no error feedback, so under adaptive
    compression a lossy response publishes its dropped mass
    (``tests/test_adaptive_compression.py:917``); a one-rank executor's
    reduction is the identity, so the helper is driven directly."""
    monkeypatch.setenv("HOROVOD_ADAPTIVE_COMPRESSION", "1")
    monkeypatch.setenv("HOROVOD_TOPK_RATIO", "0.05")
    from horovod_tpu_torch.ops import quantization as Q

    assert TX._eager_guard_signal(("topk",))
    assert not TX._eager_guard_signal(("none", "fp16"))
    x = torch.from_numpy(np.random.RandomState(13).standard_normal(
        512).astype(np.float32))
    kept = torch.zeros_like(x)
    idx = Q._topk_indices(x, Q.topk_k(512))
    kept[idx] = x[idx]
    TD._M_RESID_RATIO.reset()
    TX._publish_eager_loss(x - kept, kept, 1, PM.Hop([0], 0), 1)
    series = TD._M_RESID_RATIO.series()
    assert series and max(s["value"] for s in series) > 0.5
    TD._M_RESID_RATIO.reset()
