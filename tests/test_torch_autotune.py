"""The port's autotuner against the JAX package's.

1. ``runtime/gaussian_process.py`` and ``runtime/bayes_opt.py``: the GP
   posterior, expected improvement and the seeded candidate cloud's next
   sample, bit for bit with ``horovod_tpu.runtime`` (both are numpy on
   the same inputs).
2. ``runtime/parameter_manager.py``: the reference's 15 cases of
   ``tests/test_autotune.py`` run on the port; a scripted sequence of
   ``record_bytes``/``tick`` under a patched clock gives the JAX
   package's proposals in the same order and the same CSV rows; the
   guardrail cases of ``tests/test_adaptive_compression.py:690-965`` and
   ``tests/test_health.py:455-600`` give the reference's verdicts;
   ``apply_params`` exports the same knobs, and refuses a proposal it
   cannot apply.
3. The proposal on the wire: ``"t"`` round-trips through both codecs,
   KVControllers of both packages post the same payloads for rounds that
   carry it (fast and slow path, flat and hierarchical plane), and every
   rank applies it at the same round and toggles its cache probing; a
   spawned gloo world of 2 changes its knobs on both ranks at one round
   (``tests/test_multiprocess.py::test_autotune_param_sync_2proc``).
"""

import csv
import json
import os
import threading

import numpy as np
import pytest
import torch

from horovod_tpu.common import config as jconfig
from horovod_tpu.runtime import bayes_opt as JBO
from horovod_tpu.runtime import controller as jctl
from horovod_tpu.runtime import gaussian_process as JGP
from horovod_tpu.runtime import health as JH
from horovod_tpu.runtime import metrics as JM
from horovod_tpu.runtime import parameter_manager as JPM
from horovod_tpu.runtime import wire as jwire

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.runtime import bayes_opt as TBO
from horovod_tpu_torch.runtime import controller as tctl
from horovod_tpu_torch.runtime import gaussian_process as TGP
from horovod_tpu_torch.runtime import health as TH
from horovod_tpu_torch.runtime import metrics as TM
from horovod_tpu_torch.runtime import parameter_manager as TPM
from horovod_tpu_torch.runtime import wire as twire

from _torch_collectives_worker import spawn  # noqa: E402
from test_response_cache import DictTransport  # noqa: E402

_MUTATED_ENV = ("HOROVOD_FUSION_THRESHOLD", "HOROVOD_CYCLE_TIME",
                "HOROVOD_HIERARCHICAL_ALLREDUCE",
                "HOROVOD_HIERARCHICAL_ALLGATHER",
                "HOROVOD_OVERLAP_CHUNKS", "HOROVOD_ZERO_PREFETCH_CHUNKS",
                "HOROVOD_BUCKET_COMPRESSION", "HOROVOD_LOCAL_SGD_H")


@pytest.fixture(autouse=True)
def _restore_knob_env():
    """``apply_params`` exports knobs to ``os.environ`` (env is the one
    source of truth); no tuned value leaks into the rest of the run."""
    saved = {k: os.environ.get(k) for k in _MUTATED_ENV}
    for mod in (TH, JH):
        mod.reset()
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    for mod in (TH, JH):
        mod.reset()


# ---------------------------------------------------------------------------
# 1. GP, expected improvement, Bayesian optimization: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims,n,noise", [(1, 9, 0.01), (3, 12, 0.8),
                                          (9, 20, 0.3)])
def test_gp_fit_predict_matches_reference(dims, n, noise):
    rng = np.random.RandomState(0)
    x = rng.rand(n, dims)
    y = np.sin(2 * np.pi * x).sum(1) + 0.1 * rng.standard_normal(n)
    xs = rng.rand(64, dims)
    tg, jg = TGP.GaussianProcess(noise=noise), JGP.GaussianProcess(noise=noise)
    # the prior before any fit
    for a, b in zip(tg.predict(xs), jg.predict(xs)):
        np.testing.assert_array_equal(a, b)
    tg.fit(x, y)
    jg.fit(x, y)
    assert tg.length_scale == jg.length_scale
    for a, b in zip(tg.predict(xs), jg.predict(xs)):
        np.testing.assert_array_equal(a, b)


def test_expected_improvement_matches_reference():
    rng = np.random.RandomState(0)
    mean = rng.standard_normal(257)
    std = np.abs(rng.standard_normal(257))
    std[::7] = 0.0
    for best in (-1.0, 0.0, 0.37, 2.5):
        for xi in (0.0, 0.01, 0.3):
            np.testing.assert_array_equal(
                TBO.expected_improvement(mean, std, best, xi),
                JBO.expected_improvement(mean, std, best, xi))
    x = np.linspace(-4, 4, 101)
    np.testing.assert_array_equal(TBO._erf(x), JBO._erf(x))


@pytest.mark.parametrize("dims,seed", [(1, 0), (2, 0), (7, 0), (9, 3)])
def test_next_sample_matches_reference(dims, seed):
    """The seeded candidate cloud: the same proposals, step by step, on a
    quadratic objective."""
    target = np.linspace(0.2, 0.8, dims)
    tb = TBO.BayesianOptimization(dims, noise=0.1, seed=seed)
    jb = JBO.BayesianOptimization(dims, noise=0.1, seed=seed)
    xt = xj = np.full(dims, 0.5)
    assert np.array_equal(tb.next_sample(), jb.next_sample())
    for _ in range(12):
        tb.add_sample(xt, -float(((xt - target) ** 2).sum()))
        jb.add_sample(xj, -float(((xj - target) ** 2).sum()))
        xt, xj = tb.next_sample(), jb.next_sample()
        np.testing.assert_array_equal(xt, xj)
    for a, b in zip(tb.best(), jb.best()):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# 2a. The reference's tests/test_autotune.py, on the port
# ---------------------------------------------------------------------------


def test_gp_fits_observations():
    x = np.linspace(0, 1, 9)[:, None]
    y = np.sin(2 * np.pi * x.ravel())
    gp = TGP.GaussianProcess(noise=0.01)
    gp.fit(x, y)
    mean, std = gp.predict(x)
    np.testing.assert_allclose(mean, y, atol=0.1)
    # the posterior contracts at observed points
    _, far_std = gp.predict(np.array([[0.055]]))
    assert std.max() <= far_std[0] + 1e-6


def test_gp_prior_before_fit():
    mean, std = TGP.GaussianProcess().predict(np.array([[0.3, 0.7]]))
    assert mean.shape == (1,) and std.shape == (1,)


def test_expected_improvement_prefers_promising_point():
    ei = TBO.expected_improvement(np.array([0.0, 1.0, 2.0]),
                                  np.array([1.0, 1.0, 1.0]), best=1.0)
    assert ei[2] > ei[1] > ei[0]
    # zero std, mean below best: no improvement
    assert TBO.expected_improvement(np.array([0.0]), np.array([0.0]),
                                    1.0)[0] == 0


def test_bayes_opt_finds_maximum_1d():
    bo = TBO.BayesianOptimization(dims=1, noise=0.01, seed=1)
    x = np.array([0.1])
    for _ in range(20):
        bo.add_sample(x, -(x[0] - 0.7) ** 2)
        x = bo.next_sample()
    best_x, _ = bo.best()
    assert abs(best_x[0] - 0.7) < 0.12


def test_unit_param_roundtrip():
    u = TPM.params_to_unit(64 * 1024 * 1024, 5.0, True)
    p = TPM.unit_to_params(u)
    assert p["fusion_threshold"] == 64 * 1024 * 1024
    assert abs(p["cycle_time_ms"] - 5.0) < 0.05
    assert p["cache_enabled"] is True
    assert p["overlap_chunks"] == 4  # the knob's default
    u = TPM.params_to_unit(64 * 1024 * 1024, 5.0, True, overlap_chunks=16)
    assert TPM.unit_to_params(u)["overlap_chunks"] == 16
    # legacy 5-dim points resolve to the default
    assert TPM.unit_to_params(u[:5])["overlap_chunks"] == 4
    assert p == JPM.unit_to_params(JPM.params_to_unit(64 * 1024 * 1024,
                                                      5.0, True))


def test_canonical_unit_snaps_to_measured_config():
    a = TPM.canonical_unit(np.array([0.43, 0.30, 0.51]))
    b = TPM.canonical_unit(np.array([0.45, 0.30, 0.95]))
    np.testing.assert_allclose(a, b)
    assert TPM.unit_to_params(a) == TPM.unit_to_params(
        np.array([0.43, 0.30, 0.51]))
    np.testing.assert_array_equal(
        a, JPM.canonical_unit(np.array([0.43, 0.30, 0.51])))


def test_parameter_manager_lifecycle(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "2")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "4")
    log = tmp_path / "autotune.csv"
    monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(log))
    pm = TPM.ParameterManager()
    assert pm.enabled
    proposals = []
    for _ in range(40):
        pm.record_bytes(10 * 1024 * 1024)
        t = pm.tick()
        if t is not None:
            proposals.append(t)
        if pm._pinned:
            break
    assert pm._pinned, "should pin after max_samples windows"
    assert proposals, "should have proposed at least one tune"
    for t in proposals:
        assert set(t) == {"fusion_threshold", "cycle_time_ms",
                          "cache_enabled", "hierarchical_allreduce",
                          "hierarchical_allgather", "overlap_chunks",
                          "zero_prefetch_chunks"}
        assert 1024 * 1024 <= t["fusion_threshold"] <= 128 * 1024 * 1024
        assert 1.0 <= t["cycle_time_ms"] <= 25.0
        # world 1: the hierarchical, overlap and prefetch dims stay frozen
        assert t["hierarchical_allreduce"] is False
        assert t["hierarchical_allgather"] is False
        assert t["overlap_chunks"] == 4
        assert t["zero_prefetch_chunks"] == 4
    lines = log.read_text().strip().splitlines()
    assert lines[0].startswith("sample,score,objective")
    assert lines[0].rstrip().endswith(",bucket_compression,pinned")
    assert len(lines) >= len(proposals)
    assert lines[-1].endswith(",1")  # the pinned row


def test_parameter_manager_idle_windows_ignored(monkeypatch):
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "1")
    pm = TPM.ParameterManager()
    for _ in range(10):
        assert pm.tick() is None  # no bytes: nothing to learn
    assert pm._samples_seen == 0


def test_apply_params_exports_env(monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1048576")
    TPM.apply_params({"fusion_threshold": 2 * 1024 * 1024,
                      "cycle_time_ms": 3.5, "cache_enabled": False})
    assert _config.get("fusion_threshold") == 2 * 1024 * 1024
    assert _config.get("cycle_time_ms") == 3.5


class _FakeClock:
    """Deterministic monotonic time: +0.5 s per call, so every sample
    window spans the same time and a score is proportional to its
    bytes."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        self.t += 0.5
        return self.t


def test_autotune_flips_hierarchical_knob(monkeypatch):
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "0")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "20")
    monkeypatch.setattr(TPM, "time", _FakeClock())
    pm = TPM.ParameterManager(world=8, hier_possible=True)
    assert 3 in pm._tuned and 4 in pm._tuned
    scores = {True: [], False: []}
    for _ in range(64):
        cur = TPM.unit_to_params(pm._full(pm._current))
        rate = 20 * 1024 * 1024 if cur["hierarchical_allreduce"] \
            else 10 * 1024 * 1024
        scores[cur["hierarchical_allreduce"]].append(rate)
        pm.record_bytes(rate)
        pm.tick()
        if pm._pinned:
            break
    assert pm._pinned
    best_x, best_y = pm.bo.best()
    assert TPM.unit_to_params(pm._full(best_x))["hierarchical_allreduce"]
    assert scores[False], "the tuner never tried the hier-off arm"
    assert best_y > max(scores[False]) / 0.5  # score = bytes / 0.5 s


def test_hier_dims_frozen_when_impossible(monkeypatch):
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    pm = TPM.ParameterManager(world=8, hier_possible=False)
    assert 3 not in pm._tuned and 4 not in pm._tuned
    # the port's own detection: no (cross, local) pair was built
    pm = TPM.ParameterManager(world=8)
    assert 3 not in pm._tuned and 4 not in pm._tuned


def test_overlap_chunks_dim_gated_on_knob(monkeypatch):
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_OVERLAP", "1")
    monkeypatch.setenv("HOROVOD_OVERLAP_CHUNKS", "8")
    pm = TPM.ParameterManager(world=8, hier_possible=False)
    assert 5 in pm._tuned
    assert TPM.unit_to_params(pm._fixed_full)["overlap_chunks"] == 8
    pm = TPM.ParameterManager(world=1, hier_possible=False)
    assert 5 not in pm._tuned  # no wire to hide
    monkeypatch.setenv("HOROVOD_OVERLAP", "0")
    pm = TPM.ParameterManager(world=8, hier_possible=False)
    assert 5 not in pm._tuned  # the engine is off


def test_autotune_explores_overlap_chunks(monkeypatch):
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "0")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "24")
    monkeypatch.setenv("HOROVOD_OVERLAP", "1")
    monkeypatch.setenv("HOROVOD_OVERLAP_CHUNKS", "1")
    monkeypatch.setattr(TPM, "time", _FakeClock())
    pm = TPM.ParameterManager(world=8, hier_possible=False)
    assert 5 in pm._tuned
    tried = set()
    for _ in range(80):
        k = TPM.unit_to_params(pm._full(pm._current))["overlap_chunks"]
        tried.add(k)
        pm.record_bytes(int(20e6 - abs(np.log2(k) - 3) * 4e6))
        pm.tick()
        if pm._pinned:
            break
    assert pm._pinned
    assert len(tried) > 1, "the tuner never explored the chunk dim"
    best_x, _ = pm.bo.best()
    pinned = TPM.unit_to_params(pm._full(best_x))
    assert abs(np.log2(pinned["overlap_chunks"]) - 3) <= 1, pinned


def test_apply_params_exports_hierarchical(monkeypatch):
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", "0")
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLGATHER", "1")
    TPM.apply_params({"hierarchical_allreduce": True,
                      "hierarchical_allgather": False})
    assert _config.get("hierarchical_allreduce")
    assert not _config.get("hierarchical_allgather")


def test_autotune_end_to_end_single(monkeypatch):
    """Eager allreduces at world 1 with the tuner on: samples are taken
    and the knobs retuned live, the results stay exact."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import eager as E

    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "0")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "3")
    if hvd.is_initialized():
        hvd.shutdown()
    hvd.init(device="cpu")
    try:
        bg = None
        for i in range(40):
            out = hvd.allreduce(torch.ones(256), name=f"t{i}")
            assert torch.equal(out, torch.ones(256))
            bg = E._runtime()
            if bg.pm is not None and bg.pm._pinned:
                break
        assert bg.pm is not None
        assert bg.pm._samples_seen > 0 and bg.pm._pinned
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# 2b. The proposal sequence and the CSV against the JAX package's
# ---------------------------------------------------------------------------

_LADDER = ("none", "bf16", "fp16", "int8", "int4", "topk")


def _mode_oracle(slow: bool):
    """tests/test_adaptive_compression.py's comm-exposed oracle: bucket
    1's hop is slow (a byte cut pays off) or fast (modes only add
    overhead)."""
    state = {"modes": None}

    def signal():
        modes = state["modes"] or ["int8", "int8"]
        i0 = _LADDER.index(modes[0])
        i1 = _LADDER.index(modes[1 % len(modes)])
        hop1 = (0.500 - 0.080 * i1) if slow else 0.010 + 0.002 * i1
        return 0.010 + 0.002 * i0 + hop1

    return state, signal


SCRIPTS = {
    # name: (env, world, hier_possible, oracle kind)
    "world1": ({"HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2",
                "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
                "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "6"},
               1, False, "bytes"),
    "hier": ({"HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "12"},
             8, True, "hier"),
    "overlap": ({"HOROVOD_OVERLAP": "1", "HOROVOD_OVERLAP_CHUNKS": "1",
                 "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "12"},
                8, False, "chunks"),
    "zero3": ({"HOROVOD_ZERO_STAGE": "3", "HOROVOD_CACHE_CAPACITY": "0",
               "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "10"},
              4, False, "bytes"),
    "adaptive_slow": ({"HOROVOD_ADAPTIVE_COMPRESSION": "1",
                       "HOROVOD_OVERLAP": "1", "HOROVOD_OVERLAP_CHUNKS": "2",
                       "HOROVOD_COMPRESSION": "int8",
                       "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "16"},
                      8, False, "slow"),
    "adaptive_fast": ({"HOROVOD_ADAPTIVE_COMPRESSION": "1",
                       "HOROVOD_OVERLAP": "1", "HOROVOD_OVERLAP_CHUNKS": "2",
                       "HOROVOD_COMPRESSION": "int8",
                       "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "16"},
                      8, False, "fast"),
    "adaptive_bytes": ({"HOROVOD_ADAPTIVE_COMPRESSION": "1",
                        "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "8"},
                       4, False, "none"),
}


def _run_script(mod, name, log_path):
    env, world, hier, kind = SCRIPTS[name]
    comm = None
    state = {}
    if kind in ("slow", "fast"):
        state, comm = _mode_oracle(kind == "slow")
    elif kind == "none":
        def comm():
            return None
    mod.time = _FakeClock()
    pm = mod.ParameterManager(world=world, hier_possible=hier,
                              comm_signal=comm)
    proposals = []
    for i in range(120):
        cur = mod.unit_to_params(pm._full(pm._current))
        state["modes"] = cur.get("bucket_compression", "int8:int8").split(":")
        if kind == "hier":
            rate = (20 << 20) if cur["hierarchical_allreduce"] else (10 << 20)
        elif kind == "chunks":
            rate = int(20e6 - abs(np.log2(cur["overlap_chunks"]) - 3) * 4e6)
        else:
            rate = (10 << 20) + (i % 3) * (1 << 20)
        pm.record_bytes(rate, 2 * rate)
        t = pm.tick()
        if t is not None:
            proposals.append((i, t))
        if pm._pinned:
            break
    assert pm._pinned
    with open(log_path) as f:
        rows = list(csv.reader(f))
    return proposals, rows, pm._samples_seen, pm._objective


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_proposal_sequence_matches_reference(name, tmp_path, monkeypatch):
    """The same proposals at the same ticks and the same CSV rows as the
    JAX package's ``ParameterManager`` on the same scripted windows."""
    env = {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "1",
           "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "0"}
    env.update(SCRIPTS[name][0])
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = {}
    for tag, mod in (("port", TPM), ("jax", JPM)):
        saved = mod.time
        log = tmp_path / f"{tag}.csv"
        monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(log))
        try:
            out[tag] = _run_script(mod, name, log)
        finally:
            mod.time = saved
    assert out["port"] == out["jax"]
    proposals, rows, seen, objective = out["port"]
    assert proposals and rows[0][:3] == ["sample", "score", "objective"]
    assert rows[-1][-1] == "1"  # the pinned row
    if SCRIPTS[name][3] in ("slow", "fast"):
        assert objective == "comm_exposed"
        assert all("bucket_compression" in t for _, t in proposals)


def test_adaptive_tuner_goes_aggressive_on_delayed_path(monkeypatch,
                                                        tmp_path):
    """The reference's acceptance scenario on the port: on a slow bucket
    hop the tuner pins a mode more aggressive than int8 and than what a
    fast hop's run picks, and the CSV names the objective."""
    for k, v in SCRIPTS["adaptive_slow"][0].items():
        monkeypatch.setenv(k, v)
    for k, v in {"HOROVOD_AUTOTUNE": "1",
                 "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "1",
                 "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "0",
                 "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "30"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(TPM, "time", _FakeClock())
    pinned = {}
    for slow in (True, False):
        log = tmp_path / f"{slow}.csv"
        monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(log))
        state, signal = _mode_oracle(slow)
        pm = TPM.ParameterManager(world=8, hier_possible=False,
                                  comm_signal=signal)
        for _ in range(200):
            cur = TPM.unit_to_params(pm._full(pm._current))
            state["modes"] = cur["bucket_compression"].split(":")
            pm.record_bytes(10 * 1024 * 1024)
            pm.tick()
            if pm._pinned:
                break
        assert pm._pinned
        best_x, _ = pm.bo.best()
        pinned[slow] = TPM.unit_to_params(pm._full(best_x))
        lines = log.read_text().strip().splitlines()
        assert any("comm_exposed" in ln for ln in lines[1:])
    slow_modes = pinned[True]["bucket_compression"].split(":")
    base_modes = pinned[False]["bucket_compression"].split(":")
    assert _LADDER.index(slow_modes[1]) > _LADDER.index("int8")
    assert _LADDER.index(slow_modes[1]) > _LADDER.index(base_modes[1])


# ---------------------------------------------------------------------------
# 2c. The guardrail against the reference's verdicts
# ---------------------------------------------------------------------------


def _gauges(mod, **series):
    g = mod.gauge("hvd_compression_residual_ratio",
                  "Per-bucket EF residual-to-gradient norm ratio.")
    g.reset()
    for bucket, v in series.items():
        g.set(v, bucket=bucket.lstrip("b"))
    return g


def _feed_loss(hmod, diverged=False, nonfinite=False):
    for _ in range(hmod.WARMUP_SAMPLES + 1):
        hmod.observe_loss(1.0)
    if diverged:
        hmod.monitor()._raise_alert("loss_divergence", value=99.0)
    if nonfinite:
        hmod.monitor().note_nonfinite(1.0, "float32", 0)


# (name, extra env, world, residual series, loss, proposal, expected)
GUARD_CASES = [
    ("residual_pins_slot1", {}, 8, {"b0": 0.1, "b1": 0.9}, None,
     {"bucket_compression": "topk:topk"}, "topk:int8"),
    ("raw_bucket_folds_onto_slot", {}, 8,
     {"b0": 0.1, "b1": 0.9, "b2": 2.0}, None,
     {"bucket_compression": "int4:int8"}, "int8:int8"),
    ("ceiling_zero_disables_aggressive",
     {"HOROVOD_COMPRESSION_MAX_RESIDUAL_RATIO": "0"}, 8,
     {"b0": 0.01, "b1": 0.01}, None,
     {"bucket_compression": "int4:topk"}, "int8:int8"),
    ("ceiling_zero_unreported_left_alone",
     {"HOROVOD_COMPRESSION_MAX_RESIDUAL_RATIO": "0"}, 4, {}, None,
     {"bucket_compression": "int4:topk"}, "int4:topk"),
    ("topology_clamps_int4_past_7", {}, 8, {}, None,
     {"bucket_compression": "int4:topk"}, "int8:topk"),
    ("topology_clamps_int8_past_127", {}, 200, {}, None,
     {"bucket_compression": "int8:int4"}, "fp16:fp16"),
    ("ceiling_zero_outranks_healthy_loss",
     {"HOROVOD_COMPRESSION_MAX_RESIDUAL_RATIO": "0"}, 8,
     {"b0": 0.01, "b1": 0.01}, "healthy",
     {"bucket_compression": "int4:topk"}, "int8:int8"),
    ("no_loss_residual_fallback", {}, 8, {"b0": 0.9}, None,
     {"bucket_compression": "topk:topk"}, "int8:topk"),
    ("healthy_loss_overrides_proxy", {}, 8, {"b0": 0.9}, "healthy",
     {"bucket_compression": "topk:topk"}, "topk:topk"),
    ("diverged_loss_pins_every_slot", {}, 8, {"b0": 0.9}, "diverged",
     {"bucket_compression": "topk:int4"}, "int8:int8"),
    ("nonfinite_pins_back", {}, 8, {}, "nonfinite",
     {"bucket_compression": "int4:topk"}, "int8:int8"),
    ("no_mode_dims_untouched", {"HOROVOD_ADAPTIVE_COMPRESSION": "0"}, 8,
     {"b0": 0.9}, None, {"bucket_compression": "topk:topk"}, "topk:topk"),
]


@pytest.mark.parametrize("case", GUARD_CASES, ids=[c[0] for c in GUARD_CASES])
def test_guard_verdicts_match_reference(case, monkeypatch):
    _, env, world, series, loss, proposal, want = case
    base = {"HOROVOD_AUTOTUNE": "1", "HOROVOD_ADAPTIVE_COMPRESSION": "1",
            "HOROVOD_OVERLAP": "1", "HOROVOD_OVERLAP_CHUNKS": "2",
            "HOROVOD_COMPRESSION": "int8"}
    base.update(env)
    for k, v in base.items():
        monkeypatch.setenv(k, v)
    got = {}
    for tag, pmod, mmod, hmod in (("port", TPM, TM, TH),
                                  ("jax", JPM, JM, JH)):
        g = _gauges(mmod, **series)
        try:
            if loss is not None:
                _feed_loss(hmod, diverged=loss == "diverged",
                           nonfinite=loss == "nonfinite")
            pm = pmod.ParameterManager(world=world, hier_possible=False)
            got[tag] = pm._guard(dict(proposal))["bucket_compression"]
        finally:
            g.reset()
            hmod.reset()
    assert got["port"] == got["jax"] == want


def test_guard_hierarchical_proposal_quantizes_the_cross_axis(monkeypatch):
    for k, v in {"HOROVOD_AUTOTUNE": "1", "HOROVOD_ADAPTIVE_COMPRESSION": "1",
                 "HOROVOD_OVERLAP": "1",
                 "HOROVOD_OVERLAP_CHUNKS": "2"}.items():
        monkeypatch.setenv(k, v)
    got = []
    for pmod in (TPM, JPM):
        monkeypatch.setattr(pmod.ParameterManager, "_quantized_axis_size",
                            lambda self: 2)
        pm = pmod.ParameterManager(world=8, hier_possible=False)
        got.append(pm._guard({"bucket_compression": "int4:topk",
                              "hierarchical_allreduce": True}))
    assert got[0] == got[1]
    assert got[0]["bucket_compression"] == "int4:topk"
    # the port's cross axis without a pair is the world
    monkeypatch.undo()
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    assert TPM.ParameterManager(world=8)._quantized_axis_size() == 8


def test_adaptive_mode_dims_join_the_search(monkeypatch):
    for k, v in {"HOROVOD_AUTOTUNE": "1", "HOROVOD_ADAPTIVE_COMPRESSION": "1",
                 "HOROVOD_OVERLAP": "1",
                 "HOROVOD_OVERLAP_CHUNKS": "2"}.items():
        monkeypatch.setenv(k, v)
    for pmod in (TPM, JPM):
        pm = pmod.ParameterManager(world=8, hier_possible=False)
        assert pm._mode_slots == 2
        assert [d for d in pm._tuned if d >= 7] == [7, 8]
    monkeypatch.setenv("HOROVOD_ADAPTIVE_COMPRESSION", "0")
    assert TPM.ParameterManager(world=8, hier_possible=False)._mode_slots == 0
    monkeypatch.setenv("HOROVOD_ADAPTIVE_COMPRESSION", "1")
    monkeypatch.setenv("HOROVOD_OVERLAP", "0")
    assert TPM.ParameterManager(world=8, hier_possible=False)._mode_slots == 1


def test_comm_signal_hierarchy():
    """The device gauge wins, else the blocked phase of the last step
    span; nothing publishes the device gauge in this package yet, so the
    blocked phase is what the tuner reads."""
    for mmod, pmod in ((TM, TPM), (JM, JPM)):
        dev = mmod.gauge("hvd_device_comm_exposed_seconds",
                         "Device-measured comm seconds not hidden under "
                         "compute.")
        last = mmod.gauge("hvd_step_phase_seconds_last",
                          "Last trace_step() span, split by phase plus "
                          "wall.")
        dev.reset()
        last.reset()
        try:
            assert pmod._default_comm_signal() is None
            last.set(0.25, phase="blocked")
            assert pmod._default_comm_signal() == 0.25
            dev.set(0.125)
            assert pmod._default_comm_signal() == 0.125
        finally:
            dev.reset()
            last.reset()


# ---------------------------------------------------------------------------
# 2d. apply_params
# ---------------------------------------------------------------------------

APPLY_CASES = [
    {"fusion_threshold": 8 << 20, "cycle_time_ms": 2.5,
     "cache_enabled": True},
    {"hierarchical_allreduce": True, "hierarchical_allgather": False,
     "overlap_chunks": 16, "zero_prefetch_chunks": 2},
    {"bucket_compression": "int8:int4", "local_sgd_h": 4},
    TPM.unit_to_params(np.array([0.2, 0.7, 1.0, 0.0, 1.0, 0.6, 0.2,
                                 0.6, 0.8])),
]


@pytest.mark.parametrize("params", APPLY_CASES)
def test_apply_params_matches_reference(params):
    names = ("fusion_threshold", "cycle_time_ms", "hierarchical_allreduce",
             "hierarchical_allgather", "overlap_chunks",
             "zero_prefetch_chunks", "local_sgd_h", "bucket_compression",
             "cache_capacity")
    TPM.apply_params(dict(params))
    port = {n: _config.get(n) for n in names}
    JPM.apply_params(dict(params))
    assert port == {n: jconfig.get(n) for n in names}
    for k, v in params.items():
        if k != "cache_enabled":
            assert _config.get(k) == v, k


@pytest.mark.parametrize("bad", [{"bucket_compression": "int8:int3"},
                                 {"fusion_threshold": "lots"},
                                 {"overlap_chunks": 2.5,
                                  "cycle_time_ms": 1.0}])
def test_apply_params_refuses_a_proposal_it_cannot_apply(bad):
    before = {k: os.environ.get(k) for k in _MUTATED_ENV}
    with pytest.raises(HorovodTpuError, match="cannot apply"):
        TPM.apply_params(bad)
    # nothing moved
    assert {k: os.environ.get(k) for k in _MUTATED_ENV} == before


# ---------------------------------------------------------------------------
# 3. The proposal on the wire
# ---------------------------------------------------------------------------

TUNES = [{"fusion_threshold": 4 << 20, "cycle_time_ms": 3.25,
          "cache_enabled": False, "hierarchical_allreduce": False,
          "hierarchical_allgather": False, "overlap_chunks": 8,
          "zero_prefetch_chunks": 4, "bucket_compression": "int8:int4"},
         {"cycle_time_ms": 1.0, "cache_enabled": True}]


@pytest.mark.parametrize("codec", ["native", "python"])
@pytest.mark.parametrize("tune", TUNES)
def test_tune_field_round_trips_both_codecs(codec, tune):
    assert twire.native_loaded()
    enc = (twire._native.encode_resp_msg if codec == "native"
           else twire._py_encode_resp_msg)
    dec = (twire._native.decode_resp_msg if codec == "native"
           else twire._py_decode_resp_msg)
    for m in ({"f": [3, 1, 7], "t": tune},
              {"resp": [], "i": [2], "x": False, "aj": False, "lj": -1,
               "t": tune}):
        b = enc(m)
        assert b == jwire._py_encode_resp_msg(m)
        assert dec(b)["t"] == tune == jwire._py_decode_resp_msg(b)["t"]


def _req(mod, name, shape=(4,)):
    return mod.Request(name, "allreduce", 2, 8, tuple(shape), -1)


# rank 0 hands the tuner's proposal to rounds 1 (the warm cache's fast
# path) and 3 (a slow round); round 2 runs under round 1's cache toggle
ROUNDS = [(["a", "b"], None), (["a", "b"], TUNES[0]), (["a", "c"], None),
          (["a", "d"], TUNES[1]), (["a", "b"], None)]


def _tune_world(mod, world, fanout, epoch):
    store, cv = {}, threading.Condition()
    out = [[] for _ in range(world)]
    snaps, errs = [], []
    barrier = threading.Barrier(world, action=lambda: snaps.append(
        dict(store)))
    env = {}

    def run(rank):
        try:
            ctl = mod.KVController(DictTransport(store, cv), rank, world,
                                   epoch=epoch, fanout=fanout)
            for r, (names, tune) in enumerate(ROUNDS):
                res = ctl.negotiate([_req(mod, n) for n in names], False,
                                    False, tune=tune if rank == 0 else None)
                out[rank].append((
                    [json.dumps(p.wire(), sort_keys=True)
                     for p in res.responses],
                    ctl.fast_rounds, getattr(ctl, "cache_active", None),
                    list(getattr(ctl, "tunes", ()))))
                barrier.wait(30)
                if rank == 0:
                    env[r] = (_config.get("fusion_threshold"),
                              _config.get("cycle_time_ms"),
                              _config.get("bucket_compression"))
                barrier.wait(30)
        except BaseException as e:  # noqa: BLE001 -- surfaced below
            errs.append(e)
            barrier.abort()

    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    if errs:
        raise errs[0]
    return out, snaps, env


@pytest.mark.parametrize("world,fanout", [(2, 0), (4, 0), (5, 2)])
def test_tune_rides_the_response_list(world, fanout, monkeypatch):
    """Every rank applies the proposal at the round that carries it,
    fast path or slow, flat or hierarchical; the posted payloads are
    the JAX package's byte for byte."""
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(64 << 20))
    monkeypatch.setenv("HOROVOD_CYCLE_TIME", "5")
    monkeypatch.setenv("HOROVOD_BUCKET_COMPRESSION", "")
    port, port_snaps, env = _tune_world(tctl, world, fanout, epoch=70)
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(64 << 20))
    monkeypatch.setenv("HOROVOD_CYCLE_TIME", "5")
    monkeypatch.setenv("HOROVOD_BUCKET_COMPRESSION", "")
    jax, jax_snaps, _ = _tune_world(jctl, world, fanout, epoch=70)
    assert port_snaps == jax_snaps
    for rank in range(world):
        assert [o[0] for o in port[rank]] == [o[0] for o in jax[rank]]
        assert [o[1] for o in port[rank]] == [o[1] for o in jax[rank]]
        # the same rounds, and their knobs, on every rank
        assert port[rank][-1][3] == [(1, TUNES[0]), (3, TUNES[1])]
        assert [o[2] for o in port[rank]] == [True, False, False, True,
                                              True]
    # round 1 rode the fast path on every rank; round 2 probed no cache
    assert port[0][1][1] == 1 and port[0][2][1] == 1
    assert env[1] == (4 << 20, 3.25, "int8:int4")
    assert env[3] == (4 << 20, 1.0, "int8:int4")


def test_autotune_param_sync_2proc():
    """Rank 0's proposals reach both ranks through the response list:
    each rank's knobs change, and they change at the same rounds with
    the same values (``tests/test_multiprocess.py:169-200``)."""
    outs = spawn(2, "cpu", timeout=120, mode="autotune_sync",
                 env_extra={"HOROVOD_AUTOTUNE": "1",
                            "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "1",
                            "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "0",
                            "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "3"})
    r0, r1 = outs
    assert r0["changed"] and r1["changed"], outs
    assert r0["tunes"] and r0["tunes"] == r1["tunes"]
    assert r0["knobs"] == r1["knobs"]
    assert r0["pinned"] and r1["pm"] is None


@pytest.mark.parametrize("world,fanout", [(2, 0), (5, 2)])
def test_unappliable_proposal_fails_the_round_on_every_rank(world, fanout,
                                                           monkeypatch):
    """A proposal no rank can apply fails that round on every rank (each
    applies the same payload), before any knob moves; it is never
    skipped on one rank alone."""
    monkeypatch.setenv("HOROVOD_BUCKET_COMPRESSION", "")
    store, cv = {}, threading.Condition()
    errs = [None] * world

    def run(rank):
        ctl = tctl.KVController(DictTransport(store, cv), rank, world,
                                epoch=90, fanout=fanout, timeout=30)
        ctl.negotiate([_req(tctl, "a")], False, False)
        try:
            ctl.negotiate([_req(tctl, "a")], False, False,
                          tune={"bucket_compression": "int8:int3"}
                          if rank == 0 else None)
        except HorovodTpuError as exc:
            errs[rank] = str(exc)
        else:
            errs[rank] = "applied"

    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert all("cannot apply" in e and "int3" in e for e in errs), errs
    assert _config.get("bucket_compression") == ""
