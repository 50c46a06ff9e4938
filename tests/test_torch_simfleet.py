"""The port's fleet simulator (``horovod_tpu_torch/runtime/simfleet.py``)
against the JAX package's (``horovod_tpu/runtime/simfleet.py``).

1. Every simulator oracle of the JAX package's tests, with the port in
   place: ``tests/test_control_plane.py:216-265`` (determinism, the fault
   spec, flat against hierarchical digests, the scaling ratio, the re-form
   storm, the coordinated abort), ``tests/test_preemption.py:438`` (the
   preemption storm), ``tests/test_local_sgd.py:519-541`` (the ICI/DCN
   latency split, the local-SGD round economy) and the autopilot drills
   of ``tests/test_autopilot.py:363-450``.
2. Parity: the same arguments through both packages, every scenario's
   JSON output equal -- the per-round digests, charged op counts and
   simulated latencies, the actions and their evidence, the roster
   digests, the rollback drill's ``final_digest`` -- and the CLI's
   printed output equal.  ``coordinated_abort`` is wall-clock based: its
   summary counts are held equal, not a trace.
3. The simulated store's refusal of overwrites and what it charges; the
   port's checkpoint round trip of the drill's parameters.
"""

import json
import os

import numpy as np
import pytest
import torch

from horovod_tpu.runtime import simfleet as jsimfleet

from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.runtime import simfleet


def _same(a, b) -> bool:
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


# ---------------------------------------------------------------------------
# The simulated wire
# ---------------------------------------------------------------------------


def test_sim_store_refuses_overwrites_and_charges_only_observations():
    s = simfleet.SimStore("root")
    s.set("hvd0/q/1/0", "a")
    with pytest.raises(KeyError, match="already exists"):
        s.set("hvd0/q/1/0", "b")
    s.set("hvd0/q/1/0", "c", once=True)         # at-most-once: kept "a"
    assert s.try_get("hvd0/q/1/0") == "a"
    assert s.try_get("hvd0/q/1/9") is None       # a miss is free
    s.set("hvd0/hb/3", "1", overwrite=True)
    s.set("hvd0/hb/3", "2", overwrite=True)
    assert s.get_blocking("hvd0/hb/3", 1.0) == "2"
    s.delete("hvd0/p/1")
    with pytest.raises(TimeoutError):
        s.get_blocking("hvd0/p/2", 0.01)
    assert s.ops_by_round() == {1: {"set": 1, "get": 1, "delete": 1},
                                None: {"set": 2, "get": 1}}
    assert s.total_ops == 6


def test_sim_transport_fault_hooks_match_the_jax_package():
    spec = "delay@rank5:q/*:50ms,drop@rank5:q/2/*:1,slow:5:10ms"
    out = []
    for mod in (simfleet, jsimfleet):
        fleet = mod.SimFleet(8, fanout=0, seed=0, fault_spec=spec)
        t = mod.SimTransport(fleet, 5)
        t.set("hvd0/q/1/5", "x")
        t.set("hvd0/q/2/5", "dropped")
        t.set_once("hvd0/q/3/5", "y")
        assert t.try_get("hvd0/q/2/5") is None
        out.append((fleet.rank_delays(1), fleet.rank_delays(2),
                    fleet.rank_delays(3), fleet.root.ops_by_round()))
    assert out[0] == out[1]
    assert out[0][0] == {5: pytest.approx(0.06)}


def test_die_rule_raises_in_the_rank_thread():
    fleet = simfleet.SimFleet(4, fanout=0, fault_spec="die:rank2:round1")
    t = simfleet.SimTransport(fleet, 2)
    t.set("hvd0/q/0/2", "ok")
    with pytest.raises(simfleet.SimRankDied, match="rank 2 died"):
        t.set("hvd0/q/1/2", "x")


# ---------------------------------------------------------------------------
# The JAX package's oracles (tests/test_control_plane.py:216-265)
# ---------------------------------------------------------------------------


def test_simulator_same_seed_identical_trace():
    a = simfleet.run_trace(world=12, fanout=4, rounds=4, seed=7)
    b = simfleet.run_trace(world=12, fanout=4, rounds=4, seed=7)
    assert a == b
    assert [t["round"] for t in a] == [0, 1, 2, 3]
    c = simfleet.run_trace(world=12, fanout=4, rounds=4, seed=8)
    assert [t["digest"] for t in c] == [t["digest"] for t in a]
    assert c != a                       # jitter differs with the seed


def test_simulator_deterministic_under_fault_spec():
    # rank 5 (slice 1 member at fanout=4) blocks on sp/1/<round>; the
    # round-2 read eats a 50 ms virtual delay
    spec = "delay@rank5:sp/1/2:50ms"
    a = simfleet.run_trace(12, 4, 4, seed=3, fault_spec=spec)
    b = simfleet.run_trace(12, 4, 4, seed=3, fault_spec=spec)
    assert a == b
    clean = simfleet.run_trace(12, 4, 4, seed=3)
    assert a[2]["latency_ms"] > clean[2]["latency_ms"] + 40.0


def test_simulator_flat_and_hier_digests_agree():
    flat = simfleet.run_trace(12, 0, 3, seed=1)
    hier = simfleet.run_trace(12, 4, 3, seed=1)
    assert [t["digest"] for t in flat] == [t["digest"] for t in hier]
    assert hier[-1]["root_ops"] < flat[-1]["root_ops"]


def test_scaling_root_message_reduction():
    out = simfleet.measure_scaling(world=64, fanout=8, rounds=3)
    assert out["ratio"] >= 4.0, out
    assert out["hier_root_ops_per_round"] < out["flat_root_ops_per_round"]
    assert _same(out, jsimfleet.measure_scaling(world=64, fanout=8,
                                                rounds=3))


def test_reform_storm_dense_and_deterministic():
    a = simfleet.reform_storm(world=32, fanout=8, kill=4,
                              pre_rounds=2, post_rounds=2, seed=5)
    b = simfleet.reform_storm(world=32, fanout=8, kill=4,
                              pre_rounds=2, post_rounds=2, seed=5)
    assert a["new_world"] == 28
    assert len(a["victims"]) == 4
    assert a["roster_digest"] == b["roster_digest"]
    assert a["pre"] == b["pre"] and a["post"] == b["post"]


def test_coordinated_abort_reaches_every_survivor():
    out = simfleet.coordinated_abort(world=8, fanout=4, victim=3)
    assert out["died"] == [3]
    assert out["survivors_aborted"] == out["survivors_total"] == 7
    assert out["survivors_naming_victim"] >= 1


# ---------------------------------------------------------------------------
# tests/test_preemption.py:438, tests/test_local_sgd.py:519-541
# ---------------------------------------------------------------------------


def test_simfleet_preempt_storm_deterministic():
    kw = dict(world=32, fanout=8, kill=4, rounds=2, post_rounds=1,
              seed=3)
    a = simfleet.preempt_storm(**kw)
    b = simfleet.preempt_storm(**kw)
    assert _same(a, b)
    assert a["deaths"] == [] and a["blacklisted"] == []
    assert a["drained"] == a["victims"] and a["victims"]
    assert a["world_after"] == 32 - len(a["victims"])
    for act in a["actions"]:
        assert act["rule"] == "preempt_drain"
        assert act["outcome"] == "applied"
        assert act["evidence"]["rank"] in a["victims"]


def test_latency_model_ici_dcn_split_back_compat():
    legacy = simfleet.LatencyModel(rtt_ms=0.7)
    assert legacy.ici() == legacy.dcn() == 0.7  # pre-split numbers
    split = simfleet.LatencyModel(ici_rtt_ms=0.05, dcn_rtt_ms=2.5)
    assert split.ici() == 0.05 and split.dcn() == 2.5


def test_local_sgd_scaling_scenario_small_world():
    a = simfleet.local_sgd_scaling(world=16, fanout=4, h=4, windows=1,
                                   seed=0)
    b = simfleet.local_sgd_scaling(world=16, fanout=4, h=4, windows=1,
                                   seed=0)
    assert a == b, "local-SGD scaling scenario replay drift"
    assert a["sync_cross_rounds"] == a["h"] * 1
    assert a["localsgd_cross_rounds"] == 1
    assert a["cross_round_ratio"] >= a["h"]
    assert a["localsgd_wall_ms"] < a["sync_wall_ms"]
    # the outer round rides the cross-scope name contract
    assert all(t["round"] >= 0 for t in a["outer_trace"])


# ---------------------------------------------------------------------------
# The autopilot drills (tests/test_autopilot.py:363-450)
# ---------------------------------------------------------------------------


def test_straggler_drill_preempts_before_any_death():
    out = simfleet.straggler_drill(world=32, fanout=8, rounds=4)
    assert out["deaths"] == []  # blacklisted BEFORE any rank died
    assert out["blacklisted"] == ["host-0003"]
    assert out["world_after"] == 31
    applied = [a for a in out["actions"] if a["outcome"] == "applied"]
    assert applied and applied[0]["rule"] == "straggler_blacklist"
    assert applied[0]["evidence"]["rank"] == 3


def test_straggler_drill_replays_byte_identical():
    one = json.dumps(simfleet.straggler_drill(world=32, fanout=8),
                     sort_keys=True)
    two = json.dumps(simfleet.straggler_drill(world=32, fanout=8),
                     sort_keys=True)
    assert one == two


def test_straggler_drill_dry_run_keeps_world():
    out = simfleet.straggler_drill(world=32, fanout=8, dry_run=True)
    assert out["blacklisted"] == [] and out["world_after"] == 32
    assert any(a["outcome"] == "dry_run" for a in out["actions"])


@pytest.mark.slow
def test_straggler_drill_256_ranks_deterministic():
    """The acceptance-scale scenario: 256 ranks, replayed twice,
    byte-for-byte identical, straggler shed with zero deaths."""
    one = simfleet.straggler_drill(world=256, fanout=16)
    two = simfleet.straggler_drill(world=256, fanout=16)
    assert json.dumps(one, sort_keys=True) == \
        json.dumps(two, sort_keys=True)
    assert one["deaths"] == [] and one["world_after"] == 255


def test_slo_burn_drill_full_loop():
    out = simfleet.slo_burn_drill()
    assert out["events"][0] == ["shrink", out["victim"]]
    assert ["grow", None] in out["events"]
    assert out["shed"] == [out["victim"]]
    assert _same(out, simfleet.slo_burn_drill())
    # dry run: verdicts recorded, nobody shed
    dry = simfleet.slo_burn_drill(dry_run=True)
    assert dry["shed"] == [] and dry["events"] == []
    assert any(a["outcome"] == "dry_run" for a in dry["actions"])


def test_rollback_drill_bit_exact_resume():
    out = simfleet.rollback_drill(device="cpu")
    assert out["rollbacks"] == 1
    assert out["bit_exact"] and out["final_finite"]
    # the poisoned commit is in the ring, stamped, and skipped over
    assert out["ring_verdicts"][str(out["ring_steps"][0])] == "healthy"
    assert "poisoned" in out["ring_verdicts"].values()
    assert len(out["ring_steps"]) <= out["keep"]
    assert _same(out, simfleet.rollback_drill(device="cpu"))


def test_rollback_drill_dry_run_parity():
    dry = simfleet.rollback_drill(dry_run=True, device="cpu")
    assert not dry["bit_exact"] and not dry["final_finite"]
    assert dry["actions"][0]["outcome"] == "dry_run"


def test_rollback_drill_restores_the_checkpoint_knob(monkeypatch):
    monkeypatch.setenv("HOROVOD_CHECKPOINT_KEEP", "9")
    simfleet.rollback_drill(keep=3, device="cpu")
    assert os.environ["HOROVOD_CHECKPOINT_KEEP"] == "9"


def test_checkpoint_round_trips_the_drills_parameters(tmp_path):
    params = torch.from_numpy(
        np.random.default_rng(0).standard_normal(4))
    checkpoint.save(str(tmp_path), {"params": params, "step": 3}, step=3,
                    verdict="healthy")
    snap = checkpoint.restore(str(tmp_path), healthy_only=True)
    back = torch.as_tensor(snap["params"])
    assert snap["step"] == 3 and back.dtype == torch.float64
    assert back.numpy().tobytes() == params.numpy().tobytes()


# ---------------------------------------------------------------------------
# Parity with the JAX package: every scenario's output, field for field
# ---------------------------------------------------------------------------

PARITY = [
    ("run_trace", (12, 4, 4, 7), {}),
    ("run_trace", (12, 4, 4, 7),
     {"fault_spec": "delay@rank5:sp/1/2:50ms"}),
    ("run_trace", (12, 0, 3, 1), {}),
    ("run_trace", (9, 4, 3, 2), {"fault_spec": "slow:3:5ms"}),
    ("reform_storm", (), dict(world=32, fanout=8, kill=4, pre_rounds=2,
                              post_rounds=2, seed=5)),
    ("local_sgd_scaling", (), dict(world=16, fanout=4, h=4, windows=1,
                                   seed=0)),
    ("preempt_storm", (), dict(world=32, fanout=8, kill=4, rounds=2,
                               post_rounds=1, seed=3)),
    ("preempt_storm", (), dict(world=32, fanout=8, kill=4, rounds=2,
                               post_rounds=1, seed=3, dry_run=True)),
    ("straggler_drill", (), dict(world=32, fanout=8)),
    ("straggler_drill", (), dict(world=32, fanout=8, dry_run=True)),
    ("slo_burn_drill", (), {}),
    ("slo_burn_drill", (), dict(dry_run=True)),
    ("rollback_drill", (), {}),
    ("rollback_drill", (), dict(dry_run=True)),
    ("rollback_drill", (), dict(steps=16, poison_round=9, keep=3,
                                seed=4)),
]


@pytest.mark.parametrize(
    "name,args,kw", PARITY,
    ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(PARITY)])
def test_scenario_output_equals_the_jax_package(name, args, kw):
    ref = getattr(jsimfleet, name)(*args, **kw)
    if name == "rollback_drill":
        kw = dict(kw, device="cpu")
    mine = getattr(simfleet, name)(*args, **kw)
    assert _same(mine, ref)
    if name == "rollback_drill":
        # the parameters' float64 bytes, bit for bit
        assert mine["final_digest"] == ref["final_digest"]
        assert mine["bit_exact"] == (not kw.get("dry_run", False))


def test_coordinated_abort_counts_equal_the_jax_package():
    mine = simfleet.coordinated_abort(world=12, fanout=4, victim=5)
    ref = jsimfleet.coordinated_abort(world=12, fanout=4, victim=5)
    for k in ("world", "victim", "died", "survivors_aborted",
              "survivors_total"):
        assert mine[k] == ref[k], k
    assert mine["survivors_aborted"] == 11


CLI = [
    ["trace", "--world", "12", "--fanout", "4", "--rounds", "3",
     "--seed", "2", "--fault-spec", "slow:3:5ms"],
    ["scaling", "--world", "32", "--fanout", "8", "--rounds", "2"],
    ["localsgd", "--world", "16", "--fanout", "4", "--h", "2"],
    ["storm", "--world", "24", "--fanout", "4", "--kill", "3"],
    ["straggler", "--world", "16", "--fanout", "4", "--rounds", "3"],
    ["preempt", "--world", "16", "--fanout", "4", "--kill", "2",
     "--rounds", "2", "--dry-run"],
    ["burn", "--world", "6", "--victim", "1", "--ticks", "10"],
    ["rollback", "--steps", "10", "--poison-round", "5", "--keep", "3"],
]


@pytest.mark.parametrize("argv", CLI, ids=[a[0] for a in CLI])
def test_cli_prints_what_the_jax_package_prints(argv, capsys):
    assert jsimfleet.main(list(argv)) == 0
    ref = json.loads(capsys.readouterr().out)
    mine_argv = list(argv) + (["--device", "cpu"]
                              if argv[0] == "rollback" else [])
    assert simfleet.main(mine_argv) == 0
    assert json.loads(capsys.readouterr().out) == ref
