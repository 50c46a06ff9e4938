"""``horovod_tpu_torch/checkpoint.py`` and the ZeRO host forms against the
JAX package's ``horovod_tpu/checkpoint.py``, on the CPU.

1. The on-disk layout file for file (``tree.pkl``, ``DONE``,
   ``MANIFEST.json``, ``shard_meta.json``): a directory the port writes
   restores through the JAX package's ``restore`` to equal arrays, and
   the other way round (float32 and integer leaves; bfloat16 both ways
   within the port, and the JAX package's ``ml_dtypes`` arrays read by
   the port).
2. Durability (``tests/test_preemption.py:319-436``): manifests stamped
   inside the snapshot, a flipped byte caught and the snapshot
   quarantined with a fallback, the verify knob, pre-manifest
   snapshots, replicas serving a corrupt shard.
3. Discovery (``tests/test_fault_tolerance.py:428-451,510-545``,
   ``tests/test_autopilot.py:91-130``): torn snapshots refused, the
   retention ring, verdicts and ``latest_healthy``, orphan recovery.
4. The refusals (``tests/test_sharded_optimizer.py:382-410``,
   ``tests/test_zero23.py:571-660``, ``tests/test_mesh.py:484``): a
   change of world, of dp size, a rank-0-only save of stage-3 shards, a
   sub-3 job loading a stage-3 snapshot.
5. On a spawned gloo world of four ranks (mode ``checkpoint``): stage 2
   saved ``all_ranks`` with ring-buddy replicas, rank 1's shard corrupted
   and served from its replica; ``resync`` leaving the shard state
   alone; the stage-2 state and stage-3 parameters gathered into their
   host forms at world 4 and re-cut at world 2, bit for bit.
6. A small ResNet trained 2 steps, saved, restored into fresh objects
   and trained 2 more steps: bit-identical to 4 steps in a row.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu import checkpoint as jckpt

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.optim import distributed as D
from horovod_tpu_torch.optim import fused_update as TF
from horovod_tpu_torch.perf import goodput as GP

import sys

sys.path.insert(0, os.path.dirname(__file__))
from _torch_collectives_worker import small_resnet, spawn  # noqa: E402
from _torch_health_worker import OPT_LEAVES  # noqa: E402


@pytest.fixture()
def world1(monkeypatch):
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt4"))
    return spawn(4, "cpu", timeout=120, mode="checkpoint",
                 env_extra={"HVD_TEST_CKPT": path}), path


def _tamper(path):
    with open(path, "ab") as f:
        f.write(b"BITROT")


# ---------------------------------------------------------------------------
# 1. Either package reads the other's directories
# ---------------------------------------------------------------------------

TREE = {"w": np.arange(12, dtype=np.float32).reshape(3, 4) / 3,
        "i": np.arange(-3, 3, dtype=np.int32),
        "l": np.array([7, 1 << 40], dtype=np.int64),
        "nested": [{"b": np.float32(0.5) * np.ones(5, np.float32)}, 3],
        "step": 9}


@pytest.mark.parametrize("all_ranks", [False, True])
def test_port_directory_restores_through_jax(tmp_path, all_ranks):
    port = {"w": torch.from_numpy(TREE["w"]), "i": torch.from_numpy(
        TREE["i"]), "l": torch.from_numpy(TREE["l"]),
        "nested": [{"b": torch.from_numpy(TREE["nested"][0]["b"])}, 3],
        "step": 9}
    ckpt.save(str(tmp_path), port, 4, all_ranks=all_ranks,
              verdict="healthy")
    back = jckpt.restore(str(tmp_path), 4, all_ranks=all_ranks)
    for k in ("w", "i", "l"):
        assert back[k].dtype == TREE[k].dtype
        np.testing.assert_array_equal(back[k], TREE[k])
    np.testing.assert_array_equal(back["nested"][0]["b"],
                                  TREE["nested"][0]["b"])
    assert back["nested"][1] == 3 and back["step"] == 9
    assert jckpt.verdict_of(str(tmp_path), 4) == "healthy"
    assert jckpt.latest_complete(str(tmp_path)) == 4
    assert jckpt.verify_snapshot(str(tmp_path), 4)


@pytest.mark.parametrize("all_ranks", [False, True])
def test_jax_directory_restores_through_port(tmp_path, all_ranks):
    jtree = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
             for k, v in TREE.items() if k != "l"}
    jckpt.save(str(tmp_path), jtree, 6, all_ranks=all_ranks,
               verdict="poisoned")
    back = ckpt.restore(str(tmp_path), 6, all_ranks=all_ranks)
    for k in ("w", "i"):
        assert isinstance(back[k], torch.Tensor)
        np.testing.assert_array_equal(back[k].numpy(), TREE[k])
    np.testing.assert_array_equal(back["nested"][0]["b"].numpy(),
                                  TREE["nested"][0]["b"])
    assert back["step"] == 9
    assert ckpt.verdict_of(str(tmp_path), 6) == "poisoned"
    assert ckpt.latest_healthy(str(tmp_path)) is None
    assert ckpt.verify_snapshot(str(tmp_path), 6)
    # the layout is the JAX package's, file for file
    d = os.path.join(str(tmp_path), "step_6",
                     *(["rank_0"] if all_ranks else []))
    want = {"tree.pkl", "MANIFEST.json"} | (
        {"shard_meta.json"} if all_ranks else {"DONE"})
    assert set(os.listdir(d)) == want


def test_bfloat16_leaves(tmp_path):
    """bfloat16 is stored as tagged uint16 bits: the port reads back the
    same bits; the JAX package's ``ml_dtypes`` arrays read as bfloat16
    tensors of the same bits."""
    x = torch.randn(7, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    ckpt.save(str(tmp_path), {"x": x}, 1)
    back = ckpt.restore(str(tmp_path), 1)["x"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))
    raw = jckpt.restore(str(tmp_path), 1)["x"]
    assert raw["__hvd_dtype__"] == "bfloat16"
    np.testing.assert_array_equal(raw["bits"],
                                  x.view(torch.int16).numpy().view(
                                      np.uint16))
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jckpt.save(str(tmp_path), {"x": jx}, 2)
    back = ckpt.restore(str(tmp_path), 2)["x"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, x)


# ---------------------------------------------------------------------------
# 2. Durability
# ---------------------------------------------------------------------------


def test_manifest_stamped_inside_snapshot(tmp_path):
    import hashlib

    d = str(tmp_path)
    ckpt.save(d, {"w": torch.arange(4.0)}, 3)
    with open(os.path.join(d, "step_3", "MANIFEST.json")) as f:
        man = json.load(f)
    assert man["step"] == 3 and set(man["files"]) == {"tree.pkl"}
    with open(os.path.join(d, "step_3", "tree.pkl"), "rb") as f:
        data = f.read()
    assert man["files"]["tree.pkl"] == {
        "sha256": hashlib.sha256(data).hexdigest(), "size": len(data)}
    assert ckpt.verify_snapshot(d, 3) and ckpt.latest_complete(d) == 3


def test_corrupt_snapshot_quarantined_with_fallback(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, {"mark": "old"}, 2)
    ckpt.save(d, {"mark": "new"}, 4)
    _tamper(os.path.join(d, "step_4", "tree.pkl"))
    assert ckpt.verify_snapshot(d, 4) is False
    assert ckpt.latest_complete(d) == 2
    assert os.path.isdir(os.path.join(d, "step_4.corrupt"))
    assert ckpt.restore(d)["mark"] == "old"


def test_corrupt_snapshot_never_silently_restored(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, {"w": 1}, 1)
    _tamper(os.path.join(d, "step_1", "tree.pkl"))
    with pytest.raises(HorovodTpuError, match="quarantined"):
        ckpt.restore(d, step=1)
    assert os.path.isdir(os.path.join(d, "step_1.corrupt"))


def test_verify_knob_off_restores_tampered_bytes(tmp_path, monkeypatch):
    d = str(tmp_path)
    ckpt.save(d, {"w": 5}, 1)
    _tamper(os.path.join(d, "step_1", "tree.pkl"))
    monkeypatch.setenv("HOROVOD_CHECKPOINT_VERIFY", "0")
    assert ckpt.restore(d, step=1) == {"w": 5}
    assert ckpt.latest_complete(d) == 1


def test_pre_manifest_snapshot_still_resumes(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, {"w": torch.arange(3.0)}, 6)
    os.remove(os.path.join(d, "step_6", "MANIFEST.json"))
    assert ckpt.verify_snapshot(d, 6) is True
    assert ckpt.latest_complete(d) == 6
    assert torch.equal(ckpt.restore(d)["w"], torch.arange(3.0))


def test_latest_healthy_skips_corrupt(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, {"mark": "good"}, 2, verdict="healthy")
    ckpt.save(d, {"mark": "rotted"}, 5, verdict="healthy")
    _tamper(os.path.join(d, "step_5", "tree.pkl"))
    assert ckpt.latest_healthy(d) == 2
    assert ckpt.restore(d, healthy_only=True)["mark"] == "good"
    assert os.path.isdir(os.path.join(d, "step_5.corrupt"))


def _make_shard(dirpath, tree, step, rank=0):
    os.makedirs(dirpath)
    with open(os.path.join(dirpath, "tree.pkl"), "wb") as f:
        pickle.dump(tree, f)
    with open(os.path.join(dirpath, "shard_meta.json"), "w") as f:
        json.dump({"rank": rank, "world_size": 2, "dp_size": 2,
                   "zero_stage": 1}, f)
    ckpt._write_manifest(dirpath, step)


def test_resolve_shard_source_prefers_local(tmp_path):
    step_dir = os.path.join(str(tmp_path), "step_5")
    primary = os.path.join(step_dir, "rank_0")
    _make_shard(primary, {"m": 1}, 5)
    _make_shard(os.path.join(step_dir, "rep_0_1"), {"m": 1}, 5)
    assert ckpt._resolve_shard_source(str(tmp_path), 5, step_dir,
                                      0) == primary


def test_corrupt_shard_restores_from_replica(tmp_path):
    d = str(tmp_path)
    step_dir = os.path.join(d, "step_5")
    tree = {"m": np.arange(6.0)}
    _make_shard(os.path.join(step_dir, "rank_0"), tree, 5)
    _make_shard(os.path.join(step_dir, "rep_0_1"), tree, 5)
    _tamper(os.path.join(step_dir, "rank_0", "tree.pkl"))
    got = ckpt.restore(d, step=5, all_ranks=True)
    np.testing.assert_array_equal(got["m"].numpy(), tree["m"])
    assert os.path.isdir(os.path.join(step_dir, "rank_0.corrupt"))


def test_missing_shard_without_replica_raises(tmp_path):
    os.makedirs(os.path.join(str(tmp_path), "step_9"))
    with pytest.raises(HorovodTpuError, match="ring-buddy replica"):
        ckpt.restore(str(tmp_path), step=9, all_ranks=True)


# ---------------------------------------------------------------------------
# 3. Discovery
# ---------------------------------------------------------------------------


def test_latest_complete_refuses_torn_snapshots(tmp_path):
    base = str(tmp_path)
    ckpt.save(base, {"w": np.ones(2)}, step=3)
    assert ckpt.latest_complete(base) == 3 and ckpt.is_complete(base, 3)
    torn = tmp_path / "step_9" / "rank_0"
    torn.mkdir(parents=True)
    (torn / "tree.pkl").write_bytes(pickle.dumps({"w": np.ones(2)}))
    assert ckpt.latest_step(base) == 9
    assert ckpt.latest_complete(base) == 3
    assert not ckpt.is_complete(base, 9)
    ckpt.mark_complete(base, 9)
    assert ckpt.latest_complete(base) == 9
    assert torch.allclose(ckpt.restore(base, step=3)["w"],
                          torch.ones(2, dtype=torch.float64))


def test_single_writer_save_stamps_done_atomically(tmp_path):
    base = str(tmp_path)
    target = ckpt.save(base, {"x": torch.zeros(1)}, step=1)
    assert os.path.exists(os.path.join(target, "DONE"))
    ckpt.save(base, {"x": torch.ones(1)}, step=1)
    assert ckpt.latest_complete(base) == 1
    assert not [d for d in os.listdir(base) if ".old." in d or ".tmp." in d]


def test_all_ranks_resave_drops_stale_done_first(tmp_path, monkeypatch):
    base = str(tmp_path)
    ckpt.save(base, {"w": np.ones(2)}, step=5, all_ranks=True)
    assert ckpt.is_complete(base, 5)
    orig = ckpt.pickle.dump

    def boom(*a, **k):
        raise RuntimeError("simulated crash mid-save")

    monkeypatch.setattr(ckpt.pickle, "dump", boom)
    with pytest.raises(RuntimeError):
        ckpt.save(base, {"w": np.zeros(2)}, step=5, all_ranks=True)
    monkeypatch.setattr(ckpt.pickle, "dump", orig)
    assert not ckpt.is_complete(base, 5)
    assert ckpt.latest_complete(base) is None
    ckpt.save(base, {"w": np.zeros(2)}, step=5, all_ranks=True)
    assert ckpt.is_complete(base, 5)


def test_orphaned_old_dir_is_recovered(tmp_path):
    """A crash between save()'s two renames leaves the previous
    snapshot only under its ``.old`` name: discovery adopts it back."""
    base = str(tmp_path)
    ckpt.save(base, {"w": torch.ones(2)}, step=4)
    os.replace(os.path.join(base, "step_4"),
               os.path.join(base, "step_4.old.123.0"))
    assert ckpt.latest_complete(base) == 4
    assert os.path.isdir(os.path.join(base, "step_4"))


def _save(tmp_path, step, verdict=None):
    ckpt.save(str(tmp_path), {"w": np.full((2,), float(step))}, step,
              verdict=verdict)


def test_verdict_of_reads_done_marker(tmp_path):
    _save(tmp_path, 1, "healthy")
    _save(tmp_path, 3, "poisoned")
    _save(tmp_path, 5)
    assert ckpt.verdict_of(str(tmp_path), 1) == "healthy"
    assert ckpt.verdict_of(str(tmp_path), 3) == "poisoned"
    assert ckpt.verdict_of(str(tmp_path), 5) is None
    assert ckpt.verdict_of(str(tmp_path), 99) is None


def test_latest_healthy_skips_poisoned(tmp_path):
    _save(tmp_path, 2, "healthy")
    _save(tmp_path, 4, "healthy")
    _save(tmp_path, 6, "poisoned")
    assert ckpt.latest_healthy(str(tmp_path)) == 4
    _save(tmp_path, 8)
    assert ckpt.latest_healthy(str(tmp_path)) == 8


def test_restore_healthy_only_targets_newest_healthy(tmp_path):
    _save(tmp_path, 2, "healthy")
    _save(tmp_path, 6, "poisoned")
    snap = ckpt.restore(str(tmp_path), healthy_only=True)
    assert torch.allclose(snap["w"], torch.full((2,), 2.0,
                                                dtype=torch.float64))
    assert float(ckpt.restore(str(tmp_path))["w"][0]) == 6.0


def test_restore_healthy_only_all_poisoned_raises(tmp_path):
    _save(tmp_path, 2, "poisoned")
    with pytest.raises(FileNotFoundError, match="healthy"):
        ckpt.restore(str(tmp_path), healthy_only=True)


@pytest.mark.parametrize("keep,want", [("3", [3, 4, 5]),
                                       ("0", [1, 2, 3, 4, 5])])
def test_ring_keeps_last_k(tmp_path, monkeypatch, keep, want):
    monkeypatch.setenv("HOROVOD_CHECKPOINT_KEEP", keep)
    for s in (1, 2, 3, 4, 5):
        _save(tmp_path, s, "healthy")
    assert ckpt._complete_steps(str(tmp_path)) == want


def test_save_and_restore_time_the_checkpoint_phase(tmp_path, monkeypatch):
    """Save and restore attribute their wall to the goodput ledger's
    ``checkpoint`` phase: each span covers the whole body (at least the
    time ``_save`` / ``_restore`` take, at most the call's wall) and the
    ledger holds their sum."""
    import time

    spans, inner = [], []
    real_observe = GP.observe
    monkeypatch.setattr(GP, "observe", lambda ph, sec, split=None: (
        spans.append((ph, sec)), real_observe(ph, sec, split)))
    for name in ("_save", "_restore"):
        real = getattr(ckpt, name)

        def timed(*a, _real=real, **k):
            t0 = time.perf_counter()
            try:
                return _real(*a, **k)
            finally:
                inner.append(time.perf_counter() - t0)
        monkeypatch.setattr(ckpt, name, timed)
    GP.reset()
    GP.start()
    t0 = time.perf_counter()
    ckpt.save(str(tmp_path), {"w": torch.zeros(1 << 16)}, 1)
    ckpt.restore(str(tmp_path), 1)
    wall = time.perf_counter() - t0
    assert [ph for ph, _ in spans] == ["checkpoint", "checkpoint"]
    for (_, sec), body in zip(spans, inner):
        assert body <= sec
    total = sum(sec for _, sec in spans)
    assert total <= wall
    got = GP.ledger().snapshot()["phases"]["checkpoint"]
    assert got == pytest.approx(total, abs=1e-6)
    GP.reset()


# ---------------------------------------------------------------------------
# 4. The refusals
# ---------------------------------------------------------------------------


def test_checkpoint_shard_world_mismatch(tmp_path, world1, monkeypatch):
    tree = {"m": torch.arange(4.0)}
    ckpt.save(str(tmp_path), tree, 3, all_ranks=True)
    back = ckpt.restore(str(tmp_path), 3, all_ranks=True)
    assert torch.equal(back["m"], tree["m"])
    monkeypatch.setattr(ckpt, "_world", lambda: (0, 2))
    with pytest.raises(HorovodTpuError, match="world size"):
        ckpt.restore(str(tmp_path), 3, all_ranks=True)


def test_restore_refuses_dp_size_change(tmp_path, world1, monkeypatch):
    ckpt.save(str(tmp_path), {"w": torch.zeros(4)}, 1, all_ranks=True)
    with open(tmp_path / "step_1" / "rank_0" / "shard_meta.json") as f:
        meta = json.load(f)
    assert meta["dp_size"] == 1 and meta["world_size"] == 1
    monkeypatch.setenv("HOROVOD_MESH", "dp:4,tp:2")
    with pytest.raises(HorovodTpuError, match="data-parallel shards"):
        ckpt.restore(str(tmp_path), all_ranks=True)


def test_shard_meta_stamps_zero_stage(tmp_path, world1, monkeypatch):
    monkeypatch.delenv("HOROVOD_ZERO_STAGE", raising=False)
    zp = hvd.zero3_shard_params({"w": torch.arange(6.0)})
    ckpt.save(str(tmp_path), {"zp": zp, "step": 4}, 1, all_ranks=True)
    with open(os.path.join(str(tmp_path), "step_1", "rank_0",
                           "shard_meta.json")) as f:
        assert json.load(f)["zero_stage"] == 3
    back = ckpt.restore(str(tmp_path), 1, all_ranks=True)
    assert isinstance(back["zp"], D.Zero3Params)
    assert torch.equal(back["zp"].shards[0], zp.shards[0].detach())
    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "1")
    with pytest.raises(HorovodTpuError, match="Zero3Params"):
        ckpt.restore(str(tmp_path), 1, all_ranks=True)
    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "3")
    ckpt.restore(str(tmp_path), 1, all_ranks=True)
    ckpt.save(str(tmp_path), {"m": torch.arange(4.0)}, 2, all_ranks=True)
    with open(os.path.join(str(tmp_path), "step_2", "rank_0",
                           "shard_meta.json")) as f:
        assert json.load(f)["zero_stage"] == 2
    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "1")
    ckpt.restore(str(tmp_path), 2, all_ranks=True)


def test_refuses_rank0_only_zero3_save(tmp_path, world1):
    zp = hvd.zero3_shard_params({"w": torch.arange(6.0)})
    with pytest.raises(HorovodTpuError, match="all_ranks"):
        ckpt.save(str(tmp_path), {"params": zp}, 1)
    with pytest.raises(HorovodTpuError, match="all_ranks"):
        ckpt.save(str(tmp_path), {"shard": zp.shards[0]}, 1)


def test_load_sharded_state_refuses_another_layout(world1):
    ws = [torch.nn.Parameter(torch.zeros(s)) for _, s in OPT_LEAVES]
    opt = hvd.DistributedOptimizer(TF.sgd(ws, 0.5, 0.5), zero_stage=2)
    full = D.ShardLayout(*opt.layout)
    other = D.ShardedState(opt.shard_state, None, full._replace(
        padded=(44,), shard=(11,)))
    with pytest.raises(HorovodTpuError, match="sharded_state_from_host"):
        opt.load_sharded_state(other)


# ---------------------------------------------------------------------------
# 5. A gloo world of four ranks
# ---------------------------------------------------------------------------


def test_all_ranks_save_with_replicas_world4(world4):
    outs, _ = world4
    for o in outs:
        c = o["checkpoint"]
        assert c["replica_dirs"] == ["rep_0_1", "rep_1_2", "rep_2_3",
                                     "rep_3_0"]
        assert c["restored_equal"], o["rank"]
        assert c["quarantined"] == ["rank_1.corrupt"]
    # every rank's shard differs: the shard state is shard-local
    assert len({o["checkpoint"]["shard_digest"] for o in outs}) == 4


def test_resync_leaves_shard_state_alone_world4(world4):
    outs, _ = world4
    for o in outs:
        p, n, same = o["checkpoint"]["resync"]
        assert p == [0.0, 0.0, 0.0] and n == 0 and same


def test_resync_is_the_identity_at_world_one(world1):
    tree = {"w": torch.ones(2), "n": 3}
    assert ckpt.resync(tree) is tree


@pytest.mark.parametrize("world", [2, 1, 3])
def test_stage2_and_stage3_reshard_from_world4(world4, world):
    """The world-4 host forms, saved by rank 0, re-cut for ``world``
    ranks: the shards concatenated are the gathered full buffers, bit
    for bit (trimmed to the true size, re-padded with zeros), and
    gathered again they give the same host form."""
    outs, path = world4
    back = ckpt.restore(path, 3)
    host, zhost = back["opt"], back["zp"]
    assert isinstance(host, D.HostShardedState)
    assert isinstance(zhost, D.HostZero3Params)
    full = np.asarray(outs[0]["checkpoint"]["full_trace"], np.float32)
    np.testing.assert_array_equal(host.inner[0]["trace"], full)
    total = sum(host.layout.sizes[0])
    cuts = [D.sharded_state_from_host(host, world=world, rank=r)
            for r in range(world)]
    got = torch.cat([c.inner[0]["trace"] for c in cuts])
    assert got.numel() == total + (-total) % world
    assert torch.equal(got[:total], torch.from_numpy(full[:total]))
    assert not got[total:].any()
    again = D.sharded_state_to_host(
        cuts[0], gather=lambda t: torch.cat(
            [c.inner[0]["trace"] for c in cuts]))
    np.testing.assert_array_equal(again.inner[0]["trace"][:total],
                                  full[:total])
    # stage 3: the full parameters, re-cut and gathered back
    zps = [D.zero3_params_from_host(zhost, world=world, rank=r)
           for r in range(world)]
    flat = torch.cat([z.shards[0].detach() for z in zps])
    names = [n for n, _ in OPT_LEAVES]
    want = np.concatenate([np.asarray(zhost.tree[n]).reshape(-1)
                           for n in names])
    assert torch.equal(flat[:want.size], torch.from_numpy(want))
    regathered = D.zero3_params_to_host(zps[0], gather=lambda s: flat)
    for n in names:
        np.testing.assert_array_equal(regathered.tree[n], zhost.tree[n])
    # rank 0's world-4 shard is the head of the same buffer
    np.testing.assert_array_equal(
        np.asarray(outs[0]["checkpoint"]["zero3_shard"], np.float32),
        np.concatenate([want, np.zeros(44 - want.size, np.float32)])[:11])


def test_params_host_forms_route_mixed_trees(world1):
    """``params_to_host`` / ``params_from_host``: a tree holding stage-3
    parameters and plain values, through a pickle (a checkpoint), re-cut
    for a world of 2 (``tests/test_zero23.py:571``)."""
    params = {"a": torch.arange(10.0), "b": torch.arange(3.0)}
    zp = hvd.zero3_shard_params(params)
    host = D.params_to_host({"zp": zp, "step": 7, "w": torch.ones(2)})
    host = pickle.loads(pickle.dumps(host))
    assert isinstance(host["zp"], D.HostZero3Params)
    np.testing.assert_array_equal(host["zp"].tree["a"], np.arange(10.0))
    full = np.concatenate([np.arange(10.0), np.arange(3.0),
                           np.zeros(1)]).astype(np.float32)
    for r in range(2):
        back = D.params_from_host(host, world=2, rank=r)
        assert isinstance(back["zp"], D.Zero3Params)
        assert back["zp"].layout.padded == (14,)
        np.testing.assert_array_equal(back["zp"].shards[0].detach().numpy(),
                                      full[r * 7:(r + 1) * 7])
        assert back["step"] == 7 and torch.equal(back["w"], torch.ones(2))


# ---------------------------------------------------------------------------
# 6. A resumed run is an uninterrupted one
# ---------------------------------------------------------------------------


def _train(model, opt, batches):
    from horovod_tpu_torch.train_step import train_step

    return [float(train_step(model, opt, x, y)) for x, y in batches]


def test_resume_is_bit_identical(tmp_path, world1, monkeypatch):
    """A small ResNet (float32, fused momentum SGD) trained 4 steps in a
    row against 2 steps, a save, a restore into fresh objects and 2 more
    steps: the same weights, buffers and trace bit for bit."""
    from horovod_tpu_torch.train_step import synthetic_batch

    monkeypatch.setenv("HOROVOD_FUSED_UPDATE", "1")
    batches = [synthetic_batch(8, 32, 10, seed=s, device="cpu")
               for s in range(4)]

    def fresh():
        model = small_resnet("cpu")
        opt = hvd.DistributedOptimizer(
            TF.sgd(model.parameters(), 0.1, momentum=0.9))
        return model, opt

    m1, o1 = fresh()
    l1 = _train(m1, o1, batches)
    m2, o2 = fresh()
    l2 = _train(m2, o2, batches[:2])
    ckpt.save(str(tmp_path), {"model": m2.state_dict(),
                              "opt": o2.state_dict(), "step": 2}, 2)
    del m2, o2
    m3, o3 = fresh()
    with torch.no_grad():  # fresh objects must not already agree
        for p in m3.parameters():
            p.add_(1.0)
    back = ckpt.restore(str(tmp_path))
    assert back["step"] == 2
    m3.load_state_dict(back["model"])
    o3.load_state_dict(back["opt"])
    l2 += _train(m3, o3, batches[2:])
    assert l1 == l2
    for (k, a), b in zip(m1.state_dict().items(),
                         m3.state_dict().values()):
        assert torch.equal(a, b), k
    for p1, p3 in zip(m1.parameters(), m3.parameters()):
        assert torch.equal(o1.state[p1]["trace"], o3.state[p3]["trace"])
