"""The port's elastic training (``horovod_tpu_torch/elastic.py``) against
the JAX package's (``tests/test_elastic.py:97-400``, docs/elastic.md).

1. ``plan_reform`` against the reference's on the same survivors and
   joiners: equal rosters.  The launcher's ``Blacklist`` cooldown against
   the reference's on one clock.
2. Join registration and scan, and the commit boundary's grow decision,
   over an in-memory rendezvous, the same keys and verdicts as the
   reference's.
3. ``ElasticState`` commit and restore, bit for bit: a module (its
   buffers too), a dict of tensors, the wrapped optimizer's state; the
   stage-1/2 shard state gathered at the commit and re-cut for another
   world (each rank's segment is the commit's); stage-3 parameters
   through their host form, and a stage-3 optimizer re-pointed at the
   restored shards; error-feedback residuals restarting at
   zero.
4. The driver's pieces: a failed collective is a death only when the
   liveness sweep confirms it; the bounded teardown.
5. Launcher-driven gloo worlds on deterministic, rank-independent
   gradients (``tests/_torch_elastic_train_script.py``), whose final
   parameters must equal the script's closed form on every rank:
   a world of 3 at ZeRO stage 2 and at stage 3 whose rank 2 is SIGKILLed
   at a step boundary (the survivors re-form to 2; the re-cut shard
   state gathered equals the commit bit for bit), and a world that loses rank 2 and
   grows back to 3 when the launcher's joiner is admitted at a commit
   boundary (every rank raises at the same commit).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu import elastic as jelastic
from horovod_tpu.run.launcher import Blacklist as JBlacklist

import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.types import HorovodTpuError, RanksDownError
from horovod_tpu_torch.optim import distributed as D
from horovod_tpu_torch.run.launcher import Blacklist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "_torch_elastic_train_script.py")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_preemption import FakeStore, FakeTransport  # noqa: E402


@pytest.fixture()
def fake_rendezvous(monkeypatch):
    store = FakeStore()
    monkeypatch.setattr(elastic, "_rendezvous", None)
    monkeypatch.setattr(elastic, "_transport_factory",
                        lambda: FakeTransport(store))
    yield store
    elastic._rendezvous = None


@pytest.fixture()
def world1(monkeypatch):
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK", "HOROVOD_MESH"):
        monkeypatch.delenv(k, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


# ---------------------------------------------------------------------------
# Roster planning, blacklist
# ---------------------------------------------------------------------------

ROSTERS = [
    ([(3, "u3", "hostB"), (0, "u0", "hostA"), (2, "u2", "hostA")], []),
    ([(1, "s1", "a"), (4, "s4", "b")], [("jB", "b"), ("jA", "a")]),
    ([(0, "r0", "h")], []),
    ([(2, "r2", "h1"), (5, "r5", "h2"), (7, "r7", "h1")],
     [("joiner3", "h2"), ("joiner1", "h3")]),
]


@pytest.mark.parametrize("survivors,joiners", ROSTERS)
def test_plan_reform_matches_the_jax_package(survivors, joiners):
    mine = elastic.plan_reform(list(survivors), list(joiners))
    assert mine == jelastic.plan_reform(list(survivors), list(joiners))
    ranks = [m["rank"] for m in mine["members"]]
    assert ranks == list(range(mine["size"]))
    olds = [m["old_rank"] for m in mine["members"] if m["old_rank"] >= 0]
    assert olds == sorted(olds)


def test_blacklist_cooldown_matches_the_jax_package():
    now = [100.0]
    bls = [Blacklist(cooldown_s=30.0, clock=lambda: now[0]),
           JBlacklist(cooldown_s=30.0, clock=lambda: now[0])]
    trace = [[], []]
    for t, step in ((100.0, "h1"), (129.9, None), (130.0, None),
                    (131.0, "h1"), (140.0, "h2"), (170.0, None)):
        now[0] = t
        for i, bl in enumerate(bls):
            if step:
                bl.add(step)
            trace[i].append((bl.admissible("h1"), bl.admissible("h2"),
                             bl.active()))
    assert trace[0] == trace[1]
    assert trace[0][1] == (False, True, ["h1"])
    assert trace[0][2] == (True, True, [])


# ---------------------------------------------------------------------------
# Join registration, the commit boundary
# ---------------------------------------------------------------------------


def _join_trace(mod, t) -> list:
    out = [mod.register_join(t, "uidA", "hostA"),
           mod.register_join(t, "uidB", "hostB"), mod.scan_joiners(t)]
    t.set_overwrite("el/admitted/uidA", "2")
    out.append(mod.scan_joiners(t))
    mod.scan_joiners(t, advance_cursor=True)
    out.append(t.try_get("el/join_cursor"))
    t.set_overwrite("el/admitted/uidB", "3")
    mod.scan_joiners(t, advance_cursor=True)
    out.append(t.try_get("el/join_cursor"))
    out.append(mod.register_join(t, "uidC", "hostC"))
    out.append(mod.scan_joiners(t))
    return out


def test_join_registration_and_scan_match_the_jax_package():
    stores = [FakeStore(), FakeStore()]
    mine = _join_trace(elastic, FakeTransport(stores[0]))
    ref = _join_trace(jelastic, FakeTransport(stores[1]))
    assert mine == ref
    assert mine[2] == [("uidA", "hostA"), ("uidB", "hostB")]
    assert mine[-1] == [("uidC", "hostC")]
    assert stores[0].data == stores[1].data


def test_commit_boundary_admits_joiners_with_interrupt(
        world1, fake_rendezvous, monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    t = FakeTransport(fake_rendezvous)
    state = elastic.ElasticState(params={"w": np.ones(2)}, opt_state=None)
    state.commit()
    gen = elastic.generation()
    assert t.try_get(elastic._boundary_key(gen, 1)) == "ok"
    elastic.register_join(t, "uidJ", "hostJ")
    with pytest.raises(elastic.HostsUpdatedInterrupt):
        state.commit()
    assert t.try_get(elastic._boundary_key(gen, 2)) == "grow"
    assert state._commit is not None and state.commits == 2


def test_commit_boundary_respects_target_size(
        world1, fake_rendezvous, monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    monkeypatch.setenv("HOROVOD_ELASTIC_NP", "1")
    t = FakeTransport(fake_rendezvous)
    elastic.register_join(t, "uidJ", "hostJ")
    state = elastic.ElasticState(params={"w": np.ones(2)}, opt_state=None)
    state.commit()
    assert t.try_get(
        elastic._boundary_key(elastic.generation(), 1)) == "ok"


class _BoundaryWatch(FakeTransport):
    """A FakeTransport that signals when a commit boundary's record is
    waited for."""

    def __init__(self, store):
        super().__init__(store)
        self.waiting = threading.Event()

    def get_blocking(self, key, timeout_s):
        if key.startswith("el/c/"):
            self.waiting.set()
        return super().get_blocking(key, timeout_s)


def test_rollback_never_reads_an_earlier_boundarys_grow_record(
        world1, monkeypatch):
    """A joiner admitted at commit c-1, a rollback at commit c's tick to
    the commit c-1 snapshot, and a peer that reaches the next boundary
    before rank 0 does: the peer must wait for rank 0's verdict of THIS
    boundary, not read commit c-1's "grow" and raise alone (the others
    would hang at their next collective).  Each simulated rank keeps its
    own boundary count, as its process would."""
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    store = FakeStore()
    t = _BoundaryWatch(store)
    monkeypatch.setattr(elastic, "_rendezvous", t)
    st = basics.state()
    counts = {0: [0, 0], 1: [0, 0]}

    def as_rank(r):
        monkeypatch.setattr(st, "rank", r)
        monkeypatch.setattr(elastic, "_boundaries", counts[r])

    def boundary_all(state, grow):
        for r in (0, 1):
            as_rank(r)
            if grow:
                with pytest.raises(elastic.HostsUpdatedInterrupt):
                    elastic._commit_boundary(state)
            else:
                elastic._commit_boundary(state)

    state = elastic.ElasticState(params={"w": np.ones(2)}, opt_state=None)
    state._snapshot()                                   # commit 1
    boundary_all(state, grow=False)
    elastic.register_join(t, "uidJ", "hostJ")
    state._snapshot()                                   # commit 2: grow
    snap2 = state._commit
    boundary_all(state, grow=True)
    # the re-form: the joiner is admitted into the next generation and
    # every rank resumes from commit 2
    t.set_overwrite("el/admitted/uidJ", "2")
    monkeypatch.setattr(st, "epoch", st.epoch + 1)
    state.restore()
    state._snapshot()                                   # commit 3
    boundary_all(state, grow=False)
    # commit 4 is poisoned: its tick rolls every rank back to commit 3's
    # predecessor, the admitted commit 2
    state._snapshot()
    state.load(snap2)
    assert state.commits == 2
    outcome = []

    def peer():
        try:
            elastic._commit_boundary(state)
            outcome.append("ok")
        except elastic.HostsUpdatedInterrupt as exc:
            outcome.append(f"raised alone: {exc}")

    as_rank(1)
    t.waiting.clear()
    th = threading.Thread(target=peer)
    th.start()
    assert t.waiting.wait(10.0)
    th.join(0.2)
    as_rank(0)
    elastic._commit_boundary(state)
    th.join(10.0)
    assert outcome == ["ok"]
    gen = elastic.generation()
    # rank 0 cleared the previous generation's records at its first
    # boundary of this one
    assert not [k for k in store.data
                if k.startswith(f"el/c/g{gen - 1}/")]
    assert sorted(k for k in store.data if k.startswith("el/c/")) == [
        elastic._boundary_key(gen, 1), elastic._boundary_key(gen, 2)]


# ---------------------------------------------------------------------------
# ElasticState
# ---------------------------------------------------------------------------


def _train(model, opt, steps: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        x = torch.randn(4, 3, 8, 8, generator=g)
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()


def _small_model():
    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4), torch.nn.ReLU(),
        torch.nn.Flatten(), torch.nn.Linear(144, 5))


def _bits(model, opt) -> list:
    out = [v.detach().clone() for v in model.state_dict().values()]
    for st in opt.optimizer.state.values():
        out += [v.clone() for v in st.values() if torch.is_tensor(v)]
    return out


def test_elastic_state_commit_restore_roundtrip(world1):
    """A module (parameters and BatchNorm buffers) and the wrapped
    optimizer's momentum come back bit for bit; the step counter, the
    batch offset and the extras follow the commit; the optimizer keeps
    training the restored tensors."""
    model = _small_model()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    _train(model, opt, 2, seed=1)
    state = elastic.ElasticState(params=model, opt_state=opt, step=7,
                                 batch_offset=3, lr=0.1)
    state.commit()
    committed = _bits(model, opt)
    _train(model, opt, 2, seed=2)
    after_two = _bits(model, opt)
    state.step, state.extra["lr"] = 99, 0.5
    state.restore()
    for a, b in zip(_bits(model, opt), committed):
        assert torch.equal(a, b)
    assert state.step == 7 and state.batch_offset == 3
    assert state.extra["lr"] == 0.1
    assert state.params is model
    _train(model, opt, 2, seed=2)   # the same two steps again
    for a, b in zip(_bits(model, opt), after_two):
        assert torch.equal(a, b)


def test_dict_params_roundtrip_in_place(world1):
    w = torch.nn.Parameter(torch.arange(4.0))
    b = torch.arange(3, dtype=torch.bfloat16)
    state = elastic.ElasticState(params={"w": w, "b": b, "n": 5})
    state.commit()
    with torch.no_grad():
        w.add_(1)
        b.add_(1)
    state.restore()
    assert state.params["w"] is w and torch.equal(w, torch.arange(4.0))
    assert state.params["b"] is b and b.dtype == torch.bfloat16
    assert torch.equal(b, torch.arange(3, dtype=torch.bfloat16))
    assert state.params["n"] == 5


def test_restore_without_commit_raises(world1):
    state = elastic.ElasticState(params={"w": np.ones(2)})
    with pytest.raises(HorovodTpuError, match="commit"):
        state.restore()


def test_run_requires_elastic_mode(world1, monkeypatch):
    monkeypatch.delenv("HOROVOD_ELASTIC", raising=False)
    state = elastic.ElasticState(params={})
    with pytest.raises(HorovodTpuError, match="HOROVOD_ELASTIC"):
        elastic.run(state, lambda s: s)


def test_run_decorator_form(world1, fake_rendezvous, monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")

    @elastic.run
    def train(state, bonus):
        return state.step + bonus

    state = elastic.ElasticState(params={}, step=5)
    assert train(state, 10) == 15


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("fused", [False, True], ids=["inner", "fused"])
def test_sharded_state_gather_and_recut(world1, stage, fused, monkeypatch):
    """The commit all-gathers the shard state into its full buffers; a
    restore re-cuts it for the current world (here one rank: the whole
    buffer, bit for bit) and ``sharded_state_from_host`` cuts the same
    commit for a world of 3, whose segments laid end to end are the
    commit's buffer."""
    from horovod_tpu_torch.optim import fused_update

    model = _small_model()
    if fused:
        monkeypatch.setenv("HOROVOD_FUSED_UPDATE", "1")
        base = fused_update.sgd(model.parameters(), 0.1, momentum=0.9)
    else:
        base = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    opt = hvd.DistributedOptimizer(base, zero_stage=stage)
    _train(model, opt, 2, seed=3)
    state = elastic.ElasticState(params=model, opt_state=opt)
    state.commit()
    host = state._commit["opt_state"]["sharded"]
    before = [{k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
              for st in opt.shard_state]
    _train(model, opt, 1, seed=4)
    state.restore()
    for st, old in zip(opt.shard_state, before):
        for k, v in old.items():
            assert torch.equal(st[k], v), k
    totals = [sum(s) for s in host.layout.sizes]
    for gi, full in enumerate(host.inner):
        for k, v in full.items():
            if not isinstance(v, np.ndarray) or v.ndim != 1:
                continue
            parts = [D.sharded_state_from_host(host, world=3, rank=r)
                     .inner[gi][k] for r in range(3)]
            cat = torch.cat(parts).numpy()[:totals[gi]]
            np.testing.assert_array_equal(cat, v[:totals[gi]])


def test_stage3_params_through_the_host_form(world1):
    model = _small_model()
    zp = D.zero3_shard_params(model)
    full = {k: v.detach().clone()
            for k, v in D.zero3_full_params(zp).items()}
    state = elastic.ElasticState(params={"zp": zp})
    state.commit()
    state.restore()
    again = D.zero3_full_params(state.params["zp"])
    for k, v in full.items():
        assert torch.equal(again[k].detach(), v)
    host = state._commit["params"]["tree"]["zp"]
    cut = [D.zero3_params_from_host(host, world=2, rank=r) for r in (0, 1)]
    for g in range(len(cut[0].shards)):
        cat = torch.cat([c.shards[g].detach() for c in cut])
        ref = zp.shards[g].detach()
        n = ref.numel()
        assert torch.equal(cat[:n], ref)


def test_stage3_optimizer_commit_restore_and_recut(world1):
    """A stage-3 ``DistributedOptimizer``: the commit gathers the shard
    parameters and their optimizer state; a restore hands back new
    shards with the optimizer re-pointed at them, bit for bit, and the
    next step matches a run that never restored; the state re-cut for a
    world of 2 lays its segments end to end into the commit's."""
    def build():
        model = _small_model()
        zp = D.zero3_shard_params(model)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(zp.shards, lr=0.1, momentum=0.9), zero_stage=3)
        return model, zp, opt

    def step(model, zp, opt, seed):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(4, 3, 8, 8, generator=g)
        opt.zero_grad()
        full = D.zero3_full_params(zp)
        torch.func.functional_call(model, full, (x,)).square().mean() \
            .backward()
        opt.step()

    model, zp, opt = build()
    step(model, zp, opt, 1)
    state = elastic.ElasticState(params={"zp": zp}, opt_state=opt)
    state.commit()
    ref = [s.detach().clone() for s in zp.shards]
    ref_m = [opt.optimizer.state[s]["momentum_buffer"].clone()
             for s in zp.shards]
    step(model, zp, opt, 2)
    state.restore()
    new = state.params["zp"]
    assert new is not zp and opt._params_all == list(new.shards)
    assert opt.optimizer.param_groups[0]["params"] == list(new.shards)
    for a, b, m in zip(new.shards, ref, ref_m):
        assert torch.equal(a.detach(), b)
        assert torch.equal(opt.optimizer.state[a]["momentum_buffer"], m)
    step(model, new, opt, 2)
    model2, zp2, opt2 = build()
    step(model2, zp2, opt2, 1)
    step(model2, zp2, opt2, 2)
    for a, b in zip(new.shards, zp2.shards):
        assert torch.equal(a.detach(), b.detach())
    host = state._commit["opt_state"]["zero3"]
    for gi, full in enumerate(host.inner):
        total = sum(host.layout.sizes[gi])
        parts = [D.sharded_state_from_host(host, world=2, rank=r)
                 .inner[gi]["momentum_buffer"] for r in range(2)]
        np.testing.assert_array_equal(
            torch.cat(parts).numpy()[:total],
            full["momentum_buffer"][:total])


def test_residual_restarts_at_zero(world1):
    model = _small_model()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        compression=hvd.Compression.int8, zero_stage=1)
    _train(model, opt, 2, seed=5)
    assert opt.residual is not None
    state = elastic.ElasticState(params=model, opt_state=opt)
    state.commit()
    assert not state._commit["opt_state"]["sharded"].inner is None
    _train(model, opt, 1, seed=6)
    state.restore()
    assert all(float(r.abs().sum()) == 0.0 for r in opt.residual)


# ---------------------------------------------------------------------------
# The driver's pieces
# ---------------------------------------------------------------------------


def test_failed_collective_is_a_death_only_when_confirmed(monkeypatch):
    from horovod_tpu_torch.ops import eager as E

    monkeypatch.setenv("HOROVOD_HEARTBEAT_INTERVAL", "0.2")
    monkeypatch.setenv("HOROVOD_HEARTBEAT_TIMEOUT_SECONDS", "0.3")
    calls = {"n": 0}

    def sweep():
        calls["n"] += 1
        if calls["n"] >= 3:
            raise RanksDownError("RanksDownError: " + json.dumps(
                {"ranks": [2], "round": 4, "elapsed": 2.0, "by": 0}))

    monkeypatch.setattr(E, "check_liveness", sweep)
    down = elastic._confirmed_down(RuntimeError("Connection closed by peer"))
    assert isinstance(down, RanksDownError) and list(down.ranks) == [2]
    monkeypatch.setattr(E, "check_liveness", lambda: None)
    t0 = time.monotonic()
    assert elastic._confirmed_down(RuntimeError("a bug")) is None
    assert time.monotonic() - t0 < 5
    monkeypatch.setenv("HOROVOD_HEARTBEAT_INTERVAL", "0")
    assert elastic._confirmed_down(RuntimeError("x")) is None


def test_rendezvous_wait_wakes_on_the_set(monkeypatch):
    """A commit boundary's wait for rank 0's verdict rides the KV store's
    blocking get, which returns at the set: it never sleeps between
    reads (a 50 ms sleep cost every rank but 0 up to 50 ms per commit),
    and it still checks liveness and its deadline between slices."""
    from horovod_tpu_torch.ops import eager as E
    from horovod_tpu_torch.runtime.kvstore import (KVStoreClient,
                                                   KVStoreServer)

    srv = KVStoreServer()
    waiter = KVStoreClient("127.0.0.1", srv.port)
    setter = KVStoreClient("127.0.0.1", srv.port)
    sweeps = {"n": 0}

    def sweep():
        sweeps["n"] += 1
        if sweeps["n"] == 3:
            setter.set("el/c/7", "ok")

    def no_sleep(s):
        raise AssertionError(f"the wait slept {s} s")

    monkeypatch.setattr(E, "check_liveness", sweep)
    monkeypatch.setattr(elastic.time, "sleep", no_sleep)
    try:
        assert elastic._bounded_get(waiter, "el/c/7", 30.0,
                                    liveness=True) == "ok"
        # a liveness check after each empty slice, none once the key came
        assert sweeps["n"] == 3
        with pytest.raises(TimeoutError, match="el/c/8"):
            elastic._bounded_get(waiter, "el/c/8", 0.2)
    finally:
        waiter.close()
        setter.close()
        srv.stop()


def test_bounded_teardown(world1, monkeypatch):
    import torch.distributed as dist

    from horovod_tpu_torch.common import basics

    assert dist.is_initialized()
    # a destroy that hangs is abandoned at the deadline
    gate = threading.Event()
    real = dist.destroy_process_group
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a, **k: gate.wait(30))
    t0 = time.monotonic()
    assert basics.teardown_distributed(timeout_s=0.3) is False
    assert time.monotonic() - t0 < 5
    gate.set()
    monkeypatch.setattr(dist, "destroy_process_group", real)
    assert basics.teardown_distributed(timeout_s=5) is True
    assert not dist.is_initialized()
    assert basics.teardown_distributed() is True   # nothing left
    basics.abort_communicators()                   # no group: a no-op


# ---------------------------------------------------------------------------
# Launcher-driven worlds
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
         "--elastic", *extra_args, "--", sys.executable, SCRIPT],
        env=env, capture_output=True, text=True, timeout=120)
    events = []
    for ln in out.stdout.splitlines():
        _, _, rest = ln.partition(">:")
        if rest.startswith("{"):
            events.append(json.loads(rest))
    return out, events


@pytest.mark.parametrize("stage", ["2", "3"])
def test_kill_survivors_recut_and_match(stage):
    out, ev = _launch(3, ("--min-ranks", "2", "--blacklist-cooldown-seconds",
                          "600"),
                      HOROVOD_ZERO_STAGE=stage, ELX_TOTAL="8",
                      ELX_KILL_UID="rank2", ELX_KILL_STEP="3")
    assert out.returncode == 0, out.stderr[-4000:]
    assert "rank 2 on localhost died" in out.stderr
    assert 'reason="failure"' in out.stderr
    recut = [e for e in ev if e["event"] == "recut"]
    assert sorted(e["rank"] for e in recut) == [0, 1]
    assert all(e["same"] and e["size"] == 2 for e in recut)
    final = [e for e in ev if e["event"] == "final"]
    assert sorted((e["uid"], e["size"], e["gen"]) for e in final) == [
        ("rank0", 2, 2), ("rank1", 2, 2)]
    for e in final:
        assert e["params"] == e["closed"] and e["step"] == 8


def test_kill_then_grow_back_with_the_launchers_joiner():
    out, ev = _launch(3, ("--min-ranks", "2", "--blacklist-cooldown-seconds",
                          "1"),
                      ELX_TOTAL="14", ELX_KILL_UID="rank2",
                      ELX_KILL_STEP="3", ELX_GROW_AT="8")
    assert out.returncode == 0, out.stderr[-4000:]
    assert "respawned replacement j1 on localhost slot 2" in out.stderr
    assert 'grown=["joiner1"]' in out.stderr and 'reason="grow"' in out.stderr
    grow = [e for e in ev if e["event"] == "interrupt"]
    assert sorted(e["rank"] for e in grow) == [0, 1]
    assert {e["kind"] for e in grow} == {"HostsUpdatedInterrupt"}
    # the grow boundary is one commit for every rank
    assert len({(e["step"], e["commits"]) for e in grow}) == 1
    joined = [e for e in ev if e["event"] == "enter"
              and e["uid"] == "joiner1"]
    assert joined and joined[0]["step"] == grow[0]["step"] == 8
    final = [e for e in ev if e["event"] == "final"]
    assert sorted((e["uid"], e["size"], e["gen"]) for e in final) == [
        ("joiner1", 3, 3), ("rank0", 3, 3), ("rank1", 3, 3)]
    for e in final:
        assert e["params"] == e["closed"] and e["step"] == 14
