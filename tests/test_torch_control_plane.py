"""The port's hierarchical control plane and its round-0 handshake against
the JAX package's, in one process (``tests/test_control_plane.py:
49-208``, ``tests/test_fault_tolerance.py:394``, ``tests/
test_zero23.py:718``).

1. ``control_topology`` and ``ControlTopology`` equal the JAX ones for
   worlds 1-64 and fanouts 0, 2, 3 and 8 (and under
   ``HOROVOD_HIERARCHICAL_LOCAL_SIZE``).
2. Worlds of threaded ``KVController``s over one dict store: the
   hierarchical plane's responses are byte-identical to the flat
   plane's, and every key the port posts (the merged slice messages
   included) equals the JAX package's for the same request scripts;
   ``_gc`` reclaims the slice keys.
3. Round 0 fails on every rank, with the JAX package's message, when
   the control fanout, the heartbeat knobs, ``HOROVOD_ZERO_STAGE`` or
   ``HOROVOD_MESH`` differ between ranks.

The hierarchical plane over real processes (a gloo world of 4 under
``HOROVOD_CONTROL_FANOUT=2``) is ``tests/test_torch_eager_training.py``'s.
"""

import ast
import json
import threading

import pytest

from horovod_tpu.runtime import controller as jctl
from horovod_tpu.runtime import faults as jfaults

from horovod_tpu_torch.runtime import controller as tctl

from test_response_cache import DictTransport

MODS = {"jax": jctl, "port": tctl}


# ---------------------------------------------------------------------------
# 1. Topology
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("local", ["", "4"])
@pytest.mark.parametrize("fanout", [0, 2, 3, 8])
def test_control_topology_matches_jax(monkeypatch, fanout, local):
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_LOCAL_SIZE", local)
    for world in range(1, 65):
        t, j = (tctl.control_topology(world, fanout),
                jctl.control_topology(world, fanout))
        assert (t is None) == (j is None), (world, fanout)
        if t is None:
            continue
        assert (t.world, t.slice_size, t.n_slices) == \
            (j.world, j.slice_size, j.n_slices)
        assert t.leaders() == j.leaders()
        for r in range(world):
            assert (t.slice_of(r), t.is_leader(r)) == \
                (j.slice_of(r), j.is_leader(r))
        for s in range(t.n_slices):
            assert t.members(s) == j.members(s)
            assert t.leader_of(s) == j.leader_of(s)


def test_fanout_knob_is_read(monkeypatch):
    monkeypatch.setenv("HOROVOD_CONTROL_FANOUT", "3")
    assert tctl.control_topology(9).slice_size == 3
    assert tctl.round0_cfg()[-1] == jctl.round0_cfg()[-1] == 3
    monkeypatch.setenv("HOROVOD_CONTROL_FANOUT", "0")
    assert tctl.control_topology(4096) is None


# ---------------------------------------------------------------------------
# 2. Worlds of controllers
# ---------------------------------------------------------------------------


def _req(mod, name, shape=(4,), op=2, dtype=8, kind="allreduce", root=-1):
    return mod.Request(name, kind, op, dtype, tuple(shape), root)


def _mixed_rounds(mod, r, rank):
    if r == 0:
        return [_req(mod, "a"), _req(mod, "g", (rank + 1, 3),
                                     kind="allgather")]
    if r == 1:
        return [_req(mod, "b", (5,), kind="broadcast", root=1),
                _req(mod, "a")]
    return [_req(mod, "a")]                    # the warm cache fast path


def _run_world(mod, world, fanout, rounds_fn, n_rounds, epoch):
    """``world`` controllers of ``mod`` on threads over one dict store for
    ``n_rounds`` rounds: per rank per round the response wires, and the
    store after every round."""
    store, cv = {}, threading.Condition()
    out = [[] for _ in range(world)]
    snaps = []
    errs = []
    barrier = threading.Barrier(world, action=lambda: snaps.append(
        dict(store)))

    def run(rank):
        try:
            ctl = mod.KVController(DictTransport(store, cv), rank, world,
                                   epoch=epoch, fanout=fanout)
            for r in range(n_rounds):
                res = ctl.negotiate(rounds_fn(mod, r, rank), False, False)
                out[rank].append([json.dumps(p.wire(), sort_keys=True)
                                  for p in res.responses])
                barrier.wait(30)
        except BaseException as e:  # noqa: BLE001 -- surfaced below
            errs.append((rank, e))
            barrier.abort()

    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    if errs:
        raise errs[0][1]
    return out, snaps


@pytest.mark.parametrize("world,fanout", [(6, 3), (6, 2), (9, 4), (5, 2)])
def test_hier_vs_flat_byte_identical(world, fanout):
    n_rounds = 4
    flat, _ = _run_world(tctl, world, 0, _mixed_rounds, n_rounds, epoch=50)
    hier, snaps = _run_world(tctl, world, fanout, _mixed_rounds, n_rounds,
                             epoch=50)
    for r in range(n_rounds):
        assert all(flat[k][r] == flat[0][r] for k in range(world))
        assert all(hier[k][r] == hier[0][r] for k in range(world))
        assert hier[0][r] == flat[0][r], f"mode divergence at round {r}"
    assert any("/sq/" in k for k in snaps[-1])
    assert any("/gq/" in k for k in snaps[-1])
    # the JAX package's plane posts the same keys and payloads
    jhier, jsnaps = _run_world(jctl, world, fanout, _mixed_rounds,
                               n_rounds, epoch=50)
    assert jhier == hier
    assert _no_beats(jsnaps) == _no_beats(snaps)


def _no_beats(snaps):
    return [{k: v for k, v in s.items() if "/hb/" not in k} for s in snaps]


def test_flat_plane_matches_jax_coordinator():
    n_rounds = 4
    tout, tsnaps = _run_world(tctl, 4, 0, _mixed_rounds, n_rounds, epoch=7)
    jout, jsnaps = _run_world(jctl, 4, 0, _mixed_rounds, n_rounds, epoch=7)
    assert tout == jout
    assert _no_beats(tsnaps) == _no_beats(jsnaps)


@pytest.mark.parametrize("fanout", [2, 3])
def test_hier_gc_reclaims_slice_keys(fanout):
    world, n_rounds = 6, 5
    _, snaps = _run_world(tctl, world, fanout,
                          lambda mod, r, k: [_req(mod, "t%d" % r)],
                          n_rounds, epoch=52)
    store = snaps[-1]
    stale = [key for key in store
             if (rnd := jfaults.round_of(jfaults.strip_epoch(key)))
             is not None and rnd < n_rounds - 2]
    assert not stale, sorted(stale)
    assert any(jfaults.round_of(jfaults.strip_epoch(k)) == n_rounds - 1
               for k in store)
    _, jsnaps = _run_world(jctl, world, fanout,
                           lambda mod, r, k: [_req(mod, "t%d" % r)],
                           n_rounds, epoch=52)
    assert _no_beats(jsnaps) == _no_beats(snaps)


# ---------------------------------------------------------------------------
# 3. Round-0 mismatches
# ---------------------------------------------------------------------------


def _round0_pair(mod, make, knob_by_rank=None, monkeypatch=None):
    """Two controllers from ``make(mod, store, cv, rank)`` negotiate one
    allreduce; ``knob_by_rank`` maps a knob name to its value per rank
    (read through the config module on each rank's thread).  Returns
    the two results."""
    local = threading.local()
    if knob_by_rank:
        base = mod._config.get

        def get(name):
            vals = knob_by_rank.get(name)
            if vals is not None and hasattr(local, "rank"):
                return vals[local.rank]
            return base(name)
        monkeypatch.setattr(mod._config, "get", get)
    store, cv = {}, threading.Condition()
    ctls = [make(mod, store, cv, r) for r in range(2)]
    res = [None, None]

    def run(i):
        local.rank = i
        try:
            res[i] = ctls[i].negotiate([_req(mod, "x")], False, False)
        except BaseException as e:  # noqa: BLE001 -- asserted below
            res[i] = e

    ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    if knob_by_rank:
        monkeypatch.undo()
    return res


def _assert_round0_failed(results, env: str):
    msgs = {}
    for key, res in results.items():
        for r in res:
            assert not isinstance(r, BaseException), r
            assert r.should_stop and r.responses[0].kind == "error"
            assert env in r.responses[0].error
        msgs[key] = [r.responses[0].error for r in res]
    assert msgs["port"] == msgs["jax"]


def _plain(mod, store, cv, rank):
    return mod.KVController(DictTransport(store, cv), rank, 2, epoch=60)


def test_fanout_mismatch_fails_round0():
    def make(mod, store, cv, rank):
        return mod.KVController(DictTransport(store, cv), rank, 2,
                                epoch=60, fanout=(0, 7)[rank])
    _assert_round0_failed({k: _round0_pair(m, make)
                           for k, m in MODS.items()},
                          "HOROVOD_CONTROL_FANOUT")


def test_heartbeat_mismatch_fails_round0(monkeypatch):
    monkeypatch.setenv("HOROVOD_WIRE_TIMEOUT_SECONDS", "20")
    monkeypatch.setenv("HOROVOD_HEARTBEAT_INTERVAL", "2")
    monkeypatch.setenv("HOROVOD_HEARTBEAT_TIMEOUT_SECONDS", "20")

    def make(mod, store, cv, rank):
        ctl = _plain(mod, store, cv, rank)
        if rank == 1:
            ctl._hb_interval = 0.0          # the divergent rank
        return ctl
    results = {k: _round0_pair(m, make) for k, m in MODS.items()}
    _assert_round0_failed(results, "HOROVOD_HEARTBEAT_INTERVAL")
    err = results["port"][0].responses[0].error
    cfgs = ast.literal_eval(err[err.index("([") + 1:err.index("])") + 1])
    assert [c[5] for c in cfgs] == [0, 2000]      # the interval, in ms


@pytest.mark.parametrize("knob,env,values", [
    ("zero_stage", "HOROVOD_ZERO_STAGE", (2, 0)),
    ("mesh", "HOROVOD_MESH", ("dp:2", "dp:1,tp:2")),
])
def test_knob_mismatch_fails_round0(monkeypatch, knob, env, values):
    """One knob set differently on the two ranks: the handshake fails
    round 0 on both, naming the knob as the JAX package does."""
    results = {}
    for k, m in MODS.items():
        results[k] = _round0_pair(m, _plain, {knob: values}, monkeypatch)
    _assert_round0_failed(results, env)
    err = results["port"][0].responses[0].error
    assert "Mismatched " in err and "Shutting down." in err
