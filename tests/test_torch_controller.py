"""The port's eager control plane against the JAX package's, on the CPU
and in one process: the same request streams go through
``horovod_tpu.runtime.*`` and ``horovod_tpu_torch.runtime.*``, and every
result must be equal exactly.

1. ``_MessageTable`` and ``Coordinator``: seeded request streams with
   partial arrivals, joins and every mismatch kind; the ResponseLists
   (errors included, letter for letter), ``all_joined`` and
   ``last_joined``.
2. ``fuse_singles`` at several ``HOROVOD_FUSION_THRESHOLD`` values.
3. ``ResponseCache``: probes (HIT/MISS/INVALID), LRU order, eviction at
   capacity, ``request_for``/``response_for``, ragged allgather first
   dims, ``record_responses`` with a joined rank's zero fill.
4. ``StallInspector`` on a fake clock (the JAX one's ``time.monotonic``
   patched): the same warnings and the same shutdown error.
5. ``round0_cfg`` under the same env on both sides.
6. The wire codec: the port's payload strings byte-identical to the JAX
   package's Python codec (and its native one), each package decoding
   the other's.
7. Two, then four, ``KVController``s of each package over
   ``DictTransport`` (``tests/test_response_cache.py``) on the same
   scripted rounds: the same posted payloads (the store after every
   round) and the same ``NegotiationResult``s, through the cold round,
   a partial round, the warm fast path, a shape change's invalidation, a
   mismatch, a join and a round-0 cfg mismatch.
"""

import threading

import numpy as np
import pytest

from horovod_tpu.runtime import cache as jcache
from horovod_tpu.runtime import controller as jctl
from horovod_tpu.runtime import stall as jstall
from horovod_tpu.runtime import wire as jwire

from horovod_tpu_torch.runtime import cache as tcache
from horovod_tpu_torch.runtime import controller as tctl
from horovod_tpu_torch.runtime import stall as tstall
from horovod_tpu_torch.runtime import wire as twire

from test_response_cache import DictTransport

KINDS = ("allreduce", "allgather", "broadcast", "alltoall", "reducescatter")
F32, BF16, I32 = 8, 7, 4


def _reqs(mod, specs):
    return [mod.Request(n, k, o, d, tuple(s), r) for n, k, o, d, s, r in specs]


def _wires(responses):
    return [p.wire() for p in responses]


def _stream(seed: int, world: int, rounds: int):
    """Per round, per rank: request specs.  Some names reach the odd
    ranks one round late; some carry a mismatch on the last rank."""
    rng = np.random.RandomState(seed)
    per_round = [[[] for _ in range(world)] for _ in range(rounds)]
    for rnd in range(rounds):
        for i in range(int(rng.randint(3, 9))):
            kind = KINDS[rng.randint(len(KINDS))]
            dtype = (F32, BF16, I32)[rng.randint(3)]
            shape = tuple(int(v) for v in rng.randint(1, 6, rng.randint(1, 3)))
            op = 1 + int(rng.randint(2))
            root = int(rng.randint(world)) if kind == "broadcast" else -1
            late = rng.rand() < 0.3 and rnd + 1 < rounds
            bad = rng.randint(6)  # 0: shape, 1: dtype, 2: op/root, else none
            for r in range(world):
                s, d, o, rt = shape, dtype, op, root
                if r == world - 1 and bad == 0:
                    s = (shape[0] + 1,) + shape[1:]
                if r == world - 1 and bad == 1:
                    d = F32 if dtype != F32 else I32
                if r == world - 1 and bad == 2:
                    o, rt = 3 - op, (root + 1) % world if root >= 0 else -1
                if kind == "allgather":
                    s = (shape[0] + r,) + shape[1:]
                at = rnd + 1 if late and r % 2 else rnd
                per_round[at][r].append((f"t{rnd}.{i}", kind, o, d, s, rt))
    return per_round


# ---------------------------------------------------------------------------
# 1-2. Coordinator, message table, fusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coordinator_matches_jax(world, seed):
    jc, tc = jctl.Coordinator(world), tctl.Coordinator(world)
    rounds = _stream(seed, world, 5)
    for rnd, per_rank in enumerate(rounds):
        for r in range(world):
            joined = rnd == 4 and r == 0
            jc.ingest(r, _reqs(jctl, per_rank[r]), joined, False)
            tc.ingest(r, _reqs(tctl, per_rank[r]), joined, False)
        jres, jall = jc.compute_responses()
        tres, tall = tc.compute_responses()
        assert _wires(tres) == _wires(jres), rnd
        assert tall == jall and tc.last_joined == jc.last_joined
        assert sorted(tc.table.entries) == sorted(jc.table.entries)


def test_message_table_errors_letter_for_letter():
    cases = [
        [("a", "allreduce", 1, F32, (4,), -1),
         ("a", "allgather", 1, F32, (4,), -1)],
        [("a", "allreduce", 1, F32, (4,), -1),
         ("a", "allreduce", 1, I32, (4,), -1)],
        [("a", "allreduce", 1, F32, (4,), -1),
         ("a", "allreduce", 2, F32, (4,), -1)],
        [("a", "broadcast", 2, F32, (4,), 0),
         ("a", "broadcast", 2, F32, (4,), 1)],
        [("a", "alltoall", 2, F32, (4,), -1),
         ("a", "alltoall", 2, F32, (6,), -1)],
        [("a", "allgather", 2, F32, (4, 2), -1),
         ("a", "allgather", 2, F32, (4, 3), -1)],
        [("a", "reducescatter", 2, F32, (), -1)],
        [("a", "allreduce", 1, F32, (4,), -1),
         ("a", "allreduce", 1, F32, (4,), -1)],
    ]
    for specs in cases:
        jt, tt = jctl._MessageTable(2), tctl._MessageTable(2)
        ranks = [0, 1] if len(specs) == 2 and specs[0] != specs[1] else [0, 0]
        for r, spec in zip(ranks, specs):
            je = jt.add(r, _reqs(jctl, [spec])[0])
            te = tt.add(r, _reqs(tctl, [spec])[0])
            assert te == je
        assert je is not None


@pytest.mark.parametrize("threshold", [1, 64, 100, 4096, 64 * 1024 * 1024])
def test_fuse_singles_matches_jax(monkeypatch, threshold):
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(threshold))
    rng = np.random.RandomState(threshold % 97)
    specs = []
    for i in range(40):
        kind = ("allreduce", "broadcast", "allgather")[rng.randint(3)]
        name = ("localsgd.local." if rng.rand() < 0.1 else "") + f"g{i}"
        specs.append(dict(kind=kind, names=[name], op=1 + rng.randint(2),
                          root_rank=int(rng.randint(2)) if kind == "broadcast"
                          else -1, dtype_code=(F32, BF16)[rng.randint(2)],
                          shapes=[tuple(int(v) for v in
                                        rng.randint(1, 9, 2))]))
    j = jctl.fuse_singles([jctl.Response(**s) for s in specs])
    t = tctl.fuse_singles([tctl.Response(**s) for s in specs])
    assert _wires(t) == _wires(j)


# ---------------------------------------------------------------------------
# 3. The response cache
# ---------------------------------------------------------------------------


def test_response_cache_matches_jax():
    jc, tc = jcache.ResponseCache(capacity=5), tcache.ResponseCache(capacity=5)
    rng = np.random.RandomState(7)
    for step in range(200):
        name = f"n{rng.randint(9)}"
        kind = KINDS[rng.randint(len(KINDS))] if rng.rand() < 0.2 \
            else "allreduce"
        shape = (int(rng.randint(1, 4)), 2)
        op = 1 + int(rng.randint(2))
        root = int(rng.randint(2)) if kind == "broadcast" else -1
        spec = [(name, kind, op, F32, shape, root)]
        jq, tq = _reqs(jctl, spec)[0], _reqs(tctl, spec)[0]
        jp, tp = jc.probe(jq), tc.probe(tq)
        assert tp == jp
        state, bit = tp
        if state == tcache.INVALID:
            jc.evict_bits([bit])
            tc.evict_bits([bit])
        elif state == tcache.HIT:
            assert tc.request_for(bit, 1) == tctl.Request(
                *jc.request_for(bit, 1).__dict__.values())
            assert tc.response_for(bit).wire() == jc.response_for(bit).wire()
        fd = [shape[0], shape[0] + 1] if kind == "allgather" else []
        jresp = jctl.Response(kind, [name], op, root, F32, [shape],
                              first_dims=fd)
        tresp = tctl.Response(kind, [name], op, root, F32, [shape],
                              first_dims=fd)
        local = {} if step % 11 == 0 else {name: shape}
        jc.record_responses([jresp], local)
        tc.record_responses([tresp], local)
        assert len(tc) == len(jc)
        assert list(tc._lru) == list(jc._lru)
        assert tc._by_name == jc._by_name
        assert {b: e.__dict__ for b, e in tc._bits.items()} == \
            {b: e.__dict__ for b, e in jc._bits.items()}


def test_cache_capacity_from_knob(monkeypatch):
    monkeypatch.setenv("HOROVOD_CACHE_CAPACITY", "3")
    assert tcache.ResponseCache().capacity == jcache.ResponseCache().capacity
    monkeypatch.setenv("HOROVOD_CACHE_CAPACITY", "0")
    assert tctl.KVController(DictTransport(), 0, 2).cache is None


# ---------------------------------------------------------------------------
# 4. The stall inspector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shutdown", ["0", "30"])
def test_stall_inspector_matches_jax(monkeypatch, capsys, shutdown):
    monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME_SECONDS", "10")
    monkeypatch.setenv("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", shutdown)
    now = [1000.0]
    monkeypatch.setattr(jstall.time, "monotonic", lambda: now[0])
    js = jstall.StallInspector(4)
    ts = tstall.StallInspector(4, clock=lambda: now[0])
    pending = {"a": {0, 1}, "b": {2}}
    for s in (js, ts):
        s.observe("a")
    outs = []
    for dt in (0.5, 5, 6, 0.2, 3, 25):
        now[0] += dt
        if dt == 6:
            for s in (js, ts):
                s.observe("b")
        jo, to = js.check(pending), ts.check(pending)
        assert to == jo
        assert ts._warned == js._warned
        outs.append(to)
    if shutdown == "30":
        assert outs[-1] is not None and "Stalled collective operation a" \
            in outs[-1]
    else:
        assert outs[-1] is None and ts._warned == {"a", "b"}
    # the port's warning reached its log
    assert "Stalled ops:\na [missing ranks: [2, 3]]" in capsys.readouterr().err
    monkeypatch.setenv("HOROVOD_STALL_CHECK_DISABLE", "1")
    assert ts.check(pending) is None and js.check(pending) is None


def test_wire_timeout_knob(monkeypatch):
    monkeypatch.setenv("HOROVOD_WIRE_TIMEOUT_SECONDS", "12.5")
    assert tctl.wire_timeout() == jctl.wire_timeout() == 12.5
    monkeypatch.setenv("HOROVOD_WIRE_TIMEOUT_SECONDS", "0")
    assert tctl.wire_timeout() == jctl.wire_timeout() == 0.001


# ---------------------------------------------------------------------------
# 5. round0_cfg
# ---------------------------------------------------------------------------

CFG_ENVS = [
    {},
    {"HOROVOD_COMPRESSION": "int8", "HOROVOD_QUANT_BLOCK_SIZE": "128",
     "HOROVOD_FUSION_THRESHOLD": "1024", "HOROVOD_CACHE_CAPACITY": "7"},
    {"HOROVOD_COMPRESSION": "topk", "HOROVOD_TOPK_RATIO": "0.05",
     "HOROVOD_OVERLAP": "1", "HOROVOD_OVERLAP_CHUNKS": "3",
     "HOROVOD_ZERO_STAGE": "2", "HOROVOD_ZERO_PREFETCH_CHUNKS": "2"},
    {"HOROVOD_BUCKET_COMPRESSION": "int8:int4",
     "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
     "HOROVOD_HIERARCHICAL_LOCAL_SIZE": "2",
     "HOROVOD_RAGGED_ALLGATHER": "pad", "HOROVOD_MESH": "dp:2,tp:2"},
    {"HOROVOD_LOCAL_SGD_H": "4", "HOROVOD_OUTER_LR": "0.5",
     "HOROVOD_LOCAL_SGD_COMPRESSION": "int4",
     "HOROVOD_SHARDED_OPTIMIZER": "1", "HOROVOD_RAGGED_ALLGATHER": "psum"},
    {"HOROVOD_COMPRESSION": "fp16x", "HOROVOD_RAGGED_ALLGATHER": "zz"},
]


@pytest.mark.parametrize("env", CFG_ENVS, ids=range(len(CFG_ENVS)))
def test_round0_cfg_matches_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tctl.round0_cfg() == jctl.round0_cfg()
    assert tctl.ROUND0_KNOB_ENVS == jctl.ROUND0_KNOB_ENVS


# ---------------------------------------------------------------------------
# 6. The wire codec
# ---------------------------------------------------------------------------


def _rank_msgs():
    return [
        {"b": [], "i": [], "req": [], "j": False, "x": False},
        {"b": [3, 1], "i": [7], "j": True, "x": False, "cfg": [1, -2, 3],
         "req": [{"n": "allreduce.layer1.weight", "k": "allreduce", "o": 1,
                  "d": 8, "s": [64, 3, 7, 7], "r": -1},
                 {"n": "bcast", "k": "broadcast", "o": 2, "d": 10,
                  "s": [], "r": 3},
                 {"n": "ü-name", "k": "reducescatter", "o": 2, "d": 7,
                  "s": [9, 5], "r": -1}]},
        {"b": [0], "i": [], "req": [], "j": False, "x": True},
    ]


def _resp_msgs():
    return [
        {"f": [0, 4, 9]},
        {"resp": [{"k": "allreduce", "n": ["a", "b"], "o": 1, "r": -1,
                   "d": 8, "s": [[2, 3], [4]], "e": None, "j": -1,
                   "fd": []},
                  {"k": "allgather", "n": ["g"], "o": 2, "r": -1, "d": 4,
                   "s": [[3, 2]], "e": None, "j": -1, "fd": [3, 0, 5]},
                  {"k": "error", "n": ["bad"], "o": 2, "r": -1, "d": 0,
                   "s": [], "e": "Mismatched shapes for tensor bad: (4,) "
                   "vs (5,).", "j": -1, "fd": []},
                  {"k": "join", "n": [], "o": 2, "r": -1, "d": 0, "s": [],
                   "e": None, "j": 2, "fd": []}],
         "i": [1, 5], "x": False, "aj": True, "lj": 2},
        {"resp": [], "i": [], "x": True, "aj": False, "lj": -1},
    ]


def test_wire_codec_byte_identical():
    for m in _rank_msgs():
        s = twire.dumps_rank(m)
        assert twire.encode_rank_msg(m) == jwire._py_encode_rank_msg(m)
        assert s == jwire.dumps_rank(m)
        assert jwire.loads_rank(s) == twire.loads_rank(s)
        assert twire.loads_rank(jwire.dumps_rank(m)) == jwire.loads_rank(s)
    for m in _resp_msgs():
        s = twire.dumps_resp(m)
        assert twire.encode_resp_msg(m) == jwire._py_encode_resp_msg(m)
        assert s == jwire.dumps_resp(m)
        assert jwire.loads_resp(s) == twire.loads_resp(s)
    with pytest.raises(ValueError, match="magic"):
        twire.decode_rank_msg(b"P\x00")
    with pytest.raises(ValueError, match="truncated"):
        twire.decode_resp_msg(twire.encode_resp_msg(_resp_msgs()[1])[:-3])


# ---------------------------------------------------------------------------
# 7. KVControllers over DictTransport, round by round
# ---------------------------------------------------------------------------


def _run_round(ctls, args):
    out, errs = [None] * len(ctls), []

    def go(i):
        try:
            out[i] = ctls[i].negotiate(*args[i])
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errs.append(e)

    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(ctls))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts), "a round hung"
    if errs:
        raise errs[0]
    return out


def _result(res):
    return (_wires(res.responses), res.all_joined, res.last_joined,
            res.should_stop)


def _script(world):
    """Rounds of per-rank ``(specs, joined)``."""
    def ar(name, shape=(4, 3), op=1, d=F32):
        return (name, "allreduce", op, d, shape, -1)

    full = [ar(f"grad.{i}", (i + 1, 3)) for i in range(6)] + [
        ("bc", "broadcast", 2, F32, (5,), 1 % world),
        ("rs", "reducescatter", 2, F32, (2 * world, 2), -1)]
    rot = lambda r, xs: xs[r % len(xs):] + xs[:r % len(xs)]  # noqa: E731
    rounds = []
    # cold: every rank, its own order, plus a ragged allgather
    rounds.append([(rot(r, full) + [("ag", "allgather", 2, F32,
                                     (r + 1, 2), -1)], False)
                   for r in range(world)])
    # partial: rank 0 alone, then the rest
    rounds.append([([ar("late")] if r == 0 else [], False)
                   for r in range(world)])
    rounds.append([([] if r == 0 else [ar("late")], False)
                   for r in range(world)])
    # warm: the same set again (the fast path)
    rounds.append([(rot(r + 1, full) + [("ag", "allgather", 2, F32,
                                         (r + 1, 2), -1)], False)
                   for r in range(world)])
    # a shape change everywhere (invalidation) and a mismatch on one rank
    rounds.append([([ar("grad.0", (7, 3)), ar("grad.1", (2, 3)),
                     ar("bad", (3,) if r else (4,))], False)
                   for r in range(world)])
    # join: rank 1 joins, the others reduce once more, then all join
    rounds.append([([ar("after")] if r != 1 else [], r == 1)
                   for r in range(world)])
    rounds.append([([], True) for r in range(world)])
    return rounds


@pytest.mark.parametrize("world", [2, 4])
def test_kv_controllers_match_jax(world):
    jstore, tstore = {}, {}
    jcv, tcv = threading.Condition(), threading.Condition()
    jc = [jctl.KVController(DictTransport(jstore, jcv), r, world, epoch=3)
          for r in range(world)]
    tc = [tctl.KVController(DictTransport(tstore, tcv), r, world, epoch=3)
          for r in range(world)]
    for rnd, per_rank in enumerate(_script(world)):
        jargs = [(_reqs(jctl, s), j, False) for s, j in per_rank]
        targs = [(_reqs(tctl, s), j, False) for s, j in per_rank]
        jres = _run_round(jc, jargs)
        tres = _run_round(tc, targs)
        assert tstore == jstore, f"round {rnd}: posted payloads differ"
        for r in range(world):
            assert _result(tres[r]) == _result(jres[r]), (rnd, r)
        assert [c.fast_rounds for c in tc] == [c.fast_rounds for c in jc]
        if rnd == 3:
            assert all(c.fast_rounds == 1 for c in tc)
            for m in [twire.loads_rank(v) for k, v in tstore.items()
                      if "/q/3/" in k]:
                assert m["req"] == [] and len(m["b"]) == 9
        if rnd == 4:
            kinds = [p.kind for p in tres[0].responses]
            assert kinds[0] == "error" and "Mismatched shapes" in \
                tres[0].responses[0].error
        if rnd == 6:
            assert tres[0].all_joined and tres[0].last_joined == \
                jres[0].last_joined
    assert [c.cache._by_name for c in tc] == [c.cache._by_name for c in jc]


def test_kv_round0_cfg_mismatch_matches_jax(monkeypatch):
    world = 2
    local = threading.local()
    jbase, tbase = jctl.round0_cfg, tctl.round0_cfg

    def skew(base):
        def cfg(*a, **k):
            v = list(base(*a, **k))
            v[1] += getattr(local, "rank", 0)
            return v
        return cfg

    monkeypatch.setattr(jctl, "round0_cfg", skew(jbase))
    monkeypatch.setattr(tctl, "round0_cfg", skew(tbase))
    results = {}
    for mod, key in ((jctl, "jax"), (tctl, "port")):
        store, cv = {}, threading.Condition()
        ctls = [mod.KVController(DictTransport(store, cv), r, world)
                for r in range(world)]

        def neg(c, specs):
            local.rank = c.rank
            return c.negotiate(_reqs(mod, specs), False, False)

        out = [None] * world
        ts = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, neg(ctls[i], [("x", "allreduce", 1, F32, (2,), -1)])))
            for i in range(world)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        results[key] = ([_result(o) for o in out], dict(store))
    assert results["port"] == results["jax"]
    resps, _, _, stop = results["port"][0][0]
    assert stop and resps[0]["k"] == "error" and \
        "HOROVOD_FUSION_THRESHOLD" in resps[0]["e"]


def test_store_transport_over_a_hash_store():
    import torch.distributed as dist

    t = tctl.StoreTransport(epoch=5, store=dist.HashStore())
    assert t.try_get("k") is None
    t.set_once("k", "1")
    t.set_once("k", "2")
    assert t.try_get("k") == "1" and t.get_blocking("k", 1.0) == "1"
    t.set_overwrite("k", "3")
    assert t.get_blocking("k", 1.0) == "3"
    t.delete("k")
    assert t.try_get("k") is None
    with pytest.raises(Exception):
        t.get_blocking("missing", 0.05)
    c = tctl.KVController(t, 1, 2, timeout=0.2)
    with pytest.raises(TimeoutError, match="rank 1, round 0"):
        c.negotiate([], False, False)
