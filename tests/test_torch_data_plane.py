"""The port's two-level (cross, local) reductions and Adasum against the
JAX package, on the CPU.

One spawned gloo world of 4 ranks (``_torch_collectives_worker.
data_plane_main``) runs every case over a ``(cross 2, local 2)`` pair from
``hierarchical_mesh(2)`` with no data mesh, then re-initializes under
``HOROVOD_MESH=dp:4`` with the hierarchical split.  The JAX side runs under
``shard_map`` on a ``("cross", "local")`` mesh of 4 of the 8 CPU devices.

1. ``tests/test_hierarchical.py:52-132``: the two-level allreduce bit for
   bit with the flat sum on integer-valued floats (sizes 16, 10 and 1 for
   the padding), a bf16 2-D tensor, the knob routing ``grouped_allreduce``
   through the two-level transfers (read from a recording wrapper around
   ``torch.distributed``: the port's counterpart of the lowered-program
   check), the rank-major allgather, hierarchical Adasum.
2. ``tests/test_quantization.py:142-200,256-292``: the lossy wire over the
   pair within the reference's bounds (flat: the whole sum rides int8;
   two-level: only the cross hop, bounded by the local partial sums'
   scales), int8 and int4 payloads on the cross groups only, the two-level
   sum and residual against the JAX package's block by block, error
   feedback converging under both.
3. The knob alone: ``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` (and
   ``HOROVOD_HIERARCHICAL_LOCAL_SIZE=2``) without a mesh reduces flat, as
   the reference's ``data_axis()`` does.
4. ``tests/test_collectives.py:147-168``: Adasum against the float64
   ``adasum_reference`` (rtol 1e-4, atol 1e-5) and the JAX package's;
   identical vectors give the vector; fused leaves with per-leaf segments
   (f32, and bf16 computed in f32); every rank's result bit-identical.
5. ZeRO stages 0-3, with and without the overlap schedule, over the pair:
   bit for bit with the flat world on integer gradients, and with the JAX
   package's; int8 and int4 with error feedback at stages 0-2: every rank
   identical, the data mesh's default pair equal to the explicit one.
"""

import os
import sys

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.ops import adasum as jadasum
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.ops import quantization as jq
from horovod_tpu.parallel import mesh as JM

from horovod_tpu_torch.common.util import free_port
from horovod_tpu_torch.ops import adasum as A
from horovod_tpu_torch.parallel import mesh as M

sys.path.insert(0, os.path.dirname(__file__))
from _torch_collectives_worker import (DP_CROSS, DP_LEAVES,  # noqa: E402
                                       DP_LOCAL, HIER_EF_STEPS, HIER_SIZES,
                                       dp_inputs, spawn)
from test_torch_collectives import _f  # noqa: E402
from test_torch_quantization import BLOCK, _hold_blocks  # noqa: E402

N = DP_CROSS * DP_LOCAL
PAIR = ("cross", "local")
SUM, AVG = 2, 1


@pytest.fixture(scope="module")
def world():
    return spawn(N, mode="data_plane", timeout=300, env_extra={
        "HVD_TEST_COORD2": f"127.0.0.1:{free_port()}",
        "HOROVOD_HIERARCHICAL_LOCAL_SIZE": str(DP_LOCAL)})


@pytest.fixture(scope="module")
def hmesh():
    return Mesh(np.array(jax.devices()[:N]).reshape(DP_CROSS, DP_LOCAL),
                PAIR)


@pytest.fixture()
def knob_on(monkeypatch):
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", "1")


def run2d(hmesh, body, *xs, out_specs=P()):
    fn = jax.jit(shard_map(body, mesh=hmesh, check_vma=False,
                           in_specs=(P(PAIR),) * len(xs),
                           out_specs=out_specs))
    return jax.tree_util.tree_map(np.asarray, fn(*map(jnp.asarray, xs)))


def _stack(key):
    return np.stack([dp_inputs(r)[key] for r in range(N)])


# ---------------------------------------------------------------------------
# 1. The two-level allreduce and allgather
# ---------------------------------------------------------------------------


def test_pair_layout(world):
    """Cross groups {0, 2} and {1, 3}, local groups {0, 1} and {2, 3};
    the flat index (and the shard index) is cross-major: the rank."""
    for r, o in enumerate(world):
        c, l_ = divmod(r, DP_LOCAL)
        cross, local, flat, idx, shard = o["pair"]
        assert cross == [l_, DP_LOCAL + l_]
        assert local == [c * DP_LOCAL, c * DP_LOCAL + 1]
        assert flat == list(range(N)) and idx == shard == r


@pytest.mark.parametrize("op", [SUM, AVG])
@pytest.mark.parametrize("size", HIER_SIZES)
def test_hierarchical_allreduce_matches_flat(world, hmesh, op, size):
    x = np.arange(N * size, dtype=np.float32).reshape(N, size) % 7
    expected = x.sum(0) / (N if op == AVG else 1)
    want = run2d(hmesh, lambda b: jcoll.hierarchical_allreduce(
        b[0], "local", "cross", op=op), x)
    np.testing.assert_array_equal(want, expected)
    for o in world:
        np.testing.assert_array_equal(_f(o[f"hier_{size}_{op}"]), expected)
        np.testing.assert_array_equal(_f(o[f"flat_{size}_{op}"]), expected)


def test_hierarchical_allreduce_2d_tensor(world):
    for o in world:
        out, dtype, shape = o["bf16"]
        assert dtype == "torch.bfloat16" and shape == [3, 5]
        np.testing.assert_array_equal(_f(out), np.full((3, 5), 2.0 * N))


def test_knob_routes_grouped_allreduce(world):
    """With the knob on, a pair's grouped allreduce is local
    reduce-scatter -> cross allreduce -> local all-gather, and still
    the flat sum; with it off, one allreduce over both axes."""
    x = np.arange(N * 12, dtype=np.float32).reshape(N, 12) % 5
    for r, o in enumerate(world):
        np.testing.assert_array_equal(_f(o["knob_grouped"]), x.sum(0))
        c, l_ = divmod(r, DP_LOCAL)
        local = [c * DP_LOCAL, c * DP_LOCAL + 1]
        assert [(name, ranks) for name, _, _, ranks in o["knob_calls"]] \
            == [("reduce_scatter_tensor", local),
                ("all_reduce", [l_, DP_LOCAL + l_]),
                ("all_gather_into_tensor", local)]
        assert [(name, ranks) for name, _, _, ranks in o["flat_calls"]] \
            == [("all_reduce", list(range(N)))]


def test_hierarchical_allgather_rank_order(world, hmesh):
    want = run2d(hmesh, lambda b: jcoll.hierarchical_allgather(
        b[0], "local", "cross"),
        np.repeat(np.arange(N, dtype=np.float32)[:, None], 3,
                  axis=1).reshape(N, 1, 3))
    for o in world:
        for key in ("gather", "gather_default"):
            got = _f(o[key])
            np.testing.assert_array_equal(got, np.asarray(want).reshape(N, 3))
            np.testing.assert_array_equal(
                got, np.repeat(np.arange(N, dtype=np.float32)[:, None], 3, 1))


def test_hierarchical_adasum(world, hmesh):
    """Local mean, then Adasum across the cross axis."""
    x = np.random.RandomState(3).randn(N, 32).astype(np.float32)
    means = x.reshape(DP_CROSS, DP_LOCAL, 32).mean(axis=1)
    expected = A.adasum_reference([means[i] for i in range(DP_CROSS)])
    np.testing.assert_array_equal(
        expected, jadasum.adasum_reference([means[i]
                                            for i in range(DP_CROSS)]))
    want = run2d(hmesh, lambda b: jcoll.allreduce(
        b[0], axis_name=PAIR, op=jcoll.Adasum), x)
    for o in world:
        got = _f(o["hier_adasum"])
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got, _f(world[0]["hier_adasum"]))


# ---------------------------------------------------------------------------
# 2. The lossy wire over the pair
# ---------------------------------------------------------------------------


def _cross_scales(x, qmax):
    """The cross hop's shared scales, float32 true division, per block
    of the output (local shard ``l`` covers elements ``[l*L, (l+1)*L)``):
    the local partial sums' block absmax, max over the cross axis."""
    parts = x.reshape(DP_CROSS, DP_LOCAL, -1).sum(1)     # (nc, total)
    blockmax = np.abs(parts).max(0).reshape(-1, BLOCK).max(1)
    return (blockmax.astype(np.float32) / np.float32(qmax)).astype(
        np.float32)


@pytest.mark.parametrize("hier", [False, True])
def test_hierarchical_quantized_matches_flat_psum(world, hier):
    """Flat (the whole 4-rank sum rides int8) and two-level (only the
    cross hop, bounded from the local partial sums' scales) within the
    reference's bounds of the exact average."""
    x = _stack("q")
    for o in world:
        out, exact = _f(o[f"q_avg_{hier}"]), _f(o["q_exact"])
        np.testing.assert_allclose(exact, x.astype(np.float64).mean(0),
                                   rtol=1e-6, atol=1e-6)
        if hier:
            scale = _cross_scales(x, 127 // DP_CROSS)
            bound = np.repeat(DP_CROSS * scale / 2, BLOCK) / N + 1e-6
        else:
            absmax = np.abs(x).max(0).reshape(-1, BLOCK).max(1)
            bound = np.repeat(N * absmax / (127 // N) / 2, BLOCK) / N + 1e-6
        err = np.abs(out - exact)
        assert (err <= bound).all(), (err.max(), bound.max())


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_lossy_payload_on_cross_groups_only(world, mode):
    """Under the knob the payload rides the cross groups only (int8, or
    packed int4 bytes as int8), every local transfer is float32, and the
    only float32 traffic on a cross group is the per-block scale max;
    without the knob the whole sum rides the world group."""
    total = dp_inputs(0)["q"].size
    for r, o in enumerate(world):
        c, l_ = divmod(r, DP_LOCAL)
        cross = [l_, DP_LOCAL + l_]
        for name, dtype, numel, ranks in o[f"q_{mode}_True_calls"]:
            if ranks == cross:
                assert dtype == "torch.int8" or (
                    dtype == "torch.float32" and name == "all_reduce"
                    and numel <= total // DP_LOCAL // BLOCK), \
                    (name, dtype, numel)
            else:
                assert ranks == [c * DP_LOCAL, c * DP_LOCAL + 1]
                assert dtype == "torch.float32", (name, dtype)
        ints = [x for x in o[f"q_{mode}_True_calls"] if x[1] == "torch.int8"]
        assert ints and all(x[3] == cross for x in ints)
        flat = o[f"q_{mode}_False_calls"]
        assert [x[1] for x in flat] == ["torch.float32", "torch.int8"]
        assert all(x[3] == list(range(N)) for x in flat)
        np.testing.assert_array_equal(_f(o["mesh_q"]),
                                      _f(o["q_int8_True"][0]))
        assert o["mesh_q_calls"] == o["q_int8_True_calls"][:4]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_hierarchical_quantized_matches_jax(world, hmesh, knob_on, mode):
    """The two-level Sum and residual against the JAX package's block by
    block: bit for bit where the shared scale agrees, one scale where
    XLA's ``x/c -> x*(1/c)`` rewrite moved it; the residual (gathered
    over the local axis and divided by ``nl``) to two ulps."""
    x = _stack("q")
    qmax = 127 // DP_CROSS if mode == "int8" else 7 // DP_CROSS
    want, werr = run2d(hmesh, lambda b: jcoll.quantized_allreduce(
        b[0], axis_name=PAIR, op=jcoll.Sum, with_error=True, mode=mode),
        x, out_specs=(P(), P(PAIR)))
    werr = werr.reshape(N, -1)
    parts = x.reshape(DP_CROSS, DP_LOCAL, -1).sum(1)

    def jax_scale(b):
        part = lax.psum_scatter(b[0], "local", scatter_dimension=0,
                                tiled=True)
        return lax.pmax(jq.block_absmax(jq._to_blocks(part, BLOCK)[0]),
                        "cross") / qmax

    jax_s = run2d(hmesh, jax_scale, x, out_specs=P("local")).reshape(-1)
    port_s = _cross_scales(x, qmax)
    assert np.abs(want - parts.sum(0)).max() <= DP_CROSS * port_s.max()
    moved = [0, 0]
    for r, o in enumerate(world):
        got, err = o[f"q_{mode}_True"]
        _hold_blocks(got, want, port_s, jax_s, f"{mode} sum rank {r}", moved)
        _hold_blocks(err, werr[r], port_s, jax_s, f"{mode} residual {r}",
                     moved, qmax)
        bound = np.repeat(DP_CROSS * port_s.astype(np.float64) / 2, BLOCK)
        assert (np.abs(_f(got) - x.astype(np.float64).sum(0))
                <= bound + 1e-5).all()


@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
@pytest.mark.parametrize("hier", [False, True])
def test_reducescatter_over_the_pair(world, mode, hier):
    """Rank r gets segment r (cross-major) of the sum: dense within the
    sum's rounding, lossy within the bound of its wire (two-level: the
    cross hop's, from the local partial sums)."""
    x = _stack("qr")                               # (N, 8, 300)
    exact = x.astype(np.float64).sum(0).reshape(N, -1)
    amax = np.abs(x).max()
    if mode == "none":
        bound = 1e-5
    elif hier:
        q = (127 if mode == "int8" else 7) // DP_CROSS
        bound = DP_CROSS * (DP_LOCAL * amax / q) / 2 + 1e-5
    else:
        q = (127 if mode == "int8" else 7) // N
        bound = N * (amax / q) / 2 + 1e-5
    for r, o in enumerate(world):
        got = _f(o[f"rs_{mode}_{hier}"]).reshape(-1)
        assert np.abs(got - exact[r]).max() <= bound


@pytest.mark.parametrize("hier", [False, True])
def test_error_feedback_convergence(world, hier):
    """On a fixed per-rank gradient the running mean of the
    error-compensated reduction converges to the exact mean (the
    reference measured ~30x over 24 steps; >5x required)."""
    exact = _stack("ef").astype(np.float64).mean(0)
    for o in world:
        acc, errs = np.zeros(exact.shape), []
        for i, step in enumerate(o[f"ef_{hier}"]):
            acc += _f(step)
            errs.append(np.abs(acc / (i + 1) - exact).max())
        assert len(errs) == HIER_EF_STEPS
        assert errs[-1] < errs[0] / 5, (errs[0], errs[-1])


# ---------------------------------------------------------------------------
# 3. The knob alone
# ---------------------------------------------------------------------------


def test_knob_alone_reduces_flat(world, monkeypatch):
    """``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` with a local size but no mesh:
    the default axis is the flat world in both packages, and the int8
    sum equals the flat one bit for bit, not the two-level one."""
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", "1")
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_LOCAL_SIZE", str(DP_LOCAL))
    monkeypatch.delenv("HOROVOD_MESH", raising=False)
    assert JM.resolve_axis() == M.resolve_axis() == "hvd"
    for o in world:
        assert o["alone_axis"] == "hvd"
        np.testing.assert_array_equal(_f(o["alone"]), _f(o["alone_world"]))
        assert not np.array_equal(_f(o["alone"]), _f(o["alone_pair"]))
        assert o["mesh_axis"] == ["dpc", "dpl"]


# ---------------------------------------------------------------------------
# 4. Adasum
# ---------------------------------------------------------------------------


def test_adasum_matches_numpy_reference(world):
    per_rank = np.random.RandomState(0).randn(N, 32).astype(np.float32)
    expected = A.adasum_reference([per_rank[i] for i in range(N)])
    mesh = Mesh(np.array(jax.devices()[:N]), ("hvd",))
    want = np.asarray(jax.jit(shard_map(
        lambda b: jcoll.allreduce(b[0], axis_name="hvd", op=jcoll.Adasum),
        mesh=mesh, check_vma=False, in_specs=P("hvd"), out_specs=P()))(
            jnp.asarray(per_rank)))
    for o in world:
        got = _f(o["adasum"])
        np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_adasum_identical_vectors_behaves_like_average(world):
    for o in world:
        np.testing.assert_allclose(_f(o["adasum_same"]), np.full(16, 3.0),
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("pair", [False, True], ids=["flat", "pair"])
def test_adasum_fused_leaves(world, dtype, pair):
    """One fused buffer, per-leaf segments: each leaf is the Adasum of
    that leaf alone (rtol 1e-4, atol 1e-5 x the leaf's largest
    magnitude; bf16, rounded to bf16 at each level, within 2^-7 of the
    value and of the leaf's largest magnitude: an element is rounded at
    the magnitude of its level's partial sum, not its own)."""
    import torch

    leaves = [[torch.from_numpy(a).to(getattr(torch, dtype[6:])).float()
               .numpy() for a in dp_inputs(r)["leaves"]] for r in range(N)]
    key = f"adasum_leaves_{'pair_' if pair else ''}{dtype}"
    rtol, atol = (1e-4, 1e-5) if dtype == "torch.float32" else (2.0 ** -7,
                                                                  2.0 ** -7)
    for i, shape in enumerate(DP_LEAVES):
        per = [leaves[r][i] for r in range(N)]
        if pair:
            means = np.stack(per).reshape(DP_CROSS, DP_LOCAL, -1).mean(1)
            want = A.adasum_reference(list(means)).reshape(shape)
        else:
            want = A.adasum_reference(per)
        scale = np.abs(want).max()
        for o in world:
            np.testing.assert_allclose(_f(o[key][i]), want, rtol=rtol,
                                       atol=atol * scale)


def test_adasum_bit_identical_across_ranks(world):
    """Both partners of every level compute with the lower index's
    vector as ``a``: every rank holds the same bits."""
    keys = ["adasum", "adasum_same", "hier_adasum", "adasum_opt"] + [
        f"adasum_leaves_{p}{d}" for p in ("", "pair_")
        for d in ("torch.float32", "torch.bfloat16")]
    for key in keys:
        for o in world[1:]:
            assert o[key] == world[0][key], key


def test_adasum_optimizer_step(world):
    """``DistributedOptimizer(op=Adasum)`` at stage 0: one fused momentum
    step applies ``-lr`` times the per-leaf Adasum of the gradients."""
    for i, shape in enumerate(DP_LEAVES):
        init = np.linspace(-1, 1, int(np.prod(shape)),
                           dtype=np.float32).reshape(shape)
        g = A.adasum_reference([dp_inputs(r)["leaves"][i] for r in range(N)])
        np.testing.assert_allclose(_f(world[0]["adasum_opt"][i]),
                                   init - 0.5 * g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max())


# ---------------------------------------------------------------------------
# 5. ZeRO over the pair
# ---------------------------------------------------------------------------


def _jax_zero_pair(hmesh, grads_by_rank):
    """The JAX package's fused-momentum runs at stages 0-3 x overlap over
    the ``("cross", "local")`` pair, knob on, on the same gradients."""
    from horovod_tpu.optim import distributed as JD

    names = [f"l{i}" for i in range(len(DP_LEAVES))]
    init = {k: jnp.asarray(np.linspace(-1, 1, int(np.prod(s)),
                                       dtype=np.float32).reshape(s))
            for k, s in zip(names, DP_LEAVES)}
    configs = [(st, ov) for st in (0, 1, 2, 3) for ov in (False, True)]
    stacked = [np.stack([np.stack([grads_by_rank[r][s][i] for s in range(3)])
                         for r in range(N)]) for i in range(len(names))]

    def body(*gs):
        gs = [g[0] for g in gs]
        outs = []
        for st, ov in configs:
            opt = jhvd.DistributedOptimizer(
                optax.sgd(0.5, momentum=0.5), axis_name=PAIR, zero_stage=st,
                overlap=ov)
            if st == 3:
                zp = JD.zero3_shard_params(init, axis_name=PAIR)
                state = opt.init(zp)
                for s in range(3):
                    def loss(z):
                        full = JD.zero3_full_params(z, axis_name=PAIR)
                        return sum(jnp.sum(full[k] * gs[i][s])
                                   for i, k in enumerate(names))
                    upd, state = opt.update(jax.grad(loss)(zp), state, zp)
                    zp = optax.apply_updates(zp, upd)
                full = JD.zero3_full_params(zp, axis_name=PAIR)
                outs.append(tuple(full[k] for k in names))
                continue
            p, state = init, opt.init(init)
            for s in range(3):
                upd, state = opt.update({k: gs[i][s]
                                         for i, k in enumerate(names)},
                                        state, p)
                p = optax.apply_updates(p, upd)
            outs.append(tuple(p[k] for k in names))
        return tuple(outs)

    res = run2d(hmesh, body, *stacked)
    return dict(zip(configs, res))


def test_zero_over_the_pair_matches_flat_and_jax(world, hmesh, knob_on):
    grads = [[[dp_inputs(r)["zint"][i] * (s + 1)
               for i in range(len(DP_LEAVES))] for s in range(3)]
             for r in range(N)]
    want = _jax_zero_pair(hmesh, grads)
    for (st, ov), ws in want.items():
        for r, o in enumerate(world):
            for i, w in enumerate(ws):
                what = f"stage {st} overlap {ov} rank {r} leaf {i}"
                got = _f(o[f"zero_pair_{st}_{ov}"][i])
                np.testing.assert_array_equal(
                    got, _f(o[f"zero_flat_{st}_{ov}"][i]), err_msg=what)
                np.testing.assert_array_equal(got, np.asarray(w),
                                              err_msg=what)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_zero_over_the_pair_lossy(world, stage, mode):
    """int8/int4 with error feedback over the pair (the cross hop lossy):
    every rank identical, a residual kept, the run near the dense one;
    the data mesh's default (dpc, dpl) equals the explicit pair."""
    q = (127 if mode == "int8" else 7) // DP_CROSS
    # three steps of momentum 0.5 at lr 0.5: each step's averaged
    # gradient is off by at most two cross-hop half-scales (this step's
    # error and last step's residual), the scale at most nl * 12 + the
    # residual over q
    bound = 3 * 0.5 / (1 - 0.5) * 2 * DP_CROSS * (DP_LOCAL * 12 + 1) / q \
        / 2 / N
    for o in world:
        ws, res = o[f"zero_{mode}_{stage}"]
        assert ws == world[0][f"zero_{mode}_{stage}"][0]
        assert np.any(np.concatenate([_f(x).reshape(-1) for x in (
            res if stage == 0 else [res])]))
        for got, dense in zip(ws, o["zero_flat_0_False"]):
            assert np.abs(_f(got) - _f(dense)).max() <= bound
        if mode == "int8" and stage in (0, 2):
            assert o[f"mesh_zero_{stage}"] == ws
