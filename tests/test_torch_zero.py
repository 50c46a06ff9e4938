"""ZeRO stages 1-3 of the port's ``DistributedOptimizer`` against the JAX
package's, on the CPU.

1. Stage resolution and the refusals (``tests/test_zero23.py:111-146``);
   Adasum, refused at stages 1-3, runs at stage 0.
2. The span-wise helpers (``fuse_span``, ``fuse_bucket_piece``,
   ``leaf_from_buckets``) against the reference's on the same leaves,
   bit for bit.
3. ``fused_update_groups`` against the JAX package's (its jnp twin, run
   op by op) at steps 1 and 3: bit for bit in float32.
4. On spawned gloo worlds of 2 and 4 ranks (``_torch_collectives_worker.
   zero_main``) against the JAX package's ``DistributedOptimizer(
   zero_stage=k)`` under ``shard_map`` on n of the 8 CPU devices, on the
   same leaf list (whose sorted names keep both packages' leaf order):
   - stages 1, 2 and 3, plain SGD, momentum and Adam, with and without
     the fused tail, three steps: on integer-valued data with dyadic
     hyperparameters SGD and momentum bit for bit (every operation
     exact); Adam (square root, division), and everything on random
     data, within rtol 2e-5 / atol 1e-7 (``test_zero23.py:268``);
   - per-rank optimizer-state bytes: a 1/n shard of the padded buffer;
   - int8 with error feedback at stages 1 and 2, five steps of fixed
     gradients: both packages within 2.5 one-step quantization bounds of
     the exact trajectory (the telescoping residual,
     ``test_zero23.py:338``);
   - two backward passes per update at stage 1: bit for bit;
   - at two ranks, a small ResNet (``tests/test_torch_resnet.py``'s
     config) trained 2 steps through ``zero3_train_step`` against the
     port's stage 0 in float32: rtol 2e-5;
   - at two ranks, the JAX package's stage-1 state after two steps
     carried over (``interop.sharded_state_from_jax``), then one more step
     on each side: rtol 2e-5.
5. ``broadcast_parameters`` refusing ``Zero3Params``, and the stage-3
   interop round trip.
"""

import os
import pickle
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.ops import overlap as jovl
from horovod_tpu.optim import distributed as JD
from horovod_tpu.optim import fused_update as JF

import horovod_tpu_torch as hvd
from horovod_tpu_torch import interop
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops import overlap as O
from horovod_tpu_torch.optim import distributed as D
from horovod_tpu_torch.optim import fused_update as TF

sys.path.insert(0, os.path.dirname(__file__))
from _torch_collectives_worker import (EF_LEN, EF_LR,  # noqa: E402
                                       EF_STEPS, ZERO_HYPER, ZERO_KINDS,
                                       ZERO_LEAVES, ZERO_STEPS, ef_grad,
                                       small_resnet,
                                       spawn, zero_inputs)
from test_torch_collectives import _f  # noqa: E402
from test_torch_quantization import _mesh, _run  # noqa: E402

NAMES = [name for name, _ in ZERO_LEAVES]


# ---------------------------------------------------------------------------
# 1. Stage resolution and refusals
# ---------------------------------------------------------------------------


def test_stage_resolution_explicit_and_knob(monkeypatch):
    for zs, sh in ((2, None), (None, True), (None, False), (3, True)):
        assert D._resolve_zero_stage(zs, sh) == \
            JD._resolve_zero_stage(zs, sh)
    assert D._resolve_zero_stage(2, None) == 2
    assert D._resolve_zero_stage(None, True) == 1
    assert D._resolve_zero_stage(None, False) == 0
    assert D._resolve_zero_stage(3, True) == 3
    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "2")
    assert D._resolve_zero_stage(None, None) == 2
    assert D._resolve_zero_stage(None, True) == 1
    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "0")
    monkeypatch.setenv("HOROVOD_SHARDED_OPTIMIZER", "1")
    assert D._resolve_zero_stage(None, None) == 1
    assert JD._resolve_zero_stage(None, None) == 1


def test_stage_resolution_rejects_bad_values(monkeypatch):
    with pytest.raises(HorovodTpuError, match="zero_stage"):
        D._resolve_zero_stage(4, None)
    with pytest.raises(HorovodTpuError, match="conflicting"):
        D._resolve_zero_stage(2, False)
    with pytest.raises(HorovodTpuError, match="conflicting"):
        D._resolve_zero_stage(0, True)
    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "5")
    with pytest.raises(HorovodTpuError, match="HOROVOD_ZERO_STAGE"):
        D._resolve_zero_stage(None, None)


@pytest.fixture()
def world1(monkeypatch):
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_refusals(world1):
    w = torch.nn.Parameter(torch.zeros(4))
    with pytest.raises(HorovodTpuError, match="Adasum"):
        hvd.DistributedOptimizer(TF.sgd([w], 0.1), op=hvd.Adasum,
                                 zero_stage=2)
    # Adasum runs at stage 0: at a world of one it equals Average
    outs = []
    for op in (hvd.Adasum, hvd.Average):
        p = torch.nn.Parameter(torch.arange(4, dtype=torch.float32))
        opt = hvd.DistributedOptimizer(TF.sgd([p], 0.5, 0.5), op=op)
        for _ in range(2):
            p.grad = torch.tensor([1.0, -2.0, 3.0, 0.25])
            opt.step()
        outs.append(p.detach())
    assert torch.equal(outs[0], outs[1])
    zp = hvd.zero3_shard_params([("w", torch.zeros(5))])
    with pytest.raises(HorovodTpuError, match="backward_passes"):
        hvd.DistributedOptimizer(TF.sgd(zp.shards, 0.1), zero_stage=3,
                                 backward_passes_per_step=3)
    # a stage-3 optimizer given the full parameters
    with pytest.raises(HorovodTpuError, match="shard-resident"):
        hvd.DistributedOptimizer(TF.sgd([w], 0.1), zero_stage=3)
    with pytest.raises(HorovodTpuError, match="zero_stage"):
        hvd.DistributedOptimizer(TF.sgd([w], 0.1), zero_stage=4)
    with pytest.raises(HorovodTpuError, match="conflicting"):
        hvd.DistributedOptimizer(TF.sgd([w], 0.1), zero_stage=0,
                                 sharded=True)
    v = torch.nn.Parameter(torch.zeros(3))
    two = torch.optim.SGD([{"params": [w]}, {"params": [v], "lr": 0.5}],
                          lr=0.1)
    with pytest.raises(HorovodTpuError, match="one set of hyperparameters"):
        hvd.DistributedOptimizer(two, zero_stage=1)
    with pytest.raises(HorovodTpuError, match="synchronize"):
        hvd.DistributedOptimizer(TF.sgd([w], 0.1), zero_stage=1).synchronize()


def test_broadcast_refuses_stage3_params(world1):
    model = small_resnet("cpu")
    zp = hvd.zero3_shard_params(model)
    assert all(p.numel() == 0 for p in model.parameters())
    with pytest.raises(HorovodTpuError, match="Zero3Params"):
        hvd.broadcast_parameters(zp)
    with pytest.raises(HorovodTpuError, match="Zero3Params"):
        hvd.broadcast_parameters(zp.shards)
    with pytest.raises(HorovodTpuError, match="Zero3Params"):
        hvd.broadcast_skipping_shards(zp)
    # the shard-local state of a stage-3 optimizer is not broadcast
    opt = hvd.DistributedOptimizer(TF.sgd(zp.shards, 0.1, 0.9), zero_stage=3)
    trace = opt.optimizer.state[zp.shards[0]]["trace"]
    trace.fill_(3.0)
    hvd.broadcast_optimizer_state(opt)
    assert bool((trace == 3.0).all())


def test_torch_optimizer_runs_on_shards(world1):
    """An unfused ``torch.optim`` optimizer runs as an instance of its
    own class over the flat shard: at a world of one, the weights of
    stage 0, 1 and 2 agree bit for bit, and stage 1 keeps its state as
    one flat shard."""
    g = torch.randn(7, 5)
    out, states = [], []
    for stage in (0, 1, 2):
        torch.manual_seed(0)
        ws = [torch.nn.Parameter(torch.randn(7, 5)),
              torch.nn.Parameter(torch.randn(3))]
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(ws, lr=0.1, momentum=0.9, weight_decay=1e-2),
            zero_stage=stage)
        for _ in range(3):
            ws[0].grad, ws[1].grad = g.clone(), torch.ones(3)
            opt.step()
        out.append([w.detach().clone() for w in ws])
        states.append(opt.state_bytes())
    for ws in out[1:]:
        for a, b in zip(ws, out[0]):
            assert torch.equal(a, b)
    assert states == [38 * 4] * 3


# ---------------------------------------------------------------------------
# 2. The span-wise helpers against the reference's
# ---------------------------------------------------------------------------


def _helper_leaves():
    rng = np.random.default_rng(1)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((7,), (2, 3), (5,), (1,))]


@pytest.mark.parametrize("start,end", [(0, 22), (3, 9), (6, 7), (14, 16),
                                       (11, 13), (19, 22), (18, 19)])
def test_fuse_span_matches_reference(start, end):
    leaves = _helper_leaves()
    idxs, sizes = (0, 1, 2, 3), (7, 6, 5, 1)
    want = jcoll.fuse_span([jnp.asarray(a) for a in leaves], idxs, sizes,
                           start, end, jnp.float32)
    got = C.fuse_span([torch.from_numpy(a) for a in leaves], idxs, sizes,
                      start, end, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,chunks", [(1, 4), (2, 3), (4, 4), (4, 2)])
def test_bucket_pieces_and_leaves_match_reference(n, chunks):
    leaves = _helper_leaves()
    idxs, sizes = (0, 1, 2, 3), (7, 6, 5, 1)
    padded = 19 + (-19) % n
    L = padded // n
    bounds = O.bucket_bounds(L, chunks)
    assert bounds == jovl.bucket_bounds(L, chunks)
    res = np.arange(padded, dtype=np.float32) / 8
    jl = [jnp.asarray(a) for a in leaves]
    tl = [torch.from_numpy(a) for a in leaves]
    jres, tres = jnp.asarray(res), torch.from_numpy(res)
    jp, tp = [], []
    for s, e in bounds:
        jp.append(jcoll.fuse_bucket_piece(
            jl, idxs, sizes, padded, n, s, e, jnp.float32,
            inject=lambda lo, hi: jres[lo:hi]))
        tp.append(C.fuse_bucket_piece(
            tl, idxs, sizes, padded, n, s, e, torch.float32,
            inject=lambda lo, hi: tres[lo:hi]))
        np.testing.assert_array_equal(tp[-1].numpy(), np.asarray(jp[-1]))
    off = 0
    for i, sz in zip(idxs, sizes):
        want = jcoll.leaf_from_buckets(jp, bounds, n, L, off, sz)
        got = C.leaf_from_buckets(tp, bounds, n, L, off, sz)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), leaves[i].reshape(-1)
                                      + res[off:off + sz])
        off += sz


# ---------------------------------------------------------------------------
# 3. fused_update_groups against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ZERO_KINDS)
def test_fused_update_groups_matches_reference(monkeypatch, kind):
    monkeypatch.setenv("HOROVOD_QUANT_PALLAS", "0")
    h = ZERO_HYPER["random"]
    jopt = (JF.adam(h["lr"], b1=h["b1"], b2=h["b2"], eps=h["eps"])
            if kind == "adam" else
            JF.sgd(h["lr"], momentum=h["momentum"] if kind == "momentum"
                   else None))
    spec = TF.FusedSpec(kind, h["lr"], h["momentum"] if kind == "momentum"
                        else 0.0, h["b1"], h["b2"], h["eps"])
    rng = np.random.default_rng(4)
    base = [rng.standard_normal(n).astype(np.float32) for n in (1000, 257)]
    raws = [[3 * b + step for b in base] for step in range(3)]
    jstate = jopt.init([jnp.asarray(b) for b in base])
    tstate = TF.init_group_state(spec, [torch.from_numpy(b) for b in base])
    for step, raw in enumerate(raws):
        ju, jstate = JF.fused_update_groups(
            jopt.fused_spec, [jnp.asarray(r) for r in raw], jstate, 2,
            [jnp.float32] * 2)
        tu = TF.fused_update_groups(spec, [torch.from_numpy(r) for r in raw],
                                    tstate, 2, [torch.float32] * 2)
        if step in (0, 2):
            for a, b in zip(tu, ju):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    leaves = jax.tree_util.tree_leaves(jstate)
    if kind == "momentum":
        for st, t in zip(tstate, leaves):
            np.testing.assert_array_equal(st["trace"].numpy(), np.asarray(t))
    elif kind == "adam":
        assert all(st["count"] == 3 == int(leaves[0]) for st in tstate)
        for i, st in enumerate(tstate):
            np.testing.assert_array_equal(st["mu"].numpy(),
                                          np.asarray(leaves[1 + i]))
            np.testing.assert_array_equal(st["nu"].numpy(),
                                          np.asarray(leaves[3 + i]))
    assert TF.LAUNCHES == {"sgd": 0, "momentum": 0, "adam": 0}


# ---------------------------------------------------------------------------
# 4. Worlds of 2 and 4 against the JAX package under shard_map
# ---------------------------------------------------------------------------


def _optax(kind: str, h: dict):
    if kind == "adam":
        return optax.adam(h["lr"], b1=h["b1"], b2=h["b2"], eps=h["eps"])
    return optax.sgd(h["lr"], momentum=h["momentum"] if kind == "momentum"
                     else None)


def _jax_stages(n: int, kind: str, data: str):
    """The JAX package's weights after ``ZERO_STEPS`` steps at stages 1, 2
    and 3 (rank 0's, leaf by leaf)."""
    h = ZERO_HYPER[data]
    init, _ = zero_inputs(0, n, data)
    params = {name: jnp.asarray(a) for name, a in zip(NAMES, init)}
    grads = [zero_inputs(r, n, data)[1] for r in range(n)]
    stacked = [np.stack([[grads[r][s][i] for s in range(len(grads[0]))]
                         for r in range(n)]) for i in range(len(NAMES))]
    opts = {s: jhvd.DistributedOptimizer(_optax(kind, h), axis_name="hvd",
                                         zero_stage=s) for s in (1, 2, 3)}

    def body(*gs):
        gs = [g[0] for g in gs]                    # (steps, *leaf)
        out = []
        for s in (1, 2):
            p, st = params, opts[s].init(params)
            for step in range(gs[0].shape[0]):
                g = {k: gs[i][step] for i, k in enumerate(NAMES)}
                upd, st = opts[s].update(g, st, p)
                p = optax.apply_updates(p, upd)
            out.append(tuple(p[k] for k in NAMES))
        zp = JD.zero3_shard_params(params, axis_name="hvd")
        st = opts[3].init(zp)
        for step in range(gs[0].shape[0]):
            def loss(z):
                full = JD.zero3_full_params(z, axis_name="hvd")
                return sum(jnp.sum(full[k] * gs[i][step])
                           for i, k in enumerate(NAMES))
            upd, st = opts[3].update(jax.grad(loss)(zp), st, zp)
            zp = optax.apply_updates(zp, upd)
        full = JD.zero3_full_params(zp, axis_name="hvd")
        out.append(tuple(full[k] for k in NAMES))
        return tuple(tuple(x[None] for x in o) for o in out)

    res = _run(n, body, *stacked, out_specs=P("hvd"))
    for o in res:                       # every rank holds the same weights
        for x in o:
            assert np.ptp(np.asarray(x), axis=0).max() == 0.0
    return {s: [np.asarray(x)[0] for x in o] for s, o in zip((1, 2, 3), res)}


def _interop_inputs(tmp_path):
    """The JAX package's stage-1 momentum SGD over the small ResNet's
    flax-layout weights at two ranks: weights and state after two steps
    (saved for the port ranks), and weights after a third."""
    n = 2
    model = small_resnet("cpu")
    params, bstats = interop.cnn_to_flax(model)
    rng = np.random.default_rng(9)
    grads = [[jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32),
        params) for _ in range(n)] for _ in range(3)]
    opt = jhvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9),
                                    axis_name="hvd", zero_stage=1)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    def body(g1, g2, g3):
        strip = lambda g: jax.tree_util.tree_map(lambda x: x[0], g)  # noqa
        p, st = jparams, opt.init(jparams)
        for g in (g1, g2):
            upd, st = opt.update(strip(g), st, p)
            p = optax.apply_updates(p, upd)
        p2, inner = p, st.inner_state
        upd, st = opt.update(strip(g3), st, p)
        return p2, inner, optax.apply_updates(p, upd)

    stack = [jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)), *gs)
             for gs in grads]
    fn = jax.jit(jax.shard_map(body, mesh=_mesh(n), check_vma=False,
                               in_specs=(P("hvd"),) * 3,
                               out_specs=(P(), P("hvd"), P())))
    p2, inner, p3 = jax.tree_util.tree_map(np.asarray, fn(*stack))
    layout = JD._shard_layout(jax.tree_util.tree_leaves(jparams), n)
    path = tmp_path / "jax_stage1.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": p2, "batch_stats": bstats,
                     "state": {"trace": jax.tree_util.tree_leaves(inner)},
                     "layout": {"idxs": layout.idxs, "sizes": layout.sizes},
                     "grads": grads[2]}, f)
    return str(path), p3


@pytest.fixture(scope="module", params=[2, 4], ids=["np2", "np4"])
def world(request, tmp_path_factory):
    n = request.param
    env, p3 = {}, None
    if n == 2:
        path, p3 = _interop_inputs(tmp_path_factory.mktemp("interop"))
        env["HVD_TEST_INTEROP"] = path
    outs = spawn(n, mode="zero", env_extra=env, timeout=300)
    return n, outs, p3


@pytest.mark.parametrize("data", sorted(ZERO_HYPER))
@pytest.mark.parametrize("kind", ZERO_KINDS)
def test_stages_match_jax(world, kind, data):
    n, outs, _ = world
    want = _jax_stages(n, kind, data)
    exact = data == "dyadic" and kind != "adam"
    for stage in (1, 2, 3):
        for fused in ("0", "1"):
            for r, o in enumerate(outs):
                for name, got, w in zip(NAMES, o[f"{kind}_{stage}_{fused}_"
                                                 f"{data}"], want[stage]):
                    what = f"{kind} stage {stage} fused {fused} rank {r} " \
                        f"{name}"
                    got = _f(got).reshape(w.shape)
                    if exact:
                        np.testing.assert_array_equal(got, w, err_msg=what)
                    else:
                        np.testing.assert_allclose(got, w, rtol=2e-5,
                                                   atol=1e-7, err_msg=what)


@pytest.mark.parametrize("data", sorted(ZERO_HYPER))
@pytest.mark.parametrize("kind", ZERO_KINDS)
def test_stages_match_stage0(world, kind, data):
    """The port's stages 1-3 against its own stage 0: bit for bit where
    every operation is exact (SGD and momentum, dyadic), else within
    rtol 2e-5 / atol 1e-7."""
    n, outs, _ = world
    exact = data == "dyadic" and kind != "adam"
    for o in outs:
        for fused in ("0", "1"):
            base = o[f"{kind}_0_{fused}_{data}"]
            for stage in (1, 2, 3):
                for got, want in zip(o[f"{kind}_{stage}_{fused}_{data}"],
                                     base):
                    if exact:
                        np.testing.assert_array_equal(_f(got), _f(want))
                    else:
                        np.testing.assert_allclose(_f(got), _f(want),
                                                   rtol=2e-5, atol=1e-7)


def test_stage3_int8_backward_is_bounded(world):
    """Stage 3 with ``zero3_full_params(compression=int8)``: the
    backward's bucketed scatter rides the int8 wire without feedback,
    so each step's averaged gradient sits within half a shared scale of
    the exact one; both packages within three steps of that of the dense
    trajectory."""
    n, outs, _ = world
    h = ZERO_HYPER["random"]
    init, _ = zero_inputs(0, n, "random")
    params = {k: jnp.asarray(a) for k, a in zip(NAMES, init)}
    grads = [zero_inputs(r, n, "random")[1] for r in range(n)]
    stacked = [np.stack([[grads[r][s][i] for s in range(ZERO_STEPS)]
                         for r in range(n)]) for i in range(len(NAMES))]
    gmax = max(np.abs(x).max() for x in stacked)
    bound = ZERO_STEPS * h["lr"] * gmax / (127 // n) / 2 + 1e-6

    def body(*gs):
        outs = []
        for comp in (jhvd.Compression.int8, jhvd.Compression.none):
            opt = jhvd.DistributedOptimizer(optax.sgd(h["lr"]),
                                            axis_name="hvd", zero_stage=3)
            zp = JD.zero3_shard_params(params, axis_name="hvd")
            st = opt.init(zp)
            for step in range(ZERO_STEPS):
                def loss(z):
                    full = JD.zero3_full_params(z, axis_name="hvd",
                                                compression=comp)
                    return sum(jnp.sum(full[k] * gs[i][0][step])
                               for i, k in enumerate(NAMES))
                upd, st = opt.update(jax.grad(loss)(zp), st, zp)
                zp = optax.apply_updates(zp, upd)
            full = JD.zero3_full_params(zp, axis_name="hvd")
            outs.append(tuple(full[k] for k in NAMES))
        return tuple(outs)

    want, dense = _run(n, body, *stacked)
    for w, d in zip(want, dense):
        assert np.abs(np.asarray(w) - np.asarray(d)).max() <= bound
    for o in outs:
        for got, w, d in zip(o["zero3_int8"], want, dense):
            got = _f(got).reshape(np.shape(d))
            assert np.isfinite(got).all()
            assert np.abs(got - np.asarray(d)).max() <= bound
            assert np.abs(got - np.asarray(w)).max() <= 2 * bound
        assert any(not np.array_equal(_f(g).reshape(np.shape(d)),
                                      np.asarray(d))
                   for g, d in zip(o["zero3_int8"], dense))


def test_state_is_a_shard(world):
    n, outs, _ = world
    total = sum(int(np.prod(s)) for _, s in ZERO_LEAVES)
    L = (total + (-total) % n) // n
    per = {"sgd": 0, "momentum": 4 * L, "adam": 8 * L}
    for o in outs:
        for kind in ZERO_KINDS:
            for stage in (1, 2):
                for fused in ("0", "1"):
                    assert o[f"bytes_{kind}_{stage}_{fused}"] == per[kind]


def _jax_ef(n: int, stage: int):
    opt = jhvd.DistributedOptimizer(optax.sgd(EF_LR), axis_name="hvd",
                                    zero_stage=stage,
                                    compression=jhvd.Compression.int8)

    def body(g):
        p = {"w": jnp.zeros(EF_LEN, jnp.float32)}
        st = opt.init(p)
        for _ in range(EF_STEPS):
            upd, st = opt.update({"w": g[0]}, st, p)
            p = optax.apply_updates(p, upd)
        return p["w"]

    return _run(n, body, np.stack([ef_grad(r) for r in range(n)]))


@pytest.mark.parametrize("stage", [1, 2])
def test_int8_error_feedback_telescopes(world, stage):
    n, outs, _ = world
    g = np.stack([ef_grad(r) for r in range(n)])
    exact = -EF_LR * EF_STEPS * g.astype(np.float64).mean(0)
    bound = EF_LR * (n * np.abs(g).max() / (127 // n)) / 2 / n + 1e-7
    want = _jax_ef(n, stage)
    assert np.abs(want - exact).max() <= 2.5 * bound
    for o in outs:
        got = _f(o[f"ef_{stage}_int8"])
        assert np.abs(got - exact).max() <= 2.5 * bound, \
            (np.abs(got - exact).max(), bound)
        assert np.abs(got - want).max() <= 5 * bound
        np.testing.assert_allclose(_f(o["ef_1_none"]), exact, rtol=1e-5,
                                   atol=1e-7)
        assert np.any(_f(o[f"ef_res_{stage}"]))
        np.testing.assert_array_equal(got, _f(outs[0][f"ef_{stage}_int8"]))


def test_accumulation_wraps_the_sharded_core(world):
    n, outs, _ = world
    h = ZERO_HYPER["dyadic"]
    init, _ = zero_inputs(0, n, "dyadic")
    params = {k: jnp.asarray(a) for k, a in zip(NAMES, init)}
    opt = jhvd.DistributedOptimizer(_optax("momentum", h), axis_name="hvd",
                                    zero_stage=1, backward_passes_per_step=2)
    grads = [zero_inputs(r, n, "dyadic")[1] for r in range(n)]
    grads = [g + g[:1] for g in grads]
    stacked = [np.stack([[grads[r][s][i] for s in range(4)]
                         for r in range(n)]) for i in range(len(NAMES))]

    def body(*gs):
        p, st = params, opt.init(params)
        for step in range(4):
            upd, st = opt.update({k: gs[i][0][step]
                                  for i, k in enumerate(NAMES)}, st, p)
            p = optax.apply_updates(p, upd)
        return tuple(p[k] for k in NAMES)

    want = _run(n, body, *stacked)
    for o in outs:
        for got, w in zip(o["accum"], want):
            np.testing.assert_array_equal(_f(got).reshape(w.shape), w)


@pytest.mark.parametrize("world", [2], ids=["np2"], indirect=True)
def test_stage3_resnet_matches_stage0(world):
    n, outs, _ = world
    for o in outs:
        res = o["resnet"]
        np.testing.assert_allclose(res["loss3"], res["loss0"], rtol=2e-5)
        np.testing.assert_allclose(_f(res["w3"]), _f(res["w0"]), rtol=2e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(_f(res["bn3"]), _f(res["bn0"]), rtol=2e-5,
                                   atol=1e-7)
        assert res["bytes3"] == 4 * res["numel3"]
        assert res["bytes3"] * 2 - res["bytes0"] in range(0, 8)
    np.testing.assert_array_equal(_f(outs[0]["resnet"]["w3"]),
                                  _f(outs[1]["resnet"]["w3"]))


@pytest.mark.parametrize("world", [2], ids=["np2"], indirect=True)
def test_jax_stage1_state_carries_over(world):
    n, outs, p3 = world
    flat = dict(interop._flat(p3))
    for o in outs:
        got = dict(interop._flat(o["interop"]))
        assert set(got) == set(flat)
        for path, w in flat.items():
            np.testing.assert_allclose(_f(got[path]), np.asarray(w),
                                       rtol=2e-5, atol=1e-7,
                                       err_msg="/".join(path))


# ---------------------------------------------------------------------------
# 5. The stage-3 interop round trip
# ---------------------------------------------------------------------------


def test_zero3_params_from_jax(world1):
    src = small_resnet("cpu")
    params, _ = interop.cnn_to_flax(src)
    jzp = JD.zero3_shard_params(jax.tree_util.tree_map(jnp.asarray, params))
    model = small_resnet("cpu")
    torch.manual_seed(5)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_()
    zp = hvd.zero3_shard_params(model)
    interop.zero3_params_from_jax([np.asarray(s) for s in jzp.shards],
                                  jzp.layout, params, model, zp)
    full = hvd.zero3_full_params(zp)
    for name, p in src.named_parameters():
        assert torch.equal(full[name], p.detach()), name
