"""The port's local SGD / DiLoCo (``horovod_tpu_torch/optim/local_sgd.py``)
against the JAX package's ``LocalSGD``, on the CPU.

The JAX side runs ``LocalSGD`` in ``shard_map`` over
``hierarchical_mesh(jax.devices()[:4], local_size=2)`` (cross 2 x local
2), as ``tests/test_local_sgd.py`` does; the port side in one spawned
gloo world of 4 (``_torch_local_sgd_worker.local_sgd_main``) over the
``("cross", "local")`` pair of ``hierarchical_mesh(2)`` (rank ``c * 2 +
l``), then under ``HOROVOD_MESH=dp:4`` with the hierarchical split,
where the default pair is ``("dpc", "dpl")``.

Tolerances:
- bit for bit: H <= 1 against ``DistributedOptimizer`` and the JAX run;
  the DiLoCo outer math at dyadic values (inner lr 0.25, outer lr and
  momentum 0.5) against the JAX run and the numpy reference of
  ``tests/test_local_sgd.py:278-330``; stages 1-3 against stage 0;
  the state carried out to the JAX layout and back;
- the lossy outer wires (int8, int4 with error feedback): equal inputs
  reach the wire on both sides (the inner steps are exact on a 2^-8
  grid), and the JAX run's shared block scale may sit one ulp off the
  port's where XLA-CPU rewrites ``x / c`` into ``x * (1 / c)``
  (``tests/test_torch_quantization.py``); so each weight within one
  quantization step of its block through the outer step, ``lr * (1 +
  mu) * scale``, and each residual within ``scale`` plus two ulps of the
  block's largest dequantized value (XLA-CPU's fused ``x - q * s``);
  top-k bit for bit;
- the slice (SmallCNN through ``train_step`` and ``maybe_outer_sync``,
  fused momentum SGD 0.1/0.9, H = 2, 4 steps, each rank its own batch):
  losses within rtol 1e-4, weights and BatchNorm statistics within 5e-3
  relative plus 5e-3 of each tensor's largest magnitude
  (``tests/test_torch_cnn_models.py``'s train-step tolerance); on the
  int8 wire the two packages fuse the leaves in other orders and
  layouts, so their blocks differ: the weights plus four quantization
  steps of the largest pseudo-gradient through the outer Nesterov
  factor, ``extra = 4 * lr * (1 + mu + mu^2) * max|delta| / 63``, and
  the losses after the first sync plus the step's gradient L1 norm
  times ``extra`` (first order).
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
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.common import config as jconfig
from horovod_tpu.common.types import HorovodTpuError as JError
from horovod_tpu.models import mnist as jmnist
from horovod_tpu.ops.collectives import Adasum as JAdasum
from horovod_tpu.ops.compression import Compression as JC
from horovod_tpu.optim import local_sgd as JLS
from horovod_tpu.parallel import mesh as JM

import horovod_tpu_torch as hvd
from horovod_tpu_torch import interop
from horovod_tpu_torch.common import config as tconfig
from horovod_tpu_torch.optim import fused_update as TF
from horovod_tpu_torch.optim import local_sgd as LS
from horovod_tpu_torch.parallel.mesh import Hop, HopPair
from horovod_tpu_torch.train_step import synthetic_batch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_collectives_worker import spawn  # noqa: E402
from _torch_local_sgd_worker import (LS_CNN, LS_CNN_BATCH,  # noqa: E402
                                     LS_CNN_CLASSES, LS_CNN_SIZE,
                                     LS_CNN_STEPS, LS_CROSS, LS_ENVS,
                                     LS_LOCAL, LS_LOSSY, LS_LOSSY_LEAVES,
                                     LS_N, ls_inputs)
from test_torch_collectives import _f  # noqa: E402
from test_torch_quantization import BLOCK  # noqa: E402

PAIR = ("cross", "local")
N = LS_N


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for e in LS_ENVS:
        monkeypatch.delenv(e, raising=False)


@pytest.fixture(scope="module")
def hmesh():
    return JM.hierarchical_mesh(jax.devices()[:N], local_size=LS_LOCAL)


def _run_pair(hmesh, body, *xs):
    """``body`` per device of the pair mesh (each ``x`` split over its
    two leading axes), every output per device."""
    fn = jax.jit(shard_map(body, mesh=hmesh, check_vma=False,
                           in_specs=(P(*PAIR),) * len(xs),
                           out_specs=P(*PAIR)))
    out = fn(*map(jnp.asarray, xs))
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a).reshape((N,) + a.shape[2:]), out)


def _rank_grid():
    return np.arange(N, dtype=np.float32).reshape(LS_CROSS, LS_LOCAL, 1)


def _dev(a):
    """A per-device output: (1, 1, ...) for out_specs over the pair."""
    return a[None, None]


# ---------------------------------------------------------------------------
# The JAX runs of the slice (SmallCNN), shared with the spawned world
# ---------------------------------------------------------------------------


def _cnn_batches():
    xs, ys = [], []
    for r in range(N):
        x, y = synthetic_batch(LS_CNN_BATCH, LS_CNN_SIZE, LS_CNN_CLASSES,
                               seed=100 + r, device="cpu")
        xs.append(x.numpy())
        ys.append(y.numpy().astype(np.int32))
    shape = (LS_CROSS, LS_LOCAL)
    return (np.stack(xs).reshape(shape + xs[0].shape),
            np.stack(ys).reshape(shape + ys[0].shape))


def _jax_cnn(hmesh, params, stats, stage: int, comp: str) -> dict:
    """The JAX bench recipe (``bench.py``'s ``one_step``) under
    ``LocalSGD(fused_update.sgd(0.1, momentum=0.9), h=2)``: 4 steps, the
    outer sync after steps 2 and 4."""
    jm = jmnist.SmallCNN(num_classes=LS_CNN_CLASSES, dtype=jnp.float32)
    opt = jhvd.LocalSGD(jhvd.fused_update.sgd(0.1, momentum=0.9), h=2,
                        axis_name=PAIR, zero_stage=stage,
                        compression=JC.lookup(comp))

    def body(x, y):
        x, y = x[0, 0], y[0, 0]
        p, s = params, stats
        st = opt.init(p)
        losses = []
        for step in range(1, LS_CNN_STEPS + 1):
            def loss_fn(p, s=s):
                logits, mut = jm.apply({"params": p, "batch_stats": s}, x,
                                       train=True, mutable=["batch_stats"])
                onehot = jax.nn.one_hot(y, LS_CNN_CLASSES)
                return (optax.softmax_cross_entropy(logits, onehot).mean(),
                        mut["batch_stats"])

            (loss, s), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
            upd, st = opt.update(g, st, p)
            p = optax.apply_updates(p, upd)
            if step % 2 == 0:
                p, st = opt.outer_sync(p, st)
            losses.append(loss)
        inner = st.inner_state if stage == 0 else st.inner_state.inner_state
        o = st.outer
        state = {"trace": inner[0].trace, "anchor": o.anchor[0],
                 "velocity": o.velocity[0],
                 "residual": None if o.residual is None else o.residual[0]}
        return jax.tree_util.tree_map(_dev, (jnp.stack(losses), p, s,
                                             state))

    x, y = _cnn_batches()
    losses, p, s, state = _run_pair(hmesh, body, x, y)
    return {"losses": losses, "params": p, "stats": s, "state": state}


def _jax_layout_of(params, n: int):
    from horovod_tpu.optim import distributed as JD

    lay = JD._shard_layout(jax.tree_util.tree_leaves(params), n)
    return interop.JaxLayout(*lay)


def _interop_states(run: dict, params, stage: int) -> list:
    """The JAX run's end state, one ``interop.LocalSGDState`` per rank:
    at stage 2 each buffer the concatenation of the slice's local
    shards."""
    lay = _jax_layout_of(params, 1 if stage == 0 else LS_LOCAL)
    st = run["state"]
    out = []
    for r in range(N):
        c = r // LS_LOCAL
        slice_ = range(c * LS_LOCAL, (c + 1) * LS_LOCAL)

        def full(key, r=r, slice_=slice_):
            a = st[key]
            if stage == 0:
                return [np.asarray(a[r])]
            return [np.concatenate([np.asarray(a[q]) for q in slice_])]

        if stage == 0:
            inner = {"trace": jax.tree_util.tree_map(lambda a, r=r: a[r],
                                                     st["trace"])}
        else:
            inner = {"trace": [np.concatenate(
                [np.asarray(st["trace"][0][q]) for q in slice_])]}
        outer = interop.OuterBuffers(full("anchor"), full("velocity"),
                                     full("residual"), lay,
                                     "full" if stage == 0 else "local")
        out.append(interop.LocalSGDState(inner, outer, 0))
    return out


@pytest.fixture(scope="module")
def cnn_init():
    jm = jmnist.SmallCNN(num_classes=LS_CNN_CLASSES, dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(7),
                jnp.zeros((1, LS_CNN_SIZE, LS_CNN_SIZE, 3)), train=True)
    return (jax.tree_util.tree_map(np.asarray, v["params"]),
            jax.tree_util.tree_map(np.asarray, v["batch_stats"]))


@pytest.fixture(scope="module")
def jax_cnn(hmesh, cnn_init):
    params, stats = cnn_init
    return {case: _jax_cnn(hmesh, params, stats, *case) for case in LS_CNN}


@pytest.fixture(scope="module")
def world(jax_cnn, cnn_init, tmp_path_factory):
    params, stats = cnn_init
    init = {"params": params, "batch_stats": stats}
    for stage in (0, 2):
        init[f"jax_state_{stage}"] = _interop_states(
            jax_cnn[(stage, "int8")], params, stage)
    path = str(tmp_path_factory.mktemp("local_sgd") / "init.pkl")
    with open(path, "wb") as f:
        pickle.dump(init, f)
    return spawn(N, mode="local_sgd", timeout=600,
                 env_extra={"HVD_TEST_LS_INIT": path})


# ---------------------------------------------------------------------------
# Knobs, refusals, the single slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env", [
    {}, {"HOROVOD_LOCAL_SGD_H": "4"}, {"HOROVOD_LOCAL_SGD_H": "-3"},
    {"HOROVOD_LOCAL_SGD_H": "two"},
    {"HOROVOD_OUTER_LR": "0.5", "HOROVOD_OUTER_MOMENTUM": "0.25"},
    {"HOROVOD_COMPRESSION": "int8"},
    {"HOROVOD_COMPRESSION": "int8", "HOROVOD_LOCAL_SGD_COMPRESSION": "fp16"},
    {"HOROVOD_LOCAL_SGD_COMPRESSION": "topk"}], ids=str)
def test_knobs_match_jax(monkeypatch, env):
    """The four knobs' defaults and parsing, ``resolved_h`` (an explicit
    h wins, negatives clamp to 0) and ``outer_compression`` (explicit,
    then ``HOROVOD_LOCAL_SGD_COMPRESSION``, then
    ``HOROVOD_COMPRESSION``) equal the JAX package's under the same
    env."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for knob in ("local_sgd_h", "outer_lr", "outer_momentum",
                 "local_sgd_compression"):
        assert tconfig.get(knob) == jconfig.get(knob), knob
    assert LS.resolved_h() == JLS.resolved_h()
    assert LS.resolved_h(8) == JLS.resolved_h(8) == 8
    assert LS.resolved_h(-1) == JLS.resolved_h(-1) == 0
    assert LS.outer_compression().__name__ == \
        JLS.outer_compression().__name__
    assert LS.outer_compression(hvd.Compression.bf16) is \
        hvd.Compression.bf16
    if not env:
        assert (tconfig.get("local_sgd_h"), tconfig.get("outer_lr"),
                tconfig.get("outer_momentum"),
                tconfig.get("local_sgd_compression")) == (0, 0.7, 0.9, "")


def _fake_pair():
    """A (cross 2, local 2) pair as rank 0 sees it (constructing the
    optimizer moves no data)."""
    return HopPair(Hop([0, 2], 0, None, "cross"), Hop([0, 1], 0, None,
                                                        "local"),
                   Hop(range(4), 0, None, "flat"))


@pytest.mark.parametrize("case", ["bpps", "adasum", "type", "integer"])
def test_active_regime_rejections(case):
    """The reference's refusals, with its messages."""
    w = [torch.nn.Parameter(torch.ones(4))]
    port = {
        "bpps": (lambda: hvd.LocalSGD(TF.sgd(w, 0.1), h=4,
                                      axis_name=_fake_pair(),
                                      backward_passes_per_step=2),
                 lambda: jhvd.LocalSGD(optax.sgd(0.1), h=4, axis_name=PAIR,
                                       backward_passes_per_step=2),
                 "backward_passes_per_step"),
        "adasum": (lambda: hvd.LocalSGD(TF.sgd(w, 0.1), h=4,
                                        axis_name=_fake_pair(),
                                        op=hvd.Adasum),
                   lambda: jhvd.LocalSGD(optax.sgd(0.1), h=4,
                                         axis_name=PAIR, op=JAdasum),
                   "Adasum"),
        "integer": (lambda: hvd.LocalSGD(
            torch.optim.SGD([torch.arange(4)], lr=0.1), h=4,
            axis_name=_fake_pair(), compression=hvd.Compression.none),
            lambda: jhvd.LocalSGD(optax.sgd(0.1), h=4, axis_name=PAIR,
                                  compression=JC.none).init(
                {"w": jnp.arange(4)}),
            "floating"),
    }
    if case == "type":
        with pytest.raises(TypeError, match="torch.optim.Optimizer"):
            hvd.LocalSGD(object())
        with pytest.raises(TypeError, match="optax"):
            jhvd.LocalSGD(object())
        return
    fn, jfn, match = port[case]
    with pytest.raises(hvd.HorovodTpuError, match=match):
        fn()
    with pytest.raises(JError, match=match):
        jfn()


def test_single_slice_degenerate_warns():
    """World 1 (no init): the JAX package and the port both warn and run
    synchronously; the outer sync only restarts the window."""
    w = torch.nn.Parameter(torch.ones(4))
    with pytest.warns(UserWarning, match="single slice"):
        opt = hvd.LocalSGD(TF.sgd([w], 0.1), h=4,
                           compression=hvd.Compression.none)
    with pytest.warns(UserWarning, match="single slice"):
        jopt = jhvd.LocalSGD(optax.sgd(0.1), h=4, compression=JC.none)
    assert (opt.active, opt.degenerate) == (jopt.active,
                                            jopt._degenerate) == (True, True)
    assert opt.outer is None and not opt.should_sync(4)
    assert LS.inner_window_position(opt) is None
    assert LS.is_local_sgd_state(opt) and not LS.is_local_sgd_state(w)
    before = w.detach().clone()
    opt.outer_sync()
    assert torch.equal(w.detach(), before) and opt.inner_steps == 0


def test_world_refusals(world):
    """In the world of 4: no split (``HOROVOD_LOCAL_SIZE`` = 4) is one
    slice, so the regime warns and trains synchronously over the world;
    with ``HOROVOD_HIERARCHICAL_LOCAL_SIZE=2`` the job has two slices and
    no pair, where the eager regime runs; this world's ``init()`` ran
    without ``HOROVOD_LOCAL_SGD_H``, so it built no (cross, local) groups
    for it, and the port raises at construction, naming the knob."""
    grads = np.arange(N, dtype=np.float64)
    for o in world:
        ref = o["refusals"]
        assert any("single slice" in m for m in ref["single_slice"])
        assert ref["degenerate"] == [True, True, False, [1, N]]
        np.testing.assert_allclose(_f(ref["degenerate_w"]),
                                   1 - 0.1 * grads.mean(), rtol=1e-6)
        assert ref["topology"] == [LS_CROSS, LS_LOCAL]
        assert "(cross, local) groups" in ref["no_pair"]
        assert "HOROVOD_LOCAL_SGD_H >= 2" in ref["no_pair"]
        assert "before init()" in ref["no_pair"]


# ---------------------------------------------------------------------------
# H <= 1, the DiLoCo outer math, the ZeRO stages
# ---------------------------------------------------------------------------


def _jax_h1(stage: int, overlap: bool):
    """``tests/test_local_sgd.py::_train`` on four devices, flat."""
    mesh = Mesh(np.array(jax.devices()[:N]), ("hvd",))
    opt = jhvd.LocalSGD(optax.sgd(0.1), axis_name="hvd", zero_stage=stage,
                        overlap=overlap)
    assert not opt.active
    params = {"w": jnp.arange(-8.0, 8.0, dtype=jnp.float32),
              "b": jnp.ones((3, 3), jnp.float32)}

    def body(t):
        p = dict(params)
        state = opt.init(p)
        for _ in range(2):
            g = {k: jnp.full(v.shape, (i + 1.0) * (t[0, 0] - 1.0), v.dtype)
                 for i, (k, v) in enumerate(sorted(p.items()))}
            upd, state = opt.update(g, state, p)
            p = optax.apply_updates(p, upd)
        return p["b"].reshape(1, -1), p["w"].reshape(1, -1)

    b, w = jax.jit(shard_map(body, mesh=mesh, check_vma=False,
                             in_specs=P("hvd"),
                             out_specs=(P("hvd"),) * 2))(
        jnp.arange(N, dtype=jnp.float32).reshape(-1, 1))
    return np.asarray(b), np.asarray(w)


@pytest.mark.parametrize("overlap", [False, True], ids=["mono", "overlap"])
@pytest.mark.parametrize("stage", [0, 1])
def test_h1_is_distributed_optimizer_bit_for_bit(world, stage, overlap):
    jb, jw = _jax_h1(stage, overlap)
    for r, o in enumerate(world):
        ls, dopt = o[f"h1_{stage}_{overlap}"]
        for a, b in zip(ls, dopt):
            np.testing.assert_array_equal(_f(a), _f(b))
        np.testing.assert_array_equal(_f(ls[0]).reshape(-1), jb[r])
        np.testing.assert_array_equal(_f(ls[1]), jw[r])


def _numpy_diloco():
    """``tests/test_local_sgd.py:304-322`` at (cross 2, local 2)."""
    ranks = np.arange(N, dtype=np.float32).reshape(LS_CROSS, LS_LOCAL)
    m = (ranks + 1).mean(axis=1).astype(np.float32)
    lr_in, lr_out, mu = np.float32(0.25), np.float32(0.5), np.float32(0.5)
    p = np.tile(np.arange(8, dtype=np.float32), (LS_CROSS, 1))
    anchor = np.arange(8, dtype=np.float32)
    v = np.zeros(8, np.float32)
    for s in range(1, 5):
        p = p - lr_in * m[:, None]
        if s % 2 == 0:
            red = (anchor[None, :] - p).mean(axis=0).astype(np.float32)
            v = mu * v + red
            upd = red + mu * v
            anchor = (anchor - lr_out * upd).astype(np.float32)
            p = np.tile(anchor, (LS_CROSS, 1))
    return anchor


def test_diloco_outer_math_bit_for_bit(world, hmesh):
    """Two H = 2 windows at dyadic values: the port equals the JAX run
    and the numpy reference bit for bit on every rank, under the
    explicit pair and the data mesh's default (dpc, dpl); the window
    counter reads 1, 2 after the inner steps and 0 after each sync."""
    opt = jhvd.LocalSGD(optax.sgd(0.25), h=2, axis_name=PAIR, outer_lr=0.5,
                        outer_momentum=0.5, compression=JC.none,
                        zero_stage=0)

    def body(t):
        r = t[0, 0, 0]
        p = {"w": jnp.arange(8.0, dtype=jnp.float32)}
        state = opt.init(p)
        for s in range(1, 5):
            upd, state = opt.update({"w": jnp.full((8,), r + 1.0)}, state,
                                    p)
            p = optax.apply_updates(p, upd)
            if s % 2 == 0:
                p, state = opt.outer_sync(p, state)
        return _dev(p["w"])

    want = _run_pair(hmesh, body, _rank_grid())
    anchor = _numpy_diloco()
    for r, o in enumerate(world):
        np.testing.assert_array_equal(want[r], anchor)
        for key in ("diloco", "mesh_diloco"):
            w, windows = o[key]
            np.testing.assert_array_equal(_f(w), anchor)
            assert windows == [1, 1, 2, 0, 1, 1, 2, 0]


def _jax_stage(hmesh, stage: int):
    """``tests/test_local_sgd.py::_run_ls_stage`` at (cross 2, local 2)."""
    from horovod_tpu.optim import distributed as JD

    opt = jhvd.LocalSGD(optax.sgd(0.25), h=2, axis_name=PAIR, outer_lr=0.5,
                        outer_momentum=0.5, compression=JC.none,
                        zero_stage=stage)
    p0 = {"w": jnp.arange(16.0, dtype=jnp.float32),
          "b": jnp.full((8,), 2.0, jnp.float32)}
    keys = sorted(p0)

    def body(t):
        r = t[0, 0, 0]
        if stage == 3:
            cur = JD.zero3_shard_params(p0, axis_name="local")
            state = opt.init(cur)
            for s in range(1, 5):
                def loss(z):
                    full = JD.zero3_full_params(z, axis_name="local")
                    return sum((i + 1.0) * (r + 1.0) * jnp.sum(full[k])
                               for i, k in enumerate(keys))

                upd, state = opt.update(jax.grad(loss)(cur), state, cur)
                cur = optax.apply_updates(cur, upd)
                if s % 2 == 0:
                    cur, state = opt.outer_sync(cur, state)
            full = JD.zero3_full_params(cur, axis_name="local")
        else:
            full = dict(p0)
            state = opt.init(full)
            for s in range(1, 5):
                g = {k: jnp.full(full[k].shape, (i + 1.0) * (r + 1.0))
                     for i, k in enumerate(keys)}
                upd, state = opt.update(g, state, full)
                full = optax.apply_updates(full, upd)
                if s % 2 == 0:
                    full, state = opt.outer_sync(full, state)
        return _dev(full["b"]), _dev(full["w"])

    return _run_pair(hmesh, body, _rank_grid())


def test_zero_stages_bit_for_bit(world, hmesh):
    """ZeRO 1-3 over the local hop walk bit for bit with stage 0, and
    each equals the JAX run at its stage; the outer state is 1/L of
    stage 0's at stages 1-3 (anchor + velocity, float32)."""
    for stage in (0, 1, 2, 3):
        jb, jw = _jax_stage(hmesh, stage)
        for r, o in enumerate(world):
            ws, nbytes = o[f"stage_{stage}"]
            base = o["stage_0"][0]
            for a, b in zip(ws, base):
                np.testing.assert_array_equal(_f(a), _f(b))
            np.testing.assert_array_equal(_f(ws[0]), jb[r])
            np.testing.assert_array_equal(_f(ws[1]), jw[r])
            assert nbytes == 2 * 4 * 24 // (1 if stage == 0 else LS_LOCAL)
            if stage == 2:
                assert o["mesh_stage_2"] == o["stage_2"]
    for o in world:
        assert o["mesh_axis"] == [["dpc", "dpl"], "dpl", False]


# ---------------------------------------------------------------------------
# The lossy outer wire
# ---------------------------------------------------------------------------


def _jax_lossy(hmesh, mode: str, stage: int):
    opt = jhvd.LocalSGD(optax.sgd(0.25), h=2, axis_name=PAIR, outer_lr=0.5,
                        outer_momentum=0.5, compression=JC.lookup(mode),
                        zero_stage=stage)
    names = [k for k, _ in LS_LOSSY_LEAVES]
    inp = [ls_inputs(r) for r in range(N)]
    init = {k: jnp.asarray(a) for k, a in zip(names, inp[0]["init"])}
    grads = [np.stack([np.stack([inp[r]["grads"][s][i] for s in range(2)])
                       for r in range(N)]).reshape(
        (LS_CROSS, LS_LOCAL, 2) + inp[0]["grads"][0][i].shape)
        for i in range(len(names))]

    def body(*gs):
        p, state = init, opt.init(init)
        for s in range(2):
            g = {k: gs[i][0, 0, s] for i, k in enumerate(names)}
            upd, state = opt.update(g, state, p)
            p = optax.apply_updates(p, upd)
        p, state = opt.outer_sync(p, state)
        return (tuple(_dev(p[k]) for k in names),
                _dev(state.outer.residual[0]))

    return _run_pair(hmesh, body, *grads)


def _port_scales(deltas, qmax: int):
    """Each rank's shared block scales: the block absmax of its delta,
    max over its cross partners, over qmax (float32 true division)."""
    out = []
    for r in range(N):
        l_ = r % LS_LOCAL
        blocks = []
        for c in range(LS_CROSS):
            d = deltas[c * LS_LOCAL + l_]
            pad = (-d.size) % BLOCK
            blocks.append(np.abs(np.pad(d, (0, pad))).reshape(-1, BLOCK)
                          .max(1))
        out.append((np.max(blocks, axis=0).astype(np.float32)
                    / np.float32(qmax)).astype(np.float32))
    return out


@pytest.mark.parametrize("mode,stage", LS_LOSSY)
def test_lossy_outer_wire_matches_jax(world, hmesh, mode, stage, capsys):
    (jb, jw), jres = _jax_lossy(hmesh, mode, stage)
    deltas = [_f(o[f"lossy_{mode}_{stage}"]["delta"]) for o in world]
    qmax = (127 if mode == "int8" else 7) // LS_CROSS
    scales = _port_scales(deltas, qmax) if mode != "topk" else None
    exact, total = 0, 0
    for r, o in enumerate(world):
        got = o[f"lossy_{mode}_{stage}"]
        w = np.concatenate([_f(x).reshape(-1) for x in got["w"]])
        jwant = np.concatenate([jb[r].reshape(-1), jw[r].reshape(-1)])
        res = _f(got["res"])
        assert np.any(res), "error feedback keeps a residual"
        if mode == "topk":
            np.testing.assert_array_equal(w, jwant)
            np.testing.assert_array_equal(res, jres[r])
            continue
        s = np.repeat(scales[r], BLOCK)[:res.size]
        # the weights: one quantization step of the block through the
        # outer step; a weight's block is its element of the fused buffer
        # (stage 2: its local shard's)
        half = res.size
        if stage == 0:
            sw = s[:w.size]
        else:
            sw = np.concatenate([
                np.repeat(scales[(r // LS_LOCAL) * LS_LOCAL + q],
                          BLOCK)[:half] for q in range(LS_LOCAL)])[:w.size]
        assert (np.abs(w - jwant) <= 0.5 * 1.5 * sw
                + 2 * np.spacing(np.abs(jwant))).all(), (mode, stage, r)
        ulp2 = 2 * np.spacing(np.float32(qmax) * s)
        assert (np.abs(res - jres[r]) <= s + ulp2).all(), (mode, stage, r)
        exact += int(np.sum(w == jwant))
        total += w.size
    if total:
        with capsys.disabled():
            print(f"\n[local sgd] {mode} stage {stage}: {exact} of {total} "
                  "weights bit for bit with the JAX run")


@pytest.mark.parametrize("stage", [0, 2])
@pytest.mark.parametrize("mode", ["none", "int8"])
def test_inner_steps_stay_off_the_cross_hop(world, stage, mode):
    """From a recording wrapper around ``torch.distributed``: the inner
    steps' transfers all ride the local group; the sync sends one
    ``cross_allreduce`` per dtype group over the cross group (``none``:
    one float32 ``all_reduce`` of the group's pseudo-gradient; int8:
    the float32 per-block scale max and one int8 payload) and, at stage
    2, gathers each group's new anchor over the local group."""
    for r, o in enumerate(world):
        c, l_ = divmod(r, LS_LOCAL)
        cross, local = [l_, LS_LOCAL + l_], [c * LS_LOCAL, c * LS_LOCAL + 1]
        calls = o[f"calls_{stage}_{mode}"]
        assert calls["inner"] and all(x[3] == local
                                      for x in calls["inner"])
        on_cross = [x for x in calls["sync"] if x[3] == cross]
        on_local = [x for x in calls["sync"] if x[3] == local]
        assert len(on_cross) + len(on_local) == len(calls["sync"])
        sizes = (46, 10) if stage else (45, 10)     # padded at stage 2
        shards = [n // (LS_LOCAL if stage else 1) for n in sizes]
        if mode == "none":
            want = [["all_reduce", "torch.float32", n, cross]
                    for n in shards]
        else:
            want = [x for n in shards for x in (
                ["all_reduce", "torch.float32", -(-n // BLOCK), cross],
                ["all_reduce", "torch.int8", -(-n // BLOCK) * BLOCK, cross])]
        assert on_cross == want
        if stage:
            assert [(x[0], x[1], x[2]) for x in on_local] == [
                ("all_gather_into_tensor", "torch.float32", shards[0]),
                ("all_gather_into_tensor", "torch.bfloat16", shards[1])]
        else:
            assert not on_local
        assert o[f"calls_{stage}_{mode}"]["w"] == \
            world[0][f"calls_{stage}_{mode}"]["w"]


# ---------------------------------------------------------------------------
# The slice: SmallCNN through train_step and maybe_outer_sync
# ---------------------------------------------------------------------------


def _close_scaled(a, b, tol, extra, what):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    bound = tol * np.abs(b) + tol * max(np.abs(b).max(), 1e-30) + extra
    assert (np.abs(a - b) <= bound).all(), (what, np.abs(a - b).max())


@pytest.mark.parametrize("stage,comp", LS_CNN, ids=str)
def test_small_cnn_slice_matches_jax(world, jax_cnn, stage, comp):
    jrun = jax_cnn[(stage, comp)]
    lr, mu = 0.7, 0.9
    extra = 0.0
    if comp == "int8":
        extra = 4 * lr * (1 + mu + mu * mu) * max(
            x[f"cnn_{stage}_{comp}"]["dmax"] for x in world) / 63
    for r, o in enumerate(world):
        got = o[f"cnn_{stage}_{comp}"]
        # a loss moves at most by its gradient's L1 norm times the
        # largest weight difference (first order; steps after a sync)
        grad_l1 = np.array(got["grad_l1"])
        moved = np.where(np.arange(LS_CNN_STEPS) >= 2, grad_l1 * extra, 0)
        assert (np.abs(np.array(got["losses"]) - jrun["losses"][r])
                <= 1e-4 * np.abs(jrun["losses"][r]) + moved).all(), \
            (got["losses"], jrun["losses"][r], moved)
        for what, ours, ref in (("param", got["params"], jrun["params"]),
                                ("stat", got["stats"], jrun["stats"])):
            flat = dict(interop._flat(ours))
            for path, a in interop._flat(jax.tree_util.tree_map(
                    lambda x: x[r], ref)):
                _close_scaled(flat[path], a, 5e-3, extra,
                              f"{what} {'/'.join(path)} rank {r}")
    # a sync leaves every rank with the same weights
    for o in world[1:]:
        assert o[f"cnn_{stage}_{comp}"]["params"] == \
            world[0][f"cnn_{stage}_{comp}"]["params"]


# ---------------------------------------------------------------------------
# Carrying the state across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stage", [0, 2])
def test_state_round_trips(world, jax_cnn, cnn_init, stage):
    """The port's state out to the JAX layout and into a fresh optimizer
    equals the original bit for bit; the JAX run's end state loaded into
    the port and written back out equals the JAX state bit for bit."""
    states = _interop_states(jax_cnn[(stage, "int8")], cnn_init[0], stage)
    for r, o in enumerate(world):
        assert o["interop"][f"port_round_trip_{stage}"] == [True, True]
        back = o["interop"][f"jax_round_trip_{stage}"]
        want = states[r]
        assert back["kind"] == want.outer.kind and back["inner_steps"] == 0
        for key in ("anchor", "velocity", "residual"):
            for a, b in zip(back[key], getattr(want.outer, key)):
                np.testing.assert_array_equal(_f(a), np.asarray(b))
        if stage == 0:
            flat = dict(interop._flat(back["inner"]["trace"]))
            for path, a in interop._flat(want.inner_state["trace"]):
                np.testing.assert_array_equal(_f(flat[path]), np.asarray(a))
        else:
            np.testing.assert_array_equal(_f(back["inner"]["trace"][0]),
                                          want.inner_state["trace"][0])
