"""Tensor and expert parallelism of the port against the JAX package on
the CPU.

The JAX side runs in-process on the CPU mesh of ``tests/conftest.py``
(``make_train_step`` at the same mesh, ``shard_map`` for the f/g pair and
``moe_layer``); the port side runs on spawned gloo worlds of 2 and 4 ranks
(``_torch_collectives_worker.mp_main``), one spawn per world size for
every case.  The LM is the small config (vocab 64, d_model 32, 4 heads x
8, 4 layers, d_ff 64, float32), batch 4 x 64, SGD lr 0.5, 3 steps, at
tp 2, dp 2 x tp 2, tp 2 x sp 2, ``HOROVOD_MESH=dp:2,sp:2``, and with
MoE layers (every second layer, 2 experts per rank) at dp 2 and dp 2 x
sp 2: losses within rtol 1e-4 and weights within 1e-4 of each tensor's
largest magnitude (the float32 bounds of
``tests/test_torch_sequence_parallel.py``).  SGD shows any world-size
factor that Adam's normalization would hide: dp 2 x tp 2 is also held
against one device running the tp-equivalent ``wqkv``
(``tp_equivalent_wqkv``), and MoE at dp 2 with the same rows on both dp
ranks against one device holding all four experts.  ``moe_layer``:
rtol 1e-4 / atol 1e-5 (``tests/test_pipeline_moe.py:283``), the routes
(expert and keep flag of every token) equal first.
"""

import functools
import os
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel import moe as JMOE
from horovod_tpu.parallel import sharding as JS
from horovod_tpu.parallel.mesh import make_mesh as jax_mesh
from horovod_tpu_torch import interop
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.parallel import mesh as M
from horovod_tpu_torch.parallel import moe as TMOE
from horovod_tpu_torch.parallel import sharding as TS
from horovod_tpu_torch.train_step import lm_optimizer

sys.path.insert(0, os.path.dirname(__file__))
from _torch_collectives_worker import (  # noqa: E402
    MOE_CAP, MP_CASES, MP_LR, MP_STEPS, SP_LM, fg_inputs, moe_inputs,
    mp_tokens, spawn)

LOSS_RTOL, WEIGHT_TOL = 1e-4, 1e-4
MOE_TOL = dict(rtol=1e-4, atol=1e-5)
CASES = {c[0]: c for c in MP_CASES}


@functools.lru_cache(maxsize=None)
def _world(n: int) -> list:
    """Every case's results on a gloo world of ``n`` ranks."""
    return spawn(n, "cpu", timeout=300, mode="mp")


def _cfg(moe_every: int, jax_side: bool):
    mod = JT if jax_side else TT
    return mod.TransformerConfig(**SP_LM, dtype="float32",
                                 moe_every=moe_every)


def _scaled_close(ours, ref, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(
        np.asarray(ours, np.float32), ref, rtol=0,
        atol=WEIGHT_TOL * max(np.abs(ref).max(), 1e-30), err_msg=what)


def _trees_close(ours: dict, ref: dict, prefix=""):
    assert sorted(ours) == sorted(ref), (prefix, sorted(ours), sorted(ref))
    for k, v in ref.items():
        if isinstance(v, dict):
            _trees_close(ours[k], v, f"{prefix}{k}/")
        else:
            _scaled_close(ours[k], v, prefix + k)


def _jax_train(cfg, axes: dict, params: dict, tokens, targets):
    """``make_train_step`` with ``optax.sgd(MP_LR)`` at ``axes``: the
    losses and the trained full tree (numpy)."""
    n = axes["dp"] * axes["tp"] * axes["sp"]
    mesh = jax_mesh(dp=axes["dp"], pp=1, tp=axes["tp"], sp=axes["sp"],
                    devices=jax.devices()[:n])
    opt = optax.sgd(MP_LR)
    p = JT.shard_params(jax.tree_util.tree_map(jnp.asarray, params), cfg,
                        mesh)
    state = opt.init(p)
    step = JT.make_train_step(cfg, mesh, opt)
    sh = NamedSharding(mesh, JP("dp", "sp"))
    tok, tgt = (jax.device_put(t.numpy().astype(np.int32), sh)
                for t in (tokens, targets))
    losses = []
    for _ in range(MP_STEPS):
        p, state, loss = step(p, state, tok, tgt)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, p)


@functools.lru_cache(maxsize=None)
def _jax_case(name: str):
    case = CASES[name]
    _, _, axes, moe_every, _, _ = case
    cfg = _cfg(moe_every, True)
    params = JT.init_params(np.random.RandomState(0), cfg, ep=axes["dp"])
    return _jax_train(cfg, axes, params, *mp_tokens(case))


def _port_case(name: str):
    """The case's losses on every rank and the full tree joined from
    every rank's shards."""
    case = CASES[name]
    outs = _world(case[1])
    parts = [(o[name]["coord"], o[name]["weights"]) for o in outs]
    return ([o[name]["losses"] for o in outs],
            interop.transformer_to_jax_full(parts, _cfg(case[3], False)))


# ---------------------------------------------------------------------------
# The pieces: f/g, specs, shards, the wqkv permutation, moe_layer
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_fg():
    """The JAX f/g pair over a 2-device tp axis: out, dx, dw per rank."""
    ins = [fg_inputs(r) for r in range(2)]
    x, c = jnp.asarray(ins[0]["x"]), jnp.asarray(ins[0]["c"])
    w = jnp.stack([jnp.asarray(i["w"]) for i in ins])

    def local(x, w, c):
        def loss(x, w):
            out = JS.reduce_from_tp(JS.copy_to_tp(x, "tp") * w[0], "tp")
            return jnp.sum(out * c), out

        (_, out), (dx, dw) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(x, w)
        return out[None], dx[None], dw

    mesh = Mesh(np.array(jax.devices()[:2]), ("tp",))
    fn = jax.jit(shard_map(local, mesh=mesh, check_vma=False,
                           in_specs=(JP(), JP("tp"), JP()),
                           out_specs=(JP("tp"),) * 3))
    return [np.asarray(a) for a in fn(x, w, c)]


@pytest.mark.parametrize("what", ["out", "dx", "dw"])
def test_copy_and_reduce_match_jax(what):
    """f (identity forward, sum backward) and g (sum forward, identity
    backward) over a gloo tp hop of 2: the output, the replicated
    input's gradient (summed over the shards) and each shard's own
    gradient, against the JAX pair under ``shard_map`` and numpy."""
    want = dict(zip(("out", "dx", "dw"), _jax_fg()))[what]
    ins = [fg_inputs(r) for r in range(2)]
    wsum = ins[0]["w"] + ins[1]["w"]
    numpy_want = {"out": lambda r: ins[0]["x"] * wsum,
                  "dx": lambda r: ins[0]["c"] * wsum,
                  "dw": lambda r: ins[0]["x"] * ins[0]["c"]}[what]
    for r, o in enumerate(_world(2)):
        got = np.asarray(o["fg"][what], np.float32)
        np.testing.assert_allclose(got, want[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, numpy_want(r), rtol=1e-6,
                                   atol=1e-6)


def test_copy_and_reduce_are_identities_on_one_rank():
    x = torch.randn(3, 4, requires_grad=True)
    hop = M.Hop([0], 0, None, "tp")
    for fn in (TS.copy_to_tp, TS.reduce_from_tp):
        assert fn(x, hop) is x and fn(x, None) is x


def test_specs_and_reduce_axes_match_jax():
    """``param_specs``, ``spec_axes`` and ``grad_reduce_axes`` against the
    JAX package's, leaf for leaf (MoE on)."""
    def leaves(tree, kind):
        for k in sorted(tree):
            if isinstance(tree[k], kind):
                yield tree[k]
            else:
                yield from leaves(tree[k], kind)

    flat = list(leaves(JT.param_specs(_cfg(2, True)), JP))
    ours = list(leaves(TT.param_specs(_cfg(2, False)), TS.P))
    assert len(flat) == len(ours) == 12
    assert [tuple(s) for s in ours] == [tuple(s) for s in flat]
    for j, t in zip(flat, ours):
        assert TS.spec_axes(t) == JS.spec_axes(j)
        assert TS.grad_reduce_axes(t) == JS.grad_reduce_axes(j)
    specs = TT.param_specs(_cfg(2, False))
    seen = []
    TS.tree_map_with_specs(lambda leaf, s: seen.append((leaf, s)), specs,
                           specs)
    assert all(a is b for a, b in seen) and len(seen) == 12
    assert TS.grad_reduce_axes(TS.P(None, "dp")) == ("sp",)


@pytest.mark.parametrize("axes", [dict(dp=2, tp=2, sp=1),
                                  dict(dp=2, tp=1, sp=2),
                                  dict(dp=1, tp=4, sp=1)],
                         ids=["dp2xtp2", "dp2xsp2", "tp4"])
def test_shard_params_are_jax_shards(axes):
    """Each rank's ``shard_params`` is the block that JAX's
    ``NamedSharding`` of ``param_specs`` places on that device (the
    experts by dp, the column/row matrices by tp), and
    ``unshard_params`` joins them back bit for bit."""
    jcfg, tcfg = _cfg(2, True), _cfg(2, False)
    full = TT.init_params(np.random.RandomState(0), tcfg, ep=axes["dp"])
    n = axes["dp"] * axes["tp"] * axes["sp"]
    mesh = jax_mesh(dp=axes["dp"], pp=1, tp=axes["tp"], sp=axes["sp"],
                    devices=jax.devices()[:n])
    placed = JT.shard_params(jax.tree_util.tree_map(jnp.asarray, full),
                             jcfg, mesh)
    devs = mesh.devices.reshape(axes["dp"], axes["tp"], axes["sp"])
    parts = []
    for d in range(axes["dp"]):
        for t in range(axes["tp"]):
            for s in range(axes["sp"]):
                coord = {"dp": (d, axes["dp"]), "pp": (0, 1),
                         "tp": (t, axes["tp"]), "sp": (s, axes["sp"])}
                ours = TT.shard_params(full, tcfg, coord)
                dev = devs[d, t, s]
                jax.tree_util.tree_map_with_path(
                    lambda p, a, b: np.testing.assert_array_equal(
                        a, next(np.asarray(sh.data) for sh in
                                b.addressable_shards if sh.device == dev),
                        err_msg=jax.tree_util.keystr(p)), ours, placed)
                parts.append((coord, ours))
    back = TT.unshard_params(parts, tcfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, full)


def test_tp_equivalent_wqkv_moves_each_rank_heads():
    """At tp = 2 rank t's local column j of q (k, v) is head ``t*nh/tp +
    j // hd`` of the tp = 1 layout after the permutation, for numpy and
    torch alike, and tp = 1 leaves it alone."""
    nh, hd, tp, dm = 4, 8, 2, 3
    c = nh * hd
    w = np.arange(dm * 3 * c, dtype=np.float32).reshape(dm, 3 * c)
    eq = TT.tp_equivalent_wqkv(w, tp)
    np.testing.assert_array_equal(
        TT.tp_equivalent_wqkv(torch.from_numpy(w), tp).numpy(), eq)
    np.testing.assert_array_equal(TT.tp_equivalent_wqkv(w, 1), w)
    nhl = nh // tp
    for t in range(tp):
        local = w[:, t * 3 * c // tp:(t + 1) * 3 * c // tp].reshape(
            dm, 3, nhl, hd)
        full = eq.reshape(dm, 3, nh, hd)
        np.testing.assert_array_equal(full[:, :, t * nhl:(t + 1) * nhl],
                                      local)


@functools.lru_cache(maxsize=None)
def _jax_moe(dtype):
    """The JAX ``moe_layer`` over a 2-device ep axis and its gradients
    (float32): per rank out, aux, dx, drouter, dw_in, dw_out; and the
    routes computed with the reference's own expressions."""
    ep = 2
    g = moe_inputs(ep)
    router = jnp.asarray(g["router"])
    x = jnp.asarray(g["x"]).astype(dtype)

    def local(xb, wi, wo, rw):
        def f(xb, rw, wi, wo):
            out, aux = JMOE.moe_layer(xb[0], rw, wi, wo, "ep",
                                      capacity_factor=MOE_CAP)
            return jnp.sum(out.astype(jnp.float32) ** 2) + 0.01 * aux, \
                (out, aux)

        (_, (out, aux)), grads = jax.value_and_grad(
            f, argnums=(0, 1, 2, 3), has_aux=True)(xb, rw, wi, wo)
        return (out[None], aux.reshape(1), grads[0], grads[1][None],
                grads[2], grads[3])

    mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))
    fn = jax.jit(shard_map(local, mesh=mesh, check_vma=False,
                           in_specs=(JP("ep"),) * 3 + (JP(),),
                           out_specs=(JP("ep"),) * 6))
    res = [np.asarray(a.astype(jnp.float32))
           for a in fn(x, jnp.asarray(g["w_in"]), jnp.asarray(g["w_out"]),
                       router)]
    routes = []
    for r in range(ep):
        logits = (x[r] @ router).astype(jnp.float32)
        gates = jax.nn.softmax(logits, axis=-1)
        idx = jnp.argmax(gates, axis=-1)
        onehot = jax.nn.one_hot(idx, gates.shape[1], dtype=jnp.float32)
        pos = jnp.cumsum(onehot, axis=0) * onehot
        cap = int(max(1, (x.shape[1] / gates.shape[1]) * MOE_CAP))
        keep = ((pos > 0) & (pos <= cap)).any(-1)
        top2 = jnp.sort(gates, axis=-1)[:, -2:]
        routes.append((np.asarray(idx), np.asarray(keep).astype(int),
                       float(jnp.min(top2[:, 1] - top2[:, 0]))))
    return res, routes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_matches_jax(dtype):
    """``moe_layer`` over a gloo ep hop of 2 (experts 2 per rank): every
    token's expert and keep flag equal JAX's, then the output and aux
    (and in float32 the gradients of ``sum(out**2) + 0.01 aux`` through
    the two all-to-alls) against the JAX ``moe_layer`` under
    ``shard_map``.  bfloat16 tokens meet float32 weights: the router and
    the experts run in float32 as JAX promotes them; the output is held
    to one bfloat16 rounding.  The smallest top-1 gate margin of the
    seeded data is printed."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    res, routes = _jax_moe(jdt)
    names = ("out", "aux", "dx", "drouter", "dw_in", "dw_out")
    want = dict(zip(names, res))
    for r, o in enumerate(_world(2)):
        got = o[f"moe {'f32' if dtype == 'float32' else 'bf16'}"]
        idx, keep, margin = routes[r]
        print(f"moe {dtype} rank {r}: smallest top-1 gate margin "
              f"{margin:.3e}, {int(keep.sum())} of {keep.size} tokens "
              "kept")
        np.testing.assert_array_equal(got["idx"], idx)
        np.testing.assert_array_equal(got["keep"], keep)
        assert margin > 1e-5
        tol = MOE_TOL if dtype == "float32" else dict(rtol=2 ** -8,
                                                      atol=2 ** -8)
        np.testing.assert_allclose(got["out"], want["out"][r], **tol)
        np.testing.assert_allclose(got["aux"], want["aux"][r], **MOE_TOL)
        if dtype == "float32":
            for k in names[2:]:
                # the expert gradients are this rank's experts' rows
                w = want[k].reshape((2, -1) + want[k].shape[1:])[r] \
                    if k.startswith("dw") else want[k][r]
                np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                           w, **MOE_TOL, err_msg=k)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_moe_layer_matches_moe_reference(side):
    """Each rank's ``moe_layer`` output against ``moe_reference`` over all
    experts on its tokens (the port's and the JAX package's golden
    model)."""
    g = moe_inputs(2)
    for r, o in enumerate(_world(2)):
        if side == "port":
            ref = TMOE.moe_reference(
                torch.from_numpy(g["x"][r]), torch.from_numpy(g["router"]),
                torch.from_numpy(g["w_in"]), torch.from_numpy(g["w_out"]),
                capacity_factor=MOE_CAP).numpy()
        else:
            ref = np.asarray(JMOE.moe_reference(
                jnp.asarray(g["x"][r]), jnp.asarray(g["router"]),
                jnp.asarray(g["w_in"]), jnp.asarray(g["w_out"]),
                capacity_factor=MOE_CAP))
        np.testing.assert_allclose(o["moe f32"]["out"], ref, **MOE_TOL)


def test_moe_layer_refuses_a_router_of_another_width():
    g = moe_inputs(2)
    with pytest.raises(TMOE.HorovodTpuError, match="router width"):
        TMOE.moe_layer(torch.from_numpy(g["x"][0]),
                       torch.from_numpy(g["router"]),
                       torch.from_numpy(g["w_in"][:2]),
                       torch.from_numpy(g["w_out"][:2]), None)


# ---------------------------------------------------------------------------
# The LM against make_train_step at the same mesh
# ---------------------------------------------------------------------------

LM_CASES = [c[0] for c in MP_CASES if not c[5]]


@pytest.mark.parametrize("name", LM_CASES)
def test_lm_matches_jax_at_the_same_mesh(name):
    """Losses on every rank and the trained weights joined from every
    rank's shards, against ``make_train_step`` at the same mesh with the
    same full tree, batch and SGD."""
    want_losses, want = _jax_case(name)
    losses, got = _port_case(name)
    for r, ls in enumerate(losses):
        np.testing.assert_allclose(ls, want_losses, rtol=LOSS_RTOL,
                                   err_msg=f"rank {r}")
    _trees_close(got, want)


@pytest.mark.parametrize("name", LM_CASES)
def test_lm_reduction_groups(name):
    """One reduction group over ``("dp", "sp")``; with MoE layers a second
    one over ``("sp",)`` for the experts (which the fused tail launches
    for once more)."""
    moe = CASES[name][3]
    for o in _world(CASES[name][1]):
        assert o[name]["groups"] == ([["dp", "sp"], ["sp"]] if moe else
                                     [["dp", "sp"]])


@pytest.mark.parametrize("name", LM_CASES)
def test_place_ranks_is_the_mesh_layout(name):
    """``place_ranks`` (the layout an emulated world builds its hops
    from) names the members of every hop of the place the model took
    from ``make_mesh`` or the data mesh, on every rank."""
    axes = CASES[name][2]
    for o in _world(CASES[name][1]):
        assert o[name]["hops"] == M.place_ranks(o["rank"], **axes), o["rank"]


def _single_device(cfg, params, tokens, targets):
    return _jax_train(cfg, dict(dp=1, tp=1, sp=1), params, tokens, targets)


def test_sgd_scale_dp2_tp2_matches_one_device():
    """No dp or tp factor: the port at dp 2 x tp 2 (SGD lr 0.5) against
    one device running the same full weights with ``wqkv`` permuted by
    ``tp_equivalent_wqkv`` -- the function the tp model computes."""
    name = "dp2 x tp2"
    cfg = _cfg(0, True)
    params = JT.init_params(np.random.RandomState(0), cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["layers"]["wqkv"] = TT.tp_equivalent_wqkv(
        params["layers"]["wqkv"], 2)
    want_losses, want = _single_device(cfg, params, *mp_tokens(CASES[name]))
    losses, got = _port_case(name)
    got["layers"]["wqkv"] = TT.tp_equivalent_wqkv(got["layers"]["wqkv"], 2)
    for ls in losses:
        np.testing.assert_allclose(ls, want_losses, rtol=LOSS_RTOL)
    _trees_close(got, want)


def test_sgd_scale_moe_dp2_matches_one_device():
    """No dp factor on the experts: the MoE LM at dp 2 with the same rows
    on both dp ranks (SGD lr 0.5) against one device holding all four
    experts on those rows.  Each rank routes exactly as the one device
    does, so the global-mean gradient is the one device's; an expert
    gradient summed over dp by the all-to-all's backward and then
    averaged over sp alone would be twice it."""
    name = "moe dp2 same rows"
    cfg = _cfg(2, True)
    params = JT.init_params(np.random.RandomState(0), cfg, ep=2)
    tok, tgt = mp_tokens(CASES[name])
    rows = tok.shape[0] // 2
    want_losses, want = _single_device(cfg, params, tok[:rows], tgt[:rows])
    losses, got = _port_case(name)
    for ls in losses:
        np.testing.assert_allclose(ls, want_losses, rtol=LOSS_RTOL)
    _trees_close(got, want)


# ---------------------------------------------------------------------------
# Construction, refusals, interop on one process
# ---------------------------------------------------------------------------


def _place(tp: int = 1, dp: int = 1) -> M.Place:
    """A place at index 0 of every axis (hops without process groups:
    construction moves nothing)."""
    hop = {a: M.Hop(range(n), 0, None, a) for a, n in
           (("dp", dp), ("pp", 1), ("tp", tp), ("sp", 1))}
    flat = M.Hop(range(dp), 0, None, "dp*sp")
    return M.Place(hop["dp"], hop["pp"], hop["tp"], hop["sp"],
                   M.HopPair(hop["dp"], hop["sp"], flat))


def test_transformer_holds_its_shards():
    """A tp = 2, dp = 2 place with MoE: the module holds
    ``shard_params`` of the seed's full tree (``init_params(ep=2)``),
    ``transformer_to_jax`` returns it, and ``transformer_from_jax`` cuts
    a full tree to it."""
    cfg = _cfg(2, False)
    place = _place(tp=2, dp=2)
    model = TT.Transformer(cfg, seed=0, device="cpu", mesh=place)
    full = TT.init_params(np.random.RandomState(0), cfg, ep=2)
    want = TT.shard_params(full, cfg, place.coord())
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           interop.transformer_to_jax(model), want)
    assert model.layers[0].wqkv.shape == (32, 48)
    assert model.moe[0].w_in.shape == (2, 32, 64)
    other = TT.init_params(np.random.RandomState(5), cfg, ep=2)
    interop.transformer_from_jax(other, model)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           interop.transformer_to_jax(model),
                           TT.shard_params(other, cfg, place.coord()))


def test_transformer_refuses_a_place_it_cannot_take():
    """The sizes or the mesh, not both; heads that do not split over tp,
    given either way; a tree whose experts are not dp's."""
    cfg = _cfg(0, False)
    with pytest.raises(TypeError, match="not both"):
        TT.Transformer(cfg, device="cpu", tp=2, mesh=_place(tp=2))
    with pytest.raises(TT.HorovodTpuError, match="does not split"):
        TT.Transformer(cfg, device="cpu", mesh=_place(tp=3))
    with pytest.raises(TT.HorovodTpuError, match="does not split"):
        TT.Transformer(cfg, device="cpu", tp=3)
    with pytest.raises(TT.HorovodTpuError, match="experts"):
        TT.Transformer(_cfg(2, False), device="cpu", mesh=_place(dp=2),
                       params=TT.init_params(np.random.RandomState(0),
                                             _cfg(2, False), ep=1))


def test_lm_optimizer_refuses_zero_under_model_parallelism():
    """ZeRO stages 1-3 with tp > 1 or MoE raise, naming the Queue A item
    they wait for; a model without a mesh has no lm_optimizer."""
    from horovod_tpu_torch.optim import fused_update as TF

    for cfg, place in ((_cfg(0, False), _place(tp=2)),
                       (_cfg(2, False), _place())):
        model = TT.Transformer(cfg, seed=0, device="cpu", mesh=place)
        for stage in (1, 2, 3):
            with pytest.raises(NotImplementedError, match="item 10e"):
                lm_optimizer(model, TF.adam(model.parameters(), 1e-3),
                             zero_stage=stage)
    model = TT.Transformer(_cfg(0, False), seed=0, device="cpu")
    with pytest.raises(TT.HorovodTpuError, match="on a mesh"):
        lm_optimizer(model, TF.sgd(model.parameters(), 0.1))


def test_data_mesh_place_refuses_the_hierarchical_split():
    """Under the hierarchical dp split the data mesh has no 'dp' axis (as
    the reference's has none), so the LM cannot take a place there."""
    class Split(M.RankMesh):
        def __init__(self):
            self.axis_names = M.HIER_DATA_AXES + M.AXES[1:]
            self.shape = (2, 2, 1, 1, 1)
            self.hops = {a: None for a in self.axis_names}
            self.flat = {M.HIER_DATA_AXES: None}

    with pytest.raises(TT.HorovodTpuError, match="no dp axis"):
        Split().place()
