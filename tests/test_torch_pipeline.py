"""Pipeline parallelism of the port against the JAX package on the CPU.

The JAX side runs in-process on the CPU mesh of ``tests/conftest.py``
(``shard_map`` over a ``pp`` axis for the generic pipelines,
``make_train_step`` at the same mesh for the LM); the port side runs on
spawned gloo worlds of 2 and 4 ranks (``_torch_collectives_worker.
pp_main``), one spawn per world size for every case.

- The schedules and the stage splits equal the reference's.
- The generic pipelines (tanh layers, M = 4 microbatches of 2 x 3, as
  ``tests/test_pipeline_moe.py``): GPipe with two layers per stage and
  the interleaved schedule with two chunks of one layer per rank, at pp
  = 2 and 4, with and without ``remat``: the output and the gradients of
  ``sum(out * c)`` (each rank's stage weights and the microbatches)
  within rtol 1e-5 / atol 1e-6 of the JAX device of the same index
  (``test_pipeline_moe.py:52``); ``remat`` gradients within rtol 1e-6 /
  atol 1e-7 of those without it (``:242``).
- The LM (vocab 64, d_model 32, 4 heads x 8, 4 layers, d_ff 64,
  float32), batch 4 x 64, SGD lr 0.5, 3 steps, at pp 2 (gpipe,
  interleaved with ``pp_virtual=2`` over 8 layers, ``pp_remat``), dp 2 x
  pp 2, pp 2 x tp 2, pp 2 x sp 2 and ``HOROVOD_MESH=dp:2,pp:2``: the loss
  of every rank at pp index 0 within rtol 1e-4 of the JAX loss (device
  0's), and every rank's weights within 1e-4 of the largest magnitude of
  its own JAX device's shard.  The replicated leaves are compared rank by
  rank because they drift apart over pp on the reference: nothing sums
  their gradients over pp (ROADMAP.md, "Handled, kept as traps").
- The factor: the step-1 layer gradients (and stage 0's ``pos``) at pp =
  2 are twice pp = 1's, ``ln_f``'s equal them; stage 0's ``embed``
  gradient carries twice the input part of pp = 1's, stage 1's none.
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
from horovod_tpu.parallel import pipeline as JPL
from horovod_tpu.parallel.mesh import make_mesh as jax_mesh
from horovod_tpu_torch import interop
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.optim import fused_update as TF
from horovod_tpu_torch.parallel import mesh as M
from horovod_tpu_torch.parallel import pipeline as TPL
from horovod_tpu_torch.train_step import (lm_optimizer, synthetic_tokens,
                                          zero3_lm_train_step)

sys.path.insert(0, os.path.dirname(__file__))
from _torch_collectives_worker import (  # noqa: E402
    MP_BATCH, MP_LR, MP_STEPS, PIPE_CASES, PP_CASES, SP_LM, mp_tokens,
    pipe_inputs, spawn)

WORLDS = (2, 4)
PIPE_TOL = dict(rtol=1e-5, atol=1e-6)     # tests/test_pipeline_moe.py:52
REMAT_TOL = dict(rtol=1e-6, atol=1e-7)    # tests/test_pipeline_moe.py:242
LOSS_RTOL, WEIGHT_TOL, FACTOR_TOL = 1e-4, 1e-4, 1e-4
PIPE = {c[0]: c for c in PIPE_CASES}
LM = {c[0]: c for c in PP_CASES}


@functools.lru_cache(maxsize=None)
def _world(n: int) -> list:
    """Every case's results on a gloo world of ``n`` ranks."""
    return spawn(n, "cpu", timeout=300, mode="pp")


def _scaled_close(ours, ref, what, tol=WEIGHT_TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(
        np.asarray(ours, np.float32), ref, rtol=0,
        atol=tol * max(np.abs(ref).max(), 1e-30), err_msg=what)


def _trees_close(ours: dict, ref: dict, prefix="", tol=WEIGHT_TOL):
    assert sorted(ours) == sorted(ref), (prefix, sorted(ours), sorted(ref))
    for k, v in ref.items():
        if isinstance(v, dict):
            _trees_close(ours[k], v, f"{prefix}{k}/", tol)
        else:
            _scaled_close(ours[k], v, prefix + k, tol)


def _cfg(fields: dict, jax_side: bool):
    mod = JT if jax_side else TT
    return mod.TransformerConfig(**dict(SP_LM, **fields), dtype="float32")


# ---------------------------------------------------------------------------
# Schedules and stage splits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("v", (1, 2, 3))
@pytest.mark.parametrize("p", (2, 3, 4))
def test_interleaved_schedule_matches_jax(p, v, m):
    """The port's copy of the greedy schedule gives the reference's
    ``(steps, run)`` tables; for M >= P it takes ``M*V + P - 1`` steps,
    and at V = 1 it is GPipe's fill-drain table."""
    steps, run = TPL.interleaved_schedule(p, v, m)
    assert (steps, run) == JPL.interleaved_schedule(p, v, m)
    if m >= p:
        assert steps == m * v + p - 1
    if v == 1:
        assert (steps, run) == TPL.gpipe_schedule(p, m)


@pytest.mark.parametrize("p,v", [(2, 1), (2, 2), (4, 2), (2, 4)])
def test_stage_splits_match_jax(p, v):
    """``stage_split`` and ``interleaved_stage_split`` on dicts of tensors
    cut what the reference's cut from the same arrays, for every stage;
    a layer count that does not divide raises with its message."""
    rng = np.random.RandomState(3)
    tree = {"a": rng.randn(8, 3).astype(np.float32),
            "b": {"c": rng.randn(8, 2, 2).astype(np.float32)}}
    ours = {"a": torch.from_numpy(tree["a"]),
            "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    for stage in range(p):
        for got, want in (
                (TPL.stage_split(ours, p, stage),
                 JPL.stage_split(jtree, p, stage)),
                (TPL.interleaved_stage_split(ours, p, v, stage),
                 JPL.interleaved_stage_split(jtree, p, v, stage))):
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_array_equal(a.numpy(), b),
                got, want)
    with pytest.raises(HorovodTpuError, match="not divisible by 3 stages"):
        TPL.stage_split(ours, 3, 0)
    with pytest.raises(HorovodTpuError, match=r"3 stages x 2 virtual"):
        TPL.interleaved_stage_split(ours, 3, 2, 0)


@pytest.mark.parametrize("n,pp,v", [(8, 2, 2), (12, 2, 3), (12, 4, 3),
                                    (4, 2, 1), (12, 3, 2)])
def test_interleave_layer_order_matches_jax(n, pp, v):
    np.testing.assert_array_equal(TT.interleave_layer_order(n, pp, v),
                                  JT.interleave_layer_order(n, pp, v))
    with pytest.raises(ValueError, match="not divisible"):
        TT.interleave_layer_order(n + 1, pp, v)


def test_pipeline_refuses_what_the_reference_refuses():
    hop = M.Hop([0], 0, None, "pp")
    x = torch.zeros(2, 1, 3)
    with pytest.raises(HorovodTpuError, match="n_virtual == 1"):
        TPL.pipeline(lambda w, h: h, None, x, hop, n_virtual=2)
    with pytest.raises(HorovodTpuError, match="unknown pipeline schedule"):
        TPL.pipeline(lambda w, h: h, None, x, hop, schedule="1f1b")


def test_permute_refuses_repeated_ends():
    hop = M.Hop([0, 1], 0, None, "pp")
    with pytest.raises(HorovodTpuError, match="repeat a destination"):
        hop.permute(torch.zeros(1), [(0, 1), (1, 1)])
    with pytest.raises(HorovodTpuError, match="holds nothing"):
        hop.permute(None, [(0, 1)], like=torch.zeros(1))


def test_one_stage_pipelines_are_the_stage():
    """A hop of one rank: GPipe is the stage on each microbatch, the
    interleaved schedule its V chunks in order (the chunk's output goes
    to the same rank), gradients included."""
    hop = M.Hop([0], 0, None, "pp")
    rng = np.random.RandomState(9)
    w = torch.from_numpy(rng.randn(2, 3, 3).astype(np.float32))
    x = torch.from_numpy(rng.randn(4, 2, 3).astype(np.float32))

    def stage(wp, h):
        for layer in wp:
            h = torch.tanh(h @ layer)
        return h

    want_w = w.clone().requires_grad_()
    want = stage(want_w, x)
    want.sum().backward()
    for fn in (lambda wp: TPL.gpipe(stage, wp, x, hop),
               lambda wp: TPL.interleaved_pipeline(
                   stage, wp.reshape(2, 1, 3, 3), x, 2, hop)):
        ww = w.clone().requires_grad_()
        out = fn(ww)
        out.sum().backward()
        torch.testing.assert_close(out, want, **PIPE_TOL)
        torch.testing.assert_close(ww.grad, want_w.grad, **PIPE_TOL)


# ---------------------------------------------------------------------------
# The generic pipelines against the JAX package under shard_map
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_pipe(name: str, n: int):
    """The case on an n-device ``pp`` mesh: per device out, dw, dx."""
    case = PIPE[name]
    _, schedule, v, per, remat, bcast = case
    a = pipe_inputs(case, n)
    f = a["w"].shape[-1]
    w = jnp.asarray(a["w"])
    if schedule == "gpipe":
        ws = w.reshape(n, per, f, f)
    else:
        ws = jnp.stack([JPL.interleaved_stage_split(w, n, v, p)
                        for p in range(n)])
    c = jnp.asarray(a["c"])

    def stage(wp, h):
        for i in range(wp.shape[0]):
            h = jnp.tanh(h @ wp[i])
        return h

    def per_rank(wl, x):
        def loss(wl, x):
            out = JPL.pipeline(stage, wl[0], x, "pp", schedule=schedule,
                               n_virtual=v, broadcast_result=bcast,
                               remat=remat)
            return jnp.sum(out * c), out

        (_, out), (dw, dx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(wl, x)
        return out[None], dw, dx[None]

    mesh = Mesh(np.array(jax.devices()[:n]), ("pp",))
    fn = jax.jit(shard_map(per_rank, mesh=mesh, check_vma=False,
                           in_specs=(JP("pp"), JP()),
                           out_specs=(JP("pp"),) * 3))
    return [np.asarray(t) for t in fn(ws, jnp.asarray(a["x"]))]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", [c[0] for c in PIPE_CASES])
def test_pipeline_matches_jax(name, n):
    """Every rank's output and gradients against the JAX device of its
    index: the broadcast's backward sums the cotangents over pp, so stage
    weights and stage 0's input gradient carry the factor P on both
    sides; without ``broadcast_result`` only the last stage holds the
    result."""
    want = _jax_pipe(name, n)
    for r, o in enumerate(_world(n)):
        got = o[name]
        for k, w in zip(("out", "dw", "dx"), want):
            np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                       w[r], **PIPE_TOL,
                                       err_msg=f"{name} {k} rank {r}")
        if not PIPE[name][5] and r != n - 1:
            assert not np.asarray(got["out"]).any()


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("schedule", ["gpipe", "interleaved"])
def test_remat_gradients_equal_stored(schedule, n):
    for o in _world(n):
        for k in ("out", "dw", "dx"):
            np.testing.assert_allclose(
                np.asarray(o[f"{schedule} remat"][k], np.float32),
                np.asarray(o[schedule][k], np.float32), **REMAT_TOL,
                err_msg=k)


# ---------------------------------------------------------------------------
# The LM against make_train_step at the same mesh
# ---------------------------------------------------------------------------


def _device_tree(tree, dev) -> dict:
    """The shards of a placed JAX tree on ``dev`` (numpy)."""
    return jax.tree_util.tree_map(
        lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                       if s.device == dev), tree)


@functools.lru_cache(maxsize=None)
def _jax_lm(name: str):
    """``make_train_step`` with ``optax.sgd(MP_LR)`` at the case's mesh:
    the losses and each device's trained local tree."""
    _, n, axes, fields, _ = LM[name]
    cfg = _cfg(fields, True)
    mesh = jax_mesh(**axes, devices=jax.devices()[:n])
    params = JT.init_params(np.random.RandomState(0), cfg)
    opt = optax.sgd(MP_LR)
    p = JT.shard_params(params, cfg, mesh)
    state = opt.init(p)
    step = JT.make_train_step(cfg, mesh, opt)
    sh = NamedSharding(mesh, JP("dp", "sp"))
    tok, tgt = (jax.device_put(t.numpy().astype(np.int32), sh)
                for t in mp_tokens((None, None, axes, 0, None, False)))
    losses = []
    for _ in range(MP_STEPS):
        p, state, loss = step(p, state, tok, tgt)
        losses.append(float(loss))
    return losses, [_device_tree(p, d) for d in mesh.devices.reshape(-1)]


@pytest.mark.parametrize("name", [c[0] for c in PP_CASES])
def test_lm_matches_jax_rank_by_rank(name):
    """The loss of every rank at pp index 0 (the reference reports
    device 0's) and every rank's local weights, the replicated leaves
    included, against the JAX device of its index."""
    want_losses, want = _jax_lm(name)
    outs = _world(LM[name][1])
    for r, o in enumerate(outs):
        got = o[name]
        if got["coord"]["pp"][0] == 0:
            np.testing.assert_allclose(got["losses"], want_losses,
                                       rtol=LOSS_RTOL, err_msg=f"rank {r}")
        _trees_close(got["weights"], want[r], f"rank {r} ")


def test_replicated_leaves_drift_apart_over_pp():
    """As on the reference, the two stages' ``embed`` differ after a step
    (each trains on its own gradient), on both sides."""
    _, want = _jax_lm("pp2 gpipe")
    outs = _world(2)
    for tree in (want, [o["pp2 gpipe"]["weights"] for o in outs]):
        gap = np.abs(np.asarray(tree[0]["embed"])
                     - np.asarray(tree[1]["embed"])).max()
        assert gap > 1e-3, gap


@pytest.mark.parametrize("name", [c[0] for c in PP_CASES])
def test_lm_groups_are_the_ranks_own(name):
    """One reduction group, over ``("dp", "sp")`` at this rank's own
    ``(pp, tp)`` coordinate (no gradient is summed over pp); the place's
    hops are ``place_ranks``'s; the rank holds ``n_layers / pp``
    blocks."""
    _, n, axes, fields, _ = LM[name]
    cfg = _cfg(fields, False)
    for o in _world(n):
        got, layout = o[name], M.place_ranks(o["rank"], **axes)
        assert got["groups"] == [["dp", "sp"]]
        assert got["group_ranks"] == [layout["dp*sp"]]
        assert got["hops"] == layout
        assert got["layers"] == cfg.n_layers // axes["pp"]
        pps = {r // (axes["tp"] * axes["sp"]) % axes["pp"]
               for r in got["group_ranks"][0]}
        assert pps == {got["coord"]["pp"][0]}


def _pp1_grads(cfg) -> dict:
    """One process holding every layer: the step-1 gradient of the mean
    loss over the whole batch (numpy, JAX layout)."""
    model = TT.Transformer(cfg, seed=0, device="cpu")
    tok, tgt = synthetic_tokens(MP_BATCH, SP_LM["max_seq"], cfg.vocab,
                                seed=1, device="cpu")
    TT.loss_fn(model(tok), tgt).backward()
    return interop.transformer_to_jax(model, grads=True)


def test_pp2_gradients_are_twice_pp1():
    """The reference's factor, pinned: at pp = 2 the step-1 layer
    gradients joined from both stages and stage 0's ``pos`` gradient are
    2 x pp = 1's; ``ln_f``'s equals pp = 1's on both stages; stage 1's
    ``pos`` gradient is zero, and pp = 1's ``embed`` gradient is stage
    1's (the head alone) plus half of what stage 0 adds (twice the
    input's)."""
    cfg = _cfg({}, False)
    want = _pp1_grads(cfg)
    outs = [o["pp2 gpipe"] for o in _world(2)]
    full = TT.unshard_params([(o["coord"], o["grads"]) for o in outs], cfg)
    for k, g in want["layers"].items():
        _scaled_close(full["layers"][k], 2 * g, f"layers/{k}", FACTOR_TOL)
    g0, g1 = outs[0]["grads"], outs[1]["grads"]
    _scaled_close(g0["pos"], 2 * want["pos"], "pos", FACTOR_TOL)
    assert not np.asarray(g1["pos"]).any()
    for g in (g0, g1):
        _scaled_close(g["ln_f"], want["ln_f"], "ln_f", FACTOR_TOL)
    e0, e1 = (np.asarray(g["embed"], np.float32) for g in (g0, g1))
    _scaled_close(e1 + (e0 - e1) / 2, want["embed"], "embed", FACTOR_TOL)


# ---------------------------------------------------------------------------
# Shards, interop and refusals on one process
# ---------------------------------------------------------------------------

SHARD_CASES = {"pp2 gpipe": (dict(dp=1, pp=2, tp=1, sp=1), {}),
               "pp2 interleaved": (dict(dp=1, pp=2, tp=1, sp=1),
                                   dict(n_layers=8, pp_schedule="interleaved",
                                        pp_virtual=2)),
               "pp4 interleaved v2": (dict(dp=1, pp=4, tp=1, sp=1),
                                      dict(n_layers=8,
                                           pp_schedule="interleaved",
                                           pp_virtual=2)),
               "dp2 x pp2 x tp2": (dict(dp=2, pp=2, tp=2, sp=1), {})}


def _coord(axes: dict, r: int) -> dict:
    idx = np.unravel_index(r, tuple(axes[a] for a in M.AXES))
    return {a: (int(i), axes[a]) for a, i in zip(M.AXES, idx)}


@pytest.mark.parametrize("name", sorted(SHARD_CASES))
def test_shard_params_are_jax_shards_under_pp(name):
    """Each rank's ``shard_params`` of the model-order tree is the block
    JAX's ``shard_params`` places on that device (the interleaved
    storage permutation first); ``unshard_params`` of them is JAX's
    placed tree, in storage order."""
    axes, fields = SHARD_CASES[name]
    jcfg, tcfg = _cfg(fields, True), _cfg(fields, False)
    full = TT.init_params(np.random.RandomState(0), tcfg)
    n = int(np.prod(list(axes.values())))
    mesh = jax_mesh(**axes, devices=jax.devices()[:n])
    placed = JT.shard_params(jax.tree_util.tree_map(jnp.asarray, full),
                             jcfg, mesh)
    parts = []
    for r, dev in enumerate(mesh.devices.reshape(-1)):
        coord = _coord(axes, r)
        ours = TT.shard_params(full, tcfg, coord)
        jax.tree_util.tree_map(np.testing.assert_array_equal, ours,
                               _device_tree(placed, dev))
        parts.append((coord, ours))
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           TT.unshard_params(parts, tcfg),
                           jax.tree_util.tree_map(np.asarray, placed))


def _place(pp: int = 2, index: int = 0) -> M.Place:
    """A place at pp index ``index`` of ``pp`` (hops without process
    groups: construction moves nothing)."""
    hop = {a: M.Hop(range(n), index if a == "pp" else 0, None, a)
           for a, n in (("dp", 1), ("pp", pp), ("tp", 1), ("sp", 1))}
    return M.Place(hop["dp"], hop["pp"], hop["tp"], hop["sp"],
                   M.HopPair(hop["dp"], hop["sp"], M.Hop([0], 0, None,
                                                         "dp*sp")))


@pytest.mark.parametrize("index", [0, 1])
def test_transformer_holds_its_stage(index):
    """At pp 2 interleaved (8 layers, 2 chunks) stage ``index`` holds the
    storage-order shard: ``transformer_to_jax`` returns it,
    ``transformer_from_jax`` cuts a storage-order tree to it, and with
    ``local=True`` loads a stage's own tree as it is."""
    fields = dict(n_layers=8, pp_schedule="interleaved", pp_virtual=2)
    cfg = _cfg(fields, False)
    place = _place(2, index)
    model = TT.Transformer(cfg, seed=0, device="cpu", mesh=place)
    assert len(model.layers) == 4
    full = TT.init_params(np.random.RandomState(0), cfg)
    want = TT.shard_params(full, cfg, place.coord())
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           interop.transformer_to_jax(model), want)
    order = TT.interleave_layer_order(8, 2, 2)
    np.testing.assert_array_equal(
        want["layers"]["w1"], full["layers"]["w1"][order[4 * index:
                                                         4 * index + 4]])
    other = TT.storage_order(TT.init_params(np.random.RandomState(5), cfg),
                             cfg, 2)
    interop.transformer_from_jax(other, model)
    mine = TT.cut_params(other, cfg, place.coord())
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           interop.transformer_to_jax(model), mine)
    mine["embed"] = mine["embed"] + 1.0
    interop.transformer_from_jax(mine, model, local=True)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           interop.transformer_to_jax(model), mine)


def test_pipeline_refusals():
    """MoE under pp raises the reference's message; ZeRO stages 1-3
    under pp raise naming item 10e (``lm_optimizer`` and
    ``zero3_lm_train_step``); layers that do not split over the stages
    or chunks raise; rows that do not split into microbatches raise."""
    with pytest.raises(NotImplementedError,
                       match="MoE layers under pipeline parallelism"):
        TT.Transformer(_cfg(dict(moe_every=2), False), device="cpu",
                       mesh=_place())
    model = TT.Transformer(_cfg({}, False), seed=0, device="cpu",
                           mesh=_place())
    for stage in (1, 2, 3):
        with pytest.raises(NotImplementedError,
                           match="pipeline parallelism.*item 10e"):
            lm_optimizer(model, TF.adam(model.parameters(), 1e-3),
                         zero_stage=stage)
    with pytest.raises(NotImplementedError, match="item 10e"):
        zero3_lm_train_step(model, None, None, None, None)
    with pytest.raises(HorovodTpuError, match="does not split over pp=3"):
        TT.Transformer(_cfg({}, False), device="cpu", mesh=_place(3))
    with pytest.raises(ValueError, match="not divisible"):
        TT.Transformer(_cfg(dict(pp_schedule="interleaved", pp_virtual=4),
                            False), device="cpu", mesh=_place(2))
    with pytest.raises(HorovodTpuError, match="pp_microbatches=2"):
        model(torch.zeros(3, 8, dtype=torch.long))
