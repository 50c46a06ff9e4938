"""Sequence parallelism of the port against the JAX package on the CPU.

The JAX side runs in-process on the CPU mesh of ``tests/conftest.py``
through ``shard_map``, as ``tests/test_sequence_parallel.py`` does; the
port side runs on spawned gloo worlds of 2 and 4 ranks
(``_torch_collectives_worker.sp_main``), one spawn per world size for
every case.  Inputs are seeded numpy arrays at (B, L, H, D) = (2, 64, 8,
16).

Tolerances are the reference's: forward rtol 2e-4 / atol 2e-5 (float32)
and rtol 0.1 / atol 0.05 (bfloat16) (``test_sequence_parallel.py:48,
158``); dQ, dK and dV rtol 5e-3 / atol 5e-4 (``:142``) against the JAX
ring's gradient of the per-rank loss ``sum(out * g)``, which is the
gradient of the summed loss (no SP factor: that belongs to the
reference test's ``psum`` inside the loss); JAX cannot differentiate the
reference's Ulysses (its untiled ``all_to_all`` has no transpose), so
the port's Ulysses gradients are held against the JAX contiguous ring's,
the gradient of the same function.  The LM (vocab 64, d_model
32, 4 heads x 8, 4 layers, d_ff 64, float32, SGD lr 0.5, 3 steps) at dp
x sp = 1 x 2 and 2 x 2: losses within rtol 1e-4 and weights within 1e-4
of each tensor's largest magnitude, against the port at sp = 1 and the
JAX package's ``make_train_step`` on one device (the float32 tolerances
of ``tests/test_torch_transformer.py``).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel import ring_attention as JR
from horovod_tpu.parallel import ulysses as JU
from horovod_tpu.parallel.mesh import make_mesh
import horovod_tpu_torch as hvd
from horovod_tpu_torch import interop
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.optim import fused_update as TF
from horovod_tpu_torch.parallel import ring_attention as TR
from horovod_tpu_torch.parallel import ulysses as TU
from horovod_tpu_torch.train_step import (lm_train_step, shard_tokens,
                                          synthetic_tokens)

sys.path.insert(0, os.path.dirname(__file__))
from _torch_collectives_worker import (  # noqa: E402
    SP_CASES, SP_LM, SP_LM_BATCH, SP_LM_LR, SP_LM_STEPS, SP_SHAPE, sp_inputs,
    sp_lm_layout, spawn)

WORLDS = (2, 4)
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=0.1, atol=0.05)
GRAD_TOL = dict(rtol=5e-3, atol=5e-4)
LM_LOSS_RTOL, LM_WEIGHT_TOL = 1e-4, 1e-4
CASES = [name for name, _, _ in SP_CASES]
RING_CASES = [name for name, fn, _ in SP_CASES if fn == "ring"]


@functools.lru_cache(maxsize=None)
def _world(n: int) -> list:
    """Every case's results on a gloo world of ``n`` ranks."""
    return spawn(n, "cpu", timeout=300, mode="sp")


def _gathered(n: int, key: str, what: str) -> np.ndarray:
    """The ranks' chunks of ``what`` in case ``key``, in rank order."""
    return np.concatenate([np.asarray(o[key][what], np.float32)
                           for o in _world(n)], axis=1)


@functools.lru_cache(maxsize=None)
def _jax_case(name: str, causal: bool, sp: int, dtype=jnp.float32):
    """The JAX package's (out, dq, dk, dv) under ``shard_map`` over ``sp``
    devices, in the sharded layout."""
    _, fn, layout = dict((c[0], c) for c in SP_CASES)[name]
    x = {n: jnp.asarray(a).astype(dtype) for n, a in sp_inputs().items()}
    if layout == "zigzag":
        x = {n: JR.zigzag_shard(a, sp) for n, a in x.items()}

    def local(q, k, v, g):
        def f(q, k, v):
            # the reference's Ulysses has no VJP (JAX cannot transpose its
            # untiled all_to_all): its gradients are taken through the
            # contiguous ring, the same function of the same chunks
            o = JR.ring_attention(q, k, v, "sp", causal=causal,
                                  layout=layout)
            return (o.astype(jnp.float32) * g.astype(jnp.float32)).sum(), o

        (_, o), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
        if fn == "ulysses":
            o = JU.ulysses_attention(q, k, v, "sp", causal=causal)
        return (o, *grads)

    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    spec = P(None, "sp")
    run = jax.jit(shard_map(local, mesh=mesh, check_vma=False,
                            in_specs=(spec,) * 4, out_specs=(spec,) * 4))
    return [np.asarray(a.astype(jnp.float32))
            for a in run(x["q"], x["k"], x["v"], x["g"])]


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------


def _global_positions(idx: int, sp: int, lc: int, layout: str):
    """Global token positions of sequence rank ``idx``'s local rows."""
    if layout == "zigzag":
        return np.asarray(TR._zigzag_order(sp * lc, sp))[
            idx * lc:(idx + 1) * lc]
    return idx * lc + np.arange(lc)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("layout", TR.LAYOUTS)
@pytest.mark.parametrize("sp", [1, 2, 3, 4])
def test_ring_plan_covers_every_pair_once_with_the_global_mask(sp, layout,
                                                               causal):
    """Over a rank's ring, every (query, key) pair of the global sequence
    sits in exactly one launch; a launch that runs masks exactly the
    pairs the global causal mask hides, and a skipped launch holds only
    hidden pairs."""
    lc = 8
    for idx in range(sp):
        plan = TR.ring_plan(idx, sp, lc, causal, layout)
        assert len(plan) == sp
        gq = _global_positions(idx, sp, lc, layout)
        seen = np.zeros((lc, sp * lc), int)
        for j, step in enumerate(plan):
            gk = _global_positions((idx - j) % sp, sp, lc, layout)
            for a in step:
                qi = np.arange(lc)[a.q]
                ki = np.arange(lc)[a.kv]
                glob = gq[qi][:, None] >= gk[ki][None, :]
                if not causal:
                    glob = np.ones_like(glob)
                local = (~np.zeros_like(glob) if not a.causal else
                         (a.q_offset + np.arange(len(qi)))[:, None]
                         >= (a.k_offset + np.arange(len(ki)))[None, :])
                if a.run:
                    np.testing.assert_array_equal(local, glob)
                else:
                    assert not glob.any()
                seen[np.ix_(qi, gk[ki])] += 1
        np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("sp", [1, 2, 4, 8])
def test_ring_plan_launch_counts(sp):
    """Per pass, causal: contiguous rank i runs i + 1 launches of (lc x
    lc), zigzag rank i 2sp + 1 of (lc/2 x lc/2), 2sp - 1 full and 2
    diagonal; in (lc/2)^2 score blocks of work (a diagonal block half)
    4i + 2 against 2sp.  Without the mask every rank runs sp."""
    lc = 16
    for i in range(sp):
        cont = [a for s in TR.ring_plan(i, sp, lc) for a in s if a.run]
        zig = [a for s in TR.ring_plan(i, sp, lc, layout="zigzag")
               for a in s if a.run]
        assert len(cont) == i + 1
        assert all(a.q == a.kv == slice(0, lc) for a in cont)
        assert len(zig) == 2 * sp + 1
        assert sum(not a.causal for a in zig) == 2 * sp - 1
        assert all((a.q.stop - a.q.start, a.kv.stop - a.kv.start)
                   == (lc // 2, lc // 2) for a in zig)

        def work(launches):
            return sum((a.q.stop - a.q.start) * (a.kv.stop - a.kv.start)
                       * (0.5 if a.causal and a.q_offset == a.k_offset
                          else 1.0) for a in launches) / (lc // 2) ** 2

        assert work(cont) == 4 * i + 2
        assert work(zig) == 2 * sp
        for layout in TR.LAYOUTS:
            full = TR.ring_plan(i, sp, lc, False, layout)
            assert [len(s) for s in full] == [1] * sp
            assert all(a.run and not a.causal for s in full for a in s)


def test_ring_plan_refuses_bad_arguments():
    with pytest.raises(ValueError, match="layout"):
        TR.ring_plan(0, 2, 8, layout="striped")
    with pytest.raises(ValueError, match="even"):
        TR.ring_plan(0, 2, 7, layout="zigzag")
    with pytest.raises(ValueError, match="outside"):
        TR.ring_plan(2, 2, 8)


@pytest.mark.parametrize("length,block_k,bk", [(64, 16, 16), (64, 20, 2),
                                               (64, 512, 64)])
def test_blockwise_plan_halves_the_block(length, block_k, bk):
    (step,) = TR.blockwise_plan(length, block_k)
    assert [(a.kv.start, a.kv.stop, a.k_offset) for a in step] == [
        (j, j + bk, j) for j in range(0, length, bk)]
    assert all(a.q == slice(0, length) and a.q_offset == 0 and a.run
               for a in step)


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_zigzag_shard_round_trip_matches_jax(sp):
    x = np.arange(2 * 32 * 3, dtype=np.float32).reshape(2, 32, 3)
    ours = TR.zigzag_shard(torch.from_numpy(x), sp)
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(JR.zigzag_shard(x, sp)))
    np.testing.assert_array_equal(TR.zigzag_unshard(ours, sp).numpy(), x)
    y = np.arange(4 * 2 * 8, dtype=np.float32).reshape(4 * 2, 8)
    np.testing.assert_array_equal(
        TR.zigzag_shard(torch.from_numpy(y), sp, axis=0).numpy(),
        np.asarray(JR.zigzag_shard(y, sp, axis=0)))
    with pytest.raises(ValueError, match="multiple of 2"):
        TR.zigzag_shard(torch.zeros(1, 2 * sp + 1), sp)


# ---------------------------------------------------------------------------
# Attention on gloo worlds against the JAX package under shard_map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("sp", WORLDS)
def test_forward_matches_jax(sp, name, causal):
    key = f"{name} causal={causal}"
    np.testing.assert_allclose(_gathered(sp, key, "out"),
                               _jax_case(name, causal, sp)[0],
                               err_msg=key, **FWD_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("sp", WORLDS)
def test_gradients_match_jax(sp, name, causal):
    key = f"{name} causal={causal}"
    ref = _jax_case(name, causal, sp)
    for i, what in enumerate(("dq", "dk", "dv"), 1):
        np.testing.assert_allclose(_gathered(sp, key, what), ref[i],
                                   err_msg=f"{key} {what}", **GRAD_TOL)


@pytest.mark.parametrize("name", RING_CASES)
@pytest.mark.parametrize("sp", WORLDS)
def test_bf16_forward_matches_jax(sp, name):
    np.testing.assert_allclose(
        _gathered(sp, f"{name} bf16", "out"),
        _jax_case(name, True, sp, jnp.bfloat16)[0], **BF16_TOL)


@pytest.mark.parametrize("sp", WORLDS)
def test_zigzag_output_unshards_to_dense_attention(sp):
    """The zigzag ring's gathered output, unsharded, is dense attention
    over the global sequence."""
    x = {n: torch.from_numpy(a) for n, a in sp_inputs().items()}
    dense = TR.reference_attention(x["q"], x["k"], x["v"], True)
    out = TR.zigzag_unshard(torch.from_numpy(
        _gathered(sp, "zigzag causal=True", "out")), sp)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), **FWD_TOL)


@pytest.mark.parametrize("block_k", [16, 20])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_blockwise_attention_matches_jax(causal, block_k):
    a = sp_inputs()
    x = {n: torch.from_numpy(v).requires_grad_(n != "g")
         for n, v in a.items()}
    out = TR.blockwise_attention(x["q"], x["k"], x["v"], causal, block_k)
    (out * x["g"]).sum().backward()

    def f(q, k, v):
        o = JR.blockwise_attention(q, k, v, causal=causal, block_k=block_k)
        return (o * a["g"]).sum(), o

    (_, ref), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a[n]) for n in "qkv"))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **FWD_TOL)
    for n, g in zip("qkv", grads):
        np.testing.assert_allclose(x[n].grad.numpy(), np.asarray(g),
                                   err_msg=f"d{n}", **GRAD_TOL)


def test_ulysses_refuses_heads_not_divisible(monkeypatch):
    monkeypatch.setattr(TU, "group_place", lambda group: (3, 0))
    with pytest.raises(HorovodTpuError, match="must divide"):
        TU.seq_to_heads(torch.zeros(1, 4, 8, 8), object())


@pytest.mark.parametrize("sp", WORLDS)
def test_sequence_groups_refuse_a_layout_off_the_world(sp):
    assert all(o["groups_refused"] for o in _world(sp))


def test_shard_tokens_is_the_dp_sp_block():
    x = torch.arange(4 * 12).reshape(4, 12)
    np.testing.assert_array_equal(shard_tokens(x, 2, 3, 1, 2).numpy(),
                                  x[2:4, 8:12].numpy())
    with pytest.raises(HorovodTpuError, match="does not split"):
        shard_tokens(x, 3, 2, 0, 0)


# ---------------------------------------------------------------------------
# The LM at dp x sp
# ---------------------------------------------------------------------------


def _batch():
    return synthetic_tokens(SP_LM_BATCH, SP_LM["max_seq"], SP_LM["vocab"],
                            seed=1, device="cpu")


@pytest.fixture(scope="module")
def lm_sp1():
    """The port at world 1, sp = 1, on the global batch: initial logits,
    losses and weights."""
    with pytest.MonkeyPatch.context() as mp:
        for k in ("HOROVOD_SIZE", "HOROVOD_RANK", "HOROVOD_LOCAL_RANK",
                  "HOROVOD_LOCAL_SIZE"):
            mp.delenv(k, raising=False)
        hvd.init(device="cpu")
        try:
            cfg = TT.TransformerConfig(**SP_LM, dtype="float32")
            model = TT.Transformer(cfg, seed=0, device="cpu")
            opt = hvd.DistributedOptimizer(TF.sgd(model.parameters(),
                                                  SP_LM_LR))
            tok, tgt = _batch()
            with torch.no_grad():
                logits = model(tok).numpy()
            losses = [float(lm_train_step(model, opt, tok, tgt))
                      for _ in range(SP_LM_STEPS)]
            return logits, losses, model
        finally:
            hvd.shutdown()


@pytest.fixture(scope="module")
def lm_jax():
    """The JAX package's ``make_train_step`` on a one-device mesh, same
    weights, batch and SGD: losses and parameters."""
    cfg = JT.TransformerConfig(**SP_LM, dtype="float32")
    mesh = make_mesh(dp=1, pp=1, tp=1, sp=1, devices=jax.devices()[:1])
    opt = jhvd.fused_update.sgd(SP_LM_LR)
    params = JT.shard_params(jax.tree_util.tree_map(
        jnp.asarray, JT.init_params(np.random.RandomState(0), cfg)), cfg,
        mesh)
    state = opt.init(params)
    step = JT.make_train_step(cfg, mesh, opt)
    sh = NamedSharding(mesh, P("dp", "sp"))
    tok, tgt = (jax.device_put(t.numpy().astype(np.int32), sh)
                for t in _batch())
    losses = []
    for _ in range(SP_LM_STEPS):
        params, state, loss = step(params, state, tok, tgt)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, params)


def _scaled_close(ours, ref, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(
        np.asarray(ours, np.float32), ref, rtol=0,
        atol=LM_WEIGHT_TOL * max(np.abs(ref).max(), 1e-30), err_msg=what)


def _lm_layout_id(n):
    dp, sp = sp_lm_layout(n)
    return f"dp{dp}xsp{sp}"


@pytest.mark.parametrize("n", WORLDS, ids=_lm_layout_id)
def test_lm_matches_the_port_at_sp1(n, lm_sp1):
    _, losses, model = lm_sp1
    ref = model.state_dict()
    for o in _world(n):
        np.testing.assert_allclose(o["lm"]["losses"], losses,
                                   rtol=LM_LOSS_RTOL)
        for k, w in o["lm"]["weights"].items():
            _scaled_close(w, ref[k].numpy(), k)


@pytest.mark.parametrize("n", WORLDS, ids=_lm_layout_id)
def test_lm_matches_jax_single_device_step(n, lm_jax):
    losses, params = lm_jax
    cfg = TT.TransformerConfig(**SP_LM, dtype="float32")
    for o in _world(n):
        np.testing.assert_allclose(o["lm"]["losses"], losses,
                                   rtol=LM_LOSS_RTOL)
        model = TT.Transformer(cfg, seed=0, device="cpu")
        model.load_state_dict({k: torch.tensor(w) for k, w in
                               o["lm"]["weights"].items()})
        jax.tree_util.tree_map_with_path(
            lambda p, a, b: _scaled_close(a, b, jax.tree_util.keystr(p)),
            interop.transformer_to_jax(model), params)


@pytest.mark.parametrize("n", WORLDS, ids=_lm_layout_id)
def test_lm_positions_are_global(n, lm_sp1):
    """Rank (d, s)'s logits before training are the sp = 1 model's at
    its rows and at global positions ``s*lc ...``: a rank that took
    positions ``0 .. lc-1`` would differ here."""
    logits, _, _ = lm_sp1
    dp, sp = sp_lm_layout(n)
    for r, o in enumerate(_world(n)):
        d, s = divmod(r, sp)
        rb, lc = SP_LM_BATCH // dp, SP_LM["max_seq"] // sp
        np.testing.assert_allclose(
            o["lm"]["logits"],
            logits[d * rb:(d + 1) * rb, s * lc:(s + 1) * lc], **FWD_TOL)


def test_lm_refuses_a_sequence_longer_than_max_seq(monkeypatch):
    cfg = TT.TransformerConfig(**SP_LM, dtype="float32")
    model = TT.Transformer(cfg, seed=0, device="cpu")
    monkeypatch.setattr(TT, "group_place", lambda group: (2, 1))
    tokens = torch.zeros(1, SP_LM["max_seq"] // 2 + 1, dtype=torch.long)
    with pytest.raises(ValueError, match="max_seq"):
        model(tokens, object())
    assert SP_SHAPE[1] == SP_LM["max_seq"]
