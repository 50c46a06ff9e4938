"""The transformer slice of the port against the JAX package on the CPU.

The config is small (vocab 64, d_model 32, 4 heads x 8, 2 layers, d_ff
64, seq 64, batch 2); the JAX side runs on a one-device
('dp','pp','tp','sp') mesh with ``attn_impl="pallas"`` (the Pallas
kernels B8-B10 interpreted), the port at world 1 over gloo with the
fused Adam tail on (plain versions on CPU tensors).

Tolerances: float32 losses within rel 1e-4; weights within 1e-3 of each
tensor's largest magnitude after three Adam steps -- Adam's
``m / (sqrt(v) + eps)`` turns a last-bit difference in a near-zero
gradient into a sizeable part of one ``lr`` step, so no tighter bound
holds for every element; gradients of one step within 1e-4 of each
tensor's scale; bfloat16 losses within rel 2e-2 (the JAX package's
bf16 attention tolerance: the two frameworks round bf16 products at
different places).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel.mesh import make_mesh
import horovod_tpu_torch as hvd
from horovod_tpu_torch import interop
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.optim import fused_update as TF
from horovod_tpu_torch.train_step import lm_train_step, synthetic_tokens

SMALL = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=2,
             d_ff=64, max_seq=64)
BATCH, SEQ, STEPS = 2, 64, 3


@pytest.fixture()
def world_cpu(monkeypatch):
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK", "HOROVOD_LOCAL_RANK",
              "HOROVOD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _cfgs(dtype):
    return (JT.TransformerConfig(**SMALL, dtype=dtype, attn_impl="pallas"),
            TT.TransformerConfig(**SMALL, dtype=dtype))


def _tokens():
    tok, tgt = synthetic_tokens(BATCH, SEQ, SMALL["vocab"], seed=1,
                                device="cpu")
    return tok, tgt, tok.numpy().astype(np.int32), tgt.numpy().astype(
        np.int32)


def _scaled_close(ours, ref, tol, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(ours, np.float32), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _tree_close(ours, ref, tol, what):
    jax.tree_util.tree_map_with_path(
        lambda p, a, b: _scaled_close(
            a, b, tol, f"{what} {jax.tree_util.keystr(p)}"),
        ours, jax.tree_util.tree_map(np.asarray, ref))


def test_init_params_bit_identical():
    jcfg, tcfg = _cfgs("float32")
    ref = JT.init_params(np.random.RandomState(3), jcfg)
    ours = TT.init_params(np.random.RandomState(3), tcfg)
    assert jax.tree_util.tree_structure(ours) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, ref))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
        ours, ref)
    assert all(a.dtype == np.float32 for a in jax.tree_util.tree_leaves(ours))


def test_loss_and_gradients_match_jax(head_dim=SMALL["head_dim"]):
    """One forward and backward of the model (attention through the
    port's ring_attention) against ``jax.value_and_grad(loss_fn)``."""
    jcfg, tcfg = (dataclasses.replace(c, head_dim=head_dim)
                  for c in _cfgs("float32"))
    params = TT.init_params(np.random.RandomState(0), tcfg)
    tok, tgt, jtok, jtgt = _tokens()
    mesh = make_mesh(dp=1, pp=1, tp=1, sp=1, devices=jax.devices()[:1])
    spec = JT.param_specs(jcfg)
    fn = jax.jit(shard_map(
        lambda p, x, y: jax.value_and_grad(JT.loss_fn)(p, x, y, jcfg),
        mesh=mesh, check_vma=False,
        in_specs=(spec, P("dp", "sp"), P("dp", "sp")),
        out_specs=(P(), spec)))
    jloss, jgrads = fn(jax.tree_util.tree_map(jnp.asarray, params), jtok,
                       jtgt)

    model = TT.Transformer(tcfg, params=params, device="cpu")
    loss = TT.loss_fn(model(tok), tgt)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _tree_close(interop.transformer_to_jax(model, grads=True), jgrads, 1e-4,
                "grad")


def test_loss_and_gradients_match_jax_at_head_dim_192():
    """The same at head dim 192, the transformer example's at ``--d-model
    768`` (``head_dim = d_model // 4``): above the 128 the port's kernels
    took before they were widened to 256."""
    test_loss_and_gradients_match_jax(head_dim=192)


def _jax_train(jcfg, params, jtok, jtgt):
    mesh = make_mesh(dp=1, pp=1, tp=1, sp=1, devices=jax.devices()[:1])
    opt = jhvd.fused_update.adam(3e-4)
    jparams = JT.shard_params(jax.tree_util.tree_map(jnp.asarray, params),
                              jcfg, mesh)
    state = opt.init(jparams)
    step = JT.make_train_step(jcfg, mesh, opt)
    sh = NamedSharding(mesh, P("dp", "sp"))
    x, y = jax.device_put(jtok, sh), jax.device_put(jtgt, sh)
    losses = []
    for _ in range(STEPS):
        jparams, state, loss = step(jparams, state, x, y)
        losses.append(float(loss))
    return losses, jparams, state


def _port_train(tcfg, params, tok, tgt):
    model = TT.Transformer(tcfg, params=params, device="cpu")
    opt = hvd.DistributedOptimizer(TF.adam(model.parameters(), 3e-4))
    assert TF.active()
    losses = [float(lm_train_step(model, opt, tok, tgt))
              for _ in range(STEPS)]
    return losses, model, opt


def test_train_step_matches_jax_float32(world_cpu, monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSED_UPDATE", "1")
    jcfg, tcfg = _cfgs("float32")
    params = TT.init_params(np.random.RandomState(0), tcfg)
    tok, tgt, jtok, jtgt = _tokens()
    jlosses, jparams, jstate = _jax_train(jcfg, params, jtok, jtgt)
    losses, model, opt = _port_train(tcfg, params, tok, tgt)

    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    _tree_close(interop.transformer_to_jax(model), jparams, 1e-3, "param")
    adam = interop.adam_to_optax(model, opt)
    assert int(adam.count) == int(jstate[0].count) == STEPS
    _tree_close(adam.mu, jstate[0].mu, 1e-3, "mu")
    assert TF.LAUNCHES["adam"] == 0  # CPU tensors: plain versions


def test_train_step_matches_jax_bfloat16(world_cpu, monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSED_UPDATE", "1")
    jcfg, tcfg = _cfgs("bfloat16")
    params = TT.init_params(np.random.RandomState(0), tcfg)
    tok, tgt, jtok, jtgt = _tokens()
    jlosses, _, _ = _jax_train(jcfg, params, jtok, jtgt)
    losses, _, _ = _port_train(tcfg, params, tok, tgt)
    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)
    assert all(np.isfinite(losses))


def test_weights_and_adam_state_round_trip(world_cpu):
    _, tcfg = _cfgs("float32")
    model = TT.Transformer(tcfg, seed=0, device="cpu")
    opt = hvd.DistributedOptimizer(TF.adam(model.parameters(), 3e-4))
    rng = np.random.RandomState(9)

    def rand_tree(tree):
        return jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)

    params = rand_tree(interop.transformer_to_jax(model))
    interop.transformer_from_jax(params, model)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           interop.transformer_to_jax(model), params)
    state = interop.AdamState(np.asarray(7, np.int32),
                              rand_tree(params), rand_tree(params))
    interop.adam_from_optax(state, model, opt)
    back = interop.adam_to_optax(model, opt)
    assert int(back.count) == 7
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           (back.mu, back.nu), (state.mu, state.nu))
    missing = dict(params)
    del missing["pos"]
    with pytest.raises(KeyError, match="pos"):
        interop.transformer_from_jax(missing, model)


def test_synthetic_tokens_are_the_bench_batch():
    """bench.py's transformer batch: tokens then targets, both from
    RandomState(1)."""
    rng = np.random.RandomState(1)
    tok, tgt = synthetic_tokens(4, 16, 100, device="cpu")
    np.testing.assert_array_equal(tok.numpy(), rng.randint(0, 100, (4, 16)))
    np.testing.assert_array_equal(tgt.numpy(), rng.randint(0, 100, (4, 16)))


@pytest.mark.parametrize("what", ["pp"])
def test_unported_parallelism_raises(what):
    """Pipeline parallelism is ported (``tests/test_torch_pipeline.py``);
    what stays unsupported is MoE layers under it, as on the reference
    (``horovod_tpu/models/transformer.py:220-223``): pp > 1 with
    ``moe_every`` raises, given as a size, before any mesh is built."""
    _, tcfg = _cfgs("float32")
    with pytest.raises(NotImplementedError,
                       match="MoE layers under pipeline parallelism"):
        TT.Transformer(dataclasses.replace(tcfg, moe_every=2),
                       device="cpu", **{what: 2})


@pytest.mark.parametrize("ep", [1, 2])
def test_moe_init_params_bit_identical(ep):
    """With ``moe_every`` the MoE tree (``ep * experts_per_rank``
    experts) is drawn after the layers, as the JAX package draws it."""
    jcfg, tcfg = (dataclasses.replace(c, moe_every=2)
                  for c in _cfgs("float32"))
    ref = JT.init_params(np.random.RandomState(3), jcfg, ep=ep)
    ours = TT.init_params(np.random.RandomState(3), tcfg, ep=ep)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
        ours, ref)
    assert ours["moe"]["w_in"].shape == (1, 2 * ep, 32, 64)


def test_moe_loss_and_gradients_match_jax():
    """One forward and backward of the MoE model at world 1 (both
    experts here, the dense MLP of the MoE layer unused) against
    ``jax.value_and_grad(loss_fn)``: the loss (with ``0.01 * aux``) and
    every gradient, the unused ``w1``/``w2`` of layer 1 zero on both
    sides."""
    jcfg, tcfg = (dataclasses.replace(c, moe_every=2)
                  for c in _cfgs("float32"))
    params = TT.init_params(np.random.RandomState(0), tcfg)
    tok, tgt, jtok, jtgt = _tokens()
    mesh = make_mesh(dp=1, pp=1, tp=1, sp=1, devices=jax.devices()[:1])
    spec = JT.param_specs(jcfg)
    fn = jax.jit(shard_map(
        lambda p, a, b: jax.value_and_grad(JT.loss_fn)(p, a, b, jcfg),
        mesh=mesh, check_vma=False, in_specs=(spec, P("dp", "sp"),
                                              P("dp", "sp")),
        out_specs=(P(), spec)))
    jloss, jgrads = fn(jax.tree_util.tree_map(jnp.asarray, params), jtok,
                       jtgt)
    model = TT.Transformer(tcfg, params=params, device="cpu")
    logits, aux = model(tok, with_aux=True)
    loss = TT.loss_fn(logits, tgt, aux)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    assert grads["layers.1.w1"].abs().max() == 0
    for name, g in grads.items():
        parts = name.split(".")
        path = (parts[0], parts[2]) if len(parts) == 3 else (name,)
        ref = np.asarray(jgrads[path[0]][path[1]][int(parts[1])]
                         if len(path) == 2 else jgrads[name])
        _scaled_close(g.numpy(), ref, 1e-4, name)


@pytest.mark.parametrize("impl", ["xla", "blockwise"])
def test_attention_other_than_the_kernels_raises(impl):
    TT.TransformerConfig(**SMALL, attn_impl="pallas")
    with pytest.raises(NotImplementedError, match="flash kernels"):
        TT.TransformerConfig(**SMALL, attn_impl=impl)


def test_config_matches_jax_fields_and_defaults():
    jfields = {f.name: f.default for f in
               dataclasses.fields(JT.TransformerConfig)}
    tfields = {f.name: f.default for f in
               dataclasses.fields(TT.TransformerConfig)}
    assert tfields == jfields


def test_sequence_longer_than_max_seq_raises():
    _, tcfg = _cfgs("float32")
    model = TT.Transformer(tcfg, seed=0, device="cpu")
    tokens = torch.zeros(1, SMALL["max_seq"] + 1, dtype=torch.long)
    with pytest.raises(ValueError, match="max_seq"):
        model(tokens)
