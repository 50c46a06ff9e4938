"""The slice end to end on CPU: the port's train step (world 1 over gloo,
``DistributedOptimizer(fused_update.sgd(0.1, momentum=0.9))`` with the
fused tail on) against the JAX package's ``DistributedOptimizer`` on a
1-device mesh with ``HOROVOD_FUSED_UPDATE=1`` and
``HOROVOD_QUANT_PALLAS=1`` (the Pallas momentum kernel interpreted),
stepped with the ``one_step`` math of ``bench.py:425-462``.

A small ResNet (stages [1, 1, 1, 1], 8 filters, 10 classes, 32x32, batch
16, float32), the same flax-initialised weights and one numpy batch fed
at every step (as the bench feeds it), three steps.  Tolerance: losses
within rtol 1e-4; parameters, momentum traces and batch_stats
elementwise within 5e-3 relative plus 5e-3 of each tensor's largest
magnitude.  Forward and backward agree to about 1e-5 (see
tests/test_torch_resnet.py), but training at lr 0.1 amplifies that
difference step by step: after three steps the worst tensor (a BatchNorm
bias that starts at zero) sits near 1.2e-3 of its scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.models import resnet as jres
import horovod_tpu_torch as hvd
from horovod_tpu_torch import interop
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.optim import fused_update as TF
from horovod_tpu_torch.train_step import synthetic_batch, train_step

STEPS, BATCH, SIZE, CLASSES = 3, 16, 32, 10


@pytest.fixture()
def world_cpu(monkeypatch):
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK", "HOROVOD_LOCAL_RANK",
              "HOROVOD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _close_scaled(a, b, tol, what):
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(np.asarray(a, np.float32), b, rtol=tol,
                               atol=tol * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def _jax_run(params, stats, batches):
    model = jres.ResNet(stage_sizes=[1, 1, 1, 1],
                        block_cls=jres.BottleneckBlock, num_classes=CLASSES,
                        num_filters=8, dtype=jnp.float32)
    opt = jhvd.DistributedOptimizer(
        jhvd.fused_update.sgd(0.1, momentum=0.9), op=jhvd.Average,
        axis_name="hvd", zero_stage=0)
    assert jhvd.fused_update.active()
    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))

    def one_step(params, batch_stats, opt_state, images, labels):
        def loss_fn(p):
            logits, mut = model.apply(
                {"params": p, "batch_stats": batch_stats}, images,
                train=True, mutable=["batch_stats"])
            onehot = jax.nn.one_hot(labels, logits.shape[-1])
            return (optax.softmax_cross_entropy(logits, onehot).mean(),
                    mut["batch_stats"])

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), new_stats, opt_state,
                loss.reshape(1))

    opt_state = opt.init(params)
    step = jax.jit(shard_map(
        one_step, mesh=mesh, check_vma=False,
        in_specs=(P(), P(), P(), P("hvd"), P("hvd")),
        out_specs=(P(), P(), P(), P())))
    losses = []
    for x, y in batches:
        params, stats, opt_state, loss = step(params, stats, opt_state,
                                              x, y)
        losses.append(float(loss[0]))
    return losses, params, stats, opt_state


def test_train_step_matches_jax(world_cpu, monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSED_UPDATE", "1")
    monkeypatch.setenv("HOROVOD_QUANT_PALLAS", "1")
    jmodel = jres.ResNet(stage_sizes=[1, 1, 1, 1],
                         block_cls=jres.BottleneckBlock,
                         num_classes=CLASSES, num_filters=8,
                         dtype=jnp.float32)
    v = jmodel.init(jax.random.PRNGKey(0),
                    jnp.zeros((1, SIZE, SIZE, 3)), train=True)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    # one synthetic batch for every step, as the bench feeds it
    x, y = synthetic_batch(BATCH, SIZE, CLASSES, seed=0, device="cpu")
    batches = [(x.numpy(), y.numpy().astype(np.int32))] * STEPS

    jlosses, jparams, jstats, jstate = _jax_run(params, stats, batches)

    model = tres.ResNet(stage_sizes=[1, 1, 1, 1],
                        block_cls=tres.BottleneckBlock, num_classes=CLASSES,
                        num_filters=8, dtype=torch.float32, device="cpu")
    interop.resnet_from_flax(params, stats, model)
    opt = hvd.DistributedOptimizer(TF.sgd(model.parameters(), 0.1,
                                          momentum=0.9))
    assert TF.active()
    losses = [float(train_step(model, opt, torch.from_numpy(x),
                               torch.from_numpy(y).long()))
              for x, y in batches]

    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    tparams, tstats = interop.resnet_to_flax(model)
    ttrace = interop.momentum_to_optax(model, opt)
    jtrace = jstate[0].trace
    for name, ours, ref in (("param", tparams, jparams),
                            ("stat", tstats, jstats),
                            ("trace", ttrace, jtrace)):
        jax.tree_util.tree_map_with_path(
            lambda p, a, b, name=name: _close_scaled(
                a, b, 5e-3, f"{name} {jax.tree_util.keystr(p)}"),
            ours, jax.tree_util.tree_map(np.asarray, dict(ref)))
    assert TF.LAUNCHES["momentum"] == 0  # CPU tensors: plain versions


def test_momentum_state_round_trip(world_cpu):
    """interop.momentum_from_optax / momentum_to_optax are inverses, and
    the fused tail picks the loaded trace up."""
    model = tres.ResNet(stage_sizes=[1, 1, 1, 1],
                        block_cls=tres.ResNetBlock, num_classes=CLASSES,
                        num_filters=8, dtype=torch.float32, device="cpu")
    opt = hvd.DistributedOptimizer(TF.sgd(model.parameters(), 0.1, 0.9))
    rng = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        interop.momentum_to_optax(model, opt))
    interop.momentum_from_optax(tree, model, opt)
    back = interop.momentum_to_optax(model, opt)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_backward_passes_per_step_matches_jax(world_cpu, monkeypatch,
                                              fused):
    """k=2 accumulation: no update on the first pass, then the mean of
    both gradients (``_AccumulationState``), against the JAX optimizer."""
    monkeypatch.setenv("HOROVOD_FUSED_UPDATE", "1" if fused else "0")
    rng = np.random.RandomState(5)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal(p0.shape).astype(np.float32)
             for _ in range(4)]

    jopt = jhvd.DistributedOptimizer(jhvd.fused_update.sgd(0.1, 0.9),
                                     backward_passes_per_step=2,
                                     axis_name="hvd")
    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))

    def body(p, s, g):
        u, s = jopt.update(g, s, p)
        return optax.apply_updates(p, u), s

    jp = jnp.asarray(p0)
    js = jopt.init(jp)
    step = jax.jit(shard_map(body, mesh=mesh, check_vma=False,
                             in_specs=(P(), P(), P()),
                             out_specs=(P(), P())))

    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = hvd.DistributedOptimizer(TF.sgd([w], 0.1, 0.9),
                                   backward_passes_per_step=2)
    for i, g in enumerate(grads):
        before = w.detach().clone()
        jp, js = step(jp, js, jnp.asarray(g))
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        if i % 2 == 0:  # first pass of a window: no update
            assert torch.equal(w.detach(), before)
        else:
            assert not torch.equal(w.detach(), before)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)
