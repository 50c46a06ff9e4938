"""The port's ResNet against the flax model (``horovod_tpu/models/
resnet.py``): the same flax-initialised weights, carried over by
``interop.resnet_from_flax``, and the same numpy batch go through both;
logits, loss, every gradient and the updated ``batch_stats`` must agree.

Float32 on both sides.  Tolerance: rtol 2e-4 / atol 2e-5 on logits and
loss; rtol 1e-3 / atol 1e-4 on the statistics; gradients elementwise
within 1e-3 relative plus 1e-3 of the tensor's largest magnitude.  The two
frameworks sum in different orders (convolution algorithms, BatchNorm
reductions over up to 1024 values, the closed-form BatchNorm backward
against JAX's autodiff), so agreement is to float32 rounding of those
sums, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import resnet as jres
from horovod_tpu_torch import interop
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.train_step import softmax_cross_entropy

BATCH, CLASSES, FILTERS = 4, 10, 8


def _flax_setup(block, size, seed=0):
    model = jres.ResNet(stage_sizes=[1, 1, 1, 1], block_cls=block,
                        num_classes=CLASSES, num_filters=FILTERS,
                        dtype=jnp.float32)
    v = model.init(jax.random.PRNGKey(seed),
                   jnp.zeros((1, size, size, 3), jnp.float32), train=True)
    rng = np.random.RandomState(seed)
    # non-trivial values everywhere: the zero-initialised block scales
    # and the unit/zero statistics would hide mistakes
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
        .astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * np.abs(
            rng.standard_normal(a.shape)).astype(np.float32),
        v["batch_stats"])
    x = rng.rand(BATCH, size, size, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, BATCH)
    return model, params, stats, x, y


def _port(block, params, stats):
    m = tres.ResNet(stage_sizes=[1, 1, 1, 1], block_cls=block,
                    num_classes=CLASSES, num_filters=FILTERS,
                    dtype=torch.float32, device="cpu")
    return interop.resnet_from_flax(params, stats, m)


def _close(a, b, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=what)


def _close_scaled(a, b, tol, what):
    """Elementwise within ``tol`` of the tensor's largest magnitude: a
    gradient element that is a small difference of large sums can carry
    the sums' rounding in full."""
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=tol,
                               atol=tol * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("size", [32, 30], ids=["even", "odd"])
@pytest.mark.parametrize("block", ["BottleneckBlock", "ResNetBlock"])
def test_train_forward_backward_matches_flax(block, size):
    """Train mode: logits, loss, gradients and new batch_stats.  32x32
    puts every stride-2 3x3 conv and the max-pool on an even input
    (SAME pads (0, 1)); 30x30 gives the pool an odd one (pads (1, 1))."""
    model, params, stats, x, y = _flax_setup(getattr(jres, block), size)

    def loss_fn(p):
        logits, mut = model.apply({"params": p, "batch_stats": stats}, x,
                                  train=True, mutable=["batch_stats"])
        onehot = jax.nn.one_hot(y, CLASSES)
        return (optax.softmax_cross_entropy(logits, onehot).mean(),
                (logits, mut["batch_stats"]))

    (jloss, (jlogits, jstats)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    m = _port(getattr(tres, block), params, stats)
    m.train()
    logits = m(torch.from_numpy(x))
    loss = softmax_cross_entropy(logits, torch.from_numpy(y))
    loss.backward()

    _close(logits.detach(), jlogits, 2e-4, 2e-5, "logits")
    _close(loss.item(), float(jloss), 2e-4, 2e-5, "loss")
    tgrads, tstats = interop.resnet_to_flax(m, grads=True)
    for (path, a), (_, b) in zip(
            sorted(jax.tree_util.tree_leaves_with_path(tgrads),
                   key=lambda kv: str(kv[0])),
            sorted(jax.tree_util.tree_leaves_with_path(jgrads),
                   key=lambda kv: str(kv[0]))):
        _close_scaled(a, b, 1e-3, f"grad {jax.tree_util.keystr(path)}")
    jax.tree_util.tree_map_with_path(
        lambda p, a, b: _close(a, b, 1e-3, 1e-4,
                               f"stat {jax.tree_util.keystr(p)}"),
        tstats, jax.tree_util.tree_map(np.asarray, dict(jstats)))


def test_eval_forward_matches_flax():
    """Eval mode normalises with the running statistics."""
    model, params, stats, x, _ = _flax_setup(jres.BottleneckBlock, 32, 1)
    jlogits = model.apply({"params": params, "batch_stats": stats}, x,
                          train=False)
    m = _port(tres.BottleneckBlock, params, stats).eval()
    with torch.no_grad():
        logits = m(torch.from_numpy(x))
    _close(logits, jlogits, 2e-4, 2e-5, "eval logits")


def test_resnet50_structure_and_key_map():
    """ResNet-50 at full width: 161 parameter tensors, 25,557,032
    parameters, 106 batch-stat tensors, and every flax key maps."""
    m = tres.ResNet50(device="cpu", dtype=torch.float32)
    params = list(m.parameters())
    assert len(params) == 161
    assert sum(p.numel() for p in params) == 25_557_032
    assert len(list(m.buffers())) == 106

    shapes = jax.eval_shape(
        lambda: jres.ResNet50(num_classes=1000).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
            train=True))
    fparams = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    fstats = jax.tree_util.tree_map(
        lambda s: np.ones(s.shape, np.float32), shapes["batch_stats"])
    interop.resnet_from_flax(fparams, fstats, m)  # raises on any miss
    back_p, back_s = interop.resnet_to_flax(m)
    assert jax.tree_util.tree_structure(back_p) == \
        jax.tree_util.tree_structure(fparams)
    assert jax.tree_util.tree_structure(back_s) == \
        jax.tree_util.tree_structure(fstats)


@pytest.mark.parametrize("size,kernel,stride,want", [
    (112, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (56, 3, 1, (1, 1)),
    (56, 1, 2, (0, 0)), (15, 3, 2, (1, 1))])
def test_same_pads_match_xla(size, kernel, stride, want):
    from jax import lax

    assert tres.same_pads(size, kernel, stride) == want
    assert tuple(lax.padtype_to_pads((size,), (kernel,), (stride,),
                                     "SAME")[0]) == want
