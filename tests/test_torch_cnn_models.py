"""The port's CNN bench family (``horovod_tpu_torch.models``: the shared
layers, ``MnistCNN``, ``SmallCNN``, VGG and Inception-v3) against the
flax models of the JAX package, on the CPU.

The same weights (made with numpy from the shapes ``jax.eval_shape``
gives, then carried across by ``interop.cnn_from_flax``) and the same
numpy batch go through both.  Parameters and statistics are perturbed
away from flax's initial values (zero biases, unit scales, zero/unit
statistics would hide mistakes).  Float32 on both sides.  Tolerances, as
in tests/test_torch_resnet.py: rtol 2e-4 / atol 2e-5 on outputs, logits
and loss; rtol 1e-3 / atol 1e-4 on the statistics; gradients elementwise
within 1e-3 relative plus 1e-3 of the tensor's largest magnitude.  The
frameworks sum in different orders (convolution algorithms, BatchNorm
reductions, the closed-form BatchNorm backward against JAX's autodiff),
so agreement is to float32 rounding of those sums, not bit for bit.

Dropout: the two frameworks' random bits cannot match, so the models
are held against flax with dropout off (flax ``train=False`` and the
port in ``eval()`` for VGG, which has no BatchNorm; for Inception, whose
BatchNorm needs ``train=True``, flax's Dropout is made the identity with
``flax.linen.intercept_methods`` and only the port's Dropout submodule
is put in ``eval()``).  The port's Dropout is held on its own by its
keep share and its 1 / keep_prob scale.

Inception-v3 and its blocks are compared in float64 on both sides (the
classifier stays float32 on both, as the models fix it; the port's plain
BatchNorm takes float64 on the CPU).  In float32 the rounding carried
through the 94 BatchNorms swamps the tolerances on its own: at 75 px and
batch 8 the port's float32 logits sit 7.2e-4 from its float64 ones and
flax's 2.8e-3; at batch 2 the last blocks' BatchNorms see two rows,
where the fast variance E[x^2] - E[x]^2 cancels to rounding noise in
float32 (var / E[x^2] down to 4e-8); and a pre-activation within
rounding of zero flips its ReLU in one framework and not the other
(MixedC at 3 px in flax, at 5 px in the port).  The float32 path of the
same layers is held against flax by the other tests here and in
tests/test_torch_batch_norm.py, and against the card by chip_smoke.py.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import inception as jinc
from horovod_tpu.models import mnist as jmnist
from horovod_tpu.models import vgg as jvgg
import horovod_tpu_torch as hvd
from horovod_tpu_torch import interop
from horovod_tpu_torch.models import inception as tinc
from horovod_tpu_torch.models import layers as L
from horovod_tpu_torch.models import mnist as tmnist
from horovod_tpu_torch.models import vgg as tvgg
from horovod_tpu_torch.ops import batch_norm as BN
from horovod_tpu_torch.optim import fused_update as TF
from horovod_tpu_torch.train_step import (softmax_cross_entropy,
                                          synthetic_batch, train_step)

CLASSES = 10


def _close(a, b, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _close_scaled(a, b, tol, what):
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(np.asarray(a, np.float32), b, rtol=tol,
                               atol=tol * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def _leaves(tree):
    return sorted(jax.tree_util.tree_leaves_with_path(tree),
                  key=lambda kv: jax.tree_util.keystr(kv[0]))


def _close_trees(got, want, check, what):
    got, want = _leaves(got), _leaves(want)
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want], what
    for (path, a), (_, b) in zip(got, want):
        check(a, b, f"{what} {jax.tree_util.keystr(path)}")


def _variables(module, x, seed, *args, **kw):
    """Perturbed flax-layout numpy ``(params, batch_stats)`` for
    ``module`` at input ``x``, made from the shapes ``jax.eval_shape``
    gives: lecun-scaled normal kernels, 0.1-normal biases, BatchNorm
    scales near 1, means near 0, variances near 1."""
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.zeros(x.shape, jnp.float32), *args, **kw))
    rng = np.random.RandomState(seed)

    def make(path, s):
        leaf = path[-1].key
        n = rng.standard_normal(s.shape)
        if leaf == "kernel":
            v = n / np.sqrt(np.prod(s.shape[:-1]))
        elif leaf in ("scale", "var"):
            v = 1 + 0.1 * (np.abs(n) if leaf == "var" else n)
        else:
            v = 0.1 * n
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(make, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(
        make, shapes.get("batch_stats", {}))
    return params, stats


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _flax_train(module, params, stats, x, y, **kw):
    """flax logits, loss, gradients and new batch_stats (train mode where
    the module has BatchNorm), dropout made the identity."""
    def loss_fn(p):
        variables = {"params": p}
        if stats:
            variables["batch_stats"] = stats
        with fnn.intercept_methods(_no_dropout):
            logits, mut = module.apply(
                variables, x, mutable=["batch_stats"] if stats else [], **kw)
        loss = optax.softmax_cross_entropy(
            logits, jax.nn.one_hot(y, logits.shape[-1])).mean()
        return loss, (logits, mut.get("batch_stats", {}))

    (loss, (logits, new_stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return (np.asarray(logits), float(loss),
            jax.tree_util.tree_map(np.asarray, grads),
            jax.tree_util.tree_map(np.asarray, dict(new_stats)))


def _port_train(model, x, y):
    logits = model(torch.from_numpy(x))
    loss = softmax_cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    grads, stats = interop.cnn_to_flax(model, grads=True)
    return logits.detach().numpy(), loss.item(), grads, stats


def _hold_model(got, want):
    _close(got[0], want[0], 2e-4, 2e-5, "logits")
    _close(got[1], want[1], 2e-4, 2e-5, "loss")
    _close_trees(got[2], want[2],
                 lambda a, b, w: _close_scaled(a, b, 1e-3, w), "grad")
    _close_trees(got[3], want[3],
                 lambda a, b, w: _close(a, b, 1e-3, 1e-4, w), "stat")


def _batch(seed, n, size, ch=3):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, size, size, ch).astype(np.float32),
            rng.randint(0, CLASSES, n).astype(np.int32))


# ---------------------------------------------------------------------------
# The shared layers
# ---------------------------------------------------------------------------

CONVS = [((1, 7), 1, "SAME", False), ((7, 1), 1, "SAME", True),
         ((1, 3), 1, "SAME", False), ((3, 1), 1, "SAME", False),
         ((3, 3), 2, "VALID", False), ((3, 3), 2, "SAME", True),
         ((5, 5), 1, "SAME", False), ((2, 3), (2, 1), "SAME", True),
         ((3, 3), 1, ((2, 0), (1, 1)), False)]


def _conv_id(k, s, p, b):
    pad = p if isinstance(p, str) else "explicit"
    return f"{k[0]}x{k[1]}-s{s}-{pad}{'-bias' if b else ''}"


@pytest.mark.parametrize("kernel,strides,padding,bias", CONVS,
                         ids=[_conv_id(*c) for c in CONVS])
def test_conv_matches_flax(kernel, strides, padding, bias):
    x = np.random.RandomState(0).standard_normal((2, 9, 10, 5)) \
        .astype(np.float32)
    st = strides if isinstance(strides, tuple) else (strides, strides)
    mod = fnn.Conv(6, kernel, st, padding=padding, use_bias=bias)
    params, _ = _variables(mod, x, 1)
    want = mod.apply({"params": params}, x)
    conv = L.Conv(5, 6, kernel, strides, padding, torch.float32, bias=bias)
    interop.cnn_from_flax(params, {}, conv)
    got = conv(torch.from_numpy(x))
    assert got.shape == want.shape
    _close(got.detach(), want, 2e-4, 2e-5, "conv")


@pytest.mark.parametrize("size", [9, 10])
@pytest.mark.parametrize("window,strides,padding", [
    (2, 2, "VALID"), (3, 2, "VALID"), (3, 2, "SAME"), (2, 2, "SAME"),
    (3, 1, "SAME")])
def test_max_pool_matches_flax(window, strides, padding, size):
    x = np.random.RandomState(size).standard_normal((2, size, size, 4)) \
        .astype(np.float32)
    want = fnn.max_pool(x, (window, window), (strides, strides), padding)
    got = L.max_pool(torch.from_numpy(x), window, strides, padding)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size", [5, 8])
def test_avgpool3_counts_the_padding_as_flax(size):
    x = np.random.RandomState(size).standard_normal((2, size, size, 4)) \
        .astype(np.float32)
    want = fnn.avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")
    got = L._avgpool3(torch.from_numpy(x))
    _close(got, want, 2e-6, 1e-6, "avgpool3")
    # a corner window holds 4 inputs and divides by 9
    np.testing.assert_allclose(got[0, 0, 0].numpy(),
                               x[0, :2, :2].sum((0, 1)) / 9, rtol=2e-6)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_dense_matches_flax(dname):
    """bf16: flax rounds the product to bf16, then adds the bf16 bias and
    rounds again; PyTorch adds the bias before its one rounding.  So an
    element may sit one bf16 ulp (2^-7 relative) plus half an ulp of the
    product apart, within 2^-6 relative or 2^-8 of the largest
    magnitude."""
    rng = np.random.RandomState(3)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    mod = fnn.Dense(32, dtype=getattr(jnp, dname), param_dtype=jnp.float32)
    params, _ = _variables(mod, x, 4)
    want = np.asarray(mod.apply({"params": params}, x), np.float32)
    dense = L.Dense(64, 32, getattr(torch, dname))
    interop.cnn_from_flax(params, {}, dense)
    got = dense(torch.from_numpy(x)).detach()
    assert got.dtype == getattr(torch, dname)
    if dname == "float32":
        _close(got, want, 2e-4, 2e-5, "dense")
    else:
        _close(got.float(), want, 2.0 ** -6, 2.0 ** -8 * np.abs(want).max(),
               "dense bf16")


def test_dropout_keep_share_and_scale():
    """Training: a kept element is x / keep_prob, the rest 0, and the
    kept share is keep_prob within 5 standard deviations; the same seed
    gives the same mask; eval() is the identity."""
    x = torch.full((64, 4096), 3.0)
    for rate in (0.5, 0.2):
        drop = L.Dropout(rate, torch.Generator().manual_seed(11))
        y = drop(x)
        kept = y != 0
        keep = 1 - rate
        assert torch.equal(y[kept], torch.full_like(y[kept], 3.0 / keep))
        n = x.numel()
        share = kept.sum().item() / n
        assert abs(share - keep) < 5 * np.sqrt(keep * (1 - keep) / n)
        again = L.Dropout(rate, torch.Generator().manual_seed(11))(x)
        assert torch.equal(again, y)
        drop.eval()
        assert drop(x) is x


# ---------------------------------------------------------------------------
# MnistCNN, SmallCNN, VGG
# ---------------------------------------------------------------------------


def test_mnist_cnn_matches_flax():
    x, y = _batch(0, 4, 28, ch=1)
    params, _ = _variables(jmnist.MnistCNN(), x, 1)
    want = _flax_train(jmnist.MnistCNN(), params, {}, x, y)
    m = tmnist.MnistCNN(device="cpu")
    interop.cnn_from_flax(params, {}, m)
    _hold_model(_port_train(m, x, y), want)


@pytest.mark.parametrize("size", [32, 30], ids=["even", "odd"])
def test_small_cnn_matches_flax(size):
    """Train mode: logits, loss, gradients and batch_stats (BatchNorm
    momentum 0.99, flax's default)."""
    x, y = _batch(1, 4, size)
    jm = jmnist.SmallCNN(num_classes=CLASSES, dtype=jnp.float32)
    params, stats = _variables(jm, x, 2, train=True)
    want = _flax_train(jm, params, stats, x, y, train=True)
    m = tmnist.SmallCNN(num_classes=CLASSES, device="cpu")
    assert [b.momentum for b in (m.BatchNorm_0, m.BatchNorm_1,
                                 m.BatchNorm_2)] == [0.99] * 3
    interop.cnn_from_flax(params, stats, m).train()
    _hold_model(_port_train(m, x, y), want)


def test_vgg11_matches_flax_without_dropout():
    x, y = _batch(2, 2, 32)
    jm = jvgg.VGG11(num_classes=CLASSES, dtype=jnp.float32)
    params, _ = _variables(jm, x, 3, train=False)
    want = _flax_train(jm, params, {}, x, y, train=False)
    m = tvgg.VGG11(num_classes=CLASSES, dtype=torch.float32, image_size=32,
                   device="cpu")
    interop.cnn_from_flax(params, {}, m).eval()
    _hold_model(_port_train(m, x, y), want)


def test_vgg_flattens_in_hwc_order():
    """Dense_0 sees the activation flattened as flax flattens NHWC:
    moving one Dense_0 row moves the logits only if it is the row of
    the (h, w, c) element the port puts there."""
    m = tvgg.VGG11(num_classes=CLASSES, dtype=torch.float32, image_size=64,
                   device="cpu").eval()
    feats = {}
    m.Dense_0.register_forward_pre_hook(
        lambda mod, args: feats.setdefault("x", args[0]))
    x = torch.rand(1, 64, 64, 3)
    m(x)
    # the last conv stage's pooled NHWC output, recomputed
    h = x
    for k, (stage, name) in enumerate(m.conv_names):
        h = torch.relu(getattr(m, name)(h))
        if k + 1 == len(m.conv_names) or m.conv_names[k + 1][0] != stage:
            h = L.max_pool(h, 2, 2)
    assert h.shape == (1, 2, 2, 512)
    assert torch.equal(feats["x"], h.reshape(1, -1))
    assert torch.equal(feats["x"][0, 512 * 3 + 7], h[0, 1, 1, 7])


# ---------------------------------------------------------------------------
# Inception-v3
# ---------------------------------------------------------------------------

BLOCKS = {  # name: (JAX module, port module, input channels, side)
    "MixedA": (lambda dt: jinc.MixedA(32, dt),
               lambda dt: tinc.MixedA(192, 32, dt), 192, 5),
    "ReductionA": (lambda dt: jinc.ReductionA(dt),
                   lambda dt: tinc.ReductionA(288, dt), 288, 7),
    "MixedB": (lambda dt: jinc.MixedB(128, dt),
               lambda dt: tinc.MixedB(768, 128, dt), 768, 5),
    "ReductionB": (lambda dt: jinc.ReductionB(dt),
                   lambda dt: tinc.ReductionB(768, dt), 768, 7),
    "MixedC": (lambda dt: jinc.MixedC(dt),
               lambda dt: tinc.MixedC(1280, dt), 1280, 3),
}


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_inception_block_matches_flax(name):
    """Each block at its real channel widths, a small spatial size and
    batch 2, train mode, float64: output, input and parameter gradients
    (one numpy cotangent), new batch_stats."""
    jmake, tmake, ch, side = BLOCKS[name]
    rng = np.random.RandomState(len(name))
    x = rng.rand(2, side, side, ch)
    jm = jmake(jnp.float64)
    params, stats = _variables(jmake(jnp.float32), x, 5, train=True)

    def f(xx, p):
        out, mut = jm.apply({"params": p, "batch_stats": _f64(stats)}, xx,
                            train=True, mutable=["batch_stats"])
        return out, mut["batch_stats"]

    with jax.enable_x64(True):
        @jax.jit
        def run(xx, p, ct):
            out, vjp, new_stats = jax.vjp(f, xx, p, has_aux=True)
            return out, new_stats, *vjp(ct)

        out_shape = jax.eval_shape(f, x, _f64(params))[0].shape
        ct = rng.standard_normal(out_shape)
        jout, jstats, jdx, jgrads = jax.tree_util.tree_map(
            np.asarray, run(x, _f64(params), ct))
    assert jout.dtype == np.float64

    m = tmake(torch.float64)
    interop.cnn_from_flax(params, stats, m.double()).train()
    assert m.out_channels == out_shape[-1]
    xt = torch.from_numpy(x).requires_grad_()
    out = m(xt)
    assert out.dtype == torch.float64
    out.backward(torch.from_numpy(ct))
    _close(out.detach(), jout, 2e-4, 2e-5, f"{name} output")
    _close_scaled(xt.grad, jdx, 1e-3, f"{name} dx")
    tgrads, tstats = interop.cnn_to_flax(m, grads=True)
    _close_trees(tgrads, jgrads,
                 lambda a, b, w: _close_scaled(a, b, 1e-3, w), "grad")
    _close_trees(tstats, dict(jstats),
                 lambda a, b, w: _close(a, b, 1e-3, 1e-4, w), "stat")


def test_inception_v3_matches_flax():
    """The whole model at 75 px (the smallest input it takes), batch 2,
    train mode with dropout off on both sides, float64 up to the float32
    classifier."""
    x, y = _batch(3, 2, 75)
    x = x.astype(np.float64)
    params, stats = _variables(
        jinc.InceptionV3(num_classes=CLASSES, dtype=jnp.float32), x, 6,
        train=True)
    jm = jinc.InceptionV3(num_classes=CLASSES, dtype=jnp.float64)
    with jax.enable_x64(True):
        want = _flax_train(jm, _f64(params), _f64(stats), x, y, train=True)
    m = tinc.InceptionV3(num_classes=CLASSES, dtype=torch.float64,
                         device="cpu")
    interop.cnn_from_flax(params, stats, m.double()).train()
    m.Dropout_0.eval()
    _hold_model(_port_train(m, x, y), want)


# ---------------------------------------------------------------------------
# Structure and key maps at full width (no compile)
# ---------------------------------------------------------------------------

FULL = {  # name: (flax module, port factory, side, leaves, parameters)
    "vgg16": (lambda: jvgg.VGG16(num_classes=1000),
              lambda: tvgg.VGG16(device="cpu"), 224, 32, 138_357_544, 0),
    "inception3": (lambda: jinc.InceptionV3(num_classes=1000),
                   lambda: tinc.InceptionV3(device="cpu"), 299, 284,
                   23_834_568, 94),
}


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_structure_and_key_map(name):
    """Every flax leaf and batch_stats pair maps, both ways, at the
    bench's widths; the leaf and parameter counts."""
    jmake, tmake, side, leaves, n_params, n_bn = FULL[name]
    shapes = jax.eval_shape(lambda: jmake().init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, side, side, 3)), train=True))
    fparams = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    fstats = jax.tree_util.tree_map(
        lambda s: np.ones(s.shape, np.float32), shapes.get("batch_stats", {}))
    assert len(jax.tree_util.tree_leaves(fparams)) == leaves
    assert sum(a.size for a in jax.tree_util.tree_leaves(fparams)) \
        == n_params
    m = tmake()
    params = list(m.parameters())
    assert len(params) == leaves
    assert sum(p.numel() for p in params) == n_params
    assert len(list(m.buffers())) == 2 * n_bn
    assert sum(isinstance(mod, L.BatchNorm) for mod in m.modules()) == n_bn
    interop.cnn_from_flax(fparams, fstats, m)  # raises on any miss
    back_p, back_s = interop.cnn_to_flax(m)
    assert jax.tree_util.tree_structure(back_p) == \
        jax.tree_util.tree_structure(fparams)
    assert jax.tree_util.tree_structure(back_s) == \
        jax.tree_util.tree_structure(fstats)


# ---------------------------------------------------------------------------
# The train step with the fused momentum tail
# ---------------------------------------------------------------------------


@pytest.fixture()
def world_cpu(monkeypatch):
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK", "HOROVOD_LOCAL_RANK",
              "HOROVOD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_small_cnn_train_step_matches_optax(world_cpu, monkeypatch):
    """Three steps of ``train_step`` (world 1 over gloo,
    ``DistributedOptimizer(fused_update.sgd(0.1, momentum=0.9))``, fused
    tail on) against flax + ``optax.sgd(0.1, momentum=0.9)`` (optax's
    ``trace`` then ``scale``) on one seeded batch fed every step.
    Tolerance as tests/test_torch_train_step.py: losses rtol 1e-4;
    parameters, traces and batch_stats within 5e-3 relative plus 5e-3 of
    each tensor's largest magnitude (lr 0.1 amplifies the 1e-5
    forward/backward difference step by step)."""
    monkeypatch.setenv("HOROVOD_FUSED_UPDATE", "1")
    xt, yt = synthetic_batch(16, 32, CLASSES, seed=0, device="cpu")
    x, y = xt.numpy(), yt.numpy().astype(np.int32)
    jm = jmnist.SmallCNN(num_classes=CLASSES, dtype=jnp.float32)
    params, stats = _variables(jm, x, 7, train=True)
    tx = optax.sgd(0.1, momentum=0.9)

    @jax.jit
    def step(p, s, o):
        def loss_fn(p):
            logits, mut = jm.apply({"params": p, "batch_stats": s}, x,
                                   train=True, mutable=["batch_stats"])
            return (optax.softmax_cross_entropy(
                logits, jax.nn.one_hot(y, CLASSES)).mean(),
                mut["batch_stats"])

        (loss, s), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), s, o, loss

    jp, js, jo = params, stats, tx.init(params)
    jlosses = []
    for _ in range(3):
        jp, js, jo, loss = step(jp, js, jo)
        jlosses.append(float(loss))

    m = tmnist.SmallCNN(num_classes=CLASSES, device="cpu")
    interop.cnn_from_flax(params, stats, m)
    opt = hvd.DistributedOptimizer(TF.sgd(m.parameters(), 0.1,
                                          momentum=0.9))
    assert TF.active()
    TF.reset_launch_counts()
    BN.reset_launch_counts()
    losses = [float(train_step(m, opt, xt, yt)) for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    tparams, tstats = interop.cnn_to_flax(m)
    ttrace = interop.momentum_to_optax(m, opt)
    for what, ours, ref in (("param", tparams, jp), ("stat", tstats, js),
                            ("trace", ttrace, jo[0].trace)):
        _close_trees(ours, jax.tree_util.tree_map(np.asarray, dict(ref)),
                     lambda a, b, w: _close_scaled(a, b, 5e-3, w), what)
    # CPU tensors: plain versions, no kernel launches
    assert TF.LAUNCHES["momentum"] == 0
    assert BN.LAUNCHES == dict.fromkeys(BN.LAUNCHES, 0)
