"""The port's BatchNorm (``horovod_tpu_torch.ops.batch_norm`` through
``models.layers.BatchNorm``) against ``flax.linen.BatchNorm``, on the CPU
where the wrappers of kernels N1-N4 run their plain versions.

The same numpy inputs go through both: an NHWC activation (float32, or
rounded to bfloat16 on both sides for bf16 compute), perturbed scale,
bias and running statistics, and an upstream gradient.  Train mode
checks the output, the updated running statistics and the gradients with
respect to x, scale and bias (``jax.vjp``); eval mode the output and the
gradients.  Tolerances: float32 outputs rtol 2e-4 / atol 2e-5;
statistics rtol 1e-3 / atol 1e-4; gradients within 1e-3 relative plus
1e-3 of the tensor's largest magnitude (the two frameworks sum in other
orders).  bfloat16 outputs and input gradients are the float32 values
rounded once on both sides, so an element may land one bf16 ulp apart
(2^-7 relative) where the float32 values straddle a rounding boundary,
or 2^-8 of the tensor's largest magnitude where a value near zero is a
difference of larger ones.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.models.layers import BatchNorm
from horovod_tpu_torch.ops import batch_norm as BN

SHAPE = (2, 3, 5)  # N, H, W: 30 rows
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _close(a, b, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _close_scaled(a, b, tol, what):
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(np.asarray(a, np.float32), b, rtol=tol,
                               atol=tol * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def _close_act(a, b, dname, what, grad=False):
    """An activation (or, with ``grad``, its gradient) in the compute
    dtype."""
    if dname == "f32" and grad:
        _close_scaled(a, b, 1e-3, what)
    elif dname == "f32":
        _close(a, b, 2e-4, 2e-5, what)
    else:
        b = np.asarray(b, np.float32)
        _close(a, b, 2.0 ** -7, 2.0 ** -8 * np.abs(b).max(), what)


def _inputs(c, seed, dname, constant_channels=0):
    rng = np.random.RandomState(seed)
    x = (1.5 * rng.standard_normal((*SHAPE, c)) + 0.5).astype(np.float32)
    if constant_channels:
        # channels whose E[x^2] - E[x]^2 cancels to a rounding error
        vals = (rng.rand(constant_channels) + 0.1).astype(np.float32)
        x[..., :constant_channels] = vals
    if dname == "bf16":  # both sides see the same bf16 values
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    dy = rng.standard_normal(x.shape).astype(np.float32)
    if dname == "bf16":
        dy = np.asarray(jnp.asarray(dy, jnp.bfloat16).astype(jnp.float32))
    params = {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
             "var": (1 + 0.1 * np.abs(rng.standard_normal(c)))
             .astype(np.float32)}
    return x, dy, params, stats


def _flax(x, dy, params, stats, momentum, eps, dname, train):
    jdt = DTYPES[dname][1]
    mod = fnn.BatchNorm(use_running_average=not train, momentum=momentum,
                        epsilon=eps, dtype=jdt)

    @jax.jit
    def run(x, params, dy):
        def f(x, p):
            y, upd = mod.apply({"params": p, "batch_stats": stats}, x,
                               mutable=["batch_stats"])
            return y, upd.get("batch_stats", stats)

        y, vjp, new_stats = jax.vjp(f, x, params, has_aux=True)
        dx, dp = vjp(dy.astype(y.dtype))
        return y, new_stats, dx, dp

    y, new_stats, dx, dp = run(jnp.asarray(x, jdt), params,
                               jnp.asarray(dy, jdt))
    host = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  (y, dict(new_stats), dx, dict(dp)))
    return host


def _port(x, dy, params, stats, momentum, eps, dname, train):
    tdt = DTYPES[dname][0]
    bn = BatchNorm(x.shape[-1], momentum=momentum, eps=eps)
    with torch.no_grad():
        for k, v in {**params, **stats}.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    bn.train(train)
    xt = torch.from_numpy(x.copy()).to(tdt).requires_grad_()
    y = bn(xt)
    assert y.dtype == tdt and y.shape == xt.shape
    y.backward(torch.from_numpy(dy).to(tdt))
    return (y.detach().float().numpy(),
            {"mean": bn.mean.numpy(), "var": bn.var.numpy()},
            xt.grad.float().numpy(),
            {"scale": bn.scale.grad.numpy(), "bias": bn.bias.grad.numpy()})


CASES = [(0.9, 1e-5), (0.99, 1e-5), (0.9, 1e-3), (0.99, 1e-3)]


@pytest.mark.parametrize("c", [48, 80, 64, 16])
@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("momentum,eps", CASES,
                         ids=[f"m{m}-eps{e}" for m, e in CASES])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_flax(train, momentum, eps, dname, c):
    x, dy, params, stats = _inputs(c, c + int(1e6 * eps), dname)
    want = _flax(x, dy, params, stats, momentum, eps, dname, train)
    got = _port(x, dy, params, stats, momentum, eps, dname, train)
    _close_act(got[0], want[0], dname, "y")
    for k in ("mean", "var"):
        _close(got[1][k], want[1][k], 1e-3, 1e-4, f"running {k}")
        if not train:  # eval leaves the running statistics alone
            np.testing.assert_array_equal(got[1][k], stats[k])
    _close_act(got[2], want[2], dname, "dx", grad=True)
    for k in ("scale", "bias"):
        _close_scaled(got[3][k], want[3][k], 1e-3, f"d{k}")


@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_cancelled_variance_is_clamped(dname):
    """Constant channels: E[x^2] - E[x]^2 cancels to a rounding error.
    In float32 it is negative in some channels, and the plain N1 clamps
    those to 0, as flax does; in bf16 (8 significant bits) every sum is
    exact and it cancels to exactly 0.  The layer still matches flax
    there.  Each framework leaves its own rounding residue in the raw
    variance, of order x^2 * 2^-24 (XLA's mean multiplies by 1/M); eps
    1e-3 keeps that residue's effect on rstd below the tolerance."""
    c = 48
    x, dy, params, stats = _inputs(c, 7, dname, constant_channels=40)
    xf = torch.from_numpy(x).reshape(-1, c)
    raw = (xf * xf).mean(0) - xf.mean(0) ** 2
    if dname == "f32":
        assert bool((raw[:40] < 0).any()), "no channel cancels below zero"
    else:
        assert bool((raw[:40] == 0).all())
    _, var, rstd = BN.bn_stats(xf.to(DTYPES[dname][0]).contiguous(), 1e-3)
    assert bool((var >= 0).all())
    assert bool((var[:40][raw[:40] < 0] == 0).all())
    assert bool(torch.isfinite(rstd).all())
    want = _flax(x, dy, params, stats, 0.9, 1e-3, dname, True)
    got = _port(x, dy, params, stats, 0.9, 1e-3, dname, True)
    _close_act(got[0], want[0], dname, "y")
    _close(got[1]["var"], want[1]["var"], 1e-3, 1e-4, "running var")
    _close_act(got[2], want[2], dname, "dx", grad=True)


def test_plain_versions_compose_to_the_autograd_function():
    """N1-N4 called one by one give what the autograd function gives."""
    x, dy, params, _ = _inputs(80, 3, "f32")
    x2d = torch.from_numpy(x).reshape(-1, 80)
    dy2d = torch.from_numpy(dy).reshape(-1, 80)
    scale, bias = (torch.from_numpy(params[k]) for k in ("scale", "bias"))
    mean, var, rstd = BN.bn_stats(x2d, 1e-3)
    y = BN.bn_normalize(x2d, mean, rstd, scale, bias)
    dbias, dscale = BN.bn_bwd_reduce(dy2d, x2d, mean, rstd)
    dx = BN.bn_bwd_dx(dy2d, x2d, mean, rstd, scale, dbias, dscale)
    xt = x2d.clone().requires_grad_()
    st, bt = scale.clone().requires_grad_(), bias.clone().requires_grad_()
    ra = (torch.zeros(80), torch.ones(80))
    yt = BN.BatchNormTrain.apply(xt, st, bt, 1e-3, 0.9, ra)
    yt.backward(dy2d)
    assert torch.equal(yt.detach(), y)
    assert torch.equal(xt.grad, dx)
    assert torch.equal(st.grad, dscale) and torch.equal(bt.grad, dbias)
    # the running statistics moved by 0.1 of the batch's
    assert torch.equal(ra[0], 0.9 * torch.zeros(80) + (1 - 0.9) * mean)
    assert torch.equal(ra[1], 0.9 * torch.ones(80) + (1 - 0.9) * var)


def _refusals():
    x = torch.zeros(6, 8)
    v = torch.zeros(8)
    return {
        "non-contiguous": ((torch.zeros(8, 6).t(),), (v,)),
        "float16": ((x.half(),), (v,)),
        "float64 with float32 vectors": ((x.double(),), (v,)),
        "int": ((x.int(),), (v,)),
        "meta device": ((torch.zeros(6, 8, device="meta"),), (v,)),
        "1-D": ((torch.zeros(8),), (v,)),
        "empty": ((torch.zeros(0, 8),), (v,)),
        "vector float64": ((x,), (v.double(),)),
        "vector length": ((x,), (torch.zeros(7),)),
        "vector non-contiguous": ((x,), (torch.zeros(8, 2)[:, 0],)),
        "vector device": ((x,), (torch.zeros(8, device="meta"),)),
        "dy dtype": ((x, x.bfloat16()), (v,)),
        "dy shape": ((x, torch.zeros(5, 8)), (v,)),
    }


def _refusal_cases():
    """(wrapper, case) pairs; the upstream-gradient cases only for the
    backward wrappers, which take one."""
    return [(w, c) for w in ("bn_stats", "bn_normalize", "bn_bwd_reduce",
                             "bn_bwd_dx")
            for c in sorted(_refusals())
            if w.startswith("bn_bwd") or not c.startswith("dy")]


@pytest.mark.parametrize("wrapper,case", _refusal_cases())
def test_wrappers_refuse_what_the_kernels_do_not_take(wrapper, case):
    acts, vecs = _refusals()[case]
    x = acts[0]
    dy = acts[1] if len(acts) > 1 else x
    v = vecs[0]
    call = {
        "bn_stats": lambda: BN.bn_stats(x, 1e-5, 0.9, v, v.clone()),
        "bn_normalize": lambda: BN.bn_normalize(x, v, v, v, v),
        "bn_bwd_reduce": lambda: BN.bn_bwd_reduce(dy, x, v, v),
        "bn_bwd_dx": lambda: BN.bn_bwd_dx(dy, x, v, v, v, v, v),
    }[wrapper]
    with pytest.raises(HorovodTpuError):
        call()


def test_float64_runs_the_plain_versions_on_the_cpu():
    """A float64 CPU activation with float64 vectors computes in float64
    (the parity tests' deep-model comparisons use it)."""
    rng = np.random.RandomState(2)
    x = rng.standard_normal((40, 24)) * 2 + 1
    dy = rng.standard_normal(x.shape)
    scale, bias = 1 + 0.1 * rng.standard_normal(24), rng.standard_normal(24)
    t = {k: torch.from_numpy(v) for k, v in
         dict(x=x, dy=dy, scale=scale, bias=bias).items()}
    mean, var, rstd = BN.bn_stats(t["x"], 1e-3)
    assert mean.dtype == torch.float64
    np.testing.assert_allclose(mean.numpy(), x.mean(0), rtol=1e-13)
    np.testing.assert_allclose(var.numpy(), x.var(0), rtol=1e-12)
    y = BN.bn_normalize(t["x"], mean, rstd, t["scale"], t["bias"])
    xhat = (x - x.mean(0)) / np.sqrt(x.var(0) + 1e-3)
    np.testing.assert_allclose(y.numpy(), xhat * scale + bias, rtol=1e-12,
                               atol=1e-12)
    dbias, dscale = BN.bn_bwd_reduce(t["dy"], t["x"], mean, rstd)
    dx = BN.bn_bwd_dx(t["dy"], t["x"], mean, rstd, t["scale"], dbias,
                      dscale)
    want = scale / np.sqrt(x.var(0) + 1e-3) * (
        dy - dy.mean(0) - xhat * (dy * xhat).mean(0))
    np.testing.assert_allclose(dx.numpy(), want, rtol=1e-10, atol=1e-12)


def test_cpu_path_launches_no_kernel():
    BN.reset_launch_counts()
    x, dy, params, stats = _inputs(48, 1, "f32")
    _port(x, dy, params, stats, 0.9, 1e-5, "f32", True)
    _port(x, dy, params, stats, 0.9, 1e-5, "f32", False)
    assert BN.LAUNCHES == dict.fromkeys(BN.LAUNCHES, 0)


def test_running_statistics_need_both_and_a_momentum():
    x, v = torch.zeros(6, 8), torch.zeros(8)
    with pytest.raises(HorovodTpuError, match="both"):
        BN.bn_stats(x, 1e-5, 0.9, v, None)
    with pytest.raises(HorovodTpuError, match="momentum"):
        BN.bn_stats(x, 1e-5, None, v, v.clone())


def test_cuda_tensor_refuses_float64(monkeypatch):
    """No kernel takes float64: a CUDA activation of it is refused before
    any build."""
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    x = torch.zeros(6, 8, dtype=torch.float64)
    with pytest.raises(HorovodTpuError, match="float32 or bfloat16"):
        BN.bn_stats(x, 1e-5)


@pytest.mark.parametrize("wrapper", ["bn_stats", "bn_normalize",
                                     "bn_bwd_reduce", "bn_bwd_dx"])
def test_cuda_tensor_never_takes_the_plain_version(wrapper, monkeypatch):
    """A wrapper given a CUDA tensor launches its kernel or raises; it
    never computes the plain version instead.  Without a card this shows
    as the build failing loudly (no nvcc), not as a result."""
    from horovod_tpu_torch import _build

    calls = []
    monkeypatch.setattr(BN, f"{wrapper}_plain",
                        lambda *a, **k: calls.append(a) or a[0])
    monkeypatch.setattr(BN, "_lib", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    x, v = torch.zeros(6, 8), torch.zeros(8)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    args = {"bn_stats": (x, 1e-5), "bn_normalize": (x, v, v, v, v),
            "bn_bwd_reduce": (x, x, v, v),
            "bn_bwd_dx": (x, x, v, v, v, v, v)}[wrapper]
    with pytest.raises(HorovodTpuError, match="nvcc not found"):
        getattr(BN, wrapper)(*args)
    assert calls == []
