"""The port's fused optimizer tail (kernels B1-B3 and their plain
versions) against the JAX package's.

The JAX side is ``fused_update_groups``: with the JAX test's dyadic
hyperparameters, through the Pallas kernels in interpret mode
(``HOROVOD_QUANT_PALLAS=1``) under ``jax.jit``, as
``tests/test_fused_update.py`` runs it; with the default
hyperparameters, through its jnp twin op by op (under jit, XLA-CPU's
rewrites put the interpreted kernel up to 2 ulp off optax's own chain on
such values).  The port side is its kernel wrappers on CPU tensors,
which run the plain versions.  Same shards
(lengths 1000 and 257), same wire values (``3 * shard`` with ``navg=2``),
three steps.

Tolerance: at most 1 ulp of the working dtype (float32 or bfloat16).
XLA-CPU under jit may contract a multiply and an add into one FMA or keep
excess precision across bf16 operations, which the port -- like optax's
op-by-op chain -- does not (``tests/test_fused_update.py:174-180``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.optim import fused_update as JF
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.optim import fused_update as TF

KINDS = ("sgd", "momentum", "adam")
# the JAX test's dyadic hyperparameters, and the defaults users run
HYPER = {
    "dyadic": dict(lr=0.5, momentum=0.5, b1=0.5, b2=0.25, eps=2.0 ** -10),
    "default": dict(lr=0.1, momentum=0.9, b1=0.9, b2=0.999, eps=1e-8),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _jax_opt(kind, h):
    if kind == "sgd":
        return JF.sgd(h["lr"])
    if kind == "momentum":
        return JF.sgd(h["lr"], momentum=h["momentum"])
    return JF.adam(h["lr"], b1=h["b1"], b2=h["b2"], eps=h["eps"])


def _ordered(a: np.ndarray, dtype: str) -> np.ndarray:
    """Float bits mapped to integers whose difference counts ulps."""
    bits = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    if dtype == "bf16":
        bits = bits >> 16
    sign = (1 << 15) if dtype == "bf16" else (1 << 31)
    return np.where(bits < 0, -(bits & (sign - 1)), bits)


def assert_ulp(a, b, dtype: str, what: str, ulps: int = 1) -> None:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, what
    d = np.abs(_ordered(a, dtype) - _ordered(b, dtype))
    assert d.max(initial=0) <= ulps, (
        f"{what}: {int(d.max())} ulp apart (at {int(d.argmax())}: "
        f"{a.reshape(-1)[d.argmax()]} vs {b.reshape(-1)[d.argmax()]})")


def _t(a: np.ndarray, tdt) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(tdt)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("hyper", sorted(HYPER))
@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_plain_matches_pallas_interpret(monkeypatch, kind, dname,
                                               hyper):
    jdt, tdt = DTYPES[dname]
    h = HYPER[hyper]
    opt = _jax_opt(kind, h)
    base = [np.arange(1000, dtype=np.float32) / 64.0 - 4.0,
            np.arange(257, dtype=np.float32) / 32.0]
    shards = [jnp.asarray(b).astype(jdt) for b in base]
    raw = [s * 3 for s in shards]  # the wire's sum, navg=2 below

    def run3(raw, state):
        outs = []
        for _ in range(3):
            u, state = JF.fused_update_groups(opt.fused_spec, raw, state, 2,
                                              [s.dtype for s in shards])
            outs.append(u)
        return outs, state

    if hyper == "dyadic":
        # the Pallas kernels, interpreted, under jit: exact on dyadic data
        monkeypatch.setenv("HOROVOD_QUANT_PALLAS", "1")
        jouts, jstate = jax.jit(run3)(raw, opt.init(shards))
    else:
        # on general values XLA's jit rewrites move the Pallas path up to
        # 2 ulp off optax's chain; the jnp twin run op by op is optax's
        # arithmetic exactly
        monkeypatch.setenv("HOROVOD_QUANT_PALLAS", "0")
        jouts, jstate = run3(raw, opt.init(shards))

    spec = TF.FusedSpec(kind, h["lr"], h["momentum"] if kind != "sgd"
                        else 0.0, h["b1"], h["b2"], h["eps"])
    traw = [_t(np.asarray(r, np.float32), tdt) for r in raw]
    mus = [torch.zeros_like(r) for r in traw]
    nus = [torch.zeros_like(r) for r in traw]
    for step in range(3):
        bc1, bc2 = TF.bias_corrections(spec, step + 1)
        for i, g in enumerate(traw):
            if kind == "sgd":
                u = TF.sgd_update(g, 2, -spec.lr)
            elif kind == "momentum":
                u, _ = TF.momentum_update(g, mus[i], 2, spec.momentum,
                                          -spec.lr, t_out=mus[i])
            else:
                u, _, _ = TF.adam_update(g, mus[i], nus[i], bc1, bc2, 2,
                                         spec, mu_out=mus[i], nu_out=nus[i])
            assert_ulp(_np(u), jouts[step][i], dname, f"u step{step} #{i}")

    leaves = jax.tree_util.tree_leaves(jstate)
    if kind == "momentum":
        for i in range(2):
            assert_ulp(_np(mus[i]), leaves[i], dname, f"trace #{i}")
    elif kind == "adam":
        assert int(leaves[0]) == 3
        for i in range(2):
            assert_ulp(_np(mus[i]), leaves[1 + i], dname, f"mu #{i}")
            assert_ulp(_np(nus[i]), leaves[3 + i], dname, f"nu #{i}")
    assert TF.LAUNCHES == {"sgd": 0, "momentum": 0, "adam": 0}, \
        "CPU tensors must not count kernel launches"


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_unfused_step_matches_optax(kind, dname):
    """The optimizers' own step() (plain torch ops) against optax's
    update + apply_updates over three steps."""
    jdt, tdt = DTYPES[dname]
    h = HYPER["default"]
    rng = np.random.RandomState(3)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((31, 7), (5,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in p0]
             for _ in range(3)]
    if kind == "adam":
        jopt = optax.adam(h["lr"], b1=h["b1"], b2=h["b2"], eps=h["eps"])
    else:
        jopt = optax.sgd(h["lr"], momentum=h["momentum"] if kind ==
                         "momentum" else None)
    jp = [jnp.asarray(p).astype(jdt) for p in p0]
    jstate = jopt.init(jp)

    # op by op, as optax's chain runs without jit: under jit XLA-CPU
    # contracts ``p + (-lr) * t`` across update and apply into one FMA
    def jstep(p, g, s):
        u, s = jopt.update(g, s, p)
        return optax.apply_updates(p, u), s

    tp = [torch.nn.Parameter(_t(p, tdt)) for p in p0]
    if kind == "adam":
        topt = TF.adam(tp, h["lr"], b1=h["b1"], b2=h["b2"], eps=h["eps"])
    else:
        topt = TF.sgd(tp, h["lr"], momentum=h["momentum"] if kind ==
                      "momentum" else None)
    for g in grads:
        jp, jstate = jstep(jp, [jnp.asarray(x).astype(jdt) for x in g],
                           jstate)
        for p, x in zip(tp, g):
            p.grad = _t(x, tdt)
        topt.step()
        for i, (a, b) in enumerate(zip(tp, jp)):
            assert_ulp(_np(a.detach()), b, dname, f"param #{i}")


def test_bias_corrections_match_optax_jit():
    for b1, b2 in ((0.9, 0.999), (0.5, 0.25)):
        spec = TF.FusedSpec("adam", 0.1, 0.0, b1, b2)
        jspec = JF.FusedSpec("adam", 0.1, 0.0, b1, b2)
        for t in (1, 2, 3, 1000):
            ours = TF.bias_corrections(spec, t)
            ref = JF.bias_corrections(jspec, jnp.asarray(t, jnp.int32))
            for a, b in zip(ours, ref):
                assert_ulp(np.float32(a), np.asarray(b), "f32",
                           f"bc t={t}")


def test_wrappers_check_their_arguments():
    g = torch.zeros(8)
    with pytest.raises(HorovodTpuError, match="dtype"):
        TF.sgd_update(g.double(), 1, -0.1)
    with pytest.raises(HorovodTpuError, match="share device and dtype"):
        TF.momentum_update(g, torch.zeros(8, dtype=torch.bfloat16), 1, 0.9,
                           -0.1)
    with pytest.raises(HorovodTpuError, match="sizes differ"):
        TF.momentum_update(g, torch.zeros(9), 1, 0.9, -0.1)
    with pytest.raises(HorovodTpuError, match="contiguous"):
        TF.sgd_update(torch.zeros(4, 4).t(), 1, -0.1)
    with pytest.raises(TypeError, match="must be a float"):
        TF.sgd([torch.nn.Parameter(g)], lambda step: 0.1)


@pytest.mark.parametrize("kind,key,bad", [
    ("momentum", "trace", torch.zeros(2, 3, dtype=torch.bfloat16)),
    ("momentum", "trace", torch.zeros(6)),
    ("momentum", "trace", None),
    ("adam", "mu", torch.zeros(2, 3, dtype=torch.float64)),
    ("adam", "count", torch.tensor(1)),
])
def test_fused_tail_raises_on_foreign_state(kind, key, bad):
    """A state the kernels cannot take (another dtype or shape, say from
    a loaded checkpoint) stops the fused tail with the leaf named; no
    unfused step runs in its place."""
    params = [torch.nn.Parameter(torch.ones(4)),
              torch.nn.Parameter(torch.ones(2, 3))]
    opt = TF.adam(params, 0.1) if kind == "adam" else TF.sgd(params, 0.1,
                                                              0.9)
    before = {k: v for k, v in opt.state[params[1]].items()}
    opt.state[params[1]][key] = bad
    grads = [torch.ones_like(p) for p in params]
    states = [opt.state[p] for p in params]
    with pytest.raises(HorovodTpuError, match=f"state\\['{key}'\\] of leaf 1"):
        TF.fused_update_tree(opt.fused_spec, grads, states)
    opt.state[params[1]][key] = before[key]
    assert len(TF.fused_update_tree(opt.fused_spec, grads, states)) == 2
