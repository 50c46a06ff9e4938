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


def _kind_cases(cases):
    """``(kind, case)`` params over the three kinds; plain SGD keeps the
    case's own id."""
    return [pytest.param(k, c, id=c if k == "sgd" else f"{k}-{c}")
            for k in KINDS for c in cases]


@pytest.mark.parametrize("kind,hyper", _kind_cases(sorted(HYPER)))
def test_sgd_tree_of_mixed_dtypes_matches_jax(monkeypatch, kind, hyper):
    """The stage-0 fused tail of each kind over float32 and bfloat16
    leaves and an empty one (the port groups them by dtype, one
    multi-leaf call each) against the JAX package's
    ``fused_update_tree`` over the same tree, two steps, through the
    interpreted Pallas kernels (dyadic) or the jnp twin."""
    h = HYPER[hyper]
    rng = np.random.RandomState(11)
    shapes = [((7, 5), "f32"), ((300,), "bf16"), ((0,), "f32"),
              ((3, 3, 4), "bf16"), ((4097,), "f32")]
    base = [(rng.standard_normal(s) * 4).astype(np.float32)
            for s, _ in shapes]
    if hyper == "dyadic":
        base = [np.round(b * 64) / 64 for b in base]
    jgrads = [jnp.asarray(b).astype(DTYPES[d][0])
              for b, (_, d) in zip(base, shapes)]
    monkeypatch.setenv("HOROVOD_QUANT_PALLAS",
                       "1" if hyper == "dyadic" else "0")
    opt = _jax_opt(kind, h)
    jstate = opt.init(jgrads)
    jouts = []
    for _ in range(2):
        u, jstate = JF.fused_update_tree(opt.fused_spec, jgrads, jstate)
        jouts.append(u)

    params = [torch.nn.Parameter(_t(b, DTYPES[d][1]))
              for b, (_, d) in zip(base, shapes)]
    if kind == "adam":
        topt = TF.adam(params, h["lr"], b1=h["b1"], b2=h["b2"], eps=h["eps"])
    else:
        topt = TF.sgd(params, h["lr"], h["momentum"] if kind == "momentum"
                      else None)
    grads = [_t(b, DTYPES[d][1]) for b, (_, d) in zip(base, shapes)]
    TF.reset_launch_counts()
    for step in range(2):
        outs = TF.fused_update_tree(topt.fused_spec, grads,
                                    [topt.state[p] for p in params])
        for i, (u, j, (s, d)) in enumerate(zip(outs, jouts[step], shapes)):
            assert tuple(u.shape) == s and u.dtype == DTYPES[d][1]
            assert_ulp(_np(u), j, d, f"u step {step} #{i} {d} {s}")
    if kind == "adam":
        assert all(topt.state[p]["count"] == 2 for p in params)
    assert TF.LAUNCHES == {"sgd": 0, "momentum": 0, "adam": 0}  # CPU


def test_sgd_update_multi_equals_the_plain_loop():
    """The multi-leaf wrapper on CPU tensors is the loop of ``sgd_plain``
    over the leaves, bit for bit, into the given outputs or new ones."""
    gen = torch.Generator().manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        grads = [torch.randn(s, generator=gen).to(dtype)
                 for s in ((3, 4), (0,), (5000,), (1,))]
        for navg in (1, 2):
            want = [TF.sgd_plain(g, navg, -0.1) for g in grads]
            outs = [torch.full_like(g, 7.0) for g in grads]
            got = TF.sgd_update_multi(grads, navg, -0.1, outs=outs)
            assert all(a is b for a, b in zip(got, outs))
            again = TF.sgd_update_multi(grads, navg, -0.1)
            for a, b, w in zip(got, again, want):
                assert torch.equal(a, w) and torch.equal(b, w)
    assert TF.sgd_update_multi([], 1, -0.1) == []


def _multi_call(kind, grads, outs=None, state=None, **kw):
    """``kind``'s multi-leaf wrapper over ``grads`` (state: zeros like
    the leaves unless given)."""
    if state is None:
        state = [[torch.zeros_like(g) for g in grads] for _ in range(2)]
    if kind == "sgd":
        return [TF.sgd_update_multi(grads, 1, -0.1, outs=outs)]
    if kind == "momentum":
        return TF.momentum_update_multi(grads, state[0], 1, 0.9, -0.1,
                                        outs=outs, **kw)
    return TF.adam_update_multi(grads, *state, 0.1, 0.01, 1,
                                TF.FusedSpec("adam", 0.1), outs=outs, **kw)


@pytest.mark.parametrize("kind", ["momentum", "adam"])
def test_multi_update_equals_the_plain_loop(kind):
    """B1's and B3's multi-leaf wrappers on CPU tensors are the loop of
    ``momentum_plain`` / ``adam_plain`` over the leaves, bit for bit:
    into given outputs, into new ones, and with the state in place."""
    gen = torch.Generator().manual_seed(5)
    spec = TF.FusedSpec("adam", 0.1)
    for dtype in (torch.float32, torch.bfloat16):
        shapes = ((3, 4), (0,), (5000,), (1,))
        grads = [torch.randn(s, generator=gen).to(dtype) for s in shapes]
        for navg in (1, 2):
            state = [[torch.randn(s, generator=gen).to(dtype).abs()
                      for s in shapes] for _ in range(2)]
            if kind == "momentum":
                want = list(zip(*[TF.momentum_plain(g, t, navg, 0.9, -0.1)
                                  for g, t in zip(grads, state[0])]))

                def call(**kw):
                    return TF.momentum_update_multi(grads, state[0], navg,
                                                    0.9, -0.1, **kw)
                names = ("outs", "t_outs")
            else:
                want = list(zip(*[TF.adam_plain(g, m, v, 0.2, 0.05, navg,
                                                spec)
                                  for g, m, v in zip(grads, *state)]))

                def call(**kw):
                    return TF.adam_update_multi(grads, *state, 0.2, 0.05,
                                                navg, spec, **kw)
                names = ("outs", "mu_outs", "nu_outs")
            given = [[torch.full_like(g, 7.0) for g in grads]
                     for _ in names]
            got = call(**dict(zip(names, given)))
            assert all(a is b for a, b in zip(got, given))
            for results in (got, call()):
                for ws, gs in zip(want, results):
                    assert all(torch.equal(w, x) for w, x in zip(ws, gs))
            # the state updated in place (the fused tail's call)
            inplace = call(**dict(zip(names[1:], state)))
            assert all(a is b for a, b in zip(inplace[1:], state))
            for ws, gs in zip(want, inplace):
                assert all(torch.equal(w, x) for w, x in zip(ws, gs))
    assert TF.momentum_update_multi([], [], 1, 0.9, -0.1) == ([], [])
    assert TF.adam_update_multi([], [], [], 0.1, 0.01, 1, spec) == \
        ([], [], [])


_BAD = ["mixed_devices", "mixed_dtypes", "non_contiguous", "outs_count",
        "outs_size", "outs_dtype", "outs_non_contiguous", "dtype",
        "two_rows_write_one_pointer"]


@pytest.mark.parametrize("kind,bad", _kind_cases(_BAD))
def test_sgd_update_multi_refuses_what_one_launch_does_not_take(kind, bad):
    """Each multi-leaf wrapper refuses what one launch does not take
    (before any update runs, on the CPU as on the card)."""
    grads = [torch.zeros(4, 3), torch.zeros(6)]
    outs = None
    if bad == "mixed_devices":
        grads[1] = torch.zeros(6, device="meta")
    elif bad == "mixed_dtypes":
        grads[1] = grads[1].bfloat16()
    elif bad == "non_contiguous":
        grads[0] = torch.zeros(3, 4).t()
    elif bad == "dtype":
        grads = [g.double() for g in grads]
    elif bad == "outs_count":
        outs = [torch.zeros(4, 3)]
    elif bad == "outs_size":
        outs = [torch.zeros(4, 3), torch.zeros(7)]
    elif bad == "outs_dtype":
        outs = [torch.zeros(4, 3), torch.zeros(6).bfloat16()]
    elif bad == "two_rows_write_one_pointer":
        shared = torch.zeros(12)
        outs = [shared.view(4, 3), shared[:6]]
    else:
        outs = [torch.zeros(3, 4).t(), torch.zeros(6)]
    state = None
    if bad in ("mixed_devices", "mixed_dtypes", "non_contiguous", "dtype"):
        state = [[torch.zeros(4, 3), torch.zeros(6)] for _ in range(2)]
    with pytest.raises(HorovodTpuError):
        _multi_call(kind, grads, outs=outs, state=state)


@pytest.mark.parametrize("kind", ["momentum", "adam"])
def test_multi_update_refuses_states_one_launch_does_not_take(kind):
    """A state list of another count, size, dtype or layout than the
    leaves', and two outputs of one leaf on one pointer, are refused."""
    grads = [torch.zeros(4, 3), torch.zeros(6)]
    for bad in ([torch.zeros(4, 3)], [torch.zeros(4, 3), torch.zeros(7)],
                [torch.zeros(4, 3), torch.zeros(6).bfloat16()],
                [torch.zeros(3, 4).t(), torch.zeros(6)]):
        with pytest.raises(HorovodTpuError):
            _multi_call(kind, grads, state=[bad, bad])
    state = [[torch.zeros_like(g) for g in grads] for _ in range(2)]
    with pytest.raises(HorovodTpuError, match="write one pointer"):
        _multi_call(kind, grads, outs=state[0], state=state,
                    **{"t_outs" if kind == "momentum" else "mu_outs":
                       state[0]})


def test_leaf_table_rows_launches_and_first_chunks():
    """The parameter rows of a multi-leaf launch: empty leaves skipped,
    first chunks numbered in order from 0 within each launch, a new
    launch at every ``capacity`` rows."""
    chunk = TF._CHUNK
    sizes = [chunk, 0, 1, chunk + 1, 3 * chunk, 0, 7]
    ptrs = [[10 * i + 1 for i in range(7)], [10 * i + 2 for i in range(7)]]
    table, launches = TF.leaf_table(ptrs, sizes, 5)
    assert launches == 1 and table.dtype == np.int64
    assert table.flags.c_contiguous
    assert table.tolist() == [[1, 2, chunk, 0],
                              [21, 22, 1, 1],
                              [31, 32, chunk + 1, 2],
                              [41, 42, 3 * chunk, 4],
                              [61, 62, 7, 7]]
    # capacity + 1 rows: a second launch whose first chunks start at 0
    table, launches = TF.leaf_table(ptrs, sizes, 4)
    assert launches == 2 and table[-1].tolist() == [61, 62, 7, 0]
    table, launches = TF.leaf_table(ptrs, sizes, 2)
    assert launches == 3 and table[:, -1].tolist() == [0, 1, 0, 2, 0]
    table, launches = TF.leaf_table([[5], [6]], [0], 3)
    assert launches == 0 and table.shape == (0, 4)
