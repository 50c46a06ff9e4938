"""Kernels B8-B10 and ring attention of the port against the JAX package
on the CPU.

The port's wrappers take their plain versions on CPU tensors; the JAX
side runs the Pallas kernels in interpret mode, as
``tests/test_pallas_attention.py`` runs them, on the same numpy inputs
at (BH, L, D) = (8, 64, 16) float32.  Tolerances are the JAX tests':
rtol 2e-4 / atol 2e-5 forward, 2e-3 / 2e-4 backward (the Pallas kernels
walk 32x16 tiles with an online softmax, the plain versions take a whole
block at once, so only the order of the sums differs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import pallas_attention as JA
from horovod_tpu.parallel import ring_attention as JR
from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.ops import flash_attention as FA
from horovod_tpu_torch.parallel import ring_attention as TR

BH, L, D = 8, 64, 16
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
BWD_TOL = dict(rtol=2e-3, atol=2e-4)
BLOCKS = dict(block_q=32, block_k=16, interpret=True)


def _arrays(seed, *shapes, scale=0.3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _fresh(lq=L):
    return (np.full((BH, lq), -np.inf, np.float32),
            np.zeros((BH, lq), np.float32),
            np.zeros((BH, lq, D), np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(ours, ref, tol, what):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(ref, np.float32), err_msg=what,
                               **tol)


def _step_both(q, k, v, state, qo, ko, causal):
    ref = JA.flash_block_step(*map(jnp.asarray, (q, k, v, *state)), qo, ko,
                              causal=causal, **BLOCKS)
    ours = FA.flash_block_step(*_t(q, k, v, *state), qo, ko, causal=causal)
    return [np.asarray(r) for r in ref], [o.numpy() for o in ours]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_block_step_matches_pallas(causal):
    q, k, v = _arrays(0, (BH, L, D), (BH, L, D), (BH, L, D))
    ref, ours = _step_both(q, k, v, _fresh(), 0, 0, causal)
    for name, a, b in zip("mlo", ours, ref):
        _close(a, b, FWD_TOL, f"B8 {name}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_block_step_carries_state_across_kv_halves(causal):
    """Two steps over the two KV halves (k_offset 0 and 32), each side
    carrying its own state, and the port's pair equals its one step."""
    q, k, v = _arrays(1, (BH, L, D), (BH, L, D), (BH, L, D))
    half = L // 2
    ref, ours = _step_both(q, k[:, :half], v[:, :half], _fresh(), 0, 0,
                           causal)
    ref, _ = _step_both(q, k[:, half:], v[:, half:], ref, 0, half, causal)
    _, ours = _step_both(q, k[:, half:], v[:, half:], ours, 0, half, causal)
    for name, a, b in zip("mlo", ours, ref):
        _close(a, b, FWD_TOL, f"B8 carried {name}")
    one = FA.flash_block_step(*_t(q, k, v, *_fresh()), 0, 0, causal=causal)
    for name, a, b in zip("mlo", ours, one):
        _close(a, b.numpy(), FWD_TOL, f"B8 split vs whole {name}")


def test_fully_masked_block_keeps_fresh_state():
    """q at positions 0..63 against keys at 64..127, causal: every row is
    masked, so m stays -inf and l, o stay 0 on both sides."""
    q, k, v = _arrays(2, (BH, L, D), (BH, L, D), (BH, L, D))
    ref, ours = _step_both(q, k, v, _fresh(), 0, L, True)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert np.isneginf(ours[0]).all() and not ours[1].any()
    assert not ours[2].any()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("k_offset", [0, L // 2], ids=["own", "later"])
def test_backward_kernels_match_pallas(causal, k_offset):
    """B9 and B10 from the saved lse of a forward step, on the whole KV
    block and on a block whose positions start half-way (some rows see
    none of it)."""
    q, k, v, dout = _arrays(3, (BH, L, D), (BH, L, D), (BH, L, D),
                            (BH, L, D))
    _, state = _step_both(q, k, v, _fresh(), 0, 0, causal)
    out, lse = (t.numpy() for t in TR.finish(*_t(*state)))
    delta = (dout * out).sum(-1).astype(np.float32)
    args = (q, k, v, dout, lse, delta)
    ref_dq = JA.flash_bwd_dq(*map(jnp.asarray, args), 0, k_offset,
                             causal=causal, **BLOCKS)
    ref_dk, ref_dv = JA.flash_bwd_dkv(*map(jnp.asarray, args), 0, k_offset,
                                      causal=causal, **BLOCKS)
    dq = FA.flash_bwd_dq(*_t(*args), 0, k_offset, causal=causal)
    dk, dv = FA.flash_bwd_dkv(*_t(*args), 0, k_offset, causal=causal)
    _close(dq, ref_dq, BWD_TOL, "B9 dq")
    _close(dk, ref_dk, BWD_TOL, "B10 dk")
    _close(dv, ref_dv, BWD_TOL, "B10 dv")
    assert FA.LAUNCHES == {"flash_block_step": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}  # CPU: plain versions


# The card kernels' tile edges (tests/test_torch_cuda.py TC_SHAPES), cut
# to what the interpreted Pallas kernels run in seconds: (bh, lq, lk, d,
# q_offset, k_offset, block_q, block_k), the Pallas blocks dividing L
EDGE_SHAPES = [(2, 300, 260, 64, 40, 0, 60, 52),
               (1, 512, 512, 16, 0, 0, 128, 128),
               (1, 512, 512, 128, 0, 0, 128, 128),
               (8, 256, 256, 64, 0, 0, 128, 128)]


@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:6])))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_tile_edges_match_pallas(causal, shape):
    """bf16 B8 and B10 at the card tests' tile-edge geometry: the port's
    plain versions (which the card kernels are held to) against the
    interpreted Pallas kernels, at the JAX package's bf16 tolerance; B8's
    o as o / l (``flash_attention.state_pairs``)."""
    bh, lq, lk, d, qo, ko, bq, bk = shape
    blocks = dict(block_q=bq, block_k=bk, interpret=True)
    q, k, v, dout = _arrays(6, (bh, lq, d), (bh, lk, d), (bh, lk, d),
                            (bh, lq, d))
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, dout))
    tq, tk, tv, tdo = (x.bfloat16() for x in _t(q, k, v, dout))
    fresh = (np.full((bh, lq), -np.inf, np.float32),
             np.zeros((bh, lq), np.float32), np.zeros((bh, lq, d), np.float32))
    ref = JA.flash_block_step(jq, jk, jv, *map(jnp.asarray, fresh), qo, ko,
                              causal=causal, **blocks)
    ours = FA.flash_block_step(tq, tk, tv, *_t(*fresh), qo, ko, causal=causal)
    bf16 = dict(rtol=2e-2, atol=2e-2)
    for name, a, b in FA.state_pairs(ours, _t(*ref), True):
        _close(a, b, bf16, f"B8 {name}")
    out, lse = TR.finish(*ours)
    delta = (tdo.float() * out).sum(-1)
    ref_dk, ref_dv = JA.flash_bwd_dkv(jq, jk, jv, jdo, jnp.asarray(lse),
                                      jnp.asarray(delta), qo, ko,
                                      causal=causal, **blocks)
    dk, dv = FA.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, qo, ko,
                              causal=causal)
    _close(dk, ref_dk, bf16, "B10 dk")
    _close(dv, ref_dv, bf16, "B10 dv")


# Head dims above 128 (the card's kernels take multiples of 8 up to 256)
# and one that is not a multiple of 8 (the plain versions take any), at
# ragged lengths and non-zero offsets: (bh, lq, lk, d, q_offset,
# k_offset, block_q, block_k), the Pallas blocks dividing L
WIDE_SHAPES = [(2, 96, 80, 192, 16, 0, 32, 16),
               (2, 96, 80, 256, 0, 16, 32, 16),
               (2, 64, 48, 100, 8, 4, 32, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", WIDE_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:6])))
def test_wide_head_dims_match_pallas(shape, dtype):
    """B8, B9 and B10 (causal) at D = 192, 256 and 100: the port's plain
    versions against the interpreted Pallas kernels, at this file's
    float32 tolerances and the JAX package's bfloat16 one (B8's o as o /
    l in bfloat16, ``flash_attention.state_pairs``)."""
    bh, lq, lk, d, qo, ko, bq, bk = shape
    blocks = dict(block_q=bq, block_k=bk, interpret=True)
    bf16 = dtype == "bfloat16"
    fwd, bwd = ((dict(rtol=2e-2, atol=2e-2),) * 2 if bf16
                else (FWD_TOL, BWD_TOL))
    q, k, v, dout = _arrays(12, (bh, lq, d), (bh, lk, d), (bh, lk, d),
                            (bh, lq, d))
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.dtype(dtype))
                       for x in (q, k, v, dout))
    tq, tk, tv, tdo = (x.to(getattr(torch, dtype))
                       for x in _t(q, k, v, dout))
    fresh = (np.full((bh, lq), -np.inf, np.float32),
             np.zeros((bh, lq), np.float32), np.zeros((bh, lq, d), np.float32))
    ref = JA.flash_block_step(jq, jk, jv, *map(jnp.asarray, fresh), qo, ko,
                              causal=True, **blocks)
    ours = FA.flash_block_step(tq, tk, tv, *_t(*fresh), qo, ko, causal=True)
    for name, a, b in FA.state_pairs(ours, _t(*ref), bf16):
        _close(a, b, fwd, f"B8 D={d} {name}")
    out, lse = TR.finish(*ours)
    delta = (tdo.float() * out).sum(-1)
    jargs = (jq, jk, jv, jdo, jnp.asarray(lse), jnp.asarray(delta), qo, ko)
    targs = (tq, tk, tv, tdo, lse, delta, qo, ko)
    ref_dq = JA.flash_bwd_dq(*jargs, causal=True, **blocks)
    ref_dk, ref_dv = JA.flash_bwd_dkv(*jargs, causal=True, **blocks)
    dq = FA.flash_bwd_dq(*targs, causal=True)
    dk, dv = FA.flash_bwd_dkv(*targs, causal=True)
    _close(dq, ref_dq, bwd, f"B9 D={d} dq")
    _close(dk, ref_dk, bwd, f"B10 D={d} dk")
    _close(dv, ref_dv, bwd, f"B10 D={d} dv")
    assert np.isfinite(dq.numpy()).all() and dq.abs().max() > 0


# The card holds bf16 B8-B10 within the JAX package's 2e-2 and within
# flash_attention.BF16_MAX_ABS and BF16_ROW_REL.  These cases build, from
# the plain versions, what a kernel at the long-context row length (one
# head of 8192 positions, D 64) returns when it rounds as the tensor-core
# kernels do (B8: p to bf16 against the running max of 128-key tiles; B9:
# dQ summed over 64-key tiles) and when it drops or mis-masks one tile, on
# the rows such a fault touches.
LONG = 8192


def _long_b8(drop=None, unmask_last=False):
    """o / l of B8 and of the plain step over the last 128 query rows,
    the B8 state carried over 128-key tiles: tile ``drop`` skipped, the
    last (diagonal) tile unmasked with ``unmask_last``."""
    q, k, v = (x.bfloat16()
               for x in _t(*_arrays(8, *[(1, LONG, 64)] * 3, scale=1.0)))
    qo = LONG - 128
    q = q[:, qo:]
    fresh = (torch.full((1, 128), -np.inf), torch.zeros(1, 128),
             torch.zeros(1, 128, 64))
    want = FA.flash_block_step_plain(q, k, v, *fresh, qo, 0, True)
    got = fresh
    for t, k0 in enumerate(range(0, LONG, 128)):
        if t != drop:
            got = FA.flash_block_step_plain(
                q, k[:, k0:k0 + 128], v[:, k0:k0 + 128], *got, qo, k0,
                not (unmask_last and k0 == qo))
    return dict((n, (a, b)) for n, a, b in FA.state_pairs(got, want, True))[
        "o / l"]


def _long_b9(drop=None, unmask_last=False):
    """dQ of the last 128 query rows against every key, and the same
    summed over 64-key tiles (B9's at D = 64): tile ``drop`` left out,
    the last (diagonal) tile unmasked with ``unmask_last``."""
    q, k, v, dout = (x.bfloat16()
                     for x in _t(*_arrays(10, *[(1, LONG, 64)] * 4,
                                          scale=1.0)))
    qo = LONG - 128
    q, dout = q[:, qo:], dout[:, qo:]
    fresh = (torch.full((1, 128), -np.inf), torch.zeros(1, 128),
             torch.zeros(1, 128, 64))
    out, lse = TR.finish(*FA.flash_block_step_plain(q, k, v, *fresh, qo, 0,
                                                    True))
    delta = (dout.float() * out).sum(-1)
    want = FA.flash_bwd_dq_plain(q, k, v, dout, lse, delta, qo, 0, True)
    got = torch.zeros_like(want)
    for t, k0 in enumerate(range(0, LONG, 64)):
        if t != drop:
            got += FA.flash_bwd_dq_plain(
                q, k[:, k0:k0 + 64], v[:, k0:k0 + 64], dout, lse, delta, qo,
                k0, not (unmask_last and k0 == LONG - 64))
    return got, want


def _long_b10_dropped_query_tile():
    """dK of the first 128 keys against every query, and the same with
    the 64-query tile at the row's middle left out of the sums."""
    q, k, v, dout = (x.bfloat16()
                     for x in _t(*_arrays(9, *[(1, LONG, 64)] * 4,
                                          scale=1.0)))
    state = (torch.full((1, LONG), -np.inf), torch.zeros(1, LONG),
             torch.zeros(1, LONG, 64))
    for k0 in range(0, LONG, 1024):
        state = FA.flash_block_step_plain(q, k[:, k0:k0 + 1024],
                                          v[:, k0:k0 + 1024], *state, 0, k0)
    out, lse = TR.finish(*state)
    delta = (dout.float() * out).sum(-1)
    kb, vb = k[:, :128], v[:, :128]
    want = FA.flash_bwd_dkv_plain(q, kb, vb, dout, lse, delta, 0, 0)[0]
    t = slice(LONG // 2, LONG // 2 + 64)
    part = FA.flash_bwd_dkv_plain(q[:, t], kb, vb, dout[:, t], lse[:, t],
                                  delta[:, t], LONG // 2, 0)[0]
    return want - part, want


@pytest.mark.parametrize("case", ["tiled_rounding", "dropped_key_tile",
                                  "unmasked_diagonal_tile",
                                  "dropped_query_tile", "dq_tiled_sums",
                                  "dq_dropped_key_tile",
                                  "dq_unmasked_diagonal_tile"])
def test_bf16_bounds_pass_tiled_rounding_and_catch_a_faulty_tile(case):
    if case == "dropped_query_tile":
        got, want = _long_b10_dropped_query_tile()
    elif case.startswith("dq_"):
        got, want = _long_b9(drop=LONG // 128 if "dropped" in case else None,
                             unmask_last="unmasked" in case)
    else:
        got, want = _long_b8(drop=LONG // 256 if case == "dropped_key_tile"
                             else None,
                             unmask_last=case == "unmasked_diagonal_tile")
    err, row = FA.errors(got, want)
    if case in ("tiled_rounding", "dq_tiled_sums"):
        assert err <= FA.BF16_MAX_ABS and row <= FA.BF16_ROW_REL, (err, row)
        return
    assert err > FA.BF16_MAX_ABS and row > FA.BF16_ROW_REL, (err, row)
    if case != "dropped_query_tile":
        # the JAX package's bf16 tolerance alone lets this fault pass
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def test_row_error_of_a_zero_row_is_held_to_the_absolute_bound():
    """A row that is zero up to rounding (B9's dQ of a query that sees
    one key) reads its noise over ``BF16_MAX_ABS``, while a small row
    that is wholly wrong still fails the row bound."""
    want = torch.ones(3, 64) * 0.1
    want[0] = 0.0
    want[1] = 5e-4  # row norm 4e-3, below the absolute bound
    got = want.clone()
    got[0] = 1e-7  # rounding noise on the zero row
    err, row = FA.errors(got, want)
    assert err <= FA.BF16_MAX_ABS and row <= FA.BF16_ROW_REL, (err, row)
    got[1] = 0.0
    err, row = FA.errors(got, want)
    assert err <= FA.BF16_MAX_ABS and row > FA.BF16_ROW_REL, (err, row)


@pytest.mark.parametrize("b", [1, 2], ids=["batch1", "batch2"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_and_grads_match_jax_ring_flash(causal, b):
    """The port's ring_attention (autograd Function over B8-B10) against
    ``ring_attention(impl="pallas")`` on a one-device ``sp`` mesh, which
    runs the JAX package's ``_ring_flash`` custom VJP."""
    h = 4
    q, k, v = _arrays(4, (b, L, h, D), (b, L, h, D), (b, L, h, D))
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))

    def loss(a, b_, c):
        o = JR.ring_attention(a, b_, c, "sp", causal=causal, impl="pallas")
        return jnp.sum(o * o), o

    fn = jax.jit(shard_map(
        lambda a, b_, c: jax.value_and_grad(loss, argnums=(0, 1, 2),
                                            has_aux=True)(a, b_, c),
        mesh=mesh, check_vma=False, in_specs=(P(None, "sp"),) * 3,
        out_specs=((P(), P(None, "sp")), (P(None, "sp"),) * 3)))
    (_, ref_out), ref_grads = fn(q, k, v)

    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = TR.ring_attention(tq, tk, tv, causal=causal)
    (out * out).sum().backward()
    _close(out.detach(), ref_out, FWD_TOL, "ring attention output")
    dense = TR.reference_attention(*_t(q, k, v), causal=causal)
    _close(out.detach(), dense, FWD_TOL, "ring attention vs dense")
    for name, g, r in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          ref_grads):
        _close(g, r, BWD_TOL, f"ring attention {name}")


def test_ring_attention_bfloat16_matches_jax():
    """bf16 operands: the port's output within the JAX package's bf16
    tolerance of ``ring_attention(impl="pallas")``."""
    b, h = 2, 4
    q, k, v = _arrays(5, (b, L, h, D), (b, L, h, D), (b, L, h, D))
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))
    fn = jax.jit(shard_map(
        lambda a, b_, c: JR.ring_attention(a, b_, c, "sp", causal=True,
                                           impl="pallas"),
        mesh=mesh, check_vma=False, in_specs=(P(None, "sp"),) * 3,
        out_specs=P(None, "sp")))
    ref = fn(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    ours = TR.ring_attention(*(x.bfloat16() for x in _t(q, k, v)))
    assert ours.dtype == torch.bfloat16
    _close(ours.float(), np.asarray(ref, np.float32),
           dict(rtol=2e-2, atol=2e-2), "bf16 ring attention")


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "kv_shape", "state",
                                 "contiguous"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    q = torch.zeros(2, 16, 16)
    k = v = torch.zeros(2, 8, 16)
    m, l, o = torch.zeros(2, 16), torch.zeros(2, 16), torch.zeros(2, 16, 16)
    if bad == "head_dim":  # any other head dim is the plain versions'
        q, k, v, o = (x[..., :0].contiguous() for x in (q, k, v, o))
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "kv_shape":
        v = torch.zeros(2, 9, 16)
    elif bad == "state":
        m = m.double()
    else:
        k = torch.zeros(2, 16, 8).transpose(1, 2)
    with pytest.raises(HorovodTpuError):
        FA.flash_block_step(q, k, v, m, l, o, 0, 0)


@pytest.mark.parametrize("d,fwd,dq,dkv", [
    (64, (64, 128, 128, False), (64, 128, 64, False), (64, 128, 64, False)),
    (128, (128, 128, 64, False), (128, 128, 64, False),
     (128, 128, 32, False)),
    (136, (192, 128, 64, False), (192, 128, 32, False),
     (256, 64, 32, True)),
    (256, (256, 128, 64, False), (256, 128, 32, False),
     (256, 64, 32, True))])
def test_tc_tiles_follow_the_kernels_dispatch(d, fwd, dq, dkv):
    """``tc_tiles``: the bf16 tensor-core instantiation each wrapper
    launches at head dim ``d`` (``csrc/flash_attention.cu``'s dispatch:
    columns, rows per block, pipelined tile, B10's head-column split);
    head dims the card does not take have none."""
    keys = ("dp", "rows", "tile", "split")
    for name, want in (("flash_block_step", fwd), ("flash_bwd_dq", dq),
                       ("flash_bwd_dkv", dkv)):
        got = FA.tc_tiles(name, d)
        assert tuple(got[k] for k in keys) == want, (name, got)
    for bad in (0, FA.MAX_D + 8):
        with pytest.raises(HorovodTpuError):
            FA.tc_tiles("flash_bwd_dkv", bad)
