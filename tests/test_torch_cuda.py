"""Tests of the port that need the card: kernels B1-B10 and N1-N4 against
their plain versions (B1-B3 also in one launch over many leaves), and
short training runs through them; on a machine with
four cards, the collectives and the lossy wire over NCCL, ZeRO, sequence
parallelism, the data plane (named mesh axes, the two-level
reductions, Adasum), the LM under tensor, expert and pipeline
parallelism, ResNet-50 under local SGD and through the eager plane's
frontend.
Marked ``cuda``; each skips (with its reason) where no CUDA device is
present.  This file imports no JAX, so it runs on a GPU machine without
it::

    python -m pytest tests/test_torch_cuda.py -q -s -p no:cacheprovider --noconftest
"""

import math

import numpy as np
import pytest
import torch

from horovod_tpu_torch.common.types import HorovodTpuError
from horovod_tpu_torch.ops import flash_attention as FA
from horovod_tpu_torch.ops import quantization as Q
from horovod_tpu_torch.optim import fused_update as TF
from horovod_tpu_torch.parallel.ring_attention import finish

pytestmark = pytest.mark.cuda
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 1000, 2_359_296])
@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_kernel_bit_exact_against_plain(card, kind, dname, n):
    dtype = DTYPES[dname]
    gen = torch.Generator(device=card).manual_seed(n)
    g, t, v = (torch.randn(n, device=card, generator=gen).to(dtype)
               for _ in range(3))
    v = v.abs()
    spec = TF.FusedSpec(kind, 0.1, 0.9)
    TF.reset_launch_counts()
    for navg in (1, 3):
        if kind == "sgd":
            got = [TF.sgd_update(g, navg, -0.1)]
            want = [TF.sgd_plain(g, navg, -0.1)]
        elif kind == "momentum":
            got = TF.momentum_update(g, t, navg, 0.9, -0.1)
            want = TF.momentum_plain(g, t, navg, 0.9, -0.1)
        else:
            bc1, bc2 = TF.bias_corrections(spec, 3)
            got = TF.adam_update(g, t, v, bc1, bc2, navg, spec)
            want = TF.adam_plain(g, t, v, bc1, bc2, navg, spec)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert TF.LAUNCHES[kind] == 2


@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_sgd_one_launch_over_mixed_leaves_equals_per_leaf(card, dname):
    """B2 over leaves of many sizes (one element, a ragged chunk, an
    empty leaf, several chunks) in one launch equals ``sgd_update`` leaf
    by leaf, bit for bit, into given outputs and into new ones."""
    dtype = DTYPES[dname]
    gen = torch.Generator(device=card).manual_seed(17)
    sizes = [(1,), (4095,), (0,), (64, 64), (3, 4097), (2_359_296,), (5,)]
    grads = [torch.randn(s, device=card, generator=gen).to(dtype)
             for s in sizes]
    for navg in (1, 2):
        want = [TF.sgd_update(g, navg, -0.1) for g in grads]
        outs = [torch.full_like(g, float("nan")) for g in grads]
        TF.reset_launch_counts()
        got = TF.sgd_update_multi(grads, navg, -0.1, outs=outs)
        again = TF.sgd_update_multi(grads, navg, -0.1)
        torch.cuda.synchronize()
        assert TF.LAUNCHES["sgd"] == 2
        for a, b, w in zip(got, again, want):
            assert torch.equal(a, w) and torch.equal(b, w)


def _multi_case(kind, grads, gen, navg, step):
    """One multi-leaf call of ``kind`` over ``grads`` with in-place state
    and its plain loop on copies of the same state: ``(got, want)``, each
    a list of output lists."""
    spec = TF.FusedSpec(kind, 0.1, 0.9)
    states = [[torch.randn(g.shape, device=g.device, generator=gen)
               .to(g.dtype) for g in grads] for _ in range(2)]
    states[1] = [v.abs() for v in states[1]]
    before = [[s.clone() for s in st] for st in states]
    if kind == "sgd":
        return ([TF.sgd_update_multi(grads, navg, -0.1)],
                [[TF.sgd_plain(g, navg, -0.1) for g in grads]])
    if kind == "momentum":
        got = TF.momentum_update_multi(grads, states[0], navg, 0.9, -0.1,
                                       t_outs=states[0])
        want = zip(*[TF.momentum_plain(g, t, navg, 0.9, -0.1)
                     for g, t in zip(grads, before[0])])
        return list(got), [list(w) for w in want]
    bc1, bc2 = TF.bias_corrections(spec, step)
    got = TF.adam_update_multi(grads, *states, bc1, bc2, navg, spec,
                               mu_outs=states[0], nu_outs=states[1])
    want = zip(*[TF.adam_plain(g, m, v, bc1, bc2, navg, spec)
                 for g, m, v in zip(grads, *before)])
    return list(got), [list(w) for w in want]


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_multi_leaf_update_bit_exact_against_plain(card, kind, dname):
    """B1, B2 and B3 over leaves of many sizes (one element, a ragged
    chunk, an empty leaf, several chunks, the largest ResNet-50 leaf) in
    one launch, with the state updated in place, equal their plain loop
    bit for bit; navg 1 and 2, Adam at steps 1 and 3."""
    gen = torch.Generator(device=card).manual_seed(23)
    sizes = [(1,), (4095,), (0,), (64, 64), (3, 4097), (2_359_296,), (5,)]
    grads = [torch.randn(s, device=card, generator=gen).to(DTYPES[dname])
             for s in sizes]
    for navg, step in ((1, 1), (2, 3)):
        TF.reset_launch_counts()
        got, want = _multi_case(kind, grads, gen, navg, step)
        torch.cuda.synchronize()
        assert TF.LAUNCHES[kind] == 1
        for gs, ws in zip(got, want):
            for a, b in zip(gs, ws):
                assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_multi_leaf_update_splits_past_capacity(card, kind):
    """A list longer than one launch's parameter table takes one launch
    per ``capacity`` rows (empty leaves take no row) and equals the plain
    loop."""
    gen = torch.Generator(device=card).manual_seed(29)
    cap = TF.capacity(kind)
    grads = [torch.randn(1 + i % 5000, device=card, generator=gen)
             for i in range(cap + 2)]
    grads.insert(3, torch.empty(0, device=card))
    TF.reset_launch_counts()
    got, want = _multi_case(kind, grads, gen, 2, 2)
    torch.cuda.synchronize()
    assert TF.LAUNCHES[kind] == 2
    for gs, ws in zip(got, want):
        for a, b in zip(gs, ws):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_multi_leaf_update_takes_views_off_the_grid(card, kind, dname):
    """Leaves and states one element off the 16-byte grid run the scalar
    loop, beside aligned leaves on the 16-byte one: all equal the plain
    loop."""
    gen = torch.Generator(device=card).manual_seed(31)
    grads = [torch.randn(s, device=card, generator=gen).to(DTYPES[dname])
             for s in ((4097,), (9000,), (33,), (8192,))]
    grads = [_off_grid(g) if i % 2 else g for i, g in enumerate(grads)]
    got, want = _multi_case(kind, grads, gen, 1, 1)
    torch.cuda.synchronize()
    for gs, ws in zip(got, want):
        for a, b in zip(gs, ws):
            assert torch.equal(a, b)


def test_in_place_state_update(card):
    g = torch.randn(4097, device=card)
    t = torch.randn(4097, device=card)
    u_want, t_want = TF.momentum_plain(g, t, 1, 0.9, -0.1)
    u, t2 = TF.momentum_update(g, t, 1, 0.9, -0.1, t_out=t)
    assert t2 is t
    assert torch.equal(u, u_want) and torch.equal(t, t_want)


def test_small_training_run_goes_through_the_kernel(card, monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    for k in ("HOROVOD_SIZE", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_FUSED_UPDATE", "1")
    hvd.init()
    try:
        model = ResNet(stage_sizes=[1, 1, 1, 1], block_cls=BottleneckBlock,
                       num_classes=10, num_filters=8)
        opt = hvd.DistributedOptimizer(
            hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9))
        x, y = synthetic_batch(8, 32, 10)
        TF.reset_launch_counts()
        losses = [float(train_step(model, opt, x, y)) for _ in range(3)]
        assert all(math.isfinite(v) for v in losses)
        # one launch per step over all the leaves
        assert TF.LAUNCHES["momentum"] == 3
    finally:
        hvd.shutdown()


# f32: the kernels and the plain versions differ only in the order of
# their sums (TF32 off); bf16: p and ds are rounded to bf16, so a sum
# order that moves a value across a rounding boundary moves it by one bf16
# ulp -- the JAX package's own bf16 tolerance (test_pallas_attention.py),
# and bf16 is also held to flash_attention.BF16_MAX_ABS and BF16_ROW_REL.
FLASH_TOL = {"f32": (1e-4, 1e-5), "bf16": (2e-2, 2e-2)}
# the longest KV block at which the f32 atol was read; past it B8's
# unnormalised o grows with the row's l and its f32 sums with it, so the
# atol grows in proportion (B8 o read 1.27e-5 at Lk = 1024, D = 128)
F32_ATOL_KEYS = 256


def _close(got, want, dname, what, lk=0):
    rtol, atol = FLASH_TOL[dname]
    if dname == "f32":
        atol *= max(1.0, lk / F32_ATOL_KEYS)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")
    err, row = FA.errors(got, want)
    print(f"[reading] {what}: largest error {err:.3e}, row error {row:.3e}")
    if dname == "bf16":
        assert err <= FA.BF16_MAX_ABS and row <= FA.BF16_ROW_REL, (
            f"{what}: largest error {err}, row error {row}")


def _close_state(got, want, dname, what, lk=0):
    for name, a, b in FA.state_pairs(got, want, dname == "bf16"):
        _close(a, b, dname, f"{what} {name}", lk)


@pytest.fixture()
def exact_f32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


# (bh, lq, lk, d, q_offset, k_offset): a ragged tile edge, a KV block
# after the queries, a mostly hidden block, head dims 8 to 128
FLASH_SHAPES = [(6, 200, 136, 64, 136, 0), (3, 64, 64, 128, 0, 0),
                (2, 100, 70, 40, 64, 64), (4, 128, 128, 8, 0, 96)]
# the bf16 tensor-core kernels' tile edges (128-row blocks of two 64-row
# warpgroups, 128- or 64-key tiles): L no multiple of 128 with offsets
# no multiple of 64, D = 16 and 128 over full 1024-row tiles, and more
# blocks than one wave of the card's 132 SMs; f32 runs them too
TC_SHAPES = [(2, 300, 260, 64, 40, 0), (2, 1024, 1024, 16, 0, 0),
             (2, 1024, 1024, 128, 0, 0), (160, 256, 256, 64, 0, 0)]


@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_flash_kernels_against_plain(card, exact_f32, dname, causal, shape):
    _check_flash(card, dname, causal, shape)


@pytest.mark.parametrize("shape", TC_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_flash_tile_edges_against_plain(card, exact_f32, dname, causal,
                                        shape):
    _check_flash(card, dname, causal, shape)


def _check_flash(card, dname, causal, shape):
    """B8 from a carried state, then B9 and B10 from its lse, each
    against its plain version; one launch of each."""
    bh, lq, lk, d, qo, ko = shape
    dtype = DTYPES[dname]
    gen = torch.Generator(device=card).manual_seed(lq * d)
    case = f"{dname} {'causal' if causal else 'full'} {shape}"

    def rnd(*s):
        return (torch.randn(*s, device=card, generator=gen) * 0.5).to(dtype)

    q, do = rnd(bh, lq, d), rnd(bh, lq, d)
    k, v = rnd(bh, lk, d), rnd(bh, lk, d)
    # a carried state from an earlier block (some rows still at -inf)
    k0, v0 = rnd(bh, 32, d), rnd(bh, 32, d)
    m0 = torch.full((bh, lq), -math.inf, device=card)
    z = torch.zeros((bh, lq), device=card)
    m, l, o = FA.flash_block_step_plain(q, k0, v0, m0, z,
                                        torch.zeros(bh, lq, d, device=card),
                                        qo, qo + 16, causal)
    FA.reset_launch_counts()
    got = FA.flash_block_step(q, k, v, m, l, o, qo, ko, causal=causal)
    want = FA.flash_block_step_plain(q, k, v, m, l, o, qo, ko, causal)
    _close_state(got, want, dname, f"{case} B8", lk)
    out, lse = finish(*want)
    delta = (do.float() * out).sum(-1)
    _close(FA.flash_bwd_dq(q, k, v, do, lse, delta, qo, ko, causal=causal),
           FA.flash_bwd_dq_plain(q, k, v, do, lse, delta, qo, ko, causal),
           dname, f"{case} B9 dq", lk)
    for name, a, b in zip(("dk", "dv"),
                          FA.flash_bwd_dkv(q, k, v, do, lse, delta, qo, ko,
                                           causal=causal),
                          FA.flash_bwd_dkv_plain(q, k, v, do, lse, delta, qo,
                                                 ko, causal)):
        _close(a, b, dname, f"{case} B10 {name}", lk)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"flash_block_step": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}


@pytest.mark.parametrize("d", [64, 128])
def test_flash_bf16_kernels_are_deterministic(card, d):
    """B8, B9 and B10 on the tensor cores own their output tiles (no
    atomics): two calls give the same bits."""
    gen = torch.Generator(device=card).manual_seed(d)
    q, k, v, do = (torch.randn(8, 520, d, device=card, generator=gen)
                   .bfloat16() for _ in range(4))
    m = torch.full((8, 520), -math.inf, device=card)
    l = torch.zeros(8, 520, device=card)
    o = torch.zeros(8, 520, d, device=card)
    state = FA.flash_block_step(q, k, v, m, l, o, 0, 0)
    again = FA.flash_block_step(q, k, v, m, l, o, 0, 0)
    for a, b in zip(state, again):
        assert torch.equal(a, b)
    out, lse = finish(*state)
    delta = (do.float() * out).sum(-1)
    grads = FA.flash_bwd_dkv(q, k, v, do, lse, delta, 0, 0)
    for a, b in zip(grads, FA.flash_bwd_dkv(q, k, v, do, lse, delta, 0, 0)):
        assert torch.equal(a, b)
    assert torch.equal(FA.flash_bwd_dq(q, k, v, do, lse, delta, 0, 0),
                       FA.flash_bwd_dq(q, k, v, do, lse, delta, 0, 0))


def _off_grid(t):
    """A copy of ``t`` whose base address is one element off the 16-byte
    grid."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def test_flash_refuses_unaligned_operands(card):
    """TMA needs 16-byte-aligned base addresses: a bf16 operand of B8, B9
    or B10 that starts off that grid is refused, not copied or sent
    elsewhere."""
    k = torch.zeros(2, 64, 64, device=card, dtype=torch.bfloat16)
    q = _off_grid(k)  # 2 bytes off the grid
    m = torch.full((2, 64), -math.inf, device=card)
    l = torch.zeros(2, 64, device=card)
    o = torch.zeros(2, 64, 64, device=card)
    with pytest.raises(HorovodTpuError, match="16-byte"):
        FA.flash_block_step(q, k, k, m, l, o, 0, 0)
    with pytest.raises(HorovodTpuError, match="16-byte"):
        FA.flash_bwd_dkv(q, k, k, q, l, l, 0, 0)
    with pytest.raises(HorovodTpuError, match="16-byte"):
        FA.flash_bwd_dq(k, k, k, q, l, l, 0, 0)
    # B8 reads the carried f32 o as float2
    with pytest.raises(HorovodTpuError, match="8-byte"):
        FA.flash_block_step(k, k, k, m, l, _off_grid(o), 0, 0)


def test_flash_cuda_core_kernels_take_unaligned_operands(card, exact_f32):
    """The kernels that use no TMA (f32 B8-B10) read their operands
    element by element: operands off the 16-byte grid run and agree with
    the plain versions."""
    gen = torch.Generator(device=card).manual_seed(5)
    q, k, v, do = (_off_grid(torch.randn(2, 64, 64, device=card,
                                         generator=gen) * 0.5)
                   for _ in range(4))
    fresh = (torch.full((2, 64), -math.inf, device=card),
             torch.zeros(2, 64, device=card),
             torch.zeros(2, 64, 64, device=card))
    state = FA.flash_block_step_plain(q, k, v, *fresh, 0, 0)
    out, lse = finish(*state)
    delta = (do.float() * out).sum(-1)
    args = (q, k, v, do, _off_grid(lse), _off_grid(delta), 0, 0)
    _close(FA.flash_bwd_dq(*args), FA.flash_bwd_dq_plain(*args), "f32",
           "B9 dq f32 unaligned")
    m, l, o = (_off_grid(t) for t in state)
    _close_state(FA.flash_block_step(q, k, v, m, l, o, 0, 0),
                 FA.flash_block_step_plain(q, k, v, m, l, o, 0, 0),
                 "f32", "B8 f32 unaligned")
    for name, a, b in zip(("dk", "dv"), FA.flash_bwd_dkv(*args),
                          FA.flash_bwd_dkv_plain(*args)):
        _close(a, b, "f32", f"B10 {name} f32 unaligned")


def test_flash_fully_masked_block_keeps_fresh_state(card):
    q = torch.randn(4, 512, 64, device=card).bfloat16()
    kv = torch.randn(4, 512, 64, device=card).bfloat16()
    m = torch.full((4, 512), -math.inf, device=card)
    l = torch.zeros(4, 512, device=card)
    o = torch.zeros(4, 512, 64, device=card)
    m2, l2, o2 = FA.flash_block_step(q, kv, kv, m, l, o, 0, 512)
    assert torch.equal(m2, m) and torch.equal(l2, l) and torch.equal(o2, o)


# The offsets the sequence-parallel path gives B8-B10 (chip_smoke.py phase
# 15a), at the long-context ring's chunk (12, 2048, 64) bf16 and at (8,
# 256, 64) f32: (name, q_offset, k_offset, causal, rows) with Lq = Lk =
# rows; the zigzag pairs at half a chunk.
SP_OFFSET_CASES = {
    "bf16": (12, 2048, [("visible whole", 2048, 0, True, 2048),
                        ("hidden whole", 0, 2048, True, 2048),
                        ("partial, keys ahead", 0, 1000, True, 2048),
                        ("partial, queries ahead", 1337, 0, True, 2048),
                        ("zigzag diagonal", 0, 0, True, 1024),
                        ("zigzag full", 0, 0, False, 1024)]),
    "f32": (8, 256, [("visible whole", 256, 0, True, 256),
                     ("hidden whole", 0, 256, True, 256),
                     ("partial, keys ahead", 0, 125, True, 256),
                     ("partial, queries ahead", 167, 0, True, 256),
                     ("zigzag diagonal", 0, 0, True, 128),
                     ("zigzag full", 0, 0, False, 128)]),
}


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_flash_kernels_at_sequence_parallel_offsets(card, exact_f32, dname,
                                                    case):
    """B8 from a fresh state, B9 and B10 from the lse and delta of the
    block seen whole (every row finite), each against its plain version
    at the ring's offsets; a block hidden whole leaves the fresh state and
    gives zero dQ, dK and dV exactly."""
    bh, _, cases = SP_OFFSET_CASES[dname]
    name, qo, ko, causal, rows = cases[case]
    dtype = DTYPES[dname]
    gen = torch.Generator(device=card).manual_seed(100 + case)
    q, k, v, do = (torch.randn(bh, rows, 64, device=card, generator=gen)
                   .to(dtype) for _ in range(4))
    fresh = (torch.full((bh, rows), -math.inf, device=card),
             torch.zeros(bh, rows, device=card),
             torch.zeros(bh, rows, 64, device=card))
    what = f"{dname} {name} offsets ({qo}, {ko}) causal={causal}"
    FA.reset_launch_counts()
    got = FA.flash_block_step(q, k, v, *fresh, qo, ko, causal=causal)
    _close_state(got, FA.flash_block_step_plain(q, k, v, *fresh, qo, ko,
                                                causal), dname,
                 f"{what} B8", rows)
    out, lse = finish(*FA.flash_block_step_plain(q, k, v, *fresh, 0, 0,
                                                 False))
    delta = (do.float() * out).sum(-1)
    args = (q, k, v, do, lse, delta, qo, ko)
    dq = FA.flash_bwd_dq(*args, causal=causal)
    dk, dv = FA.flash_bwd_dkv(*args, causal=causal)
    _close(dq, FA.flash_bwd_dq_plain(*args, causal), dname, f"{what} B9 dq",
           rows)
    for n, a, b in zip(("dk", "dv"), (dk, dv),
                       FA.flash_bwd_dkv_plain(*args, causal)):
        _close(a, b, dname, f"{what} B10 {n}", rows)
    if name == "hidden whole":
        assert all(torch.equal(a, b) for a, b in zip(got, fresh))
        assert not (dq.any() or dk.any() or dv.any())
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"flash_block_step": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}


def test_small_transformer_goes_through_the_kernels(card, monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.train_step import lm_train_step, synthetic_tokens

    for k in ("HOROVOD_SIZE", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_FUSED_UPDATE", "1")
    hvd.init()
    try:
        cfg = TransformerConfig(vocab=256, d_model=64, n_heads=4,
                                head_dim=16, n_layers=2, d_ff=128,
                                max_seq=128)
        model = Transformer(cfg, seed=0)
        opt = hvd.DistributedOptimizer(
            hvd.fused_update.adam(model.parameters(), 3e-4))
        tokens, targets = synthetic_tokens(2, 128, cfg.vocab, seed=1)
        FA.reset_launch_counts()
        TF.reset_launch_counts()
        losses = [float(lm_train_step(model, opt, tokens, targets))
                  for _ in range(3)]
        assert all(math.isfinite(v) for v in losses)
        assert losses[-1] < losses[0]
        assert FA.LAUNCHES == {"flash_block_step": 6, "flash_bwd_dq": 6,
                               "flash_bwd_dkv": 6}
        assert TF.LAUNCHES["adam"] == 3  # one per step
    finally:
        hvd.shutdown()


def test_four_cards_nccl_collectives():
    """The collective checks of tests/test_torch_collectives.py on four
    cards over NCCL (on a machine with four cards)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    import test_torch_collectives as C
    from _torch_collectives_worker import spawn

    outs = spawn(4, "cuda", timeout=300)
    for check in (C.check_topology, C.check_allreduce, C.check_grouped,
                  C.check_broadcasts, C.check_distributed_optimizer,
                  *C.LOSSY_CHECKS):
        check(outs, 4)


# (nblocks, block, offset): a full 256 row, the vector paths at a width
# that is no multiple of 256, the scalar paths (block 6 and 10: rows not
# a multiple of 4 or 8 wide; offset 1: a pointer off the 16-byte grid)
CODEC_SHAPES = [(1000, 256, 0), (33, 200, 0), (7, 6, 0), (5, 10, 0),
                (64, 256, 1)]


def _codec_inputs(card, nb, block, offset, qmax):
    gen = torch.Generator(device=card).manual_seed(nb * block + qmax)
    buf = torch.randn(nb * block + offset, device=card, generator=gen)
    x = buf[offset:].view(nb, block)
    s = Q.block_absmax(x) / torch.full((nb,), float(qmax), device=card)
    # an all-zero block and a block of exact .5 ties under scale 1/8
    x[0] = 0.0
    s[0] = 0.0
    k = torch.randint(-qmax, qmax, (block,), device=card, generator=gen)
    x[1] = (k.float() + 0.5) / 8
    s[1] = 0.125
    return x, s, gen


@pytest.mark.parametrize("shape", CODEC_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_codec_kernels_bit_exact_against_plain(card, shape):
    nb, block, offset = shape
    Q.reset_launch_counts()
    for qmax in (127, 63, 31):
        x, s, gen = _codec_inputs(card, nb, block, offset, qmax)
        q = Q.quantize_values(x, s, qmax)
        assert torch.equal(q, Q.quantize_plain(x, s, qmax))
        assert torch.equal(Q.dequantize_values(q, s),
                           Q.dequantize_plain(q, s))
        # int32 partial sums, negative ones included
        qs = (q.int() * 4 - 3 * qmax).contiguous()
        assert torch.equal(Q.dequantize_values(qs, s),
                           Q.dequantize_plain(qs, s))
    for qmax in (7, 3, 1):
        x, s, gen = _codec_inputs(card, nb, block, offset, qmax)
        p = Q.quantize_pack4_values(x, s, qmax)
        assert torch.equal(p, Q.quantize_pack4_plain(x, s, qmax))
        assert torch.equal(Q.unpack_dequantize4_values(p, s),
                           Q.unpack_dequantize4_plain(p, s))
        # the int8 sum of 7 // qmax ranks' packed bytes
        ranks = 7 // qmax
        grid = torch.randint(-qmax, qmax + 1, (ranks, nb, block),
                             device=card, generator=gen)
        h = block // 2
        packed = (grid[..., h:] * 16 + grid[..., :h]).to(torch.int8)
        summed = packed.sum(0, dtype=torch.int8)
        assert torch.equal(summed.long(), packed.long().sum(0))
        assert torch.equal(Q.unpack_dequantize4_values(summed, s),
                           Q.unpack_dequantize4_plain(summed, s))
    torch.cuda.synchronize()
    assert Q.LAUNCHES == {"quantize": 3, "dequantize": 6, "pack4": 3,
                          "unpack4": 6}


def test_four_cards_lossy_resnet50():
    """ResNet-50 at full width, batch 256 per card, fused momentum SGD
    with the int8 and then the int4 wire and error feedback, 3 steps on
    four cards: one B4 and two B5 (int4: one B6, two B7) per step on every
    rank, finite losses, and the reduced gradient identical bit for bit
    on every rank."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import math
    import os
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import spawn

    outs = spawn(4, "cuda", timeout=900, mode="resnet")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    one = {"int8": {"quantize": 1, "dequantize": 2, "pack4": 0,
                    "unpack4": 0, "momentum": 1},
           "int4": {"quantize": 0, "dequantize": 0, "pack4": 1,
                    "unpack4": 2, "momentum": 1}}
    for mode, want in one.items():
        for o in outs:
            r = o[mode]
            assert r["launches"] == [want] * 3, (mode, r["launches"])
            assert all(math.isfinite(v) for v in r["losses"])
        assert len({o[mode]["grad_digest"] for o in outs}) == 1
        steady = sorted(o[mode]["times"][-1] for o in outs)
        print(f"[four cards] ResNet-50 {mode} + EF, batch 256 per card: "
              f"losses {outs[0][mode]['losses']}, step times rank 0 "
              f"{outs[0][mode]['times']} s, last step over ranks "
              f"{steady[0]:.4f}-{steady[-1]:.4f} s; on 4 x {card.strip()}")


def test_four_cards_zero_resnet50():
    """ResNet-50 at full width, batch 256 per card, fused momentum SGD, 4
    steps from the same seeded weights at stage 0, stage 0 + overlap,
    stages 1, 2 and 3, and stage 2 + overlap + int8 + error feedback, on
    four cards: finite losses; per step one B1 launch, 53 of each of
    N1-N4, and under int8 one B4 and two B5 per bucket; at stages 1 and 2
    the weights identical bit for bit on every rank after each step;
    stage 3's gathered weights within rtol 2e-5, atol 1e-7 of stage 1's
    after one step; stage 1's optimizer state a quarter of stage 0's.
    Prints each configuration's median step time (steps 2-4 of two
    passes, the second in reverse order, after a warm-up), per-rank peak
    memory and optimizer-state bytes."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import os
    import statistics
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import (ZERO_RESNET, ZERO_RESNET_STEPS,
                                           spawn)

    outs = spawn(4, "cuda", timeout=900, mode="zero_resnet")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    buckets = 4  # HOROVOD_ZERO_PREFETCH_CHUNKS
    for name, stage, _, comp in ZERO_RESNET:
        want = {"quantize": 0, "dequantize": 0, "pack4": 0, "unpack4": 0,
                "bn_stats": 53, "bn_normalize": 53, "bn_bwd_reduce": 53,
                "bn_bwd_dx": 53, "momentum": 1}
        if comp == "int8":
            want.update(quantize=buckets, dequantize=2 * buckets)
        for o in outs:
            r = o[name]
            assert r["launches"] == [want] * ZERO_RESNET_STEPS, \
                (name, r["launches"])
            assert all(math.isfinite(v) for v in r["losses"]), name
        if stage in (1, 2):
            for step in range(ZERO_RESNET_STEPS):
                assert len({o[name]["digests"][step] for o in outs}) == 1, \
                    (name, step)
        med = [statistics.median(o[name]["times"][1:] + o[name]["times2"][1:])
               for o in outs]
        print(f"[four cards] ResNet-50 {name}, batch 256 per card: losses "
              f"{outs[0][name]['losses']}, median step {min(med):.4f}-"
              f"{max(med):.4f} s over ranks (rank 0's steps "
              f"{outs[0][name]['times']} then {outs[0][name]['times2']} s), "
              f"peak "
              f"{[o[name]['peak_bytes'] for o in outs]} B (rank 0: forward "
              f"and backward {outs[0][name]['peak_fwd_bwd']} B, optimizer "
              f"step {outs[0][name]['peak_step']} B from "
              f"{outs[0][name]['resident_step']} B allocated as it begins), "
              f"optimizer state "
              f"{[o[name]['state_bytes'] for o in outs]} B per rank; on "
              f"4 x {card.strip()}")
    for o in outs:
        assert o["stage3_close"], o["stage3_vs_stage1"]
        assert o["stage 0"]["state_bytes"] == 102_228_128
        assert o["stage 1"]["state_bytes"] == 25_557_032
        assert o["stage 2"]["state_bytes"] == 25_557_032
        assert o["stage 3"]["state_bytes"] == 25_557_032


def test_four_cards_sequence_parallel_lm(tmp_path):
    """The LM at full width (vocab 32768, d_model 768, 12 x 64 heads, 12
    layers, d_ff 3072, bf16, fused Adam 3e-4), 3 steps over NCCL: the
    long-context config (seq 8192, batch 1) at sp = 4 and the bench config
    (seq 1024, batch 16) at dp = 2 x sp = 2, each against one card's sp =
    1 run (its own process, world 1) of the same global batch and seeded
    weights: global losses within rtol 2e-2 (``tests/test_transformer.py``'s
    layout tolerance);
    the world-averaged gradient of step 1 within a relative L2 error of
    0.1 of one card's (a world-size factor of 2 reads 0.5 or 1: Adam's
    normalised step would hide it in the weights); the same weights bit
    for bit on every rank after each step; per step on sequence rank s
    12 (s + 1) launches of each of B8, B9 and B10 (the contiguous ring
    skips the blocks the mask hides whole) and one of B3.  Then the
    contiguous ring, the zigzag ring and Ulysses at (1, 8192, 12, 64)
    bf16, causal, over the sp = 4 group against the one-call kernels,
    launches as planned.  Prints the median step, tokens/s per card,
    per-rank peak memory and per-rank attention time."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import os
    import statistics
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import SP_CARD_ATTN, SP_CARD_CONFIGS, spawn

    from horovod_tpu_torch.parallel.ring_attention import blockwise_plan

    env = {"HVD_TEST_REF_DIR": str(tmp_path)}
    ref_all = spawn(1, "cuda", timeout=600, mode="sp_cards_ref",
                    env_extra=env)[0]
    outs = spawn(4, "cuda", timeout=900, mode="sp_cards", env_extra=env)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    for name, seq, batch, dp, sp in SP_CARD_CONFIGS:
        ref = ref_all[name]
        assert ref["launches"] == [dict.fromkeys(
            ("flash_block_step", "flash_bwd_dq", "flash_bwd_dkv"), 12)
            | {"adam": 1}] * len(ref["launches"]), ref["launches"]
        for o in outs:
            r = o[name]
            s = r["place"][1]
            want = {"flash_block_step": 12 * (s + 1),
                    "flash_bwd_dq": 12 * (s + 1),
                    "flash_bwd_dkv": 12 * (s + 1), "adam": 1}
            assert r["launches"] == [want] * len(r["launches"]), \
                (name, o["rank"], r["launches"])
            assert all(math.isfinite(v) for v in r["losses"])
            np.testing.assert_allclose(r["losses"], ref["losses"], rtol=2e-2)
        for step in range(len(ref["losses"])):
            assert len({o[name]["digests"][step] for o in outs}) == 1, \
                (name, step)
        err = outs[0][name]["grad_rel_err"]
        assert err < 0.1, (name, err)
        med = [statistics.median(o[name]["times"][1:]) for o in outs]
        one = statistics.median(ref["times"][1:])
        print(f"[four cards] LM {name} (seq {seq}, global batch {batch}, dp "
              f"{dp} x sp {sp}): losses {outs[0][name]['losses']} (one card "
              f"{ref['losses']}); step-1 gradient relative L2 error "
              f"{err:.3e}; median step "
              f"{min(med):.4f}-{max(med):.4f} s over ranks = "
              f"{batch * seq / max(med) / 4:.1f} tokens/s per card (one card "
              f"{one:.4f} s = {batch * seq / one:.1f} tokens/s); rank 0 steps "
              f"{outs[0][name]['times']} s; peak "
              f"{[o[name]['peak_bytes'] for o in outs]} B per rank (one card "
              f"{ref['peak_bytes']} B); launches per step "
              f"{[o[name]['launches'][0] for o in outs]}; on "
              f"4 x {card.strip()}")
    sp = SP_CARD_CONFIGS[0][4]
    blocks = len(blockwise_plan(SP_CARD_ATTN[1])[0])
    planned = {"contiguous": lambda s: s + 1, "zigzag": lambda s: 2 * sp + 1,
               "ulysses": lambda s: blocks}
    for layout, count in planned.items():
        for o in outs:
            a = o["attention"][layout]
            s = o["long-context sp4"]["place"][1]
            assert a["launches"] == dict.fromkeys(
                ("flash_block_step", "flash_bwd_dq", "flash_bwd_dkv"),
                count(s)), (layout, o["rank"], a["launches"])
            for what, (err, row) in a["errors"].items():
                assert row <= FA.BF16_ROW_REL, (layout, what, err, row)
        print(f"[four cards] attention {SP_CARD_ATTN} bf16 causal, "
              f"{layout} over sp = {sp} (NCCL), forward + backward: ms per "
              f"rank {[o['attention'][layout]['ms'] for o in outs]}; "
              f"largest (abs, row) errors against the one-call kernels "
              f"{outs[0]['attention'][layout]['errors']}; on "
              f"4 x {card.strip()}")


def _npz_tree(path: str):
    """A tree saved by ``_torch_collectives_worker._save_tree`` and its
    coordinate (``{axis: (index, size)}`` or ``None``)."""
    with np.load(path) as z:
        tree, coord = {}, None
        for k in z.files:
            if k == "coord":
                coord = {a: tuple(int(x) for x in v) for a, v in
                         zip(("dp", "pp", "tp", "sp"), z[k])}
                continue
            d = tree
            *head, leaf = k.split("/")
            for h in head:
                d = d.setdefault(h, {})
            d[leaf] = z[k]
    return tree, coord


def _flat(tree) -> np.ndarray:
    return np.concatenate([
        _flat(tree[k]) if isinstance(tree[k], dict)
        else np.asarray(tree[k], np.float64).reshape(-1)
        for k in sorted(tree)])


def test_four_cards_model_parallel_lm(tmp_path):
    """The bench LM (vocab 32768, d_model 768, 12 x 64 heads, 12 layers,
    d_ff 3072, seq 1024, global batch 16, bf16, fused Adam 3e-4), 3 steps
    over NCCL on four cards, the world re-initialized per case:
    (1) the LM without a mesh on ``sequence_groups(2, 2)`` with the
    world average;
    (2) ``HOROVOD_MESH=dp:2,sp:2``, the model on the data mesh and
    ``lm_optimizer`` (the ``("dp", "sp")`` sum): losses and the step-1
    gradient bit for bit equal to (1)'s, the weights bit for bit on every
    rank; (3) ``HOROVOD_MESH=dp:2,tp:2``: against one card at tp = 1 whose
    ``wqkv`` is ``tp_equivalent_wqkv`` of the same weights (losses within
    rtol 1e-3, the step-1 gradient joined from every rank's shards within
    0.1 relative L2), each tp column's weights bit for bit over dp; (4)
    ``HOROVOD_MESH=dp:4`` with a Switch-MoE MLP every second layer (8
    experts, 2 per card): losses finite and equal on every rank, the
    replicated weights bit for bit.  Launches per step: 12 (s + 1) of
    each of B8-B10 on sequence rank s, 12 under tp and ep; one B3 per
    reduction group (two with MoE).  Prints the median step, tokens/s per
    card and per-rank peak memory."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import os
    import statistics
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import (MP_CARD_BATCH, MP_CARD_CASES,
                                           MP_CARD_SEQ, SP_CARD_LM, spawn)

    from horovod_tpu_torch.models import transformer as TT

    env = {"HVD_TEST_REF_DIR": str(tmp_path)}
    ref = spawn(1, "cuda", timeout=600, mode="mp_cards_ref",
                env_extra=env)[0]
    outs = spawn(4, "cuda", timeout=1200, mode="mp_cards", env_extra=env)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    names = [c[0] for c in MP_CARD_CASES]
    flash = ("flash_block_step", "flash_bwd_dq", "flash_bwd_dkv")
    cfg = TT.TransformerConfig(**SP_CARD_LM, max_seq=MP_CARD_SEQ)

    def grads(i):
        """Case ``i``'s step-1 gradient (rank 0's where nothing is
        sharded, else joined from every rank's shards)."""
        parts = [_npz_tree(str(tmp_path / f"{i}_{r}.npz")) for r in range(4)]
        if MP_CARD_CASES[i][1] != "dp:2,tp:2":
            return _flat(parts[0][0])
        full = TT.unshard_params([(c, t) for t, c in parts], cfg)
        full["layers"]["wqkv"] = TT.tp_equivalent_wqkv(
            full["layers"]["wqkv"], 2)
        return _flat(full)

    for i, (name, spec, moe) in enumerate(MP_CARD_CASES):
        for o in outs:
            r = o[name]
            s = r["coord"]["sp"][0]
            want = dict.fromkeys(flash, 12 * (s + 1)) | {
                "adam": 2 if moe else 1}
            assert r["launches"] == [want] * len(r["launches"]), \
                (name, o["rank"], r["launches"])
            assert all(math.isfinite(v) for v in r["losses"]), name
            assert r["losses"] == outs[0][name]["losses"], name
        for step in range(len(outs[0][name]["losses"])):
            by_col = {}
            for o in outs:
                by_col.setdefault(o[name]["coord"]["tp"][0], set()).add(
                    o[name]["digests"][step])
            assert all(len(v) == 1 for v in by_col.values()), (name, step)
    base, base_grad = outs[0][names[0]], grads(0)
    # the ("dp", "sp") sum of the loss over the global token count is the
    # world average of the local mean scaled by a power of two: the same
    # bits
    assert outs[0][names[1]]["losses"] == base["losses"]
    np.testing.assert_array_equal(grads(1), base_grad)
    rel = {names[1]: 0.0}
    ref_grad = _flat(_npz_tree(str(tmp_path / "ref_tp1.npz"))[0])
    np.testing.assert_allclose(outs[0][names[2]]["losses"], ref["losses"],
                               rtol=1e-3)
    g = grads(2)
    rel[names[2]] = float(np.linalg.norm(g - ref_grad)
                          / np.linalg.norm(ref_grad))
    assert rel[names[2]] < 0.1, rel[names[2]]
    against = {names[1]: "the sequence_groups run",
               names[2]: "one card at tp = 1"}
    for name in names:
        med = [statistics.median(o[name]["times"][1:]) for o in outs]
        print(f"[four cards] LM {name} (seq {MP_CARD_SEQ}, global batch "
              f"{MP_CARD_BATCH}): losses {outs[0][name]['losses']}"
              + (f"; step-1 gradient relative L2 {rel[name]:.3e} from "
                 f"{against[name]}" if name in rel else "")
              + f"; median step {min(med):.4f}-{max(med):.4f} s over ranks "
              f"= {MP_CARD_BATCH * MP_CARD_SEQ / max(med) / 4:.1f} tokens/s "
              f"per card; rank 0 steps {outs[0][name]['times']} s; peak "
              f"{[o[name]['peak_bytes'] for o in outs]} B per rank; "
              f"launches per step {outs[0][name]['launches'][0]}; on "
              f"4 x {card.strip()}")
    one = statistics.median(ref["times"][1:])
    print(f"[four cards] one card at tp = 1 (tp-equivalent wqkv): losses "
          f"{ref['losses']}; median step {one:.4f} s = "
          f"{MP_CARD_BATCH * MP_CARD_SEQ / one:.1f} tokens/s; peak "
          f"{ref['peak_bytes']} B; on {card.strip()}")


def test_four_cards_pipeline_lm(tmp_path):
    """The bench LM (vocab 32768, d_model 768, 12 x 64 heads, 12 layers,
    d_ff 3072, seq 1024, global batch 16, bf16, fused Adam 3e-4), 3 steps
    over NCCL on four cards, one ``make_mesh`` per case: (1) dp 2 x pp 2,
    GPipe, 2 microbatches; (2) pp 4, the interleaved schedule with
    ``pp_virtual=3`` and 4 microbatches; (3) pp 2 x sp 2, GPipe, beside
    the KV ring.  Each against one card at pp = 1 (phase 18a's bounds):
    the step-1 loss of every rank within rtol 1e-3, and the step-1 layer
    gradient joined from every rank's shards (storage order) within 0.1
    relative L2 of pp times pp = 1's, the reference's factor.  Launches
    per rank per step: 12 (s + 1) of each of B8-B10 on sequence rank s,
    one B3.  Prints the step time per rank, tokens/s per card and the
    peak memory per rank."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import os
    import statistics
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import (PP_CARD_BATCH, PP_CARD_CASES,
                                           PP_CARD_SEQ, SP_CARD_LM, spawn)

    from horovod_tpu_torch.models import transformer as TT

    env = {"HVD_TEST_REF_DIR": str(tmp_path)}
    ref = spawn(1, "cuda", timeout=600, mode="pp_cards_ref",
                env_extra=env)[0]
    outs = spawn(4, "cuda", timeout=1200, mode="pp_cards", env_extra=env)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    flash = ("flash_block_step", "flash_bwd_dq", "flash_bwd_dkv")
    ref_tree = _npz_tree(str(tmp_path / "ref_pp1.npz"))[0]
    one = statistics.median(ref["times"][1:])
    for i, (name, axes, fields) in enumerate(PP_CARD_CASES):
        cfg = TT.TransformerConfig(**SP_CARD_LM, max_seq=PP_CARD_SEQ,
                                   **fields)
        pp = axes["pp"]
        for o in outs:
            r = o[name]
            s = r["coord"]["sp"][0]
            want = dict.fromkeys(flash, 12 * (s + 1)) | {"adam": 1}
            assert r["launches"] == [want] * len(r["launches"]), \
                (name, o["rank"], r["launches"])
            assert all(math.isfinite(v) for v in r["losses"]), name
            np.testing.assert_allclose(r["losses"][0], ref["losses"][0],
                                       rtol=1e-3, err_msg=name)
        parts = [_npz_tree(str(tmp_path / f"pp{i}_{k}.npz"))
                 for k in range(4)]
        full = TT.unshard_params([(c, t) for t, c in parts], cfg)
        want = TT.storage_order(ref_tree, cfg, pp)
        g, w = _flat(full["layers"]), pp * _flat(want["layers"])
        rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        assert rel < 0.1, (name, rel)
        med = [statistics.median(o[name]["times"][1:]) for o in outs]
        print(f"[four cards] LM {name} (seq {PP_CARD_SEQ}, global batch "
              f"{PP_CARD_BATCH}, {cfg.pp_microbatches} microbatches): "
              f"losses per rank {[o[name]['losses'] for o in outs]}; "
              f"step-1 layer gradient {rel:.3e} relative L2 from {pp} x "
              f"pp = 1's; median step per rank {med} s = "
              f"{PP_CARD_BATCH * PP_CARD_SEQ / max(med) / 4:.1f} tokens/s "
              f"per card; rank 0 steps {outs[0][name]['times']} s; peak "
              f"{[o[name]['peak_bytes'] for o in outs]} B per rank; "
              f"launches per step per rank "
              f"{[o[name]['launches'][0] for o in outs]}; on "
              f"4 x {card.strip()}")
    print(f"[four cards] one card at pp = 1: losses {ref['losses']}; "
          f"median step {one:.4f} s = "
          f"{PP_CARD_BATCH * PP_CARD_SEQ / one:.1f} tokens/s; peak "
          f"{ref['peak_bytes']} B; on {card.strip()}")


def test_four_cards_data_plane():
    """ResNet-50 at full width (224 px, batch 256 per card, bf16, fused
    momentum SGD), 3 steps per case on four cards, deterministic cuDNN:
    (1) ``HOROVOD_MESH=dp:4`` with ``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` and
    ``HOROVOD_HIERARCHICAL_LOCAL_SIZE=2``: the default axis is the (dpc,
    dpl) pair, the weights identical on every rank, step 1's reduced
    gradient within a relative L2 error of 1e-5 of the flat world's (the
    summation order only); (2) the same with int8 and int4 and error
    feedback at stages 0 and 2: identical weights on every rank, from a
    recording wrapper around ``torch.distributed`` the lossy payload on
    the cross groups only and every local transfer float32, B4-B7 launch
    counts exact; (3) ``op=Adasum`` flat over 4 and hierarchical over the
    pair: identical weights on every rank; (4) ``HOROVOD_MESH=dp:2,tp:2``:
    dp groups {0, 2} and {1, 3}, the tp columns' weights bit for bit
    equal, and equal to a two-rank flat run's on the same data.  Prints
    median step times and peak memory per case.  The four cards share
    one host's NVLink: the (cross, local) split proves correctness on
    NCCL, not the speed of a slower cross link."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import os
    import statistics
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import DP_CARD_CASES, DP_CARD_STEPS, spawn

    from horovod_tpu_torch.common.util import free_port

    coords = ",".join(f"127.0.0.1:{free_port()}" for _ in range(2))
    outs = spawn(4, "cuda", timeout=900, mode="dp_cards",
                 env_extra={"HVD_TEST_COORDS": coords})
    two = spawn(2, "cuda", timeout=600, mode="dp_cards")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    bn = dict.fromkeys(("bn_stats", "bn_normalize", "bn_bwd_reduce",
                        "bn_bwd_dx"), 53)
    for name, mesh, hier, stage, comp, op in DP_CARD_CASES:
        per = 4 if stage == 2 else 1        # HOROVOD_ZERO_PREFETCH_CHUNKS
        want = {"quantize": 0, "dequantize": 0, "pack4": 0, "unpack4": 0,
                "momentum": 1, **bn}
        if comp == "int8":
            want.update(quantize=per, dequantize=2 * per)
        if comp == "int4":
            want.update(pack4=per, unpack4=2 * per)
        for o in outs:
            r = o[name]
            assert r["launches"] == [want] * DP_CARD_STEPS, \
                (name, o["rank"], r["launches"])
            assert all(math.isfinite(v) for v in r["losses"]), name
        for step in range(DP_CARD_STEPS):
            assert len({o[name]["digests"][step] for o in outs}) == 1, \
                (name, step)
        if mesh == "dp:4":
            for o in outs:
                rank = o["rank"]
                c, l_ = divmod(rank, 2)
                assert o[name]["axis"] == "('dpc', 'dpl')"
                assert o[name]["hops"] == {"cross": [l_, 2 + l_],
                                           "local": [2 * c, 2 * c + 1],
                                           "flat": [0, 1, 2, 3]}
                if comp != "none":
                    for call, dtype, ranks in o[name]["calls"]:
                        if list(ranks) == [2 * c, 2 * c + 1]:
                            assert dtype == "torch.float32", \
                                (name, call, dtype)
                        elif dtype != "torch.float32":
                            assert dtype == "torch.int8" \
                                and list(ranks) == [l_, 2 + l_], \
                                (name, call, dtype, ranks)
                    assert any(x[1] == "torch.int8" for x in
                               o[name]["calls"]), name
        med = [statistics.median(o[name]["times"][1:]) for o in outs]
        print(f"[four cards] data plane: ResNet-50 {name}, batch 256 per "
              f"card: losses {outs[0][name]['losses']}, median step "
              f"{min(med):.4f}-{max(med):.4f} s over ranks (rank 0's steps "
              f"{outs[0][name]['times']} s), peak "
              f"{[o[name]['peak_bytes'] for o in outs]} B per rank; "
              f"launches per step {outs[0][name]['launches'][0]}; on "
              f"4 x {card.strip()}")
    for o in outs:
        assert o["hier"]["grad_rel_err"] <= 1e-5, o["hier"]["grad_rel_err"]
        assert o["dp2 x tp2"]["hops"] == [o["rank"] % 2, 2 + o["rank"] % 2]
        assert o["dp2 x tp2"]["digests"] == \
            two[o["rank"] // 2]["flat2"]["digests"], o["rank"]
    print(f"[four cards] data plane: step 1's reduced gradient, two-level "
          f"against flat: relative L2 error "
          f"{[o['hier']['grad_rel_err'] for o in outs]}, largest element "
          f"difference over the largest magnitude "
          f"{[o['hier']['grad_max_rel'] for o in outs]}; two-rank flat run "
          f"median step {statistics.median(two[0]['flat2']['times'][1:]):.4f}"
          f" s; on 4 x {card.strip()}")


ITEMSIZE = {"torch.float32": 4, "torch.bfloat16": 2, "torch.int8": 1}


def _bytes_on(calls, ranks) -> int:
    """Payload bytes of the recorded transfers over the group ``ranks``."""
    return sum(n * ITEMSIZE[dt] for _, dt, n, rk in calls if rk == ranks)


def test_four_cards_local_sgd_resnet50():
    """The bench step under local SGD on four cards: ResNet-50 at full
    width (224 px, batch 256 per card, bf16, fused momentum SGD),
    ``HOROVOD_MESH=dp:4`` with ``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` and
    ``HOROVOD_HIERARCHICAL_LOCAL_SIZE=2`` (cross 2 x local 2), 6 steps at
    H = 2, deterministic cuDNN: H = 1 equal bit for bit to the
    synchronous two-level ``DistributedOptimizer``; stage 0 on the none
    wire, stage 0 and stage 2 on int8 with error feedback: from a
    recording wrapper around ``torch.distributed`` no transfer on a cross
    group during the inner steps and one cross reduction per dtype group
    per sync (none: one float32 ``all_reduce`` of the fused delta or its
    local shard; int8: the scales' ``max`` and one int8 payload), a
    slice's ranks identical after every step and all four after every
    sync, one B1 per step and one B4 and two B5 per int8 sync, finite
    losses.  Prints the median inner step and sync, the synchronous step
    on the same wire, the cross bytes per rank per H steps of both, and
    the peak memory per rank."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import os
    import statistics
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import spawn
    from _torch_local_sgd_worker import LS_CARD_CASES, LS_CARD_H, \
        LS_CARD_STEPS

    outs = spawn(4, "cuda", timeout=1500, mode="ls_cards")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    n = 25_557_032
    for name, h, stage, comp in LS_CARD_CASES:
        sync_key = f"sync {stage} {comp}"
        for o in outs:
            c, l_ = divmod(o["rank"], 2)
            cross, local = [l_, 2 + l_], [2 * c, 2 * c + 1]
            assert (o["cross"], o["local"]) == (cross, local)
            r = o[name]
            assert all(math.isfinite(v) for v in r["losses"]), name
            if h == 1:
                assert r["digests"] == o[sync_key]["digests"], o["rank"]
                assert not r["sync_s"]
                continue
            shard = n // 2 if stage else n
            nb = -(-shard // 256)
            for step, calls in enumerate(r["calls"], 1):
                assert calls and all(x[3] == local for x in calls), \
                    (name, step)
                want = {"momentum": 1, "quantize": 0, "dequantize": 0,
                        "pack4": 0, "unpack4": 0}
                if comp == "int8" and step % h == 0:
                    want.update(quantize=1, dequantize=2)
                assert r["launches"][step - 1] == want, (name, step)
            assert len(r["sync_calls"]) == LS_CARD_STEPS // h
            for calls in r["sync_calls"]:
                on_cross = [x[:3] for x in calls if x[3] == cross]
                if comp == "none":
                    assert on_cross == [["all_reduce", "torch.float32",
                                         shard]], name
                else:
                    assert on_cross == [
                        ["all_reduce", "torch.float32", nb],
                        ["all_reduce", "torch.int8", nb * 256]], name
                rest = [x for x in calls if x[3] != cross]
                assert all(x[3] == local for x in rest), name
                assert len(rest) == (1 if stage else 0), name
        for step in range(LS_CARD_STEPS):
            for c in range(2):
                assert outs[2 * c][name]["digests"][step] == \
                    outs[2 * c + 1][name]["digests"][step], (name, step)
            if h > 1 and (step + 1) % h == 0:
                assert len({o[name]["digests"][step] for o in outs}) == 1, \
                    (name, step)
        if h == 1:
            continue
        inner = [o[name]["median_inner_s"] for o in outs]
        sync = [o[name]["median_sync_s"] for o in outs]
        syn = [o[sync_key]["median_inner_s"] for o in outs]
        o0 = outs[0]
        cross0 = [0, 2]
        ls_bytes = sum(_bytes_on(x, cross0)
                       for x in o0[name]["calls"][:h]) + \
            _bytes_on(o0[name]["sync_calls"][0], cross0)
        sync_bytes = sum(_bytes_on(x, cross0)
                         for x in o0[sync_key]["calls"][:h])
        print(f"[four cards] local SGD {name}: ResNet-50 batch 256 per "
              f"card, H = {h}: losses {o0[name]['losses']}; median inner "
              f"step {min(inner):.4f}-{max(inner):.4f} s, sync "
              f"{min(sync):.4f}-{max(sync):.4f} s over ranks; synchronous "
              f"two-level DistributedOptimizer on the same wire "
              f"{min(syn):.4f}-{max(syn):.4f} s per step; cross bytes per "
              f"rank per {h} steps {ls_bytes} (synchronous {sync_bytes}); "
              f"peak {[o[name]['peak_bytes'] for o in outs]} B per rank "
              f"(synchronous {[o[sync_key]['peak_bytes'] for o in outs]}); "
              f"outer state {o0[name]['outer_bytes']} B, optimizer state "
              f"{o0[name]['state_bytes']} B per rank; on 4 x {card.strip()}")
    per_h = statistics.median(
        [o["stage 0 none"]["median_inner_s"] * LS_CARD_H
         + o["stage 0 none"]["median_sync_s"] for o in outs])
    print(f"[four cards] local SGD: stage 0 none, {LS_CARD_H} inner steps "
          f"and one sync {per_h:.4f} s against {LS_CARD_H} synchronous "
          f"steps "
          f"{LS_CARD_H * statistics.median([o['sync 0 none']['median_inner_s'] for o in outs]):.4f}"
          f" s (median over ranks); on 4 x {card.strip()}")


def test_four_cards_eager_frontend_resnet50():
    """The eager plane on four cards: ResNet-50 at full width (224 px,
    batch 256 per card, bf16) trained 6 steps by the frontend's
    hook-driven ``horovod_tpu_torch.torch.DistributedOptimizer(
    torch.optim.SGD(0.1, momentum=0.9))`` over NCCL on the none and the
    int8 wire (``HOROVOD_COMPRESSION``), beside the in-trace
    ``DistributedOptimizer`` (stage 0, the same SGD, the none wire) on the
    same batches, deterministic cuDNN: on the none wire the step-1
    weights within 1e-6 relative L2 of the in-trace run's (NCCL's sum
    order moves with the fusion; the int8 wire's distance is printed),
    every rank identical after every step, finite losses; no B4
    or B5 on the none wire and one B4 and one B5 per fused float response
    on the int8 wire; join with uneven work on the cards returns the
    last rank and its sums see the joined ranks' zeros.  Prints per rank
    the median step, rounds, fast rounds and responses per step, B4/B5
    launches per step and the peak memory, beside the in-trace step."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import os
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import spawn
    from _torch_eager_worker import CARD_CASES, CARD_STEPS, JOIN_EXTRA

    outs = spawn(4, "cuda", timeout=900, mode="eager_cards")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    for case, wire in CARD_CASES:
        for step in range(CARD_STEPS):
            assert len({o[case]["digests"][step] for o in outs}) == 1, \
                (case, step)
        for o in outs:
            r = o[case]
            assert all(math.isfinite(v) for v in r["losses"]), case
            if case == "eager none":
                assert r["step1_rel_l2"] <= 1e-6, r["step1_rel_l2"]
            if case != "intrace":
                for step, launches in enumerate(r["launches"]):
                    n = r["responses"][step]
                    if wire == "none":
                        assert launches == {"quantize": 0,
                                            "dequantize": 0}, case
                    else:
                        # one per fused float response: every response
                        # of this step is one, none is an error or join
                        assert launches == {"quantize": n,
                                            "dequantize": n}, (case, step)
            print(f"[four cards] {case}: rank {o['rank']} median step "
                  f"{r['median_step_s']:.4f} s (in-trace "
                  f"{o['intrace']['median_step_s']:.4f} s); peak "
                  f"{r['peak_bytes']} B (in-trace "
                  f"{o['intrace']['peak_bytes']} B)"
                  + ("" if case == "intrace" else
                     f"; step-1 weights {r['step1_rel_l2']:.3e} relative "
                     f"L2 from the in-trace run; rounds per step "
                     f"{r['rounds']}, fast rounds {r['fast_rounds']}, "
                     f"responses {r['responses']}, explicit requests "
                     f"{r['explicit']}, B4/B5 per step {r['launches']}, "
                     f"median round {r['round_ms']:.3f} ms")
                  + f"; losses {r['losses']}; on 4 x {card.strip()}")
    for o in outs:
        assert o["join"]["join"] == 3, o["rank"]
        assert o["join"]["extra"] == ([0.0] * JOIN_EXTRA if o["rank"] == 3
                                      else []), o["rank"]


def test_four_cards_eager_zero_local_sgd_resnet50():
    """The training paths on the eager plane on four cards: the bench
    ResNet-50 step (224 px, batch 256 per card, bf16, fused momentum SGD,
    deterministic cuDNN) under ``DistributedOptimizer(..., eager=True)``
    at stages 2 and 3 on the none and int8 wires, each beside the
    in-trace stage in the same call; local SGD (H = 2, (cross 2, local
    2)) in its eager regime under ``HOROVOD_LOCAL_SIZE=2`` beside the
    in-trace ``LocalSGD`` over the ``(dpc, dpl)`` pair; then, in a second
    world at ``HOROVOD_HEARTBEAT_INTERVAL=0.2`` /
    ``_TIMEOUT_SECONDS=2``, rank 3 SIGKILLed after step 3 of the eager
    stage 2 and ranks 0-2 raising ``RanksDownError`` naming ``[3]``
    within the timeout plus 5 s.  Every rank the same weights after the
    last step (an outer sync under local SGD); on the
    none wire the step-1 weights within 1e-6 relative L2 of the in-trace
    run's; one B1 per step; on int8 one B4 and one B5 per reduce-scatter
    response (the stage's buckets), none on the none wire.  Eager stage
    2 on the none wire runs once more with the eager plane's rounds
    through the pure-Python codec.  Prints per case and rank the
    median, least and most of the 10 steps after two of warm-up (local
    SGD: the inner and the sync steps apart), B1/B4/B5 per step, peak
    memory, optimizer-state bytes per rank, the step-1 distance and the
    median round of the case; then per case the spread over ranks."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import os
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import spawn
    from _torch_eager_training_worker import (CARD_CASES, HB_CARD,
                                              KILL_AFTER, spawn_kill)

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    outs = spawn(4, "cuda", timeout=1200, mode="eager_training_cards")
    chunks = 4                       # HOROVOD_ZERO_PREFETCH_CHUNKS
    cases = [(c, rg, st, w) for c, rg, st, w in CARD_CASES] + [
        ("ls intrace", "intrace", 0, "none"), ("ls eager", "eager", 0,
                                               "none")]
    for case, regime, stage, wire in cases:
        assert len({o[case]["digest"] for o in outs}) == 1, case
        for o in outs:
            r = o[case]
            assert all(math.isfinite(v) for v in r["losses"]), case
            for step in r["launches"]:
                assert step["B1"] == 1, (case, r["launches"])
                want = chunks if wire == "int8" else 0
                assert step["B4"] == step["B5"] == want, (case, step)
            if wire == "none":
                assert r["step1_rel_l2"] <= 1e-6, (case, r["step1_rel_l2"])
            if case == "ls eager":
                assert r["eager"], o["rank"]
            split = (f" (inner {r['median_inner_s']:.4f} s, sync "
                     f"{r['median_sync_s']:.4f} s)"
                     if "median_sync_s" in r else "")
            print(f"[four cards] {case}: rank {o['rank']} step median "
                  f"{r['median_step_s']:.4f} s, least "
                  f"{r['min_step_s']:.4f} s, most {r['max_step_s']:.4f} s"
                  f"{split}; B1/B4/B5 per step {r['launches']}; peak "
                  f"{r['peak_bytes']} B; optimizer state "
                  f"{r['state_bytes']} B per rank; step-1 weights "
                  f"{r['step1_rel_l2']:.3e} relative L2 from the in-trace "
                  f"run; median round {r['round_ms']} ms over "
                  f"{r['rounds']} rounds; step times {r['step_s']}; losses "
                  f"{r['losses']}; on 4 x {card.strip()}")
        meds = [o[case]["median_step_s"] for o in outs]
        rounds = [o[case]["round_ms"] for o in outs]
        print(f"[four cards] {case}: over ranks, step medians "
              f"{min(meds):.4f}-{max(meds):.4f} s, every timed step "
              f"{min(o[case]['min_step_s'] for o in outs):.4f}-"
              f"{max(o[case]['max_step_s'] for o in outs):.4f} s, median "
              f"rounds {rounds} ms; on 4 x {card.strip()}")
    old = {k: os.environ.get(k) for k in HB_CARD}
    os.environ.update(HB_CARD)
    try:
        killed = spawn_kill(4, "cuda", "eager_kill_cards", timeout=900)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rc3, last3, err3 = killed[3]
    assert rc3 == -9 and last3 and "killed_at" in last3, (rc3, err3)
    for rank in range(3):
        rc, res, err = killed[rank]
        assert rc == 0 and res and "no_error" not in res, (rank, err)
        assert res["ranks"] == [3] and res["step"] == KILL_AFTER + 1, res
        took = res["raised_at"] - last3["killed_at"]
        assert took < float(HB_CARD["HOROVOD_HEARTBEAT_TIMEOUT_SECONDS"]) \
            + 5, (rank, took)
        print(f"[four cards] SIGKILL of rank 3 after step {KILL_AFTER}: "
              f"rank {rank} raised RanksDownError naming [3] {took:.3f} s "
              f"after the kill; on 4 x {card.strip()}")


# ---------------------------------------------------------------------------
# BatchNorm N1-N4, held as chip_smoke.py holds them (bn_case): statistics
# and sums within twice the plain version's error against a float64
# evaluation plus 1e-6 of scale, y and dx within one ulp of the plain
# version's (or 2^-8 bf16 / 2^-20 f32 of the largest magnitude), and the
# same bits from the same input twice.
# ---------------------------------------------------------------------------

BN_CASES = [((4097, 48), "bf16", 1e-3, 0.9),
            ((2000, 80), "f32", 1e-5, 0.99),
            ((8192, 448), "f32", 1e-3, 0.9),
            ((12544, 2048), "bf16", 1e-5, 0.9),
            ((3000, 3), "f32", 1e-5, 0.9),
            ((1, 32), "bf16", 1e-3, 0.99),
            ((700, 36), "bf16", 1e-5, 0.99),
            ((100_000, 64), "bf16", 1e-5, 0.9)]


@pytest.mark.parametrize("off_grid", [False, True],
                         ids=["aligned", "off_grid"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape,dname,eps,momentum", BN_CASES,
                         ids=[f"{s[0]}x{s[1]}-{d}" for s, d, _, _ in BN_CASES])
def test_batch_norm_kernels_against_plain(card, shape, dname, eps, momentum,
                                          train, off_grid):
    import chip_smoke
    from horovod_tpu_torch.ops import batch_norm as BN

    res = chip_smoke._bn_res()
    gen = torch.Generator(device=card).manual_seed(shape[0] + shape[1])
    BN.reset_launch_counts()
    chip_smoke.bn_case(BN, torch, res, shape, DTYPES[dname], eps, momentum,
                       train, gen, "test", off_grid=off_grid)
    assert BN.LAUNCHES["bn_normalize"] > 0
    assert BN.LAUNCHES["bn_bwd_reduce"] > 0
    if train:
        assert BN.LAUNCHES["bn_stats"] > 0 and BN.LAUNCHES["bn_bwd_dx"] > 0
    print(f"{shape} {dname} {'train' if train else 'eval'} "
          f"off_grid={off_grid}: {res}")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dname", ["bf16", "f32"])
@pytest.mark.parametrize("shape", [(100_000, 64), (4097, 48)],
                         ids=["100000x64", "4097x48"])
def test_batch_norm_kernels_cancelling_variance(card, shape, dname, train):
    """x = 1e3 + 1e-2 * randn, where the fast variance cancels in float32:
    held as chip_smoke.bn_case holds its cancelling cases."""
    import chip_smoke
    from horovod_tpu_torch.ops import batch_norm as BN

    res = chip_smoke._bn_res()
    gen = torch.Generator(device=card).manual_seed(shape[0] + shape[1])
    BN.reset_launch_counts()
    chip_smoke.bn_case(BN, torch, res, shape, DTYPES[dname], 1e-5, 0.9,
                       train, gen, "test", cancel=True)
    assert BN.LAUNCHES["bn_normalize"] > 0
    assert len(res["bn_stats"]["cancel"]) == int(train)
    print(f"{shape} {dname} {'train' if train else 'eval'}: {res}")


def test_batch_norm_refuses_float64_on_the_card(card):
    from horovod_tpu_torch.ops import batch_norm as BN

    with pytest.raises(HorovodTpuError, match="float32 or bfloat16"):
        BN.bn_stats(torch.zeros(8, 4, device=card, dtype=torch.float64),
                    1e-5)


CNN_PATHS = {  # name: (factory, side, BatchNorm layers)
    "resnet50": ("horovod_tpu_torch.models.resnet", "ResNet50", 224, 53),
    "vgg16": ("horovod_tpu_torch.models.vgg", "VGG16", 224, 0),
    "inception3": ("horovod_tpu_torch.models.inception", "InceptionV3", 299,
                   94),
    "smallcnn": ("horovod_tpu_torch.models.mnist", "SmallCNN", 96, 3),
}


@pytest.mark.parametrize("name", sorted(CNN_PATHS))
def test_cnn_paths_launch_counts(card, monkeypatch, name):
    """Two bf16 steps at the bench's side and batch 2 with fused momentum
    SGD: one B1 launch per step and one launch of each of N1-N4 per
    BatchNorm per step; losses finite."""
    import importlib

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    mod, cls, side, n_bn = CNN_PATHS[name]
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_FUSED_UPDATE", "1")
    hvd.init()
    try:
        model = getattr(importlib.import_module(mod), cls)(
            num_classes=1000, dtype=torch.bfloat16)
        opt = hvd.DistributedOptimizer(
            hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9))
        x, y = synthetic_batch(2, side, 1000)
        TF.reset_launch_counts()
        BN.reset_launch_counts()
        losses = [float(train_step(model, opt, x, y)) for _ in range(2)]
        assert all(math.isfinite(v) for v in losses)
        assert TF.LAUNCHES["momentum"] == 2
        assert BN.LAUNCHES == dict.fromkeys(BN.LAUNCHES, 2 * n_bn)
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("dname", ["f64", "f32"])
def test_avgpool3_gradient_matches_cpu(card, dname):
    """Inception's 3x3 "SAME" average (the padding counted) on a
    channels-last card tensor: output and input gradient equal the CPU's
    (float64 to 1e-12; float32 to rounding).  PyTorch 2.11's CUDA
    ``avg_pool2d(padding=1)`` on a channels-last input gets this
    gradient wrong by O(1), so ``layers._avgpool3`` pads explicitly."""
    from horovod_tpu_torch.models.layers import _avgpool3

    dtype = {"f64": torch.float64, "f32": torch.float32}[dname]
    tol = 1e-12 if dname == "f64" else 1e-5
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 7, 7, generator=gen, dtype=dtype) \
        .contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    ct = torch.randn(2, 7, 7, 8, generator=gen, dtype=dtype)
    out = {}
    for dev in ("cpu", card):
        xx = x.to(dev).detach().requires_grad_()
        y = _avgpool3(xx)
        (y * ct.to(dev)).sum().backward()
        out[str(dev)] = (y.detach().cpu(), xx.grad.cpu())
    (y0, g0), (y1, g1) = out.values()
    torch.testing.assert_close(y1, y0, rtol=tol, atol=tol)
    torch.testing.assert_close(g1, g0, rtol=tol, atol=tol)


def test_four_cards_observability_resnet50(tmp_path):
    """The observability planes on four cards: the bench ResNet-50 step
    (224 px, batch 256 per card, bf16, fused momentum SGD) at in-trace
    stage 2, then at eager stage 2 on the none wire with every step under
    ``hvd.trace_step`` on every rank, ``CARD_STEPS`` steps each, with
    ``HOROVOD_FLIGHT_DIR`` and ``HOROVOD_GOODPUT_DIR`` set and
    ``HOROVOD_FAULT_SPEC=delay@rank1:q/*:50ms``: the merged flight dumps'
    analyzer ranks rank 1 first, and ``python -m horovod_tpu_torch.perf
    goodput <dir>`` reports four ranks whose phases conserve their wall.
    Then both cases again without the fault and without the directories:
    per rank the median, least and most step (printed beside PR 15's
    in-trace stage 2, 0.0615 s, and eager stage 2 none, 0.0789-0.0795 s;
    the in-trace step now pays the eager runtime that ``init()``
    starts)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import json
    import os
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import spawn

    from horovod_tpu_torch.trace import analyze
    from horovod_tpu_torch.trace.merge import compute_offsets, load_dumps

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    obs = str(tmp_path / "obs")
    outs = spawn(4, "cuda", timeout=900, mode="observability_cards",
                 env_extra={"HOROVOD_FLIGHT_DIR": obs,
                            "HOROVOD_GOODPUT_DIR": obs,
                            # every step's span stays on the ring
                            "HOROVOD_FLIGHT_EVENTS": "65536",
                            "HOROVOD_FAULT_SPEC": "delay@rank1:q/*:50ms"})
    bare = spawn(4, "cuda", timeout=900, mode="observability_cards")
    for name, world in (("delay@rank1 50 ms, observed", outs),
                        ("no fault", bare)):
        for case in ("intrace 2", "eager 2 none"):
            for o in world:
                r = o[case]
                assert all(math.isfinite(v) for v in r["losses"]), \
                    (name, case, r)
                assert all(s["B1"] == 1 for s in r["launches"]), \
                    (name, case, r)
                print(f"[four cards] {case}, {name}: rank {o['rank']} step "
                      f"median {r['median_step_s']:.4f} s, least "
                      f"{r['min_step_s']:.4f} s, most "
                      f"{r['max_step_s']:.4f} s, median round "
                      f"{r['round_ms']} ms, step-1 rel L2 "
                      f"{r['step1_rel_l2']:.3g}; on 4 x {card.strip()}")
    dumps = load_dumps(obs)
    assert sorted(d.rank for d in dumps) == [0, 1, 2, 3], os.listdir(obs)
    report = analyze(dumps, compute_offsets(dumps))
    ranking = report["stragglers"]["ranking"]
    assert ranking[0]["rank"] == 1, ranking
    steps = {p["rank"]: p["steps"] for p in report["phases"]}
    print(f"[four cards] the analyzer: straggler ranking "
          f"{[(x['rank'], x['max_lateness_s'], x['last_count']) for x in ranking]}"
          f"; trace_step spans per rank {steps}")
    assert all(n == 12 for n in steps.values()), steps
    p = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.perf", "goodput", obs,
         "--json"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
    assert p.returncode == 0, p.stderr
    rep = json.loads(p.stdout)
    assert rep["world"] == 4, rep
    for s in rep["ranks"]:
        tot = sum(s["phases"].values()) + s["unattributed_s"]
        assert abs(tot - s["elapsed_s"]) <= 0.02 * s["elapsed_s"] + 1e-6, s
    print(f"[four cards] goodput: fleet {rep['fleet_goodput']}, dominant "
          f"{rep.get('dominant_bottleneck')}, per rank "
          + "; ".join(f"{s['rank']}: comm_exposed "
                      f"{s['phases'].get('comm_exposed', 0):.3f} s of "
                      f"{s['elapsed_s']:.3f} s" for s in rep["ranks"]))


def test_four_cards_health_checkpoint_resnet50(tmp_path):
    """The training-health plane and the checkpoint on four cards: the
    bench ResNet-50 step (224 px, batch 256 per card, bf16, fused
    momentum SGD) at eager stage 2 on the none wire, 6 steps with
    ``HOROVOD_HEALTH`` off and 6 on, twice in alternation (the on/off
    step ratio); then 8 steps under ``HOROVOD_HEALTH=1``,
    ``HOROVOD_HEALTH_SKIP_NONFINITE=1`` and
    ``nan@rank1:grad_buffer*:round3``, and 8 in-trace steps with
    ``nan@rank1:grads*`` set for step 3 only: every rank's metrics name
    rank 1 / float32, one step skipped on every rank, the weights finite
    and the same on every rank.  Then an ``all_ranks`` save, a restore at
    world 4 into fresh objects (bit for bit) and 2 steps; the host form
    saved by rank 0 and restored in a world of 2 through
    ``sharded_state_from_host``: the gathered trace equal to the saved
    one bit for bit, and one step with a finite loss."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import os
    import statistics
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import spawn

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    path = str(tmp_path / "ckpt")
    outs = spawn(4, "cuda", timeout=900, mode="health_cards",
                 env_extra={"HVD_TEST_CKPT": path})
    for regime in ("eager", "intrace"):
        digests = {o[regime]["digest"] for o in outs}
        for o in outs:
            r = o[regime]
            assert r["nonfinite"] == [["1", "float32", 1.0]] or (
                regime == "intrace" and r["nonfinite"]
                and all(x[:2] == ["1", "float32"] for x in r["nonfinite"])
            ), (regime, o["rank"], r["nonfinite"])
            assert r["skipped"] == 1 and r["finite"], (regime, r)
            assert all(math.isfinite(v) for v in r["losses"])
        assert len(digests) == 1, (regime, digests)
    for o in outs:
        assert o["restored_equal"], o["rank"]
        assert all(math.isfinite(v) for v in o["resumed_losses"])
    med = {}
    for flag in ("0", "1"):
        med[flag] = [statistics.median(o[f"eager clean health={flag}"])
                     for o in outs]
    ratio = max(med["1"]) / max(med["0"])
    print(f"[four cards] ResNet-50 eager stage 2, none wire: median step "
          f"health off {min(med['0']):.4f}-{max(med['0']):.4f} s, on "
          f"{min(med['1']):.4f}-{max(med['1']):.4f} s over ranks, ratio "
          f"of the slowest ranks {ratio:.4f}; skip runs' steps (rank 0): "
          f"eager "
          f"{[round(t, 4) for t in outs[0]['eager']['times']]}, in-trace "
          f"{[round(t, 4) for t in outs[0]['intrace']['times']]}; "
          f"all_ranks save {[round(o['save_s'], 3) for o in outs]} s, "
          f"restore {[round(o['restore_s'], 3) for o in outs]} s; on "
          f"4 x {card.strip()}")
    two = spawn(2, "cuda", timeout=600, mode="health_cards_restore",
                env_extra={"HVD_TEST_CKPT": path})
    want = outs[0]["full_trace_digest"]
    for o in two:
        assert o["saved_trace_digest"] == want
        assert o["full_trace_digest"] == want, o["rank"]
        assert math.isfinite(o["loss"])
    print(f"[four cards] the world-4 stage-2 state re-cut for 2 ranks: "
          f"gathered trace equal bit for bit; losses "
          f"{[o['loss'] for o in two]}; on 2 x {card.strip()}")


def test_four_cards_elastic_resnet50(tmp_path):
    """Elastic training on four cards (``tests/_torch_elastic_train_script
    .py``'s ``ELX_CARDS`` mode): ``python -m horovod_tpu_torch.run -np 4
    --elastic --min-ranks 2`` over the ResNet-50 bench step (224 px, batch
    256 per card, bf16, fused momentum SGD, in-trace ZeRO stage 2,
    deterministic cuDNN), a commit every step, through four generations:
    4 steps at world 4; ``--preempt 3`` (rank 3 drains, the survivors
    re-form to 3 proactively, reason ``preempt``) and 4 steps; the
    launcher's joiner on card 3 admitted at a commit boundary and 4 steps
    at world 4; rank 2 SIGKILLed after it logs a step (the survivors
    detect it, abort their NCCL communicators and re-form to 3, reason
    ``failure``) and 4 steps.  After each re-form every rank's parameters
    and gathered trace are bit-identical, the step counter follows the
    commit, no two processes share a card; one B1 and 53 of each of N1-N4
    per step, finite losses; the launcher returns 0.  Prints each
    re-form's wall time and split (el/status), the kill's detection time
    and the median step per generation."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import json
    import os
    import re
    import statistics
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    env = dict(os.environ)
    env.update({"PYTHONPATH": repo + os.pathsep + env.get("PYTHONPATH", ""),
                "ELX_CARDS": "1", "HOROVOD_FUSED_UPDATE": "1",
                "HOROVOD_HEARTBEAT_INTERVAL": "0.2",
                "HOROVOD_HEARTBEAT_TIMEOUT_SECONDS": "2",
                "HOROVOD_ELASTIC_SETTLE_SECONDS": "1",
                "HOROVOD_SHUTDOWN_TIMEOUT_SECONDS": "10",
                "HOROVOD_METRICS_PUBLISH_INTERVAL": "0"})
    env.pop("HOROVOD_PLATFORM", None)
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "4",
         "--elastic", "--min-ranks", "2", "--blacklist-cooldown-seconds",
         "5", "--", sys.executable,
         os.path.join(here, "_torch_elastic_train_script.py")],
        env=env, capture_output=True, text=True, timeout=900, cwd=repo)
    # HVD_TEST_LOG_DIR keeps the job's whole output (the assertion
    # messages carry only its tail)
    log_dir = os.environ.get("HVD_TEST_LOG_DIR")
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "four_cards_elastic.log"), "w") as f:
            f.write(out.stdout + "\n----- stderr -----\n" + out.stderr)
    assert out.returncode == 0, out.stderr[-6000:]
    ev = []
    for ln in out.stdout.splitlines():
        _, _, rest = ln.partition(">:")
        if rest.startswith("{"):
            ev.append(json.loads(rest))
    enters = [e for e in ev if e["event"] == "enter"]
    gens = {}
    for e in enters:
        gens.setdefault(e["gen"], []).append(e)
    assert sorted(gens) == [1, 2, 3, 4], sorted(gens)
    assert [len(gens[g]) for g in (1, 2, 3, 4)] == [4, 3, 4, 3]
    assert sorted(e["uid"] for e in gens[2]) == ["rank0", "rank1", "rank2"]
    assert "joiner1" in {e["uid"] for e in gens[3]}
    assert sorted(e["uid"] for e in gens[4]) == ["joiner1", "rank0",
                                                 "rank1"]
    steps = [e for e in ev if e["event"] == "step"]
    smi_seen = {}
    for g, es in gens.items():
        # bit-identical parameters and gathered trace on every rank
        assert len({e["digest"] for e in es}) == 1, g
        # the step counter follows the commit: 4 steps per generation
        assert {e["step"] for e in es} == {4 * (g - 1)}, (g, es)
        # no two processes on one card
        devs = [e["device"] for e in es]
        assert len(set(devs)) == len(devs), (g, devs)
        assert all(e["device"] == f"cuda:{e['current']}" for e in es)
        # nvidia-smi's view, read by rank 0 as the generation starts:
        # one compute process on each card the generation's tensors name
        # and none elsewhere, so no card holds two (a drained or killed
        # process that has not left its card included).  Its pids are
        # the container's view, so the check is by card.
        apps, uuids = next(e["smi"] for e in es if e["rank"] == 0)
        cards = sorted(u for _, u in apps)
        assert cards == sorted(uuids[d.split(":")[1]] for d in devs), (
            g, apps)
        smi_seen[g] = len(cards)
        gsteps = [s for s in steps if s["gen"] == g]
        assert len(gsteps) == 4 * len(es), (g, len(gsteps))
        for s in gsteps:
            assert s["b1"] == 1 and s["bn"] == dict.fromkeys(
                ("bn_stats", "bn_normalize", "bn_bwd_reduce", "bn_bwd_dx"),
                53), s
            assert math.isfinite(s["loss"]), s
    joiner = next(e for e in gens[3] if e["uid"] == "joiner1")
    assert joiner["device"] == "cuda:3", joiner
    finals = [e for e in ev if e["event"] == "final"]
    assert len(finals) == 3 and len({e["digest"] for e in finals}) == 1
    assert all(e["step"] == 16 for e in finals)
    status = [dict(re.findall(r'(\w+)=("[^"]*"|\[[^\]]*\]|[-\d.]+)', ln))
              for ln in out.stderr.splitlines()
              if "elastic re-form complete" in ln]
    reasons = [json.loads(s["reason"]) for s in status]
    assert reasons == ["preempt", "grow", "failure"], reasons
    assert "exited after graceful preemption drain (rc=0)" in out.stderr
    assert "aborted every NCCL communicator" in out.stderr
    dying = next(e for e in ev if e["event"] == "dying")
    detect = [e["t"] - dying["t"] for e in ev
              if e["event"] == "reform_start" and e["reason"] == "failure"]
    assert len(detect) == 3
    for s in status:
        print(f"[four cards] re-form gen {s.get('gen')} ({s.get('reason')},"
              f" size {s.get('size')}): {s.get('reform_s')} s = teardown "
              f"{s.get('teardown_s')} + rendezvous {s.get('rendezvous_s')} "
              f"+ init {s.get('init_s')} + resync {s.get('resync_s')} s")
    print(f"[four cards] the kill's detection (SIGKILL to re-form start on "
          f"each survivor): {[round(d, 3) for d in detect]} s")
    for g in (1, 2, 3, 4):
        med = statistics.median(s["step_s"] for s in steps if s["gen"] == g)
        print(f"[four cards] generation {g} (world {len(gens[g])}): median "
              f"step {med:.4f} s, devices "
              f"{sorted(e['device'] for e in gens[g])}")
    print(f"[four cards] compute processes nvidia-smi listed at each "
          f"generation's start, one per card of the generation: "
          f"{smi_seen}; on 4 x {card.strip()}")


def test_four_cards_elastic_clean_step():
    """The elastic plane's cost on a clean step, four cards: the ResNet-50
    bench step of ``test_four_cards_elastic_resnet50`` (224 px, batch 256
    per card, bf16, fused momentum SGD, in-trace ZeRO stage 2,
    deterministic cuDNN, the same liveness settings, a commit and a poll
    before every step) launched by ``python -m horovod_tpu_torch.run -np
    4`` without ``--elastic``, with it, with it and without it again, the
    metrics publisher at its default interval.  Each launch: one B1 and
    53 of each of N1-N4 per step, finite losses, the same parameters on
    every rank, no re-form.  Prints the median step, commit and whole
    iteration of each launch and the on/off ratio of the iterations."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import json
    import os
    import statistics
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    total, warm = 12, 2
    env = dict(os.environ)
    env.update({"PYTHONPATH": repo + os.pathsep + env.get("PYTHONPATH", ""),
                "ELX_CARDS": "clean", "ELX_TOTAL": str(total),
                "HOROVOD_FUSED_UPDATE": "1",
                "HOROVOD_HEARTBEAT_INTERVAL": "0.2",
                "HOROVOD_HEARTBEAT_TIMEOUT_SECONDS": "2",
                "HOROVOD_ELASTIC_SETTLE_SECONDS": "1",
                "HOROVOD_SHUTDOWN_TIMEOUT_SECONDS": "10"})
    for k in ("HOROVOD_PLATFORM", "HOROVOD_METRICS_PUBLISH_INTERVAL"):
        env.pop(k, None)
    runs = []
    for on in (False, True, True, False):
        out = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "4",
             *(["--elastic", "--min-ranks", "2"] if on else []), "--",
             sys.executable,
             os.path.join(here, "_torch_elastic_train_script.py")],
            env=env, capture_output=True, text=True, timeout=300, cwd=repo)
        assert out.returncode == 0, out.stderr[-6000:]
        assert "elastic re-form complete" not in out.stderr
        ev = []
        for ln in out.stdout.splitlines():
            _, _, rest = ln.partition(">:")
            if rest.startswith("{"):
                ev.append(json.loads(rest))
        steps = [e for e in ev if e["event"] == "step"]
        finals = [e for e in ev if e["event"] == "final"]
        assert len(steps) == 4 * total and len(finals) == 4
        assert len({e["digest"] for e in finals}) == 1
        assert all(e["elastic"] == on for e in steps)
        for s in steps:
            assert s["b1"] == 1 and s["bn"] == dict.fromkeys(
                ("bn_stats", "bn_normalize", "bn_bwd_reduce", "bn_bwd_dx"),
                53), s
            assert math.isfinite(s["loss"]), s
        timed = [s for s in steps if s["step"] > warm]
        runs.append({"on": on, "digest": finals[0]["digest"],
                     **{k: statistics.median(s[k] for s in timed)
                        for k in ("step_s", "commit_s", "iter_s")}})
    for r in runs:
        print(f"[four cards] clean steps, elastic {'on ' if r['on'] else 'off'}"
              f": median step {r['step_s']:.4f} s, commit "
              f"{r['commit_s']:.4f} s, iteration {r['iter_s']:.4f} s "
              f"(steps {warm + 1}-{total} of each rank)")
    it = {on: statistics.mean(r["iter_s"] for r in runs if r["on"] == on)
          for on in (False, True)}
    print(f"[four cards] elastic on/off, whole iteration: "
          f"{it[True] / it[False]:.4f}; final parameters equal across the "
          f"four launches: {len({r['digest'] for r in runs}) == 1}; on 4 x "
          f"{card.strip()}")


def test_four_cards_autopilot_resnet50(tmp_path):
    """The autopilot on four cards: ``python -m horovod_tpu_torch.run -np 4
    --elastic --min-ranks 2 --autopilot`` over the ResNet-50 bench step
    (224 px, batch 256 per card, bf16, fused momentum SGD, in-trace ZeRO
    stage 2, deterministic cuDNN; ``tests/_torch_elastic_train_script.py``
    in its ``autopilot_*`` modes), the ranks publishing their metrics to
    the launcher every 0.5 s from ``init()`` on (its evidence), at the
    straggler rule's default floor (the sweep leaves that rule unfed, as
    all four ranks share one host), twice:

    1. Rollback (``HOROVOD_HEALTH=1``, a durable commit every 2 steps, 8
       steps): an unpoisoned run, then a run whose step 5 carries NaN on
       rank 1 (``nan@rank1:grads*``: the in-trace rule has no round, so
       it is set for that one step).  Rank 0's tick applies one rollback,
       every rank restores the commit of step 4 and replays, and the
       final parameters and gathered traces are bit-identical on every
       rank and to the unpoisoned run's.
    2. SLO burn, then recovery: ``slow:3:0.5s`` slows rank 3's controller
       transport, and so its liveness polls, which sit outside its
       ``trace_step`` spans; ``HOROVOD_GOODPUT_SLO=0.95`` over a 4 s
       window, 2 trip ticks.  The start, booked outside any span, burns
       the SLO on every rank alike: the launcher judges a rank's goodput
       only once it has stepped, and its actuators never shed rank 0,
       whose death the job cannot survive in process.  The launcher's
       ``slo_burn_shrink`` sheds the bottleneck rank (3) and the
       survivors re-form to 3; once the window
       is clean, ``slo_recover_grow`` raises the target and the respawn
       sweep's joiner takes the freed card: the world is back to 4.  The
       ``slow:`` rule names a rank number, which a later generation would
       give to another process, so the script drops it from the
       environment once generation 1 has started (a joiner before its
       ``init()``): the slowness ends with the shed process.

    After each re-form every rank's parameters and gathered trace are
    bit-identical, no two processes share a card; one B1 and 53 of each of
    N1-N4 per step; the launcher returns 0.  Prints each verdict's
    evidence, each re-form's wall time, the rollback's and the median step
    per generation."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import json
    import os
    import re
    import statistics
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    bn = dict.fromkeys(("bn_stats", "bn_normalize", "bn_bwd_reduce",
                        "bn_bwd_dx"), 53)
    log_dir = os.environ.get("HVD_TEST_LOG_DIR")

    def launch(name: str, timeout: float, **extra):
        env = dict(os.environ)
        env.update({"PYTHONPATH": repo + os.pathsep
                    + env.get("PYTHONPATH", ""),
                    "HOROVOD_FUSED_UPDATE": "1",
                    "HOROVOD_HEARTBEAT_INTERVAL": "0.2",
                    "HOROVOD_HEARTBEAT_TIMEOUT_SECONDS": "3",
                    "HOROVOD_ELASTIC_SETTLE_SECONDS": "1",
                    "HOROVOD_SHUTDOWN_TIMEOUT_SECONDS": "10",
                    "HOROVOD_METRICS_PUBLISH_INTERVAL": "0.5", **extra})
        env.pop("HOROVOD_PLATFORM", None)
        out = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "4",
             "--elastic", "--min-ranks", "2", "--autopilot", "--",
             sys.executable,
             os.path.join(here, "_torch_elastic_train_script.py")],
            env=env, capture_output=True, text=True, timeout=timeout,
            cwd=repo)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            with open(os.path.join(log_dir, f"four_cards_{name}.log"),
                      "w") as f:
                f.write(out.stdout + "\n----- stderr -----\n" + out.stderr)
        assert out.returncode == 0, out.stderr[-6000:]
        assert out.stderr.count("[hvdrun autopilot] engaged: rules") == 1
        ev = []
        for ln in out.stdout.splitlines():
            _, _, rest = ln.partition(">:")
            if rest.startswith("{"):
                ev.append(json.loads(rest))
        for s in (e for e in ev if e["event"] == "step"):
            assert s["b1"] == 1 and s["bn"] == bn, s
            assert math.isfinite(s["loss"]), s
        return out, ev

    # 1. rollback at the commit
    out, ev = launch("autopilot_rollback", 600,
                     ELX_CARDS="autopilot_rollback",
                     ELX_CKPT=str(tmp_path / "ckpt"), HOROVOD_HEALTH="1",
                     HOROVOD_CHECKPOINT_KEEP="4")
    runs = {(e["run"], e["rank"]): e for e in ev if e["event"] == "run"}
    assert sorted(runs) == [(r, k) for r in ("clean", "poisoned")
                            for k in range(4)], sorted(runs)
    digests = {e["digest"] for e in runs.values()}
    assert len(digests) == 1, runs   # every rank, both runs
    for k in range(4):
        clean, pois = runs["clean", k], runs["poisoned", k]
        assert clean["ran"] == list(range(8)) and not clean["rollbacks"]
        assert pois["ran"] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7], pois["ran"]
        assert [r[0] for r in pois["rollbacks"]] == [4], pois
    judge = runs["poisoned", 0]
    assert judge["stats"]["rollbacks"] == 1, judge["stats"]
    applied = [a for a in judge["actions"] if a["outcome"] == "applied"]
    assert len(applied) == 1 and applied[0]["rule"] == "health_rollback"
    assert all(runs["poisoned", k]["actions"] == [] for k in (1, 2, 3))
    print(f"[four cards] rollback: evidence {applied[0]['evidence']}; "
          f"verdicts {judge['stats']['by_outcome']}; restore wall time "
          f"per rank {[round(runs['poisoned', k]['rollbacks'][0][1], 3) for k in range(4)]}"
          f" s; final state bit for bit with the unpoisoned run")

    # 2. SLO burn, shrink, recovery, grow
    fl = tmp_path / "flight"
    out, ev = launch("autopilot_slo", 900, ELX_CARDS="autopilot_slo",
                     HOROVOD_FAULT_SPEC="slow:3:0.5s",
                     HOROVOD_GOODPUT_SLO="0.95",
                     HOROVOD_GOODPUT_WINDOW_SECONDS="4",
                     HOROVOD_AUTOPILOT_TRIP_TICKS="2",
                     HOROVOD_AUTOPILOT_COOLDOWN_SECONDS="120",
                     HOROVOD_FLIGHT_DIR=str(fl))
    gens = {}
    for e in (e for e in ev if e["event"] == "enter"):
        gens.setdefault(e["gen"], []).append(e)
    assert sorted(gens) == [1, 2, 3], sorted(gens)
    assert [len(gens[g]) for g in (1, 2, 3)] == [4, 3, 4]
    assert sorted(e["uid"] for e in gens[2]) == ["rank0", "rank1", "rank2"]
    joiner = next(e for e in gens[3] if e["uid"] == "joiner1")
    assert joiner["device"] == "cuda:3", joiner
    for g, es in gens.items():
        assert len({e["digest"] for e in es}) == 1, g
        devs = [e["device"] for e in es]
        assert len(set(devs)) == len(devs), (g, devs)
        apps, uuids = next(e["smi"] for e in es if e["rank"] == 0)
        assert sorted(u for _, u in apps) == sorted(
            uuids[d.split(":")[1]] for d in devs), (g, apps)
    finals = [e for e in ev if e["event"] == "final"]
    assert len(finals) == 4 and len({e["digest"] for e in finals}) == 1
    status = [dict(re.findall(r'(\w+)=("[^"]*"|\[[^\]]*\]|[-\d.]+)', ln))
              for ln in out.stderr.splitlines()
              if "elastic re-form complete" in ln]
    assert [json.loads(s["reason"]) for s in status] == ["failure", "grow"]
    acts = []
    for name in os.listdir(fl):
        if name.startswith("flight-") and name.endswith(".jsonl"):
            with open(fl / name) as f:
                lines = [json.loads(ln) for ln in f if ln.strip()]
            if lines and "initialized" not in lines[0]["meta"]:
                acts += [a for a in lines if a.get("kind") == "autopilot"]
    assert not [a for a in acts if a["rule"] == "straggler_blacklist"], acts
    applied = [a for a in acts if a["outcome"] == "applied"]
    assert [a["rule"] for a in applied] == ["slo_burn_shrink",
                                            "slo_recover_grow"], acts
    shrink, grow = applied
    assert shrink["evidence"]["bottleneck_rank"] == 3
    assert shrink["evidence"]["killed"] == ["3"]
    assert shrink["evidence"]["target_np"] == 3
    assert grow["evidence"]["target_np"] == 4
    assert "SLO-burn shrink: shed rank 3 on localhost" in out.stderr
    for a in applied:
        print(f"[four cards] {a['rule']}: evidence {a['evidence']}")
    print(f"[four cards] autopilot verdicts: "
          f"{sorted((a['rule'], a['outcome']) for a in acts)}")
    for st in status:
        print(f"[four cards] re-form gen {st.get('gen')} ({st.get('reason')},"
              f" size {st.get('size')}): {st.get('reform_s')} s = teardown "
              f"{st.get('teardown_s')} + rendezvous {st.get('rendezvous_s')} "
              f"+ init {st.get('init_s')} + resync {st.get('resync_s')} s")
    steps = [e for e in ev if e["event"] == "step"]
    for g in (1, 2, 3):
        med = statistics.median(s["step_s"] for s in steps if s["gen"] == g)
        print(f"[four cards] generation {g} (world {len(gens[g])}): median "
              f"step {med:.4f} s over "
              f"{sum(1 for s in steps if s['gen'] == g)} rank-steps, "
              f"devices {sorted(e['device'] for e in gens[g])}")
    print(f"[four cards] on 4 x {card.strip()}")


def test_four_cards_timeline_autotune_resnet50(tmp_path):
    """The timeline and the tuner on four cards: the bench ResNet-50 step
    (224 px, batch 256 per card, bf16, fused momentum SGD) under
    ``DistributedOptimizer(eager=True)`` at ZeRO stage 2, each phase its
    own world generation: without the timeline, with it (rank 1 sleeps
    1 s before step 5), without it, with it, then under
    ``HOROVOD_AUTOTUNE`` (2 cycles a sample, 1 warm-up sample, 4
    samples).  Rank 0's trace is valid JSON; every submitted row holds
    ``RANK0_READY`` to ``RANK3_READY`` and a straggling step in which
    rank 1's tick is later than the other three's by at least 0.95 of
    the sleep on every gradient bucket's reduce-scatter row (the others'
    host time to the same submission differs from rank 1's by a few
    ms); every rank reports the same tuned knobs after every step and applied
    the same proposals at the same rounds.  Prints the timeline's on/off
    step ratio (medians over steps 3-10 but the straggling one)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import json
    import os
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import spawn
    from _torch_tuning_worker import STRAGGLE_S

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    trace = str(tmp_path / "timeline.json")
    outs = spawn(4, "cuda", timeout=900, mode="tuning_cards",
                 env_extra={"HVD_TEST_TRACE": trace,
                            "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2",
                            "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
                            "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "4"})
    for o in outs:
        for phase in ("off", "on", "off2", "on2", "tune"):
            r = o[phase]
            assert all(math.isfinite(v) for v in r["losses"]), (phase, r)
            assert all(b == 1 for b in r["B1"]), (phase, r)
    with open(trace) as f:
        events = json.load(f)
    rows = {e["tid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    ticks: dict = {}
    for e in events:
        if e.get("ph") == "i" and e["name"].endswith("_READY"):
            rk = int(e["name"][4:-6])
            ticks.setdefault(rows[e["tid"]], {}).setdefault(rk, []).append(
                e["ts"])
    shard_rows = {n for n in rows.values() if n.startswith("shard_")}
    assert shard_rows and shard_rows <= set(ticks), sorted(rows)
    late = []
    for name, per in ticks.items():
        assert sorted(per) == [0, 1, 2, 3], (name, sorted(per))
        if not name.startswith("shard_rs."):
            continue  # the all-gathers start after every rank's scatter
        # the k-th tick of each rank is one step's arrival (a fast round
        # ingests no request, and ticks none)
        n = min(len(v) for v in per.values())
        gaps = [per[1][i] - max(per[k][i] for k in (0, 2, 3))
                for i in range(n)]
        late.append(max(gaps) / 1e6)
        # the three others reach the same submission a few ms apart
        # from rank 1's own host time: 0.95 of the sleep
        assert max(gaps) >= 0.95 * STRAGGLE_S * 1e6, (name, gaps)
    assert late, sorted(ticks)
    knobs = [o["tune"]["knobs"] for o in outs]
    assert all(k == knobs[0] for k in knobs), knobs
    tunes = [o["tune"]["tunes"] for o in outs]
    assert tunes[0] and all(t == tunes[0] for t in tunes), tunes
    off = [o[p]["median_step_s"] for o in outs for p in ("off", "off2")]
    on = [o[p]["median_step_s"] for o in outs for p in ("on", "on2")]
    ratio = (sum(on) / len(on)) / (sum(off) / len(off))
    print(f"[four cards] timeline on/off median step ratio {ratio:.4f} "
          f"(off {[round(x, 4) for x in off]} s, on "
          f"{[round(x, 4) for x in on]} s); rank 1's straggling tick "
          f"later by {min(late):.4f}-{max(late):.4f} s over "
          f"{len(ticks)} rows (sleep {STRAGGLE_S} s); tuner: "
          f"{outs[0]['tune']['samples']} samples, pinned "
          f"{outs[0]['tune']['pinned']}, proposals at rounds "
          f"{[t[0] for t in tunes[0]]}, final knobs {knobs[0][-1]}, "
          f"tuned step median {outs[0]['tune']['median_step_s']:.4f} s; "
          f"on 4 x {card.strip()}")


def test_four_cards_profile_resnet50(tmp_path):
    """The perf observatory on four cards: the bench ResNet-50 step (224
    px, batch 256 per card, bf16, fused momentum SGD) 8 steps under
    ``hvd.trace_step`` with ``HOROVOD_PROFILE_EVERY_N_STEPS=2``, at stage
    0 with the overlap engine and at ZeRO stage 2 with overlap on
    (``tests/_torch_perf_worker.py``).  On every rank: at least two
    captures analyzed, the NCCL kernels read as reduce-scatter and
    all-gather comm, resolved to the case's ``hvd_overlap_*`` or
    ``hvd_zero2_*`` scopes, hidden + exposed = comm, the goodput ledger
    booking ``comm_exposed`` from the device, and the tuner's comm signal
    the device gauge.  Prints each rank's hidden share of device comm."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import os
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import spawn
    from _torch_perf_worker import PERF_CASES

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    outs = spawn(4, "cuda", timeout=900, mode="perf_cards",
                 env_extra={"HOROVOD_PROFILE_DIR": str(tmp_path)})
    for case, _, _, family in PERF_CASES:
        for o in outs:
            r = o[case]
            la = r["analysis"]
            tot = la["totals"]
            assert all(math.isfinite(x) for x in r["losses"]), (case, r)
            assert r["captures"] >= 2, (case, r["captures"])
            kinds = set().union(*(s["comm_by_kind"] for s in la["steps"]))
            scopes = set().union(*(s["scopes"] for s in la["steps"]))
            assert {"reduce-scatter", "all-gather"} <= kinds, (case, kinds)
            assert any(s.startswith(family) for s in scopes), (case, scopes)
            assert tot["comm_s"] > 0
            assert tot["comm_hidden_s"] + tot["comm_exposed_s"] == \
                pytest.approx(tot["comm_s"], abs=2e-6)
            assert r["exposed_source"].get("device", 0) > 0, r
            assert r["tuner_signal"] == r["gauge"] == \
                tot["comm_exposed_s_per_step"], r
            print(f"[four cards] profile, {case}: rank {o['rank']} step "
                  f"{la['captured_step']}: wall {tot['wall_s_per_step']} s,"
                  f" compute {tot['compute_s_per_step']} s, comm "
                  f"{tot['comm_s_per_step']} s, hidden "
                  f"{tot['comm_hidden_s_per_step']} s, exposed "
                  f"{tot['comm_exposed_s_per_step']} s, hidden share "
                  f"{tot['comm_hidden_s'] / tot['comm_s']:.4f}; kinds "
                  f"{la['steps'][0]['comm_by_kind']}; "
                  f"{la['scopes_resolved']} scoped ops over "
                  f"{len(scopes)} scopes; {r['captures']:g} captures; "
                  f"on 4 x {card.strip()}")


def test_four_cards_schedule_lint():
    """The schedule pass over four NCCL ranks as the (cross 2, local 2)
    pair (``tests/_torch_analysis_worker.py``): ZeRO-2 at k = 4 with its
    stage-1 control, overlap on and off, hierarchical int8 with the flat
    int8 control, local SGD's inner step and outer sync (each preset's
    control the other program).  On every rank: every preset clean and
    every control flagged, the ``c10d`` records' ranks equal to the
    hops' transfer by transfer, and B4/B5 launched in the lossy programs
    only."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    import os
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_collectives_worker import spawn

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    outs = spawn(4, "cuda", timeout=600, mode="schedule")
    want = {"zero2": [], "zero1-control": ["SCHED-FULLBUF"],
            "overlap": [],
            "overlap-off-control": ["SCHED-MESH-PLACEMENT",
                                    "SCHED-MONOLITHIC"],
            "hier-int8": [], "flat-int8-control": ["SCHED-LOSSY-PLACEMENT"],
            "localsgd-inner": [], "localsgd-outer": [],
            "localsgd-inner-control": ["SCHED-LOCALSGD-INNER"],
            "localsgd-outer-control": ["SCHED-LOCALSGD-OUTER"]}
    lossy = {"hier-int8", "flat-int8-control"}
    for r, o in enumerate(outs):
        assert {k: o[k]["rules"] for k in want} == want, r
        assert o["basic"]["c10d"][:3] == o["basic"]["hop"]
        for k, v in o.items():
            if k in ("rank", "basic") or "hop" not in v:
                continue
            assert v["c10d"] == v["hop"], (r, k, v["c10d"], v["hop"])
            codec = {n: c for n, c in v["kernels"].items()
                     if n.startswith("hvd.quantization.")}
            if k in lossy:
                assert codec.get("hvd.quantization.quantize", 0) >= 1 and \
                    codec.get("hvd.quantization.dequantize", 0) >= 1, \
                    (r, k, codec)
            else:
                assert codec == {}, (r, k, codec)
        print(f"[four cards] schedule lint, rank {r}: "
              + "; ".join(f"{k} {v['rules']} hops "
                          f"{[tuple(x) for x in v.get('hop', [])][:6]} "
                          f"kernels {v.get('kernels')}"
                          for k, v in o.items() if k not in ("rank", "basic"))
              + f"; on 4 x {card.strip()}")
