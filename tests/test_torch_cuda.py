"""Tests of the port that need the card: kernels B1-B3 and B8-B10
against their plain versions, and short training runs through them.
Marked ``cuda``; each skips (with its reason) where no CUDA device is
present.  This file imports no JAX, so it runs on a GPU machine without
it::

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider --noconftest
"""

import math

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as FA
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
        n_params = len(list(model.parameters()))
        assert TF.LAUNCHES["momentum"] == 3 * n_params
    finally:
        hvd.shutdown()


# f32: the kernels and the plain versions differ only in the order of
# their sums (TF32 off); bf16: p and ds are rounded to bf16, so a sum
# order that moves a value across a rounding boundary moves it by one bf16
# ulp -- the JAX package's own bf16 tolerance (test_pallas_attention.py).
FLASH_TOL = {"f32": (1e-4, 1e-5), "bf16": (2e-2, 2e-2)}


def _close(got, want, dname, what):
    rtol, atol = FLASH_TOL[dname]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")


def _close_state(got, want, dname, what):
    for name, a, b in FA.state_pairs(got, want, dname == "bf16"):
        _close(a, b, dname, f"{what} {name}")


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


@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_flash_kernels_against_plain(card, exact_f32, dname, causal, shape):
    bh, lq, lk, d, qo, ko = shape
    dtype = DTYPES[dname]
    gen = torch.Generator(device=card).manual_seed(lq * d)

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
    _close_state(got, want, dname, "B8")
    out, lse = finish(*want)
    delta = (do.float() * out).sum(-1)
    _close(FA.flash_bwd_dq(q, k, v, do, lse, delta, qo, ko, causal=causal),
           FA.flash_bwd_dq_plain(q, k, v, do, lse, delta, qo, ko, causal),
           dname, "B9 dq")
    for name, a, b in zip(("dk", "dv"),
                          FA.flash_bwd_dkv(q, k, v, do, lse, delta, qo, ko,
                                           causal=causal),
                          FA.flash_bwd_dkv_plain(q, k, v, do, lse, delta, qo,
                                                 ko, causal)):
        _close(a, b, dname, f"B10 {name}")
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"flash_block_step": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}


def test_flash_fully_masked_block_keeps_fresh_state(card):
    q = torch.randn(4, 512, 64, device=card).bfloat16()
    kv = torch.randn(4, 512, 64, device=card).bfloat16()
    m = torch.full((4, 512), -math.inf, device=card)
    l = torch.zeros(4, 512, device=card)
    o = torch.zeros(4, 512, 64, device=card)
    m2, l2, o2 = FA.flash_block_step(q, kv, kv, m, l, o, 0, 512)
    assert torch.equal(m2, m) and torch.equal(l2, l) and torch.equal(o2, o)


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
        assert TF.LAUNCHES["adam"] == 3 * (3 + 6 * cfg.n_layers)
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
                  C.check_broadcasts, C.check_distributed_optimizer):
        check(outs, 4)
