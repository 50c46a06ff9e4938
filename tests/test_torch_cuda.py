"""Tests of the port that need the card: kernels B1-B3 against their
plain versions, and a short training run through the fused tail.  Marked
``cuda``; each skips (with its reason) where no CUDA device is present.
This file imports no JAX, so it runs on a GPU machine without it::

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider --noconftest
"""

import math

import pytest
import torch

from horovod_tpu_torch.optim import fused_update as TF

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
