"""The port's process world and collectives on spawned gloo ranks (2 and
4), against numpy.

Each rank runs ``tests/_torch_collectives_worker.py`` with the env the
JAX package's launcher exports (``run/launcher.py:619-626``), on a fresh
port, under a timeout.  With two ranks a float sum is one addition, so
float32 results must match numpy bit for bit; with four the reduction
order is the backend's, so float32 is held to rtol 1e-6.  The bf16 and
fp16 wires are held to their dtype's rounding of the numpy sum (exact
with two ranks, 2 ulp of the dtype with four).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.types import HorovodTpuError

sys.path.insert(0, os.path.dirname(__file__))
from _torch_collectives_worker import WORKER, inputs, spawn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=[2, 4], ids=["np2", "np4"])
def world(request):
    return request.param, spawn(request.param)


def _f(x):
    return np.asarray(x, np.float32)


def _cast(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype).float() \
        .numpy()


def _same(got, want, n, dtype=torch.float32):
    """Exact for two ranks; else within the reduction-order rounding of
    ``dtype``."""
    got, want = _f(got), _f(want)
    if n == 2:
        np.testing.assert_array_equal(got, want)
    else:
        rtol = {torch.float32: 1e-6, torch.bfloat16: 2 ** -7,
                torch.float16: 2 ** -10}[dtype]
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * np.abs(want).max())


def check_topology(outs, n):
    for r, out in enumerate(outs):
        assert out["topology"] == [r, n, r, n, 0, 1]


def check_allreduce(outs, n):
    xs = [inputs(r)["x"] for r in range(n)]
    total = np.sum(xs, axis=0, dtype=np.float32) if n == 2 else \
        np.sum(np.asarray(xs, np.float64), axis=0)
    h = np.sum([x.astype(np.float16) for x in xs], axis=0,
               dtype=np.float16) / np.float16(n)
    for out in outs:
        _same(out["sum"], total, n)
        _same(out["avg"], _f(total) / np.float32(n), n)
        # fp16 wire: each rank's value cast, summed in fp16, divided
        _same(out["fp16"], h.astype(np.float32), n, torch.float16)


def check_grouped(outs, n):
    ins = [inputs(r) for r in range(n)]

    def tot(k, dtype=torch.float32):
        vals = [_cast(i[k], dtype) for i in ins]
        return np.sum(np.asarray(vals, np.float64), axis=0)

    for out in outs:
        assert out["grouped_dtypes"] == ["torch.float32", "torch.bfloat16",
                                         "torch.int32", "torch.float32"]
        a, b, c, d = out["grouped"]
        _same(a, tot("a"), n)
        _same(b, _cast(tot("b", torch.bfloat16), torch.bfloat16), n,
              torch.bfloat16)
        np.testing.assert_array_equal(np.asarray(c),
                                      np.sum([i["c"] for i in ins], axis=0))
        _same(d, tot("d"), n)
        ga, gd = out["grouped_avg"]
        _same(ga, _f(tot("a")) / np.float32(n), n)
        _same(gd, _f(tot("d")) / np.float32(n), n)


def check_broadcasts(outs, n):
    for out in outs:
        np.testing.assert_array_equal(_f(out["bcast"]), inputs(1)["x"])
        w, b = out["bparams"]
        assert np.all(_f(w) == 1.0) and np.all(_f(b) == 0.0)
        mu, count = out["bstate"]
        assert np.all(_f(mu) == 10.0) and count == 7
        assert out["bobject"] == {"rank": 1, "x": [1, "s"]}


def check_distributed_optimizer(outs, n):
    a = np.sum([inputs(r)["a"] for r in range(n)], axis=0,
               dtype=np.float64)
    for out in outs:
        # sgd(lr=1): the update is minus the averaged gradient
        _same(out["dopt"], -(_f(a) / np.float32(n)), n)


def test_env_contract_topology(world):
    check_topology(world[1], world[0])


def test_allreduce_average_and_sum(world):
    check_allreduce(world[1], world[0])


def test_grouped_allreduce_mixed_dtypes(world):
    check_grouped(world[1], world[0])


def test_broadcast_helpers(world):
    check_broadcasts(world[1], world[0])


def test_distributed_optimizer_averages(world):
    check_distributed_optimizer(world[1], world[0])


def test_world_of_one_without_env(monkeypatch):
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK", "HOROVOD_LOCAL_RANK",
              "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
              "HOROVOD_CROSS_SIZE", "HOROVOD_COORDINATOR_ADDR"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(HorovodTpuError, match="not been initialized"):
        hvd.size()
    hvd.init(device="cpu")
    try:
        assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
                hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
        x = torch.arange(6, dtype=torch.float32)
        assert torch.equal(hvd.allreduce(x), x)
        assert torch.equal(hvd.allreduce(x, op=hvd.Sum), x)
    finally:
        hvd.shutdown()
    assert not hvd.is_initialized()


def test_size_above_one_needs_a_coordinator(monkeypatch):
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.delenv("HOROVOD_COORDINATOR_ADDR", raising=False)
    with pytest.raises(HorovodTpuError, match="COORDINATOR_ADDR"):
        hvd.init(device="cpu")


def test_unported_modes_raise():
    x = torch.zeros(3)
    for comp in (hvd.Compression.int8, hvd.Compression.int4,
                 hvd.Compression.topk):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            hvd.allreduce(x, compression=comp)
    with pytest.raises(NotImplementedError, match="Adasum"):
        hvd.allreduce(x, op=hvd.Adasum)
    w = torch.nn.Parameter(torch.zeros(2))
    from horovod_tpu_torch.optim import fused_update as TF

    with pytest.raises(NotImplementedError, match="zero_stage"):
        hvd.DistributedOptimizer(TF.sgd([w], 0.1), zero_stage=1)
    with pytest.raises(NotImplementedError, match="int8"):
        hvd.DistributedOptimizer(TF.sgd([w], 0.1),
                                 compression=hvd.Compression.int8)


def test_jax_launcher_spawns_port_ranks():
    """The JAX package's launcher, unchanged, runs two ranks of the port:
    its env contract is all ``init`` needs."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["HOROVOD_PLATFORM"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu.run", "-np", "2", "--",
         sys.executable, WORKER, "cpu"], env=env, capture_output=True,
        text=True,
        timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    x0, x1 = inputs(0)["x"], inputs(1)["x"]
    for r in range(2):
        line = next(ln for ln in out.stdout.splitlines()
                    if ln.startswith(f"[{r}]<stdout>:{{"))
        res = json.loads(line.split(":", 1)[1])
        assert res["topology"] == [r, 2, r, 2, 0, 1]
        np.testing.assert_array_equal(_f(res["sum"]), x0 + x1)
