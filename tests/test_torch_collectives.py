"""The port's process world and collectives on spawned gloo ranks (2 and
4), against numpy.

The lossy wire (int8, int4, top-k) is held against a numpy model of the
same codec (:func:`np_dense_psum`, :func:`np_scatter`, :func:`np_topk`):
float32 division, ``rint`` and one multiply per element round exactly as
the port does, and the int8 sums are exact, so every int8/int4 result is
bit for bit, on gloo and on NCCL alike.  Top-k sums several values into
one element, so it is bit for bit with two ranks and within rtol 1e-6
with four.

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
from _torch_collectives_worker import (RS_MODES, WORKER,  # noqa: E402
                                       inputs, lossy_inputs, spawn)

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


# ---------------------------------------------------------------------------
# The lossy wire: a numpy model of the codec
# ---------------------------------------------------------------------------

BLOCK = 256
F32 = np.float32


def np_grid(x2d, s, qmax: int):
    """``clip(rint(x * inv), -qmax, qmax)``, inv = 1/s (0 where s == 0)."""
    inv = np.where(s > 0, F32(1) / np.where(s > 0, s, F32(1)), F32(0))
    return np.clip(np.rint(x2d * inv.astype(F32)[:, None]), -qmax, qmax)


def _blocks(flat, block=BLOCK):
    pad = (-flat.shape[-1]) % block
    flat = np.concatenate([flat, np.zeros(flat.shape[:-1] + (pad,), F32)],
                          axis=-1)
    return flat.reshape(flat.shape[:-1] + (-1, block))


def np_dense_psum(xs, int4: bool = False):
    """The int8 (or int4) allreduce of the rows of ``xs`` (n, L):
    ``(sum, residuals, scales)``."""
    n, L = xs.shape
    qmax = 7 // n if int4 else 127 // n
    x3 = _blocks(np.asarray(xs, F32))                      # (n, nb, block)
    s = (np.abs(x3).max(axis=(0, 2)) / F32(qmax)).astype(F32)
    q = [np_grid(x3[r], s, qmax) for r in range(n)]
    out = (np.sum(q, axis=0).astype(F32) * s[:, None]).reshape(-1)[:L]
    errs = np.stack([(x3[r] - q[r].astype(F32) * s[:, None]).reshape(-1)[:L]
                     for r in range(n)])
    return out, errs, s


def np_scatter(segs, int4: bool = False):
    """The int8 (or int4) reduce-scatter of per-rank (n, L) segment
    stacks ``segs`` (n, n, L): the (n, L) stack of every rank's shard."""
    n, _, L = segs.shape
    qmax = 7 // n if int4 else 127 // n
    x4 = _blocks(np.asarray(segs, F32))                    # (n, n, nb, b)
    s = (np.abs(x4).max(axis=(0, 3)) / F32(qmax)).astype(F32)   # (n, nb)
    qsum = np.sum([np_grid(x4[r].reshape(-1, BLOCK), s.reshape(-1), qmax)
                   for r in range(n)], axis=0).reshape(x4.shape[1:])
    return (qsum.astype(F32) * s[:, :, None]).reshape(n, -1)[:, :L]


def np_topk(xs):
    """The top-k allreduce (ratio 0.01) of the rows of ``xs``: ``(sum,
    residuals)``, the sum added in rank order."""
    n, L = xs.shape
    k = max(1, min(L, int(round(L * 0.01))))
    dense, errs = np.zeros(L, F32), []
    for x in xs:
        idx = np.argsort(-np.abs(x), kind="stable")[:k]
        np.add.at(dense, idx, x[idx])
        e = x.copy()
        e[idx] = 0
        errs.append(e)
    return dense, np.stack(errs)


def _bits(got, want, what):
    np.testing.assert_array_equal(_f(got), _f(want), err_msg=what)


def _segments(x, n):
    """``x``'s leading dimension padded to ``ceil(d0/n)*n``, as (n, L)."""
    rows = -(-x.shape[0] // n) * n
    pad = np.zeros((rows - x.shape[0],) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad]).reshape(n, -1)


def check_lossy_allreduce(outs, n):
    """int8/int4/top-k allreduce (Sum, Average, error feedback) and the
    scale grid against the numpy codec; int8/int4 within the reference's
    own bound of n * scale / 2 of the exact sum."""
    outs = [o["lossy"] for o in outs]
    ins = [lossy_inputs(r, n) for r in range(n)]
    xs = np.stack([i["v"] for i in ins])
    exact = xs.astype(np.float64).sum(0)
    for mode in ("int8", "int4"):
        out, errs, s = np_dense_psum(xs, int4=mode == "int4")
        bound = np.repeat(n * s.astype(np.float64) / 2, BLOCK)[:xs.shape[1]]
        assert (np.abs(out - exact) <= bound + 1e-6).all()
        for r, o in enumerate(outs):
            _bits(o[f"{mode}_sum"], out, f"{mode} sum, rank {r}")
            _bits(o[f"{mode}_avg"], out / F32(n), f"{mode} average")
            got, err = o[f"{mode}_ef"]
            _bits(got, out, f"{mode} with error")
            _bits(err, errs[r], f"{mode} residual, rank {r}")
    out, errs = np_topk(xs)
    for r, o in enumerate(outs):
        _same(o["topk_sum"], out, n)
        _same(o["topk_avg"], out / F32(n), n)
        _same(o["topk_ef"][0], out, n)
        _bits(o["topk_ef"][1], errs[r], f"top-k residual, rank {r}")
    grid = np.stack([i["grid"] for i in ins]).sum(0)
    for o in outs:
        _bits(o["grid"], grid, "scale-grid input")


def check_lossy_grouped(outs, n):
    """One fused float32 int8 buffer for the float leaves (bf16 too), the
    int leaf summed exactly; the int4 grouped Average."""
    outs = [o["lossy"] for o in outs]
    ins = [lossy_inputs(r, n) for r in range(n)]
    bf = [_cast(i["gd"], torch.bfloat16) for i in ins]
    buf = np.stack([np.concatenate([i["ga"].ravel(), i["gb"], b])
                    for i, b in zip(ins, bf)])
    cuts = np.cumsum([120, 17])
    ints = np.sum([i["gc"] for i in ins], axis=0)
    for mode, key in (("int8", "grouped"), ("int4", "grouped_avg")):
        red, errs, _ = np_dense_psum(buf, int4=mode == "int4")
        if key == "grouped_avg":
            red = red / F32(n)
        a, b, d = np.split(red, cuts)
        for r, o in enumerate(outs):
            ga, gb, gd, gc = o[key]
            _bits(np.ravel(ga), a, f"{key} a")
            _bits(gb, b, f"{key} b")
            _bits(gd, _cast(d, torch.bfloat16), f"{key} bf16 leaf")
            if key == "grouped":
                np.testing.assert_array_equal(np.asarray(gc), ints)
                ea, eb, ed, ec = o["grouped_err"]
                _bits(np.concatenate([np.ravel(ea), eb, ed]), errs[r],
                      f"grouped residual, rank {r}")
                assert not np.any(ec)
                assert o["grouped_dtypes"] == [
                    "torch.float32", "torch.float32", "torch.bfloat16",
                    "torch.int32"]
            else:
                _bits(gc, ints.astype(F32) / F32(n), "int leaf average")


def check_lossy_scatter(outs, n):
    """reducescatter (none, int8, int4; 9 rows over 2 or 4 ranks, so the
    last shard holds zero pad rows), allgather and alltoall."""
    outs = [o["lossy"] for o in outs]
    ins = [lossy_inputs(r, n) for r in range(n)]
    segs = np.stack([_segments(i["rs"], n) for i in ins])       # (n, n, L)
    shard0 = -(-9 // n)
    want = {"none": segs.astype(np.float64).sum(0),
            "int8": np_scatter(segs), "int4": np_scatter(segs, True)}
    for r, o in enumerate(outs):
        for mode in RS_MODES:
            got = _f(o[f"rs_{mode}"])
            assert got.shape == (shard0, 5)
            w = want[mode][r].reshape(shard0, 5)
            if mode == "none":
                _same(got, w, n)
            else:
                _bits(got, w, f"reducescatter {mode}, rank {r}")
        _bits(o["rs_int8_avg"],
              want["int8"][r].reshape(shard0, 5) / F32(n),
              "reducescatter int8 average")
        _bits(o["allgather"], np.concatenate([i["ag"] for i in ins]),
              "allgather")
        _bits(o["alltoall"],
              np.concatenate([i["a2a"][2 * r:2 * r + 2] for i in ins]),
              "alltoall")


def check_lossy_optimizer(outs, n, res1=None):
    """Two ``DistributedOptimizer(sgd(0.1), compression=int8)`` steps
    with error feedback: the update is ``-0.1 *`` the int8 average of
    ``g + residual``.  ``res1`` replaces the port's step-1 residuals
    when the ranks loaded it before step 2."""
    outs = [o["lossy"] for o in outs]
    g = np.stack([lossy_inputs(r, n)["opt_g"] for r in range(n)])
    res = np.zeros_like(g)
    for step in (1, 2):
        red, errs, _ = np_dense_psum(g + res)
        u = (red / F32(n)) * F32(-0.1)
        for r, o in enumerate(outs):
            _bits(o[f"opt_u{step}"], u, f"optimizer update {step}")
            if step == 1 or res1 is None:
                _bits(o[f"opt_res{step}"], errs[r], f"residual {step}")
        res = errs if res1 is None else res1
    assert np.abs(errs).max() > 0


LOSSY_CHECKS = (check_lossy_allreduce, check_lossy_grouped,
                check_lossy_scatter, check_lossy_optimizer)


@pytest.mark.parametrize("check", LOSSY_CHECKS,
                         ids=lambda c: c.__name__[len("check_lossy_"):])
def test_lossy_wire(world, check):
    check(world[1], world[0])


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
        assert torch.equal(hvd.collectives.allreduce(x), x)
        assert torch.equal(hvd.collectives.allreduce(x, op=hvd.Sum), x)
    finally:
        hvd.shutdown()
    assert not hvd.is_initialized()


def test_size_above_one_needs_a_coordinator(monkeypatch):
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.delenv("HOROVOD_COORDINATOR_ADDR", raising=False)
    with pytest.raises(HorovodTpuError, match="COORDINATOR_ADDR"):
        hvd.init(device="cpu")


def test_unported_modes_raise(monkeypatch):
    x = torch.zeros(3)
    w = torch.nn.Parameter(torch.zeros(2))
    from horovod_tpu_torch.optim import fused_update as TF

    # no knob of the JAX package is refused any more: the health plane
    # and the adaptive guardrail's knobs, the last ones that raised, run
    # from every collective entry and the optimizer
    # (tests/test_torch_health.py holds them against the JAX package)
    for env in ("HOROVOD_ADAPTIVE_COMPRESSION", "HOROVOD_HEALTH",
                "HOROVOD_HEALTH_SKIP_NONFINITE"):
        monkeypatch.setenv(env, "1")
        for k in ("HOROVOD_SIZE", "HOROVOD_RANK"):
            monkeypatch.delenv(k, raising=False)
        hvd.init(device="cpu")
        try:
            hvd.collectives.allreduce(x, compression=hvd.Compression.int8)
            hvd.grouped_allreduce([x])
            hvd.collectives.reducescatter(x)
            hvd.collectives.allgather(x)
            hvd.collectives.alltoall(x)
            hvd.collectives.broadcast(x)
            hvd.DistributedOptimizer(TF.sgd([w], 0.1),
                                     compression=hvd.Compression.int8)
        finally:
            hvd.shutdown()
        monkeypatch.delenv(env)
    # HOROVOD_MESH=dp:1 now runs: a one-rank data mesh, every entry
    # reducing over its dp axis
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_MESH", "dp:1")
    hvd.init(device="cpu")
    try:
        y = torch.arange(3, dtype=torch.float32)
        assert torch.equal(hvd.collectives.allreduce(y, compression=hvd.Compression.int8),
                           y)
        assert torch.equal(hvd.grouped_allreduce([y])[0], y)
        assert torch.equal(hvd.collectives.reducescatter(y), y)
        assert torch.equal(hvd.collectives.allgather(y), y)
        assert torch.equal(hvd.collectives.alltoall(y), y)
        assert torch.equal(hvd.collectives.broadcast(y), y)
        assert torch.equal(hvd.collectives.allreduce(y, op=hvd.Adasum), y)
        w.grad = torch.ones(2)
        hvd.DistributedOptimizer(TF.sgd([w], 0.5),
                                 compression=hvd.Compression.int8).step()
        assert torch.equal(w.detach(), torch.full((2,), -0.5))
    finally:
        hvd.shutdown()


def test_integer_average_at_world_one_matches_jax(monkeypatch):
    """An int32 Average at world 1 through ``allreduce`` and
    ``grouped_allreduce`` returns the JAX package's dtype and values
    (float32: its ``out / size`` divides an integer sum at any world
    size); a float32 leaf keeps its dtype and values."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.ops import collectives as jcoll

    x = np.arange(6, dtype=np.int32) * 3 - 7
    f = np.linspace(-1.0, 1.0, 6, dtype=np.float32)

    def body(a, b):
        return (jcoll.allreduce(a, axis_name="hvd", op=jcoll.Average),
                jcoll.grouped_allreduce([a, b], axis_name="hvd",
                                        op=jcoll.Average))

    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("hvd"), P("hvd")),
                           out_specs=P("hvd"), check_vma=False))
    jone, jgroup = fn(jnp.asarray(x), jnp.asarray(f))
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK", "HOROVOD_COORDINATOR_ADDR"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    try:
        one = hvd.collectives.allreduce(torch.from_numpy(x), op=hvd.Average)
        group = hvd.grouped_allreduce([torch.from_numpy(x),
                                       torch.from_numpy(f)], op=hvd.Average)
    finally:
        hvd.shutdown()
    for got, want in zip([one, *group], [jone, *jgroup]):
        want = np.asarray(want)
        assert str(got.dtype) == f"torch.{want.dtype}"
        np.testing.assert_array_equal(got.numpy(), want)


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
