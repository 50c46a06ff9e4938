"""The port's eager plane across processes, against the JAX package's.

One spawned gloo world of 4 ranks (``tests/_torch_eager_worker.py``)
runs, on inputs seeded by rank:

1. ``tests/test_multiprocess.py:90-160``'s cases at 4 ranks: out-of-order
   async submissions, a ragged allgather, a broadcast from rank 1 (bool
   too), ``broadcast_object``, a shape mismatch raising the coordinator's
   message on every rank with the runtime usable afterwards, and ``join``
   with uneven work returning the last rank to join; plus reducescatter
   (Sum and Average, 9 rows zero-padded to 3 per rank), alltoall, Adasum
   (against the JAX package's ``adasum_reference``), an int32 Average
   (truncated, the payload dtype kept) and a bf16 sum.
2. The int8 and int4 wire (``HOROVOD_COMPRESSION``) on a fused response
   of three float32 tensors: each executed response within one scale and
   2 ulps of the JAX package's ``xla_exec._build_allreduce`` on a
   4-device CPU mesh (the allowance of the codec tests,
   ``tests/test_torch_quantization.py``), every rank the same bits.
3. The frontend's hook-driven ``DistributedOptimizer`` over 3 SGD steps
   within 1e-6 relative of the port's in-trace ``DistributedOptimizer``
   (stage 0, the same SGD, the none wire) on the same world, every rank
   identical after every step.
4. The top-level names' repair (ROADMAP.md Queue C): after the world
   splits into two worlds of 2 ranks, the positional
   ``hvd.allreduce(x, hvd.Sum)`` is the JAX package's Average (its second
   positional argument is ``average``); re-initialized under
   ``HOROVOD_MESH=dp:2,tp:2``, ``hvd.allreduce`` raises the JAX package's
   message.  At world 2 the frontend's optimizer equals the in-trace one
   bit for bit.
"""

import os
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from horovod_tpu.common.types import HorovodTpuError
from horovod_tpu.ops import adasum as jadasum
from horovod_tpu.ops import eager as jeager
from horovod_tpu.ops import xla_exec

from horovod_tpu_torch.ops import quantization as Q

sys.path.insert(0, os.path.dirname(__file__))
from _torch_collectives_worker import spawn  # noqa: E402
from _torch_eager_worker import (LOSSY_SHAPES, SGD_STEPS,  # noqa: E402
                                 eager_inputs)

N = 4
BLOCK = 256


@pytest.fixture(scope="module")
def world():
    return spawn(N, mode="eager", timeout=240)


def _f(v):
    return np.asarray(v, np.float32)


def _stack(key):
    return np.stack([eager_inputs(r)[key] for r in range(N)])


def test_every_rank_agrees(world):
    for key in ("sum", "positional", "bf16", "ab", "inplace", "ragged",
                "bcast", "bcast_bool", "adasum", "join", "int8", "int4"):
        for o in world[1:]:
            assert o[key] == world[0][key], key


def test_allreduce_sum_average_and_dtypes(world):
    x = _stack("x")
    for o in world:
        np.testing.assert_allclose(_f(o["sum"]), x.sum(0), rtol=1e-6)
        np.testing.assert_allclose(_f(o["positional"]), x.sum(0) / N,
                                   rtol=1e-6)
        assert o["inplace_is_input"]
        np.testing.assert_allclose(_f(o["inplace"]), x.sum(0), rtol=1e-6)
        # int32 Average: the sum divided, truncated, in the payload dtype
        # (xla_exec.py:_build_allreduce)
        i = _stack("i").astype(np.int64).sum(0)
        assert o["avg_int_dtype"] == "torch.int32"
        assert o["avg_int"] == np.trunc(i / N).astype(np.int32).tolist()
        # bf16: each of the N - 1 adds rounds to 8 bits
        bf = np.asarray(jnp.asarray(_stack("bf")).astype(jnp.bfloat16)
                        .astype(jnp.float32))
        assert (np.abs(_f(o["bf16"]) - bf.sum(0))
                <= N * 2 ** -8 * np.abs(bf).sum(0)).all()


def test_out_of_order_async_and_mismatch(world):
    for o in world:
        assert o["ab"] == [[4.0] * 8, [8.0] * 8]
        # _MessageTable's message; the first rank to submit gives the
        # table its shape, so either order
        assert o["mismatch"] in (
            "Mismatched shapes for tensor bad: (4,) vs (5,).",
            "Mismatched shapes for tensor bad: (5,) vs (4,).")
        assert o["mismatch"] == world[0]["mismatch"]
        assert o["after"] == [4.0, 4.0]


def test_allgather_broadcast_object(world):
    want = np.concatenate([np.full((r + 1, 3), float(r)) for r in range(N)])
    for o in world:
        np.testing.assert_array_equal(_f(o["ragged"]), want)
        assert o["bcast"] == [10.0] * 5
        assert o["bcast_bool"] == [0.0, 1.0, 0.0]
        assert o["object"] == {"x": 42, "r": 0}


def test_reducescatter_alltoall_adasum(world):
    rs = _stack("rs")
    padded = np.concatenate([rs.sum(0), np.zeros((3, 5), np.float32)])
    a2a = _stack("a2a")
    ref = jadasum.adasum_reference([_stack("ada")[r] for r in range(N)])
    for r, o in enumerate(world):
        np.testing.assert_allclose(_f(o["rs"]), padded[3 * r:3 * r + 3],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_f(o["rs_avg"]),
                                   padded[3 * r:3 * r + 3] / N,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(
            _f(o["a2a"]),
            np.concatenate([a2a[s][2 * r:2 * r + 2] for s in range(N)]))
        np.testing.assert_allclose(_f(o["adasum"]), ref, rtol=1e-4)


def test_join_with_uneven_work(world):
    for r, o in enumerate(world):
        assert o["join"] == N - 1
        # the joined ranks contributed zeros
        assert o["extra"] == ([[6.0] * 3] * 2 if r == N - 1 else [])


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_lossy_fused_response_matches_xla_exec(world, mode):
    case = world[0][mode]
    assert any(len(resp["names"]) > 1 for resp in case["responses"])
    attempt = case["attempt"]
    inputs = [eager_inputs(r)["lossy"] for r in range(N)]
    index = {f"{mode}.{attempt}.{i}": i for i in range(len(LOSSY_SHAPES))}
    mesh = Mesh(np.array(jax.devices()[:N]), ("hvd",))
    qmax = Q.sum_safe_qmax(N) if mode == "int8" else Q.sum_safe_qmax4(N)
    for resp in case["responses"]:
        idx = [index[n] for n in resp["names"]]
        shapes = tuple(LOSSY_SHAPES[i] for i in idx)
        fn = xla_exec._build_allreduce(mesh, shapes, xla_exec._AVERAGE, N,
                                       None, ((mode,), BLOCK, 0))
        outs = fn(*[jnp.asarray(np.stack([inputs[r][i] for r in range(N)]))
                    for i in idx])
        outs = outs if isinstance(outs, tuple) else (outs,)
        want = np.concatenate([np.asarray(w).reshape(-1) for w in outs])
        got = np.concatenate([_f(g).reshape(-1) for g in resp["outs"]])
        flat = np.stack([np.concatenate([inputs[r][i].reshape(-1)
                                         for i in idx]) for r in range(N)])
        pad = (-flat.shape[1]) % BLOCK
        blocks = np.abs(np.pad(flat, ((0, 0), (0, pad)))).reshape(
            N, -1, BLOCK).max(2).max(0) / qmax
        scale = np.repeat(blocks, BLOCK)[:got.size]
        tol = scale + 2 * np.spacing(np.abs(want))
        assert (np.abs(got - want) <= tol).all(), mode


def _rel(a, b) -> float:
    a, b = _f(a), _f(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_frontend_optimizer_matches_in_trace(world):
    for o in world:
        run = o["sgd4"]
        assert len(run["eager"]) == SGD_STEPS
        for step_e, step_i in zip(run["eager"], run["intrace"]):
            for a, b in zip(step_e, step_i):
                assert _rel(a, b) <= 1e-6
        assert run["eager"] == world[0]["sgd4"]["eager"]
        # at world 2, bit for bit
        assert o["sgd2"]["eager"] == o["sgd2"]["intrace"]


def test_positional_sum_is_the_jax_average(world):
    """The repaired fault: the second positional argument of the
    top-level ``allreduce`` is ``average`` on the JAX package, so
    ``hvd.allreduce(x, hvd.Sum)`` averages (world 2: bit for bit with
    ``(x0 + x1) / 2``)."""
    x = _stack("x")
    for r, o in enumerate(world):
        pair = (r // 2) * 2
        want = (jnp.asarray(x[pair]) + jnp.asarray(x[pair + 1])) / 2
        np.testing.assert_array_equal(_f(o["pair_positional"]),
                                      np.asarray(want))


def test_allreduce_refuses_a_model_parallel_mesh(world, monkeypatch):
    """The repaired fault: under ``HOROVOD_MESH=dp:2,tp:2`` the eager
    ``hvd.allreduce`` raises the JAX package's message."""
    from horovod_tpu.common import basics as jbasics

    monkeypatch.setenv("HOROVOD_MESH", "dp:2,tp:2")
    monkeypatch.setattr(jbasics, "state", lambda: types.SimpleNamespace(
        initialized=True, data_axes=None))
    with pytest.raises(HorovodTpuError) as exc:
        jeager._runtime()
    for o in world:
        assert o["mesh_refusal"] == str(exc.value)
