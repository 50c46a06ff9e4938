"""The training paths that ride the eager plane, on gloo worlds of 2 and 4
ranks (``tests/_torch_eager_training_worker.py``, one spawn per world
size) and in one process at world 1.

1. ``DistributedOptimizer(..., eager=True)`` at stages 0-3 against the
   in-trace stages bit for bit on dyadic data (every kind, the fused
   tail on and off), and against optax replicated at the reference's
   tolerance (``tests/test_zero23.py:676-716``: rtol 1e-6, atol 1e-8);
   stage 3's resident shard is the padded parameter count over the
   world; the calls per step of the tail's wrappers (one per dtype
   group: B1 on the card) and of the codec wrappers on the int8 wire
   (B4/B5, once per fused float response that quantizes) beside the
   negotiated responses.
2. At world 1, the same problem against the JAX package's eager regime
   (``horovod_tpu.DistributedOptimizer.update`` outside ``jit``).
3. At four ranks, the eager stages again under
   ``HOROVOD_CONTROL_FANOUT=2``: the hierarchical control plane gives the
   flat plane's results bit for bit.
4. At four ranks (cross 2 x local 2, H = 2), local SGD's eager regime
   (no axis pair) against the in-trace ``LocalSGD`` over the ``(dpc,
   dpl)`` pair bit for bit at dyadic values (``tests/
   test_torch_local_sgd.py`` holds that one against the JAX package),
   every inner step's transfers on the local groups
   only and every outer sync's on the cross groups only; stages 1-3
   refused.
"""

import numpy as np
import pytest
import torch

from _torch_collectives_worker import ZERO_KINDS, spawn
from _torch_eager_training_worker import OPTAX_STEPS

STAGES = (0, 1, 2, 3)
CHUNKS = 4          # HOROVOD_ZERO_PREFETCH_CHUNKS' default
LOCAL_GROUPS = ([0, 1], [2, 3])
CROSS_GROUPS = ([0, 2], [1, 3])


@pytest.fixture(scope="module", params=[2, 4], ids=["np2", "np4"])
def world(request):
    n = request.param
    return n, spawn(n, mode="eager_training", timeout=300)


def _f(v):
    return np.asarray(v, dtype=np.float32)


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("kind", ZERO_KINDS)
def test_eager_stages_match_in_trace(world, kind, stage, fused):
    n, outs = world
    key = f"{kind}_{stage}_{fused}"
    for r, o in enumerate(outs):
        for i, (got, want) in enumerate(zip(o["stages"]["eager_" + key],
                                            o["stages"]["trace_" + key])):
            np.testing.assert_array_equal(
                _f(got), _f(want), err_msg=f"{key} rank {r} leaf {i}")


def _optax_reference():
    import jax.numpy as jnp
    import optax

    p = {"w": jnp.linspace(-1.0, 1.0, 5), "b": jnp.zeros((3,))}
    target = jnp.arange(1.0, 6.0) / 4.0
    opt = optax.adam(0.1)
    s = opt.init(p)
    for _ in range(OPTAX_STEPS):
        g = {"w": 2.0 * (p["w"] - target), "b": jnp.ones((3,))}
        u, s = opt.update(g, s, p)
        p = optax.apply_updates(p, u)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("stage", STAGES)
def test_eager_stages_match_optax(world, stage):
    n, outs = world
    ref = _optax_reference()
    for r, o in enumerate(outs):
        got = o["optax"][str(stage)]
        for k in ("w", "b"):
            np.testing.assert_allclose(_f(got[k]), ref[k], rtol=1e-6,
                                       atol=1e-8,
                                       err_msg=f"stage {stage} rank {r} {k}")


def test_stage3_resident_is_the_padded_count_over_the_world(world):
    n, outs = world
    padded = 8 + (-8) % n            # w (5) and b (3): one float32 group
    for o in outs:
        assert o["optax"]["3"]["resident"] == padded // n
    if n == 2:
        assert outs[0]["optax"]["3"]["resident"] == 4


@pytest.mark.parametrize("comp", ["none", "int8"])
@pytest.mark.parametrize("stage", STAGES)
def test_launches_per_step(world, stage, comp):
    """One fused momentum step: one tail call per dtype group (the
    multi-leaf wrapper at stage 0, the flat one on the shard after);
    responses: one allreduce (stage 0), a reduce-scatter and an
    all-gather (stage 1), one of each per bucket (stages 2-3); on int8
    the codec calls of one negotiated response for each response that
    quantizes (allreduce, reduce-scatter), none for the gathers."""
    n, outs = world
    for o in outs:
        got = o["launches"][f"{stage}_{comp}"]
        calls = got["calls"]
        tail = "momentum_update_multi" if stage == 0 else "momentum_update"
        assert calls[tail] == 1, (stage, calls)
        assert sum(calls[k] for k in calls if "update" in k) == 1
        want_resp = {0: 1, 1: 2, 2: 2 * CHUNKS, 3: 2 * CHUNKS}[stage]
        assert got["responses"] == want_resp
        quantizing = {0: 1, 1: 1, 2: CHUNKS, 3: CHUNKS}[stage]
        one = o["one_response"]["allreduce" if stage == 0
                                else "reducescatter"]
        for k in ("quantize_values", "dequantize_values",
                  "quantize_pack4_values", "unpack_dequantize4_values"):
            want = one[k] * quantizing if comp == "int8" else 0
            assert calls[k] == want, (stage, comp, k, calls)
        if comp == "int8":
            assert calls["quantize_values"] == quantizing


def test_world1_matches_jax_eager():
    """World 1, in one process: the port's eager stages against the JAX
    package's ``DistributedOptimizer`` with ``update`` called on
    concrete arrays (its eager regime)."""
    import jax.numpy as jnp
    import optax

    import horovod_tpu as jhvd
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.optim import fused_update as TF

    jhvd.init()
    hvd.init(device="cpu")
    try:
        target = jnp.arange(1.0, 6.0) / 4.0
        tt = torch.arange(1.0, 6.0) / 4.0
        for stage in STAGES:
            params = {"w": jnp.linspace(-1.0, 1.0, 5), "b": jnp.zeros((3,))}
            jopt = jhvd.DistributedOptimizer(optax.adam(0.1),
                                             zero_stage=stage)
            if stage == 3:
                zp = jhvd.zero3_shard_params(params)
                s = jopt.init(zp)
                for _ in range(OPTAX_STEPS):
                    full = jhvd.zero3_full_params(zp)
                    g = {"w": 2.0 * (full["w"] - target),
                         "b": jnp.ones((3,))}
                    u, s = jopt.update(g, s, zp)
                    zp = optax.apply_updates(zp, u)
                jref = jhvd.zero3_full_params(zp)
            else:
                p = dict(params)
                s = jopt.init(p)
                for _ in range(OPTAX_STEPS):
                    g = {"w": 2.0 * (p["w"] - target), "b": jnp.ones((3,))}
                    u, s = jopt.update(g, s, p)
                    p = optax.apply_updates(p, u)
                jref = p
            w = torch.nn.Parameter(torch.linspace(-1.0, 1.0, 5))
            b = torch.nn.Parameter(torch.zeros(3))
            if stage == 3:
                zpt = hvd.zero3_shard_params([("w", w), ("b", b)])
                opt = hvd.DistributedOptimizer(TF.adam(zpt.shards, 0.1),
                                               zero_stage=3, eager=True)
                for _ in range(OPTAX_STEPS):
                    opt.zero_grad()
                    full = hvd.zero3_full_params(zpt, eager=True)
                    (((full["w"] - tt) ** 2).sum()
                     + full["b"].sum()).backward()
                    opt.step()
                full = hvd.zero3_full_params(zpt, eager=True)
                got = {k: full[k].detach().numpy() for k in ("w", "b")}
            else:
                opt = hvd.DistributedOptimizer(TF.adam([w, b], 0.1),
                                               zero_stage=stage, eager=True)
                for _ in range(OPTAX_STEPS):
                    w.grad = 2.0 * (w.detach() - tt)
                    b.grad = torch.ones(3)
                    opt.step()
                got = {"w": w.detach().numpy(), "b": b.detach().numpy()}
            for k in ("w", "b"):
                np.testing.assert_allclose(got[k], np.asarray(jref[k]),
                                           rtol=1e-6, atol=1e-8,
                                           err_msg=f"stage {stage} {k}")
    finally:
        hvd.shutdown()
        jhvd.shutdown()


@pytest.mark.parametrize("arg", ["compression", "axis_name"])
def test_zero3_full_params_eager_refuses_wire_arguments(arg):
    """``zero3_full_params(eager=True)`` gathers over the eager plane's
    world on the knob's wire, so a ``compression`` or ``axis_name`` it
    would ignore is refused; without one it gives the parameters."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.types import HorovodTpuError

    hvd.init(device="cpu")
    try:
        w = torch.nn.Parameter(torch.linspace(-1.0, 1.0, 5))
        zp = hvd.zero3_shard_params([("w", w)])
        bad = {"compression": hvd.Compression.int8, "axis_name": "hvd"}
        with pytest.raises(HorovodTpuError, match="pass no compression "
                           "or axis_name"):
            hvd.zero3_full_params(zp, eager=True, **{arg: bad[arg]})
        full = hvd.zero3_full_params(zp, eager=True)
        assert torch.equal(full["w"], torch.linspace(-1.0, 1.0, 5))
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("stage", STAGES)
def test_hierarchical_plane_matches_flat(world, stage):
    n, outs = world
    for r, o in enumerate(outs):
        if n == 2:
            # a world of 2 is below any fanout: the plane stays flat
            assert "hier" not in o
            continue
        assert o["hier_slice"] == [2, 2]
        for key in o["stages"]:
            if key.startswith("eager_") and f"_{stage}_" in key:
                for got, want in zip(o["hier"][key], o["stages"][key]):
                    np.testing.assert_array_equal(
                        _f(got), _f(want), err_msg=f"{key} rank {r}")


def test_eager_local_sgd_matches_the_pair(world):
    n, outs = world
    for r, o in enumerate(outs):
        if n == 2:
            assert "ls_eager" not in o
            continue
        eager, trace = o["ls_eager"], o["ls_trace"]
        assert eager["eager"] and not trace["eager"]
        for got, want in zip(eager["w"], trace["w"]):
            np.testing.assert_array_equal(_f(got), _f(want),
                                          err_msg=f"rank {r}")


def test_eager_local_sgd_keeps_inner_steps_off_the_cross_hop(world):
    n, outs = world
    for r, o in enumerate(outs):
        if n == 2:
            continue
        groups = o["ls_eager"]["groups"]
        for step, g in enumerate(groups, start=1):
            assert g["inner"] and all(list(x) in LOCAL_GROUPS
                                      for x in g["inner"]), (r, step, g)
            assert g["synced"] == (step % 2 == 0)
            if g["synced"]:
                assert g["outer"] and all(list(x) in CROSS_GROUPS
                                          for x in g["outer"]), (r, step, g)
            else:
                assert g["outer"] == []


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_eager_local_sgd_refuses_zero(world, stage):
    n, outs = world
    for o in outs:
        if n == 2:
            continue
        msg = o[f"ls_refuse_{stage}"]
        assert msg and "zero_stage=0 only" in msg
