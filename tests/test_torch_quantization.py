"""The port's lossy gradient wire (``horovod_tpu_torch.ops.quantization``,
``Compression.int8/int4/topk``) against the JAX package, on the CPU.

1. The plain versions of kernels B4-B7 against the interpreted Pallas
   kernels, called directly with the scales as inputs: bit for bit.
2. The compressors' standalone round trips against the JAX package's,
   eager: bit for bit.
3. The reductions on spawned gloo worlds of 2 and 4 ranks against the
   JAX package under ``shard_map`` on n of the 8 CPU devices, same
   per-rank inputs.  Under ``jit`` XLA-CPU rewrites ``absmax / qmax``
   into ``absmax * (1/qmax)``, so a shared scale may sit 1 ulp off the
   port's true division.  Blocks whose scale is equal on both sides are
   held bit for bit; a block whose scale moved is held to one shared
   scale per element.  Every output is also within the reference's own
   bound of ``n * scale / 2`` of the exact sum.  Top-k is bit for bit
   with two ranks and within rtol 1e-6 with four (the sum order of the
   scatter-add).
4. World-1 shortcuts, the headroom refusals, Adasum, accumulation
   without feedback, and the residual interop.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.ops import quantization as jq
from horovod_tpu.ops.compression import Compression as JCompression

import horovod_tpu_torch as hvd
from horovod_tpu_torch import interop
from horovod_tpu_torch.ops import quantization as Q
from horovod_tpu_torch.optim import fused_update as TF

sys.path.insert(0, os.path.dirname(__file__))
from _torch_collectives_worker import (RS_MODES, lossy_inputs,  # noqa: E402
                                       spawn)
from test_torch_collectives import _f, _same, _segments  # noqa: E402

BLOCK = 256


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scales(x2d, qmax):
    return (np.abs(x2d).max(1) / np.float32(qmax)).astype(np.float32)


# ---------------------------------------------------------------------------
# 1. B4-B7: plain versions against the interpreted Pallas kernels
# ---------------------------------------------------------------------------


def _kernel_inputs(kernel: str, nb: int, qmax: int, kind: str):
    rng = np.random.default_rng(nb * 100 + qmax)
    x = rng.standard_normal((nb, BLOCK)).astype(np.float32)
    s = _scales(x, qmax)
    if kind == "ties":
        # block 0: exact .5 ties under a power-of-two scale
        s[0] = np.float32(2.0 ** -3)
        k = rng.integers(-qmax, qmax, BLOCK).astype(np.float32)
        x[0] = (k + np.float32(0.5)) * s[0]
        # block 1: all zero, scale 0
        x[1], s[1] = 0.0, 0.0
    if kernel in ("quantize", "pack4"):
        return x, s
    if kernel == "dequantize":
        q = rng.integers(-qmax, qmax + 1, (nb, BLOCK)).astype(np.int8)
        if kind == "int32_sums":
            q = (q.astype(np.int32) * 4 - 3 * qmax).astype(np.int32)
        return q, s
    # unpack4: packed bytes, or the int8 sum of four ranks' packed bytes
    # at their sum-safe headroom (negative partial sums included)
    ranks = 4 if kind == "summed" else 1
    qm = 7 // ranks
    grid = rng.integers(-qm, qm + 1, (ranks, nb, BLOCK)).astype(np.int32)
    half = BLOCK // 2
    packed = (grid[:, :, half:] * 16 + grid[:, :, :half]).astype(np.int8)
    p = packed.sum(0, dtype=np.int8)
    assert np.array_equal(p, packed.astype(np.int64).sum(0))  # no wrap
    return p, s


KERNEL_CASES = (
    [("quantize", nb, qm, kind) for nb in (5, 33) for qm in (127, 63, 31)
     for kind in ("normal", "ties")]
    + [("dequantize", nb, qm, kind) for nb in (5, 33) for qm in (127, 31)
       for kind in ("int8", "int32_sums")]
    + [("pack4", nb, qm, kind) for nb in (5, 33) for qm in (7, 3, 1)
       for kind in ("normal", "ties")]
    + [("unpack4", nb, 7, kind) for nb in (5, 33)
       for kind in ("packed", "summed")])


@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_interpreted_pallas(case):
    kernel, nb, qmax, kind = case
    a, s = _kernel_inputs(kernel, nb, qmax, kind)
    ja, js = jnp.asarray(a), jnp.asarray(s)
    if kernel == "quantize":
        want = jq._quantize_pallas_call(ja, js, qmax, True)
        got = Q.quantize_values(_t(a), _t(s), qmax)
    elif kernel == "dequantize":
        want = jq._dequantize_pallas_call(ja, js, True)
        got = Q.dequantize_values(_t(a), _t(s))
    elif kernel == "pack4":
        want = jq._pack4_pallas_call(ja, js, qmax, True)
        got = Q.quantize_pack4_values(_t(a), _t(s), qmax)
    else:
        want = jq._unpack4_pallas_call(ja, js, True)
        got = Q.unpack_dequantize4_values(_t(a), _t(s))
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# 2. The compressors' round trips against the JAX package's, eager
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1024,), (3, 333), (7,)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", ["int8", "int4", "topk"])
def test_compressor_round_trip_matches_jax(mode, shape, dtype):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = _t(x).to(getattr(torch, dtype))
    jc, tc = (getattr(c, mode) for c in (JCompression, hvd.Compression))
    jw, jctx = jc.compress(jx)
    tw, tctx = tc.compress(tx)
    back = tc.decompress(tw, tctx)
    want = np.asarray(jc.decompress(jw, jctx).astype(jnp.float32))
    assert back.dtype == tx.dtype and back.shape == tx.shape
    np.testing.assert_array_equal(back.float().numpy(), want)
    if mode == "topk":
        np.testing.assert_array_equal(np.sort(tw[0].numpy()),
                                      np.sort(np.asarray(jw[0])))
        return
    np.testing.assert_array_equal(tw[0].numpy(), np.asarray(jw[0]))
    np.testing.assert_array_equal(tw[1].numpy(), np.asarray(jw[1]))
    assert tctx == jctx._replace(dtype=tx.dtype)
    if dtype == "float32":  # |x - dq(q(x))| <= scale / 2 per element
        err = np.abs(back.numpy() - x).reshape(-1)
        half = np.repeat(tw[1].numpy() / 2, BLOCK)[:err.size]
        assert (err <= half + 1e-7).all()


@pytest.mark.parametrize("mode", ["int8", "int4", "topk"])
def test_integer_and_bool_tensors_pass_through(mode):
    comp = hvd.Compression.lookup(mode)
    for t in (torch.arange(8, dtype=torch.int32),
              torch.tensor([True, False, True])):
        wire, ctx = comp.compress(t)
        assert wire is t and ctx is None
        assert comp.decompress(wire, ctx) is t


# ---------------------------------------------------------------------------
# 3. Multi-rank reductions against the JAX package under shard_map
# ---------------------------------------------------------------------------


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("hvd",))


def _run(n, body, *xs, out_specs=P()):
    fn = jax.jit(shard_map(body, mesh=_mesh(n), check_vma=False,
                           in_specs=(P("hvd"),) * len(xs),
                           out_specs=out_specs))
    return jax.tree_util.tree_map(np.asarray, fn(*map(jnp.asarray, xs)))


def _jax_scales(n, xs, qmax):
    """The JAX package's shared scales of the rows of ``xs`` (n, L), as
    its reductions compute them under ``jit``."""
    return _run(n, lambda b: lax.pmax(jq.block_absmax(
        jq._to_blocks(b[0], BLOCK)[0]), "hvd") / qmax, xs)


def _jax_seg_scales(n, segs, qmax):
    """Per-(segment, block) shared scales of the reduce-scatter."""
    def body(b):
        x = b[0]
        pad = (-x.shape[1]) % BLOCK
        x3 = jnp.pad(x, ((0, 0), (0, pad))).reshape(n, -1, BLOCK)
        return lax.pmax(jnp.max(jnp.abs(x3), axis=2), "hvd") / qmax
    return _run(n, body, segs)


def _hold_blocks(got, want, port_s, jax_s, what, moved, qmax=None):
    """Bit for bit in every block whose scale agrees; one shared scale
    per element where XLA's rewrite moved it.  A residual (``qmax``
    given) is held in the agreeing blocks to two ulps of the block's
    largest dequantized value: under ``jit`` XLA-CPU also contracts
    ``x - q * s`` into one fused multiply-add, where the port (and the
    Pallas kernels' materialised dequantize) rounds ``q * s`` first.
    ``moved`` collects (moved, total) block counts."""
    got = _f(got).reshape(-1)
    want = np.asarray(want, np.float32).reshape(-1)
    same = np.repeat(port_s == jax_s, BLOCK)[:got.size]
    if qmax is None:
        np.testing.assert_array_equal(got[same], want[same], err_msg=what)
    else:
        ulp2 = 2 * np.spacing(np.float32(qmax) * port_s)
        tol = np.repeat(ulp2, BLOCK)[:got.size][same]
        assert (np.abs(got[same] - want[same]) <= tol).all(), what
    tol = np.repeat(port_s, BLOCK)[:got.size][~same]
    assert (np.abs(got[~same] - want[~same]) <= tol).all(), what
    moved[0] += int(np.sum(port_s != jax_s))
    moved[1] += port_s.size


@pytest.fixture(scope="module", params=[2, 4], ids=["np2", "np4"])
def wire(request, tmp_path_factory):
    """The JAX package's two int8 optimizer steps, then n port ranks
    that start step 2 from the JAX residual."""
    import optax
    from horovod_tpu.optim import distributed as jdist

    n = request.param
    g = np.stack([lossy_inputs(r, n)["opt_g"] for r in range(n)])
    opt = jdist.DistributedOptimizer(optax.sgd(0.1),
                                     compression=JCompression.int8,
                                     op=jcoll.Average, axis_name="hvd")
    params = {"w": jnp.zeros(256, jnp.float32)}
    inner = opt.init(params).inner_state

    def step(gl, res, inner):
        st = jdist._FeedbackState({"w": res[0]}, inner)
        upd, new = opt.update({"w": gl[0]}, st, params)
        return upd["w"], new.residual["w"][None], new.inner_state

    fn = jax.jit(shard_map(step, mesh=_mesh(n), check_vma=False,
                           in_specs=(P("hvd"), P("hvd"), P()),
                           out_specs=(P(), P("hvd"), P())))
    res0 = jnp.zeros((n, 256), jnp.float32)
    u1, res1, inner = fn(jnp.asarray(g), res0, inner)
    u2, res2, _ = fn(jnp.asarray(g), res1, inner)
    path = tmp_path_factory.mktemp("feedback") / f"res1_np{n}.npy"
    np.save(path, np.asarray(res1))
    outs = spawn(n, env_extra={"HVD_TEST_FEEDBACK": str(path)})
    jax_opt = {"g": g, "u1": np.asarray(u1), "res1": np.asarray(res1),
               "u2": np.asarray(u2), "res2": np.asarray(res2)}
    return n, [o["lossy"] for o in outs], jax_opt


def _report(what, moved):
    print(f"{what}: {moved[0]} of {moved[1]} blocks had a scale moved by "
          f"XLA's rewrite ({moved[0] / max(moved[1], 1):.3f})")


@pytest.mark.parametrize("op", ["Sum", "Average"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_dense_allreduce_matches_jax(wire, mode, op):
    n, outs, _ = wire
    xs = np.stack([lossy_inputs(r, n)["v"] for r in range(n)])
    qmax = 127 // n if mode == "int8" else 7 // n
    want, werr = _run(n, lambda b: jcoll.quantized_allreduce(
        b[0], axis_name="hvd", op=getattr(jcoll, op), with_error=True,
        mode=mode), xs, out_specs=(P(), P("hvd")))
    werr = werr.reshape(n, -1)
    port_s = _scales(np.pad(xs, ((0, 0), (0, 24))).reshape(-1, BLOCK),
                     1).reshape(n, -1).max(0) / np.float32(qmax)
    port_s = port_s.astype(np.float32)
    jax_s = _jax_scales(n, xs, qmax)
    moved = [0, 0]
    key = f"{mode}_{'sum' if op == 'Sum' else 'avg'}"
    exact = xs.astype(np.float64).sum(0) / (n if op == "Average" else 1)
    bound = np.repeat(n * port_s.astype(np.float64) / 2, BLOCK)[:1000]
    bound /= n if op == "Average" else 1
    for r, o in enumerate(outs):
        _hold_blocks(o[key], want, port_s, jax_s, f"{key} rank {r}", moved)
        assert (np.abs(_f(o[key]) - exact) <= bound + 1e-6).all()
        if op == "Sum":
            got, err = o[f"{mode}_ef"]
            _hold_blocks(got, want, port_s, jax_s, f"{mode} ef", moved)
            _hold_blocks(err, werr[r], port_s, jax_s,
                         f"{mode} residual rank {r}", moved, qmax)
    _report(f"{mode} {op} np{n}", moved)
    if op == "Sum":
        # which form the reference's residual takes under jit: x - q*s
        # rounded once (a fused multiply-add) or twice (as written)
        x3 = np.pad(xs, ((0, 0), (0, 24))).reshape(n, -1, BLOCK)
        s3 = jax_s[None, :, None]
        inv = np.float32(1) / np.where(s3 > 0, s3, np.float32(1))
        q = np.clip(np.rint(x3 * inv.astype(np.float32)), -qmax, qmax)
        fma = (x3 - q * s3.astype(np.float64)).astype(np.float32)
        two = x3 - (q.astype(np.float32) * s3)
        fma, two = (a.reshape(n, -1)[:, :1000] for a in (fma, two))
        print(f"{mode} np{n}: the JAX residual equals x - q*s rounded once "
              f"in {np.mean(fma == werr):.4f} of its values, rounded twice "
              f"in {np.mean(two == werr):.4f}")


def test_scale_grid_is_exact(wire):
    n, outs, _ = wire
    xs = np.stack([lossy_inputs(r, n)["grid"] for r in range(n)])
    want = _run(n, lambda b: jcoll.quantized_allreduce(
        b[0], axis_name="hvd", op=jcoll.Sum), xs)
    np.testing.assert_array_equal(want, xs.sum(0))
    for o in outs:
        np.testing.assert_array_equal(_f(o["grid"]), xs.sum(0))


@pytest.mark.parametrize("op", ["Sum", "Average"])
def test_topk_allreduce_matches_jax(wire, op):
    n, outs, _ = wire
    xs = np.stack([lossy_inputs(r, n)["v"] for r in range(n)])
    want, werr = _run(n, lambda b: jcoll.quantized_allreduce(
        b[0], axis_name="hvd", op=getattr(jcoll, op), with_error=True,
        mode="topk"), xs, out_specs=(P(), P("hvd")))
    werr = werr.reshape(n, -1)
    key = "topk_sum" if op == "Sum" else "topk_avg"
    for r, o in enumerate(outs):
        _same(o[key], want, n)
        if op == "Sum":
            _same(o["topk_ef"][0], want, n)
            np.testing.assert_array_equal(_f(o["topk_ef"][1]), werr[r])


def test_grouped_quantized_allreduce_matches_jax(wire):
    n, outs, _ = wire
    ins = [lossy_inputs(r, n) for r in range(n)]
    st = {k: np.stack([i[k] for i in ins]) for k in ("ga", "gb", "gd", "gc")}

    def body(a, b, d, c):
        o, e = jcoll.grouped_quantized_allreduce(
            [a[0], b[0], d[0].astype(jnp.bfloat16), c[0]],
            axis_name="hvd", op=jcoll.Sum, with_error=True)
        return tuple(x.astype(jnp.float32) for x in o), \
            tuple(x[None] for x in e)

    want, werr = _run(n, body, st["ga"], st["gb"], st["gd"], st["gc"],
                      out_specs=((P(),) * 4, (P("hvd"),) * 4))
    bf = np.stack([np.asarray(jnp.asarray(i["gd"]).astype(jnp.bfloat16)
                              .astype(jnp.float32)) for i in ins])
    buf = np.concatenate([st["ga"].reshape(n, -1), st["gb"], bf], axis=1)
    port_s = (np.abs(np.pad(buf, ((0, 0), (0, 256 - buf.shape[1] % 256)))
                     .reshape(n, -1, BLOCK)).max((0, 2))
              / np.float32(127 // n)).astype(np.float32)
    jax_s = _jax_scales(n, buf, 127 // n)
    moved = [0, 0]
    wflat = np.concatenate([w.reshape(-1) for w in want[:3]])
    for r, o in enumerate(outs):
        got = np.concatenate([_f(x).reshape(-1) for x in o["grouped"][:3]])
        gerr = np.concatenate([_f(x).reshape(-1)
                               for x in o["grouped_err"][:3]])
        wr = np.concatenate([w.reshape(n, -1)[r] for w in werr[:3]])
        if np.array_equal(port_s, jax_s):
            np.testing.assert_array_equal(got, wflat)
        else:  # the bf16 leaf rounds after the sum: one scale, then bf16
            bound = np.repeat(port_s, BLOCK)[:got.size] * 1.01
            assert (np.abs(got - wflat) <= bound).all()
        _hold_blocks(gerr, wr, port_s, jax_s, "grouped residual", moved,
                     127 // n)
        np.testing.assert_array_equal(np.asarray(o["grouped"][3]), want[3])
        assert not np.any(werr[3]) and not np.any(o["grouped_err"][3])
    _report(f"grouped np{n}", moved)


@pytest.mark.parametrize("mode", RS_MODES)
def test_reducescatter_matches_jax(wire, mode):
    n, outs, _ = wire
    xs = np.stack([lossy_inputs(r, n)["rs"] for r in range(n)])
    comp = getattr(JCompression, mode)
    want = _run(n, lambda b: jcoll.reducescatter(
        b[0], axis_name="hvd", op=jcoll.Sum, compression=comp), xs,
        out_specs=P("hvd"))
    shard0 = -(-9 // n)
    want = want.reshape(n, shard0, 5)
    if mode == "none":
        for r, o in enumerate(outs):
            _same(o["rs_none"], want[r], n)
        return
    segs = np.stack([_segments(x, n) for x in xs])     # (n ranks, n, L)
    qmax = 127 // n if mode == "int8" else 7 // n
    L = segs.shape[2]
    pad = (-L) % BLOCK
    x4 = np.pad(segs, ((0, 0), (0, 0), (0, pad))).reshape(n, n, -1, BLOCK)
    port_s = (np.abs(x4).max((0, 3)) / np.float32(qmax)).astype(np.float32)
    jax_s = _jax_seg_scales(n, segs, qmax)
    moved = [0, 0]
    for r, o in enumerate(outs):
        _hold_blocks(o[f"rs_{mode}"], want[r], port_s[r], jax_s[r],
                     f"reducescatter {mode} rank {r}", moved)
    _report(f"reducescatter {mode} np{n}", moved)


def test_allgather_and_alltoall_match_jax(wire):
    n, outs, _ = wire
    ins = [lossy_inputs(r, n) for r in range(n)]
    ag = _run(n, lambda b: jcoll.allgather(b[0], axis_name="hvd"),
              np.stack([i["ag"] for i in ins]))
    a2a = _run(n, lambda b: jcoll.alltoall(b[0], axis_name="hvd")[None],
               np.stack([i["a2a"] for i in ins]), out_specs=P("hvd"))
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(_f(o["allgather"]), ag)
        np.testing.assert_array_equal(_f(o["alltoall"]), a2a[r])


def test_distributed_optimizer_int8_matches_jax(wire):
    """Two steps of ``DistributedOptimizer(compression=int8)`` with error
    feedback (``test_quantization.py:305-341``'s construction, optax
    ``sgd(0.1)`` against the port's ``fused_update.sgd``); both start
    step 2 from the JAX residual (``interop.feedback_from_jax``)."""
    n, outs, j = wire
    qmax = 127 // n
    g = j["g"]
    moved = [0, 0]
    for step, inp in ((1, g), (2, g + j["res1"])):
        port_s = (np.abs(inp.reshape(n, -1, BLOCK)).max((0, 2))
                  / np.float32(qmax)).astype(np.float32)
        jax_s = _jax_scales(n, inp, qmax)
        for r, o in enumerate(outs):
            _hold_blocks(o[f"opt_u{step}"], j[f"u{step}"], 0.1 * port_s,
                         0.1 * jax_s, f"update {step}", moved)
            _hold_blocks(o[f"opt_res{step}"], j[f"res{step}"][r], port_s,
                         jax_s, f"residual {step} rank {r}", moved, qmax)
        if step == 1:  # within the reference's bound of full-precision SGD
            bound = np.repeat(0.1 * port_s / 2, BLOCK) + 1e-6
            assert (np.abs(_f(outs[0]["opt_u1"]) + 0.1 * g.mean(0))
                    <= bound).all()
    _report(f"optimizer np{n}", moved)


# ---------------------------------------------------------------------------
# 4. One rank: shortcuts, refusals, accumulation, interop
# ---------------------------------------------------------------------------


@pytest.fixture()
def world1(monkeypatch):
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.mark.parametrize("mode", ["int8", "int4", "topk"])
def test_world_of_one_is_an_identity(world1, monkeypatch, mode):
    calls = []
    for name in ("quantize_values", "dequantize_values",
                 "quantize_pack4_values", "unpack_dequantize4_values"):
        monkeypatch.setattr(Q, name, lambda *a, name=name:
                            calls.append(name))
    x = torch.randn(3, 300).to(torch.bfloat16)
    out, err = hvd.quantized_allreduce(x, op=hvd.Sum, with_error=True,
                                       mode=mode)
    assert torch.equal(out, x) and out.dtype == x.dtype
    assert err.dtype == torch.float32 and not err.any()
    outs, errs = hvd.grouped_quantized_allreduce(
        [x, torch.arange(4)], with_error=True, mode=mode)
    assert torch.equal(outs[0], x) and torch.equal(outs[1], torch.arange(4))
    assert not any(e.any() for e in errs)
    comp = hvd.Compression.lookup(mode)
    assert torch.equal(hvd.collectives.allreduce(x, compression=comp), x)
    assert torch.equal(hvd.collectives.reducescatter(x, compression=comp), x)
    assert calls == []


def test_headroom_refusals():
    for n in (1, 2, 3, 4, 8, 127):
        assert 1 <= Q.sum_safe_qmax(n) and n * Q.sum_safe_qmax(n) <= 127
    for n in (1, 2, 7):
        assert 1 <= Q.sum_safe_qmax4(n) and n * Q.sum_safe_qmax4(n) <= 7
    with pytest.raises(ValueError, match="sum-safe"):
        Q.sum_safe_qmax(128)
    with pytest.raises(ValueError, match="sum-safe"):
        Q.sum_safe_qmax4(8)
    with pytest.raises(ValueError, match="even"):
        Q.quantize4_block_scaled(torch.zeros(10), block_size=5)


@pytest.mark.parametrize("mode", ["int8", "int4", "topk"])
def test_adasum_with_a_lossy_codec_raises(world1, mode):
    comp = hvd.Compression.lookup(mode)
    x = torch.zeros(4)
    with pytest.raises(hvd.HorovodTpuError, match="Adasum"):
        hvd.collectives.allreduce(x, op=hvd.Adasum, compression=comp)
    with pytest.raises(hvd.HorovodTpuError, match="Adasum"):
        hvd.grouped_allreduce([x], op=hvd.Adasum, compression=comp)
    w = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(hvd.HorovodTpuError, match="Adasum"):
        hvd.DistributedOptimizer(TF.sgd([w], 0.1), compression=comp,
                                 op=hvd.Adasum)


def test_accumulation_reduces_without_feedback(world1, monkeypatch):
    w = torch.nn.Parameter(torch.zeros(300))
    opt = hvd.DistributedOptimizer(TF.sgd([w], 1.0),
                                   compression=hvd.Compression.int8,
                                   backward_passes_per_step=2)
    assert opt.residuals is None
    from horovod_tpu_torch.optim import distributed as D

    monkeypatch.setattr(D, "allreduce_gradients_with_feedback",
                        lambda *a, **k: pytest.fail("feedback ran"))
    g = torch.randn(300)
    for _ in range(2):
        w.grad = g.clone()
        opt.step()
    assert torch.equal(w.detach(), -g)
    ef = hvd.DistributedOptimizer(TF.sgd([w], 1.0),
                                  compression=hvd.Compression.topk)
    assert set(ef.residuals) == {w}
    assert ef.residuals[w].dtype == torch.float32 and not ef.residuals[w].any()


def test_feedback_with_a_knob_that_is_not_lossy_takes_int8(world1,
                                                           monkeypatch):
    monkeypatch.setenv("HOROVOD_COMPRESSION", "bf16")
    g = [torch.randn(10)]
    out, err = hvd.allreduce_gradients_with_feedback(g, [torch.zeros(10)])
    assert torch.equal(out[0], g[0]) and not err[0].any()


def test_feedback_interop_round_trip(world1):
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)

    rng = np.random.default_rng(3)
    cfg = TransformerConfig(vocab=16, d_model=16, n_heads=2, head_dim=8,
                            n_layers=2, d_ff=16, max_seq=8)
    for model in (ResNet(stage_sizes=[1, 1, 1, 1],
                         block_cls=BottleneckBlock, num_classes=10,
                         num_filters=8, device="cpu"),
                  Transformer(cfg, device="cpu")):
        opt = hvd.DistributedOptimizer(TF.sgd(model.parameters(), 0.1),
                                       compression=hvd.Compression.int8)
        tree = interop.feedback_to_jax(model, opt)
        filled = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        interop.feedback_from_jax(filled, model, opt)
        back = interop.feedback_to_jax(model, opt)
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, filled)
    plain = hvd.DistributedOptimizer(TF.sgd(model.parameters(), 0.1))
    with pytest.raises(ValueError, match="no error-feedback"):
        interop.feedback_to_jax(model, plain)
