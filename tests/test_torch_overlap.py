"""The port's overlap engine (``horovod_tpu_torch.ops.overlap``) against
the JAX package's, on the CPU.

1. ``bucket_bounds`` equal to the reference's.
2. On spawned gloo worlds of 2 and 4 ranks, against the JAX package
   under ``shard_map`` on n of the 8 CPU devices, same per-rank inputs
   (``_torch_collectives_worker.overlap_main``), a length no multiple
   of n:
   - ``overlapped_flat_reduce``, dense Sum and Average over K = 1, 3, 4:
     exact on integer-valued data; on random data bit for bit with two
     ranks and within rtol 1e-6 with four (the reduction order;
     ``tests/test_overlap.py:320``);
   - int8, int4 and top-k with error, bucket by bucket: a lossy bucket
     is held as ``tests/test_torch_quantization.py`` holds the lossy
     wire (bit for bit in every block whose shared scale agrees, one
     scale where XLA's ``x/c -> x*(1/c)`` rewrite moved it, residuals to
     two ulps, every sum within n * scale / 2 of the exact one); top-k
     bit for bit with two ranks, rtol 1e-6 with four, its residual exact;
   - per-bucket modes through ``HOROVOD_BUCKET_COMPRESSION``;
   - ``allreduce``, ``grouped_allreduce``, ``grouped_quantized_allreduce``
     and ``reducescatter`` with ``overlap=True``;
   - ``DistributedOptimizer`` with the overlap on against off, at stages
     0 and 1 (the port against itself: bit for bit with two ranks,
     rtol 1e-6 with four).
3. World-1 shortcuts.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.ops import overlap as jovl

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import overlap as O
from horovod_tpu_torch.ops import quantization as Q

sys.path.insert(0, os.path.dirname(__file__))
from _torch_collectives_worker import (OVL_CHUNKS, OVL_LOSSY,  # noqa: E402
                                       OVL_MODES, overlap_inputs, spawn)
from test_torch_collectives import _f, _same  # noqa: E402
from test_torch_quantization import (BLOCK, _hold_blocks,  # noqa: E402
                                     _jax_seg_scales, _report, _run)


@pytest.mark.parametrize("length,chunks", [(0, 4), (1, 4), (3, 4), (10, 4),
                                           (10, 3), (250, 1), (251, 4),
                                           (7, 32), (1000, None)])
def test_bucket_bounds_match_reference(length, chunks):
    assert O.bucket_bounds(length, chunks) == jovl.bucket_bounds(length,
                                                                 chunks)


@pytest.fixture(scope="module", params=[2, 4], ids=["np2", "np4"])
def world(request):
    n = request.param
    return n, spawn(n, mode="overlap"), [overlap_inputs(r, n)
                                         for r in range(n)]


def _stack(ins, key):
    return np.stack([i[key] for i in ins])


def _qmax(mode: str, n: int) -> int:
    return Q.sum_safe_qmax(n) if mode == "int8" else Q.sum_safe_qmax4(n)


def _hold_bucketed(n, xs, got, want, got_errs, want_errs, modes, chunks,
                   what, moved):
    """Hold a bucketed Sum of the per-rank buffers ``xs`` (ranks,
    total) bucket by bucket: ``got`` one rank's port result, ``want`` the
    JAX result; ``got_errs`` / ``want_errs`` (ranks, total) residuals or
    None; ``modes`` each bucket's wire mode."""
    total = xs.shape[1]
    pad = (-total) % n
    L = (total + pad) // n

    def cols(a, s, e):
        return np.pad(_f(a).reshape(-1), (0, pad)).reshape(n, L)[:, s:e]

    segs = np.stack([cols(x, 0, L) for x in xs])          # (ranks, n, L)
    for b, (s, e) in enumerate(jovl.bucket_bounds(L, chunks)):
        mode, gb, wb = modes[b], cols(got, s, e), cols(want, s, e)
        if mode not in ("int8", "int4"):
            _same(gb, wb, n)
            if got_errs is not None:
                for r in range(n):
                    ge, we = cols(got_errs[r], s, e), cols(want_errs[r], s, e)
                    np.testing.assert_array_equal(ge, we)
                    assert mode == "topk" or not ge.any()
            continue
        qmax = _qmax(mode, n)
        seg_b = np.ascontiguousarray(segs[:, :, s:e])
        bpad = (-(e - s)) % BLOCK
        x4 = np.pad(seg_b, ((0, 0), (0, 0), (0, bpad))).reshape(n, n, -1,
                                                                 BLOCK)
        port_s = (np.abs(x4).max((0, 3)) / np.float32(qmax)).astype(
            np.float32)                                      # (seg, nb)
        jax_s = _jax_seg_scales(n, seg_b, qmax)

        def blocks(a):
            return np.pad(a, ((0, 0), (0, bpad))).reshape(-1)

        tag = f"{what} bucket {b} ({mode})"
        _hold_blocks(blocks(gb), blocks(wb), port_s.reshape(-1),
                     jax_s.reshape(-1), tag, moved)
        exact = seg_b.astype(np.float64).sum(0)
        bound = n * np.repeat(port_s, BLOCK, axis=1)[:, :e - s] / 2
        assert (np.abs(gb - exact) <= bound + 1e-6).all(), tag
        if got_errs is not None:
            for r in range(n):
                _hold_blocks(blocks(cols(got_errs[r], s, e)),
                             blocks(cols(want_errs[r], s, e)),
                             port_s.reshape(-1), jax_s.reshape(-1),
                             f"{tag} residual rank {r}", moved, qmax)


@pytest.mark.parametrize("data", ["int", "rand"])
@pytest.mark.parametrize("chunks", OVL_CHUNKS)
@pytest.mark.parametrize("op", ["Sum", "Average"])
def test_dense_flat_reduce_matches_jax(world, op, chunks, data):
    n, outs, ins = world
    code = getattr(hvd, op)
    want = _run(n, lambda b: jovl.overlapped_flat_reduce(
        b[0], "hvd", op=code, chunks=chunks)[0], _stack(ins, data))
    for o in outs:
        got = o[f"dense_{code}_{chunks}_{data}"]
        if data == "int":
            np.testing.assert_array_equal(_f(got), want)
        else:
            _same(got, want, n)


@pytest.mark.parametrize("mode", OVL_LOSSY)
def test_lossy_flat_reduce_matches_jax(world, mode):
    n, outs, ins = world
    xs = _stack(ins, "rand")
    want, werr = _run(n, lambda b: jovl.overlapped_flat_reduce(
        b[0], "hvd", op=jcoll.Sum, quantized=mode, with_error=True,
        chunks=3), xs, out_specs=(P(), P("hvd")))
    werr = werr.reshape(n, -1)
    moved = [0, 0]
    got_errs = [o[f"lossy_{mode}"][1] for o in outs]
    for r, o in enumerate(outs):
        _hold_bucketed(n, xs, o[f"lossy_{mode}"][0], want, got_errs, werr,
                       [mode] * 3, 3, f"{mode} rank {r}", moved)
    _report(f"overlapped {mode} np{n}", moved)


def test_per_bucket_modes_match_jax(world, monkeypatch):
    n, outs, ins = world
    xs = _stack(ins, "rand")
    monkeypatch.setenv("HOROVOD_BUCKET_COMPRESSION", OVL_MODES)
    want, werr = _run(n, lambda b: jovl.overlapped_flat_reduce(
        b[0], "hvd", op=jcoll.Sum, with_error=True, chunks=3), xs,
        out_specs=(P(), P("hvd")))
    werr = werr.reshape(n, -1)
    modes = OVL_MODES.split(":")
    moved = [0, 0]
    got_errs = [o["modes"][1] for o in outs]
    for r, o in enumerate(outs):
        _hold_bucketed(n, xs, o["modes"][0], want, got_errs, werr, modes, 3,
                       f"modes rank {r}", moved)
    _report(f"per-bucket modes np{n}", moved)


def test_entry_points_with_overlap_match_jax(world):
    n, outs, ins = world
    st = {k: _stack(ins, k) for k in ("ga", "gb", "gc", "rs", "rand")}

    def grouped(a, b, c):
        return tuple(jcoll.grouped_allreduce([a[0], b[0], c[0]],
                                             axis_name="hvd", overlap=True))

    want = _run(n, grouped, st["ga"], st["gb"], st["gc"],
                out_specs=(P(),) * 3)
    for o in outs:
        for got, w in zip(o["grouped"], want):
            _same(got, w, n)
    want = _run(n, lambda b: jcoll.allreduce(b[0], axis_name="hvd",
                                             overlap=True), st["rand"])
    for o in outs:
        _same(o["allreduce"], want, n)
    want = _run(n, lambda b: jcoll.reducescatter(
        b[0], axis_name="hvd", op=jcoll.Sum, overlap=True), st["rs"],
        out_specs=P("hvd"))
    rows = -(-9 // n)
    for r, o in enumerate(outs):
        _same(o["rs"], want.reshape(n, rows, 5)[r], n)

    def grouped_q(a, b):
        o, e = jcoll.grouped_quantized_allreduce(
            [a[0], b[0]], axis_name="hvd", op=jcoll.Sum, with_error=True,
            overlap=True)
        return tuple(o), tuple(x[None] for x in e)

    want, werr = _run(n, grouped_q, st["ga"], st["gb"],
                      out_specs=((P(),) * 2, (P("hvd"),) * 2))
    flat = np.concatenate([st["ga"].reshape(n, -1), st["gb"]], axis=1)
    wflat = np.concatenate([w.reshape(-1) for w in want])
    werr = np.concatenate([w.reshape(n, -1) for w in werr], axis=1)
    got_errs = [np.concatenate([_f(x).reshape(-1) for x in o["grouped_q"][1]])
                for o in outs]
    moved = [0, 0]
    for r, o in enumerate(outs):
        got = np.concatenate([_f(x).reshape(-1) for x in o["grouped_q"][0]])
        _hold_bucketed(n, flat, got, wflat, got_errs, werr, ["int8"] * 4, 4,
                       f"grouped int8 rank {r}", moved)
    _report(f"grouped int8 overlap np{n}", moved)


@pytest.mark.parametrize("stage", [0, 1])
def test_optimizer_overlap_on_matches_off(world, stage):
    n, outs, _ = world
    for o in outs:
        for on, off in zip(o[f"opt_{stage}_True"], o[f"opt_{stage}_False"]):
            _same(on, off, n)
    for o in outs[1:]:
        for a, b in zip(o[f"opt_{stage}_True"], outs[0][f"opt_{stage}_True"]):
            np.testing.assert_array_equal(_f(a), _f(b))


# ---------------------------------------------------------------------------
# World of one
# ---------------------------------------------------------------------------


@pytest.fixture()
def world1(monkeypatch):
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_world_of_one_shortcuts(world1, monkeypatch):
    import torch.distributed as dist

    for name in ("all_reduce", "reduce_scatter_tensor",
                 "all_gather_into_tensor"):
        monkeypatch.setattr(dist, name, lambda *a, name=name, **k:
                            pytest.fail(f"{name} at a world of one"))
    x = torch.randn(1003)
    out, err = O.overlapped_flat_reduce(x, op=hvd.Average,
                                        quantized="int8", with_error=True)
    assert out is x and err.dtype == torch.float32 and not err.any()
    i = torch.arange(10, dtype=torch.int32)
    assert O.overlapped_flat_reduce(i, op=hvd.Average)[0] is i
    shard, err = O.overlapped_scatter_flat_buffer(x, with_error=True)
    assert shard is x and not err.any()
    assert O.overlapped_gather_flat_shard(x) is x
    outs, bounds = O.prefetched_gather_flat_shard(x, 4)
    assert bounds == jovl.bucket_bounds(1003, 4)
    assert torch.equal(torch.cat(outs), x)
    assert outs[0].data_ptr() == x.data_ptr()
    assert torch.equal(hvd.collectives.allreduce(x, overlap=True), x)
    assert torch.equal(hvd.grouped_allreduce([x, i], overlap=True)[1], i)


def test_bucket_modes_knob(monkeypatch):
    from horovod_tpu_torch.ops import compression as C

    assert O.resolve_bucket_modes(3, "int8", torch.float32) == \
        jovl.resolve_bucket_modes(None, 3, "int8", jnp.float32)
    monkeypatch.setenv("HOROVOD_BUCKET_COMPRESSION", "int8:bf16")
    for k, tdt, jdt in ((3, torch.float32, jnp.float32),
                        (2, torch.int32, jnp.int32)):
        assert O.resolve_bucket_modes(k, False, tdt) == \
            jovl.resolve_bucket_modes(None, k, False, jdt)
    assert O.resolve_bucket_modes(3, False, torch.float32) == \
        ["int8", "bf16", "int8"]
    monkeypatch.setenv("HOROVOD_BUCKET_COMPRESSION", "int9")
    with pytest.raises(ValueError, match="not a wire mode"):
        C.bucket_modes(2)
