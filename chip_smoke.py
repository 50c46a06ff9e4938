#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``horovod_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``horovod_tpu_torch/csrc``, one ``nvcc``
   per source, all started together;
3. the fused optimizer tail (B1 momentum, B2 sgd, B3 adam) against its
   plain PyTorch version on the card at 2,359,296 (the largest ResNet-50
   leaf), 25,557,032 (all parameters in one buffer) and 1,000 elements,
   float32 and bfloat16, Adam at steps 1 and 3: float32 bit for bit,
   bfloat16 within 1 bf16 ulp; B3 also at the leaf shapes of both
   transformer paths, float32, bit for bit; then B1 and B2 timed over the 161
   ResNet-50 leaves of one step and B3 over the 75 transformer leaves,
   each beside its plain version, its memory bound and, where one
   PyTorch call computes the same function, that call;
4. flash attention (B8 forward step, B9 dQ, B10 dK/dV) against the plain
   versions on the card: the transformer path's shape (192, 1024, 64)
   bf16, causal and not, from a fresh state; the carried state over two
   KV halves against one call; a fully masked block; float32 at (8,
   256, 64); then each timed at the path's shape beside its plain
   version, its bound and ``scaled_dot_product_attention``;
5. a small ResNet and a small transformer (float32, TF32 off) trained 3
   steps on the card through the kernels and on the CPU through the
   plain versions: losses and weights must agree;
6. the ResNet-50 path: ``init()`` (world 1, NCCL), ResNet-50 at
   224x224, 1000 classes, batch 256, bf16 compute, ``DistributedOptimizer(
   fused_update.sgd(0.1, momentum=0.9))`` with ``HOROVOD_FUSED_UPDATE=1``
   on a seeded synthetic batch; every loss finite and exactly 161
   momentum-kernel launches per step;
7. the transformer path: the JAX package's transformer bench config
   (vocab 32768, d_model 768, 12 x 64 heads, 12 layers, d_ff 3072, seq
   1024, batch 16, bf16) trained 6 steps with ``DistributedOptimizer(
   fused_update.adam(3e-4))``: losses finite and falling, 12 launches of
   each of B8, B9 and B10 and 75 of B3 per step;
8. the long-context config (seq 8192, batch 1) trained 2 steps, its
   peak memory below one float32 (12, 8192, 8192) score block per layer
   and below the measured peak plus one such block, and B8, B9 and B10
   checked at its attention shape (12, 8192, 64) bf16 causal;
9. the codec kernels (B4 quantize, B5 dequantize, B6 int4 pack, B7 int4
   unpack) against their plain versions, bit for bit, at the fused
   gradient buffer of both paths (25,557,032 and 110,906,112 float32 in
   blocks of 256) for the int8 headroom of 1, 2 and 4 ranks (qmax 127,
   63, 31; int4 7, 3, 1), with a block of .5 ties, a zero block, int32
   partial sums and the int8 sum of four payloads; each timed beside its
   plain version, its bound and, for B5, ``torch.mul``;
10. the lossy wire on the ResNet-50 path: the 161 gradient leaves of the
   main path's model through ``Compression.int8`` and ``Compression.int4``
   (exactly 161 launches of each of B4-B7, error at most scale / 2), then
   a 4-rank reduction at the fused-buffer width from four seeded 64-image
   batch shards, int8 at qmax 31 and int4 at qmax 1, with only the
   transport emulated on the one card: equal to the plain pipeline bit
   for bit and within n * scale / 2 of the float sum.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``.  ``--profile FILE`` adds a
device-time breakdown of the ResNet-50 path (table in FILE), the
transformer path and the long-context path (tables in FILE with
``_transformer`` and ``_long`` before its suffix).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

MEM_BW = 3.35e12       # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
F32_PEAK = 67e12       # H100 SXM float32 outside the tensor cores, FLOP/s
BF16_PEAK = 989e12     # H100 SXM dense bf16 tensor cores, FLOP/s
STEPS, BATCH = 6, 256  # main path: bench.py's batch per chip
N_LEAF_MAX = 2_359_296
N_PARAMS = 25_557_032
REPLACES = {
    "momentum": "horovod_tpu/optim/fused_update.py:314",
    "sgd": "horovod_tpu/optim/fused_update.py:299",
    "adam": "horovod_tpu/optim/fused_update.py:331",
    "flash_block_step": "horovod_tpu/ops/pallas_attention.py:94",
    "flash_bwd_dq": "horovod_tpu/ops/pallas_attention.py:256",
    "flash_bwd_dkv": "horovod_tpu/ops/pallas_attention.py:301",
    "quantize": "horovod_tpu/ops/quantization.py:210",
    "dequantize": "horovod_tpu/ops/quantization.py:232",
    "pack4": "horovod_tpu/ops/quantization.py:496",
    "unpack4": "horovod_tpu/ops/quantization.py:519",
}
CODECS = ("quantize", "dequantize", "pack4", "unpack4")
# the JAX package's transformer bench (bench.py:_bench_transformer)
LM = dict(vocab=32768, d_model=768, n_heads=12, head_dim=64, n_layers=12,
          d_ff=3072)
LM_STEPS, LM_BATCH, LM_SEQ = 6, 16, 1024
LONG_STEPS, LONG_BATCH, LONG_SEQ = 2, 1, 8192
# one float32 (heads, L, L) score block for each layer: what a backward
# that kept its scores would hold at the long-context config
LONG_MEM_LIMIT = LM["n_layers"] * LM["n_heads"] * LONG_SEQ ** 2 * 4
# and the tighter gate: the peak measured on an H100 80GB HBM3 at 700 W
# (9,219,148,288 B, PERF.md) plus one layer's f32 score block, which a
# backward that kept bf16 scores for every layer, or f32 scores for two
# layers, would exceed
LONG_MEM_TIGHT = 9_219_148_288 + LM["n_heads"] * LONG_SEQ ** 2 * 4
LM_LEAVES = 3 + 6 * LM["n_layers"]
# the fused float32 gradient buffer of each path, in blocks of 256
QBLOCK = 256
CODEC_BUFFERS = {"ResNet-50": N_PARAMS, "transformer": 110_906_112}
# bytes per element moved (float32 side 4 B, int8 side 1 B or 1/2 B) and
# float operations per element (B4/B6: multiply, rint, two clamps; B5/B7:
# one multiply); plus one 4 B scale per block
CODEC_BYTES = {"quantize": 5, "dequantize": 5, "pack4": 4.5, "unpack4": 4.5}
CODEC_FLOPS = {"quantize": 4, "dequantize": 1, "pack4": 4, "unpack4": 1}
CODEC_LIBRARY = {
    "dequantize": "torch.mul(q2d, scales[:, None]) (int8 x float32 -> "
                  "float32 in one kernel)",
    "quantize": None, "pack4": None, "unpack4": None}
NO_LIBRARY = ("no one PyTorch call computes it: torch.quantize_per_channel "
              "divides by the scale and clamps to [-128, 127]")
# the path's attention shape: (batch * heads, seq, head_dim)
ATTN_SHAPE = (LM_BATCH * LM["n_heads"], LM_SEQ, LM["head_dim"])
# bf16: p and ds are rounded to bf16 and the kernels sum in another
# order, so a value that crosses a rounding boundary moves by one bf16
# ulp; this is the JAX package's own bf16 tolerance
# (tests/test_pallas_attention.py:118).  f32: only the order of the sums
# differs (TF32 off).
ATTN_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-5)}
# bytes moved and float operations per element (f32): reads + writes
BYTES_PER_EL = {"sgd": 8, "momentum": 16, "adam": 24}
FLOPS_PER_EL = {"sgd": 1, "momentum": 3, "adam": 12}


def log(msg: str) -> None:
    print(msg, flush=True)


def pin_one_card() -> str:
    """Make the run see one card, the first one it was given, before
    CUDA starts: the smoke uses one card and reports one.  Returns that
    card's index (or UUID) for ``nvidia-smi -i``."""
    os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    card = "0" if visible is None else visible.split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    return card


def nvidia_smi_line(card: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ulp_diff(a, b) -> int:
    """Largest distance in ulps of a's dtype (float32 or bfloat16)."""
    import torch

    if a.dtype == torch.bfloat16:
        ia, ib = a.view(torch.int16).int(), b.view(torch.int16).int()
        sign = 1 << 15
    else:
        ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
        sign = 1 << 31
    ia = torch.where(ia < 0, -(ia & (sign - 1)), ia)
    ib = torch.where(ib < 0, -(ib & (sign - 1)), ib)
    return int((ia - ib).abs().max().item()) if a.numel() else 0


def _hold_ulp(res: dict, kind: str, got, want, tol: int, what: str):
    for a, b in zip(got, want):
        err = float((a.float() - b.float()).abs().max().item())
        ulp = ulp_diff(a, b)
        r = res[kind]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_ulp"] = max(r["max_ulp"], ulp)
        if ulp > tol:
            raise AssertionError(f"{kind} {what}: kernel is {ulp} ulp from "
                                 f"its plain version (max abs {err})")


def kernel_checks(TF, torch, adam_shapes) -> dict:
    """Phase 3a: kernel against plain version; returns per-kernel
    max_abs_err (and max ulp).  B3 is also held at the distinct leaf
    shapes ``adam_shapes`` of the path that runs it."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    res = {k: {"max_abs_err": 0.0, "max_ulp": 0}
           for k in ("sgd", "momentum", "adam")}
    for n in (N_LEAF_MAX, N_PARAMS, 1000):
        for dtype in (torch.float32, torch.bfloat16):
            g, t, v = (torch.randn(n, device="cuda", generator=gen)
                       .to(dtype) for _ in range(3))
            v = v.abs()
            cases = [("sgd", 1, None), ("momentum", 1, None),
                     ("adam", 1, 1), ("adam", 1, 3)]
            if n == 1000:
                cases += [("sgd", 3, None), ("momentum", 3, None),
                          ("adam", 3, 3)]
            for kind, navg, step in cases:
                spec = TF.FusedSpec(kind, 0.1, 0.9)
                if kind == "sgd":
                    got = [TF.sgd_update(g, navg, -0.1)]
                    want = [TF.sgd_plain(g, navg, -0.1)]
                elif kind == "momentum":
                    got = TF.momentum_update(g, t, navg, 0.9, -0.1)
                    want = TF.momentum_plain(g, t, navg, 0.9, -0.1)
                else:
                    bc1, bc2 = TF.bias_corrections(spec, step)
                    got = TF.adam_update(g, t, v, bc1, bc2, navg, spec)
                    want = TF.adam_plain(g, t, v, bc1, bc2, navg, spec)
                torch.cuda.synchronize()
                _hold_ulp(res, kind, got, want,
                          0 if dtype == torch.float32 else 1,
                          f"n={n} {dtype} navg={navg} step={step}")
            log(f"[kernels] n={n} {str(dtype)[6:]}: sgd, momentum, adam "
                "agree with their plain versions")
            del g, t, v
    spec = TF.FusedSpec("adam", 3e-4)
    for shape in sorted(set(adam_shapes)):
        g, mu, nu = (torch.randn(shape, device="cuda", generator=gen)
                     for _ in range(3))
        nu = nu.abs()
        for step in (1, 3):
            bc1, bc2 = TF.bias_corrections(spec, step)
            got = TF.adam_update(g, mu, nu, bc1, bc2, 1, spec)
            want = TF.adam_plain(g, mu, nu, bc1, bc2, 1, spec)
            torch.cuda.synchronize()
            _hold_ulp(res, "adam", got, want, 0, f"{shape} step={step}")
    log(f"[kernels] adam at the path's {len(set(adam_shapes))} distinct "
        "leaf shapes, float32, steps 1 and 3: bit-exact")
    return res


def kernel_timings(TF, torch, shapes, kinds) -> dict:
    """Phase 3b: each kernel of ``kinds`` over one step's leaves (its
    path's shapes), its plain version, and a one-call library
    equivalent."""
    gen = torch.Generator(device="cuda").manual_seed(99)

    def leaves():
        return [torch.randn(s, device="cuda", generator=gen)
                for s in shapes]

    g, t, v = leaves(), leaves(), [x.abs() for x in leaves()]
    u = [torch.empty_like(x) for x in g]
    n_el = sum(x.numel() for x in g)
    spec = TF.FusedSpec("adam", 0.1)
    bc1, bc2 = TF.bias_corrections(spec, 3)
    calls = {
        "sgd": (lambda: [TF.sgd_update(a, 1, -0.1, out=o)
                         for a, o in zip(g, u)],
                lambda: [TF.sgd_plain(a, 1, -0.1) for a in g],
                lambda: [torch.mul(a, -0.1, out=o) for a, o in zip(g, u)]),
        "momentum": (lambda: [TF.momentum_update(a, b, 1, 0.9, -0.1, out=o,
                                                 t_out=b)
                              for a, b, o in zip(g, t, u)],
                     lambda: [TF.momentum_plain(a, b, 1, 0.9, -0.1)
                              for a, b in zip(g, t)],
                     None),
        "adam": (lambda: [TF.adam_update(a, b, c, bc1, bc2, 1, spec, out=o,
                                         mu_out=b, nu_out=c)
                          for a, b, c, o in zip(g, t, v, u)],
                 lambda: [TF.adam_plain(a, b, c, bc1, bc2, 1, spec)
                          for a, b, c in zip(g, t, v)],
                 None),
    }
    flat = torch.randn(n_el, device="cuda", generator=gen)
    flat_t, flat_u = torch.randn_like(flat), torch.empty_like(flat)
    flat_v = torch.randn_like(flat).abs()
    out = {}
    for kind in kinds:
        kern, plain, lib = calls[kind]
        one = {"sgd": lambda: TF.sgd_update(flat, 1, -0.1, out=flat_u),
               "momentum": lambda: TF.momentum_update(
                   flat, flat_t, 1, 0.9, -0.1, out=flat_u, t_out=flat_t),
               "adam": lambda: TF.adam_update(
                   flat, flat_t, flat_v, bc1, bc2, 1, spec, out=flat_u,
                   mu_out=flat_t, nu_out=flat_v)}[kind]
        out[kind] = {
            # kernel, plain, kernel, plain: the two measured in turns
            "ms": cuda_ms(kern),
            "plain_ms": cuda_ms(plain, reps=5),
        }
        out[kind]["ms_again"] = cuda_ms(kern)
        out[kind]["plain_ms_again"] = cuda_ms(plain, reps=5)
        out[kind]["ms_one_buffer"] = cuda_ms(one)
        out[kind]["library_ms"] = cuda_ms(lib) if lib else None
        bytes_ = BYTES_PER_EL[kind] * n_el
        flops = FLOPS_PER_EL[kind] * n_el
        t_bytes, t_ops = bytes_ / MEM_BW * 1e3, flops / F32_PEAK * 1e3
        out[kind]["bound_ms"] = max(t_bytes, t_ops)
        out[kind]["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[timing] {kind}: kernel {out[kind]['ms']:.4f} / "
            f"{out[kind]['ms_again']:.4f} ms, plain "
            f"{out[kind]['plain_ms']:.4f} / {out[kind]['plain_ms_again']:.4f}"
            f" ms over {len(shapes)} leaves ({n_el} f32); one "
            f"{n_el}-element launch {out[kind]['ms_one_buffer']:.4f} ms; "
            f"bound {out[kind]['bound_ms']:.4f} ms; library "
            f"{out[kind]['library_ms']}")
    return out


def small_reference(hvd, torch) -> None:
    """Phase 4: a small ResNet trained 3 steps on the card (fused tail)
    and on the CPU (plain optimizer) from the same weights and batch."""
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    torch.backends.cudnn.allow_tf32 = False
    try:
        kw = dict(stage_sizes=[1, 1, 1, 1], block_cls=BottleneckBlock,
                  num_classes=10, num_filters=8, dtype=torch.float32,
                  seed=7)
        mg, mc = ResNet(device="cuda", **kw), ResNet(device="cpu", **kw)
        og = hvd.DistributedOptimizer(TF.sgd(mg.parameters(), 0.1, 0.9))
        oc = TF.sgd(mc.parameters(), 0.1, 0.9)
        xg, yg = synthetic_batch(8, 32, 10, seed=3, device="cuda")
        xc, yc = synthetic_batch(8, 32, 10, seed=3, device="cpu")
        for step in range(3):
            lg = float(train_step(mg, og, xg, yg))
            lc = float(train_step(mc, oc, xc, yc))
            if not math.isclose(lg, lc, rel_tol=1e-4, abs_tol=1e-5):
                raise AssertionError(
                    f"small reference step {step}: card loss {lg} vs CPU {lc}")
        worst = 0.0
        for (name, a), b in zip(mg.state_dict().items(),
                                mc.state_dict().values()):
            a, b = a.cpu(), b
            err = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            worst = max(worst, err)
            if err > 1e-3:
                raise AssertionError(
                    f"small reference: {name} differs by {err} of its scale")
        log(f"[reference] small ResNet, 3 steps: card and CPU agree "
            f"(last loss {lg:.6f} vs {lc:.6f}; worst weight error "
            f"{worst:.2e} of scale; tolerance rel 1e-4 loss, 1e-3 weights)")
    finally:
        torch.backends.cudnn.allow_tf32 = True


def main_path(hvd, torch, steps: int, batch: int, gpu: str,
              profile: str | None = None) -> dict:
    """Phase 5: ResNet-50 training steps through the public entry points."""
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9))
    if not TF.active():
        raise AssertionError("the fused tail is not active")
    images, labels = synthetic_batch(batch, 224, 1000, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    TF.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = train_step(model, opt, images, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = dict(TF.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if launches["momentum"] != 161 * steps:
        raise AssertionError(
            f"momentum kernel launched {launches['momentum']} times in "
            f"{steps} steps, expected {161 * steps}")
    steady = times[1:] or times
    step_s = sum(steady) / len(steady)
    med = statistics.median(steady)
    log(f"[main] ResNet-50 224x224 batch {batch} bf16, fused momentum SGD,"
        f" {steps} steps on {gpu}: losses {losses}")
    log(f"[main] step times (s) {times}; steady step mean {step_s:.4f} s = "
        f"{batch / step_s:.1f} img/s, median {med:.4f} s = "
        f"{batch / med:.1f} img/s; peak memory "
        f"{peak / 2**30:.2f} GiB; kernel launches {launches}; on {gpu}")
    if profile:
        profile_steps(torch, lambda: train_step(model, opt, images, labels),
                      step_s, profile, RESNET_CLASSES, "resnet50")
    return {"launches": launches, "losses": losses, "step_s": step_s,
            "median_s": med, "peak_bytes": peak, "model": model}


RESNET_CLASSES = {"convolution (cuDNN)": ("xmma", "conv", "gemm", "cudnn",
                                          "implicit", "cutlass"),
                  "fused tail B1": ("momentum_kernel",),
                  "NCCL": ("nccl",)}
LM_CLASSES = {"attention B8 forward": ("flash_fwd_kernel",),
              "attention B9 dQ": ("flash_bwd_dq_kernel",),
              "attention B10 dK/dV": ("flash_bwd_dkv_kernel",),
              "fused tail B3": ("adam_kernel",),
              "matmul (cuBLAS)": ("gemm", "nvjet", "xmma", "cutlass"),
              "NCCL": ("nccl",)}


def profile_steps(torch, step, step_s: float, out: str, classes: dict,
                  tag: str, steps: int = 3) -> None:
    """``--profile``: device kernel time per step of a path by class
    (``torch.profiler``) and the device's busy share of the profiled
    wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    ka = prof.key_averages()
    # device activity only: CPU-side rows (aten:: ops, and the autograd
    # Function around a ctypes launch) repeat their kernels' time, and
    # "Command Buffer Full" marks the host waiting, not device work
    kern = {e.key: e.self_device_time_total / steps / 1e3 for e in ka
            if e.self_device_time_total > 0
            and e.device_type == DeviceType.CUDA
            and "Command Buffer" not in e.key}
    if not kern:
        raise AssertionError("the profiler recorded no device time")
    totals = dict.fromkeys([*classes, "elementwise and reductions"], 0.0)
    for k, ms in kern.items():
        name = next((c for c, words in classes.items()
                     if any(w in k.lower() for w in words)),
                    "elementwise and reductions")
        totals[name] += ms
    busy = sum(kern.values())
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=60))
        for k, ms in sorted(kern.items(), key=lambda kv: -kv[1]):
            f.write(f"{ms:10.3f} ms/step  {k}\n")
    log(f"[profile {tag}] {steps} profiled steps: wall "
        f"{wall * 1e3:.3f} ms/step (unprofiled {step_s * 1e3:.3f}); "
        f"device kernels {busy:.3f} ms/step, busy share "
        f"{busy / 1e3 / wall:.3f}")
    for name, ms in totals.items():
        log(f"[profile {tag}]   {name}: {ms:.3f} ms/step "
            f"({ms / busy:.3f} of device time)")
    for k, ms in sorted(kern.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile {tag}]   {ms:9.3f} ms/step  {k[:100]}")


def _attn_inputs(torch, shape, dtype, gen):
    """q, k, v and dO of ``shape`` (BH, L, D), standard normal."""
    return [torch.randn(*shape, device="cuda", generator=gen).to(dtype)
            for _ in range(4)]


def _fresh(torch, bh: int, l_: int, d: int):
    return (torch.full((bh, l_), -math.inf, device="cuda"),
            torch.zeros(bh, l_, device="cuda"),
            torch.zeros(bh, l_, d, device="cuda"))


def _lse_delta(state, do):
    """The ring forward's saved lse and the backward's delta for a
    state ``(m, l, o)`` and upstream gradient ``do``."""
    from horovod_tpu_torch.parallel.ring_attention import finish

    out, lse = finish(*state)
    return lse, (do.float() * out).sum(-1)


def _hold(torch, res: dict, name: str, got, want, dtype, what: str) -> None:
    """Raise unless ``got`` is within the attention tolerance of
    ``want``; record the largest finite absolute error under ``name``."""
    rtol, atol = ATTN_TOL[str(dtype)[6:]]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")
    d = (got.float() - want.float()).abs()
    d = d[torch.isfinite(d)]
    res[name] = max(res[name], float(d.max()) if d.numel() else 0.0)


def _hold_state(FA, torch, res: dict, got, want, dtype, what: str) -> None:
    """B8's (m, l, o); in bf16 o is held as o / l (see
    ``flash_attention.state_pairs``)."""
    for n, a, b in FA.state_pairs(got, want, dtype == torch.bfloat16):
        _hold(torch, res, "flash_block_step", a, b, dtype, f"{what} {n}")


def _hold_three(FA, torch, res: dict, q, k, v, do, causal: bool,
                what: str) -> None:
    """B8 from a fresh state, then B9 and B10 from the lse and delta of
    the plain B8 state, each against its plain version."""
    dtype = q.dtype
    fresh = _fresh(torch, *q.shape)
    want = FA.flash_block_step_plain(q, k, v, *fresh, 0, 0, causal)
    _hold_state(FA, torch, res, FA.flash_block_step(
        q, k, v, *fresh, 0, 0, causal=causal), want, dtype, f"B8 {what}")
    lse, delta = _lse_delta(want, do)
    del want, fresh
    args = (q, k, v, do, lse, delta, 0, 0)
    _hold(torch, res, "flash_bwd_dq", FA.flash_bwd_dq(*args, causal=causal),
          FA.flash_bwd_dq_plain(*args, causal), dtype, f"B9 dq {what}")
    for n, a, b in zip(("dk", "dv"), FA.flash_bwd_dkv(*args, causal=causal),
                       FA.flash_bwd_dkv_plain(*args, causal)):
        _hold(torch, res, "flash_bwd_dkv", a, b, dtype, f"B10 {n} {what}")
    torch.cuda.synchronize()


def attention_checks(FA, torch) -> dict:
    """Phase 4a: B8-B10 against their plain versions on the card;
    returns each kernel's largest absolute error."""
    res = dict.fromkeys(("flash_block_step", "flash_bwd_dq",
                         "flash_bwd_dkv"), 0.0)
    gen = torch.Generator(device="cuda").manual_seed(2024)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dtype, shape, causals in (
                (torch.bfloat16, ATTN_SHAPE, (True, False)),
                (torch.float32, (8, 256, 64), (True, False))):
            q, k, v, do = _attn_inputs(torch, shape, dtype, gen)
            for causal in causals:
                what = f"{shape} {str(dtype)[6:]} causal={causal}"
                _hold_three(FA, torch, res, q, k, v, do, causal, what)
                log(f"[attention] {what}: B8, B9, B10 agree with their "
                    f"plain versions")
            del q, k, v, do
        # the carried state: two steps over the KV halves, one call
        q, k, v, _ = _attn_inputs(torch, ATTN_SHAPE, torch.bfloat16, gen)
        half = ATTN_SHAPE[1] // 2
        k1, k2 = k[:, :half].contiguous(), k[:, half:].contiguous()
        v1, v2 = v[:, :half].contiguous(), v[:, half:].contiguous()
        st = FA.flash_block_step(q, k1, v1, *_fresh(torch, *ATTN_SHAPE), 0, 0)
        st = FA.flash_block_step(q, k2, v2, *st, 0, half)
        want = FA.flash_block_step_plain(q, k, v, *_fresh(torch, *ATTN_SHAPE),
                                         0, 0, True)
        _hold_state(FA, torch, res, st, want, torch.bfloat16,
                    "B8 two KV halves vs one call")
        # a fully masked block: queries 0..511 against keys 512..1023
        bh, _, d = ATTN_SHAPE
        m, l, o = FA.flash_block_step(q[:, :half].contiguous(), k2, v2,
                                      *_fresh(torch, bh, half, d), 0, half)
        if not (torch.isneginf(m).all() and not l.any() and not o.any()):
            raise AssertionError("B8 on a fully masked block changed the "
                                 "fresh state")
        torch.cuda.synchronize()
        log(f"[attention] {ATTN_SHAPE} bf16: the carried state over two KV "
            f"halves agrees with one call; a fully masked block keeps m = "
            f"-inf, l = 0; largest errors {res} (bf16 B8 o as o / l); "
            f"tolerance rtol/atol {ATTN_TOL}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return res


def attention_costs(shape, itemsize: int) -> dict:
    """(bytes, float operations) each kernel must move and do at
    ``shape`` (BH, L, D), causal: every input read once, every output
    written once; products over the (q, k) pairs the mask leaves."""
    bh, l_, d = shape
    el, rows = bh * l_ * d, bh * l_
    pairs = bh * l_ * (l_ + 1) // 2
    return {
        # q, k, v; m, l, o in and out
        "flash_block_step": (3 * el * itemsize + 2 * (2 * rows + el) * 4,
                             4 * pairs * d),
        # q, k, v, dO, lse, delta in; dQ out
        "flash_bwd_dq": (4 * el * itemsize + 2 * rows * 4 + el * 4,
                         6 * pairs * d),
        # the same in; dK, dV out
        "flash_bwd_dkv": (4 * el * itemsize + 2 * rows * 4 + 2 * el * 4,
                          8 * pairs * d),
    }


def attention_timings(FA, torch) -> dict:
    """Phase 4b: B8-B10 at the transformer path's shape (bf16, causal),
    each beside its plain version, its bound and
    ``scaled_dot_product_attention`` on the same inputs (forward for B8,
    its backward for B9 and B10 together; SDPA returns the normalised
    output where B8 returns the carried state)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(7)
    bh, l_, d = ATTN_SHAPE
    q, k, v, do = _attn_inputs(torch, ATTN_SHAPE, torch.bfloat16, gen)
    fresh = _fresh(torch, *ATTN_SHAPE)
    lse, delta = _lse_delta(FA.flash_block_step(q, k, v, *fresh, 0, 0), do)
    args = (q, k, v, do, lse, delta, 0, 0)
    calls = {
        "flash_block_step": (
            lambda: FA.flash_block_step(q, k, v, *fresh, 0, 0),
            lambda: FA.flash_block_step_plain(q, k, v, *fresh, 0, 0, True)),
        "flash_bwd_dq": (lambda: FA.flash_bwd_dq(*args),
                         lambda: FA.flash_bwd_dq_plain(*args, True)),
        "flash_bwd_dkv": (lambda: FA.flash_bwd_dkv(*args),
                          lambda: FA.flash_bwd_dkv_plain(*args, True)),
    }
    b, h = LM_BATCH, LM["n_heads"]
    q4, k4, v4, do4 = (x.view(b, h, l_, d) for x in (q, k, v, do))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    out4 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib = {
        "fwd": cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)),
        "bwd": cuda_ms(lambda: torch.autograd.grad(
            out4, (qg, kg, vg), do4, retain_graph=True)),
    }
    costs = attention_costs(ATTN_SHAPE, 2)
    out = {}
    for name, (kern, plain) in calls.items():
        t = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, reps=3)}
        t["ms_again"] = cuda_ms(kern)
        t["plain_ms_again"] = cuda_ms(plain, reps=3)
        bytes_, flops = costs[name]
        t_bytes, t_ops = bytes_ / MEM_BW * 1e3, flops / BF16_PEAK * 1e3
        t["bound_ms"] = max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        fwd = name == "flash_block_step"
        t["library_ms"] = lib["fwd" if fwd else "bwd"]
        t["library"] = ("F.scaled_dot_product_attention(is_causal=True) "
                        + ("forward" if fwd else
                           "backward, dQ dK dV together"))
        t["bytes"], t["flops"] = bytes_, flops
        out[name] = t
        log(f"[timing] {name} {ATTN_SHAPE} bf16 causal: kernel "
            f"{t['ms']:.4f} / {t['ms_again']:.4f} ms "
            f"({flops / t['ms'] / 1e9:.1f} TFLOP/s, "
            f"{t['bound_ms'] / t['ms']:.4f} of bound), plain "
            f"{t['plain_ms']:.4f} / {t['plain_ms_again']:.4f} ms; bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {bytes_} B, "
            f"{flops} FLOP); library {t['library_ms']:.4f} ms "
            f"({t['library']})")
    return out


def lm_shapes(seq: int) -> list:
    """The transformer's parameter shapes, in ``parameters()`` order."""
    dm, ff = LM["d_model"], LM["d_ff"]
    hd = LM["n_heads"] * LM["head_dim"]
    layer = [(dm, 3 * hd), (hd, dm), (dm, ff), (ff, dm), (dm,), (dm,)]
    return ([(LM["vocab"], dm), (seq, dm), (dm,)]
            + layer * LM["n_layers"])


def small_lm_reference(hvd, torch) -> None:
    """Phase 5b: a small transformer (f32, TF32 off) trained 3 steps on
    the card (B8-B10, fused Adam B3) and on the CPU (plain versions) from
    the same weights and batch."""
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import lm_train_step, synthetic_tokens

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = TransformerConfig(vocab=256, d_model=64, n_heads=4,
                                head_dim=16, n_layers=2, d_ff=256,
                                max_seq=128, dtype="float32")
        mg = Transformer(cfg, seed=3, device="cuda")
        mc = Transformer(cfg, seed=3, device="cpu")
        og = hvd.DistributedOptimizer(TF.adam(mg.parameters(), 3e-4))
        oc = TF.adam(mc.parameters(), 3e-4)
        xg, yg = synthetic_tokens(2, 128, cfg.vocab, seed=5, device="cuda")
        xc, yc = synthetic_tokens(2, 128, cfg.vocab, seed=5, device="cpu")
        for step in range(3):
            lg = float(lm_train_step(mg, og, xg, yg))
            lc = float(lm_train_step(mc, oc, xc, yc))
            if not math.isclose(lg, lc, rel_tol=1e-4):
                raise AssertionError(
                    f"small transformer step {step}: card loss {lg} vs CPU "
                    f"{lc}")
        worst = 0.0
        for (name, a), b in zip(mg.state_dict().items(),
                                mc.state_dict().values()):
            err = float((a.cpu() - b).abs().max()) / max(
                float(b.abs().max()), 1e-30)
            worst = max(worst, err)
            if err > 1e-3:
                raise AssertionError(
                    f"small transformer: {name} differs by {err} of its "
                    "scale")
        log(f"[reference] small transformer, 3 steps: card and CPU agree "
            f"(last loss {lg:.6f} vs {lc:.6f}; worst weight error "
            f"{worst:.2e} of scale; tolerance rel 1e-4 loss, 1e-3 weights)")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def lm_path(hvd, torch, seq: int, batch: int, steps: int, gpu: str,
            tag: str, profile: str | None = None) -> dict:
    """Phases 7 and 8: the transformer LM trained through the public
    entry points at the bench's widths (seed 0 weights, seed 1 tokens)."""
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import lm_train_step, synthetic_tokens

    cfg = TransformerConfig(**LM, max_seq=seq)
    model = Transformer(cfg, seed=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.adam(model.parameters(), 3e-4))
    if not TF.active():
        raise AssertionError("the fused tail is not active")
    tokens, targets = synthetic_tokens(batch, seq, cfg.vocab, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    FA.reset_launch_counts()
    TF.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = lm_train_step(model, opt, tokens, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {**FA.LAUNCHES, "adam": TF.LAUNCHES["adam"]}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    want = {k: cfg.n_layers * steps for k in FA.LAUNCHES}
    want["adam"] = LM_LEAVES * steps
    if launches != want:
        raise AssertionError(
            f"{tag}: kernel launches {launches} in {steps} steps, expected "
            f"{want}")
    steady = times[1:] or times
    step_s = sum(steady) / len(steady)
    med = statistics.median(steady)
    log(f"[{tag}] transformer d{cfg.d_model} L{cfg.n_layers} "
        f"h{cfg.n_heads}x{cfg.head_dim} seq {seq} batch {batch} bf16, "
        f"fused Adam, {steps} steps on {gpu}: losses {losses}")
    log(f"[{tag}] step times (s) {times}; steady step mean {step_s:.4f} s ="
        f" {batch * seq / step_s:.1f} tokens/s, median {med:.4f} s = "
        f"{batch * seq / med:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB ({peak} B); kernel launches {launches}; "
        f"on {gpu}")
    if profile:
        stem, ext = os.path.splitext(profile)
        profile_steps(torch, lambda: lm_train_step(model, opt, tokens,
                                                   targets),
                      step_s, f"{stem}_{tag}{ext}", LM_CLASSES, tag)
    return {"launches": launches, "losses": losses, "step_s": step_s,
            "median_s": med, "peak_bytes": peak}


def long_context(hvd, torch, FA, gpu: str, profile: str | None) -> dict:
    """Phase 8: the long-context config, its peak memory under the
    O(L^2) limits, then B8, B9 and B10 against their plain versions at
    its attention shape; returns each kernel's largest error there."""
    path = lm_path(hvd, torch, LONG_SEQ, LONG_BATCH, LONG_STEPS, gpu, "long",
                   profile)
    peak = path["peak_bytes"]
    for limit, what in ((LONG_MEM_LIMIT, "one f32 score block per layer"),
                        (LONG_MEM_TIGHT, "the measured O(L) peak plus one "
                                         "layer's f32 score block")):
        if peak >= limit:
            raise AssertionError(f"long context: peak memory {peak} B is "
                                 f"not below {limit} B, {what}")
    torch.cuda.empty_cache()
    shape = (LONG_BATCH * LM["n_heads"], LONG_SEQ, LM["head_dim"])
    gen = torch.Generator(device="cuda").manual_seed(11)
    res = dict.fromkeys(("flash_block_step", "flash_bwd_dq",
                         "flash_bwd_dkv"), 0.0)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        q, k, v, do = _attn_inputs(torch, shape, torch.bfloat16, gen)
        _hold_three(FA, torch, res, q, k, v, do, True,
                    f"{shape} bf16 causal")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    del q, k, v, do
    torch.cuda.empty_cache()
    log(f"[long] peak memory {peak} B < {LONG_MEM_TIGHT} B < "
        f"{LONG_MEM_LIMIT} B; B8, B9, B10 at {shape} bf16 causal agree with "
        f"their plain versions (largest errors {res}; B8 o as o / l)")
    return res


def _hold_bits(res: dict, name: str, got, want, what: str) -> None:
    """Raise unless ``got`` equals ``want`` bit for bit; record the
    largest absolute difference (0.0 when they agree)."""
    err = float((got.float() - want.float()).abs().max().item()) \
        if got.numel() else 0.0
    res[name] = max(res[name], err)
    if got.dtype != want.dtype or not got.equal(want):
        bad = int((got != want).sum().item()) if got.shape == want.shape \
            else got.numel()
        raise AssertionError(f"{name} {what}: {bad} elements differ from "
                             f"the plain version (max abs {err})")


def _tie_blocks(torch, x2d, gen):
    """Block 0: exact .5 ties under a power-of-two scale (set by
    :func:`_tie_scales`); block 1: all zero."""
    k = torch.randint(-31, 31, (x2d.shape[1],), device="cuda", generator=gen)
    x2d[0] = (k.float() + 0.5) * 0.125
    x2d[1] = 0.0


def _tie_scales(s):
    s[0] = 0.125
    return s


def _emulated_wire(Q, torch, res, xs, qmax: int, int4: bool, what: str):
    """An n-rank reduction of the rows ``xs`` (list of (nb, block)
    float32) with only the transport emulated: shared scales (max over
    the ranks), each rank's payload, their int8 sum (checked against the
    int64 sum: no wrap), the sum and each residual dequantized; every
    kernel output held against its plain version.  Returns ``(sum,
    scales)``."""
    enc, dec = ((Q.quantize_pack4_values, Q.unpack_dequantize4_values)
                if int4 else (Q.quantize_values, Q.dequantize_values))
    enc_p, dec_p = ((Q.quantize_pack4_plain, Q.unpack_dequantize4_plain)
                    if int4 else (Q.quantize_plain, Q.dequantize_plain))
    ek, dk = ("pack4", "unpack4") if int4 else ("quantize", "dequantize")
    shared = torch.stack([Q.block_absmax(x) for x in xs]).amax(0)
    s = Q._scales(shared, qmax)
    qs = []
    for r, x in enumerate(xs):
        q = enc(x, s, qmax)
        _hold_bits(res, ek, q, enc_p(x, s, qmax), f"{what} rank {r}")
        _hold_bits(res, dk, dec(q, s), dec_p(q, s),
                   f"{what} rank {r} residual")
        qs.append(q)
    stack = torch.stack(qs)
    qsum = stack.sum(0, dtype=torch.int8)
    if not qsum.long().equal(stack.long().sum(0)):
        raise AssertionError(f"{what}: the int8 sum wrapped")
    out = dec(qsum, s)
    _hold_bits(res, dk, out, dec_p(qsum, s), f"{what} sum")
    torch.cuda.synchronize()
    return out, s


def codec_checks(Q, torch) -> dict:
    """Phase 9a: B4-B7 against their plain versions on the card at the
    fused gradient buffer of both paths; returns each kernel's largest
    absolute difference."""
    res = dict.fromkeys(CODECS, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(4242)
    for name, n_el in CODEC_BUFFERS.items():
        x2d, _ = Q._to_blocks(torch.randn(n_el, device="cuda",
                                          generator=gen), QBLOCK)
        _tie_blocks(torch, x2d, gen)
        absmax = Q.block_absmax(x2d)
        what = f"{name} {tuple(x2d.shape)}"
        for qmax in (127, 63, 31):
            s = _tie_scales(Q._scales(absmax, qmax))
            q = Q.quantize_values(x2d, s, qmax)
            _hold_bits(res, "quantize", q, Q.quantize_plain(x2d, s, qmax),
                       f"{what} qmax {qmax}")
            _hold_bits(res, "dequantize", Q.dequantize_values(q, s),
                       Q.dequantize_plain(q, s), f"{what} qmax {qmax}")
            del q
        for qmax in (7, 3, 1):
            s = _tie_scales(Q._scales(absmax, qmax))
            p = Q.quantize_pack4_values(x2d, s, qmax)
            _hold_bits(res, "pack4", p, Q.quantize_pack4_plain(x2d, s, qmax),
                       f"{what} qmax {qmax}")
            _hold_bits(res, "unpack4", Q.unpack_dequantize4_values(p, s),
                       Q.unpack_dequantize4_plain(p, s), f"{what} qmax {qmax}")
            del p
        # four payloads summed on an int8 wire: B5 on the sum (and on the
        # same sums held as int32), B7 on summed packed bytes
        xs = [x2d] + [torch.randn(x2d.shape, device="cuda", generator=gen)
                      for _ in range(3)]
        _emulated_wire(Q, torch, res, xs, 31, False, f"{what} 4 payloads")
        qsum = torch.stack([Q.quantize_values(x, Q._scales(absmax, 31), 31)
                            for x in xs]).sum(0, dtype=torch.int32)
        s = Q._scales(absmax, 31)
        _hold_bits(res, "dequantize", Q.dequantize_values(qsum, s),
                   Q.dequantize_plain(qsum, s), f"{what} int32 sums")
        del qsum
        _emulated_wire(Q, torch, res, xs, 1, True, f"{what} 4 packed payloads")
        del xs, x2d
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"[codec] {what}: B4, B5 at qmax 127/63/31 and B6, B7 at 7/3/1 "
            "(a .5-tie block, a zero block), B5 on int32 sums and on the "
            "int8 sum of 4 payloads, B7 on summed packed bytes: bit for bit "
            "with their plain versions")
    return res


def half_scale(s, qmax: int):
    """The per-element error bound of one rank's round trip, ``s / 2``,
    widened by the float32 rounding of ``1/s``, ``x * (1/s)`` and ``q *
    s`` (each at most 2**-24 relative, with ``|x/s|, |q| <= qmax``):
    ``s * (1/2 + (3 qmax + 2) 2**-24)``.  A value ``x/s`` within that
    rounding of a .5 tie may round to the farther grid point."""
    return s * (0.5 + (3 * qmax + 2) * 2.0 ** -24)


def codec_path(hvd, Q, torch, model, gpu: str) -> dict:
    """Phase 10: the lossy wire on the ResNet-50 path (one card).
    Returns the launches of B4-B7 in the compressors' round trips and
    each kernel's largest difference from its plain version."""
    from horovod_tpu_torch.train_step import (softmax_cross_entropy,
                                              synthetic_batch)

    grads = [p.grad.detach().clone() for p in model.parameters()]
    if len(grads) != 161 or any(g.dtype != torch.float32 for g in grads):
        raise AssertionError("expected the 161 float32 gradient leaves of "
                             "the main path's backward")
    worst = {"int8": 0.0, "int4": 0.0}
    Q.reset_launch_counts()
    for g in grads:
        for mode, qmax in (("int8", 127), ("int4", 7)):
            comp = hvd.Compression.lookup(mode)
            wire, ctx = comp.compress(g)
            back = comp.decompress(wire, ctx)
            err2d, _ = Q._to_blocks(back - g, ctx.block)
            ratio = float((err2d.abs() / (wire[1][:, None] / 2)
                           .clamp_min(1e-30)).max())
            worst[mode] = max(worst[mode], ratio)
            if not bool((err2d.abs() <= half_scale(wire[1], qmax)[:, None])
                        .all().item()):
                raise AssertionError(
                    f"{mode} round trip of a {tuple(g.shape)} leaf: error "
                    f"{ratio} of scale / 2, beyond its float32 rounding")
    torch.cuda.synchronize()
    launches = dict(Q.LAUNCHES)
    if launches != dict.fromkeys(CODECS, 161):
        raise AssertionError(f"codec launches {launches}, expected 161 each")
    log(f"[wire] 161 ResNet-50 gradient leaves through Compression.int8 and "
        f"Compression.int4: launches {launches}; largest error / (scale/2) "
        f"{worst}")

    # a 4-rank reduction at the fused-buffer width: four batch shards of
    # 64 images, one backward each; only the transport is emulated
    res = dict.fromkeys(CODECS, 0.0)
    xs = []
    for r in range(4):
        images, labels = synthetic_batch(64, 224, 1000, seed=100 + r)
        model.zero_grad(set_to_none=True)
        softmax_cross_entropy(model(images), labels).backward()
        flat = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
        xs.append(Q._to_blocks(flat, QBLOCK)[0])
        del images, labels, flat
    model.zero_grad(set_to_none=True)
    exact = torch.stack(xs).double().sum(0)
    for qmax, int4 in ((31, False), (1, True)):
        what = f"4-rank {'int4' if int4 else 'int8'} qmax {qmax}"
        out, s = _emulated_wire(Q, torch, res, xs, qmax, int4, what)
        bound = 4 * half_scale(s.double(), qmax)[:, None]
        excess = float(((out.double() - exact).abs() - bound).max())
        if excess > 0:
            raise AssertionError(f"{what}: beyond n * scale / 2 of the float "
                                 f"sum by {excess}")
        log(f"[wire] {what} over 4 gradient buffers of {N_PARAMS} float32 "
            f"({tuple(out.shape)} blocks; only the transport is emulated, "
            f"the four ranks' payloads summed on this card): kernels bit for "
            f"bit with the plain pipeline, the sum within n * scale / 2 of "
            f"the float sum; on {gpu}")
    del xs, exact
    torch.cuda.empty_cache()
    return {"launches": launches, "errs": res}


def codec_timings(Q, torch) -> dict:
    """Phase 9b: B4-B7 at both fused-buffer shapes, each twice beside its
    plain version, its memory bound and (B5) ``torch.mul``."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for name, n_el in CODEC_BUFFERS.items():
        x2d, _ = Q._to_blocks(torch.randn(n_el, device="cuda", generator=gen),
                              QBLOCK)
        nb = x2d.shape[0]
        s = Q._scales(Q.block_absmax(x2d), 127)
        q = Q.quantize_values(x2d, s, 127)
        p = Q.quantize_pack4_values(x2d, s, 7)
        calls = {
            "quantize": (lambda: Q.quantize_values(x2d, s, 127),
                         lambda: Q.quantize_plain(x2d, s, 127), None),
            "dequantize": (lambda: Q.dequantize_values(q, s),
                           lambda: Q.dequantize_plain(q, s),
                           lambda: torch.mul(q, s[:, None])),
            "pack4": (lambda: Q.quantize_pack4_values(x2d, s, 7),
                      lambda: Q.quantize_pack4_plain(x2d, s, 7), None),
            "unpack4": (lambda: Q.unpack_dequantize4_values(p, s),
                        lambda: Q.unpack_dequantize4_plain(p, s), None),
        }
        for kind, (kern, plain, lib) in calls.items():
            t = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, reps=5)}
            t["ms_again"] = cuda_ms(kern)
            t["plain_ms_again"] = cuda_ms(plain, reps=5)
            t["library_ms"] = cuda_ms(lib) if lib else None
            bytes_ = CODEC_BYTES[kind] * nb * QBLOCK + 4 * nb
            flops = CODEC_FLOPS[kind] * nb * QBLOCK
            t_bytes, t_ops = bytes_ / MEM_BW * 1e3, flops / F32_PEAK * 1e3
            t["bound_ms"] = max(t_bytes, t_ops)
            t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            t["bytes"] = bytes_
            out.setdefault(kind, {})[name] = t
            log(f"[timing] {kind} {name} ({nb}, {QBLOCK}): kernel "
                f"{t['ms']:.4f} / {t['ms_again']:.4f} ms "
                f"({bytes_ / t['ms'] / 1e9:.3f} TB/s, "
                f"{t['bound_ms'] / t['ms']:.3f} of bound), plain "
                f"{t['plain_ms']:.4f} / {t['plain_ms_again']:.4f} ms; bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {bytes_:.0f} B); "
                f"library {t['library_ms']}")
        del x2d, q, p
        torch.cuda.empty_cache()
    return out


def run(args) -> int:
    card = pin_one_card()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to test",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        raise AssertionError(
            f"expected one visible card, see {torch.cuda.device_count()}")
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import _build
        from horovod_tpu_torch.models.resnet import ResNet50
        from horovod_tpu_torch.ops import flash_attention as FA
        from horovod_tpu_torch.ops import quantization as Q
        from horovod_tpu_torch.optim import fused_update as TF
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc}); run "
              "from the repository root", file=sys.stderr)
        return 2

    gpu = nvidia_smi_line(card)
    log(f"[gpu] {gpu}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = ("fused_update", "flash_attention", "quantization")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.load, sources))
    for name in sources:
        info = _build.build_info[name]
        log(f"[build] {name}.cu: nvcc {info['seconds']:.1f} s\n"
            f"{info['log'].strip()}")
    log(f"[build] all {len(sources)} loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    shapes = {"momentum": [tuple(p.shape) for p in
                           ResNet50(device="cpu").parameters()],
              "adam": lm_shapes(LM_SEQ)}
    shapes["sgd"] = shapes["momentum"]
    # B3 at the leaf shapes of both transformer paths (the long-context
    # path adds the (8192, 768) position table)
    checks = kernel_checks(TF, torch, shapes["adam"] + lm_shapes(LONG_SEQ))
    checks.update(attention_checks(FA, torch))
    codec_errs = codec_checks(Q, torch)
    hvd.init()
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    timings = kernel_timings(TF, torch, shapes["momentum"],
                             ("momentum", "sgd"))
    timings.update(kernel_timings(TF, torch, shapes["adam"], ("adam",)))
    timings.update(attention_timings(FA, torch))
    codec_times = codec_timings(Q, torch)
    small_reference(hvd, torch)
    small_lm_reference(hvd, torch)
    torch.backends.cudnn.benchmark = True
    path = main_path(hvd, torch, STEPS, BATCH, gpu, args.profile)
    wire = codec_path(hvd, Q, torch, path.pop("model"), gpu)
    torch.cuda.empty_cache()
    lm = lm_path(hvd, torch, LM_SEQ, LM_BATCH, LM_STEPS, gpu, "transformer",
                 args.profile)
    torch.cuda.empty_cache()
    long_errs = long_context(hvd, torch, FA, gpu, args.profile)
    hvd.shutdown()

    launches = {**path["launches"], **lm["launches"]}
    kernels = []
    for kind in ("momentum", "sgd", "adam"):
        t = timings[kind]
        n_el = sum(math.prod(s) for s in shapes[kind])
        model = "transformer" if kind == "adam" else "ResNet-50"
        kernels.append({
            "name": f"fused_update.{kind}",
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/fused_update.cu",
            "replaces": REPLACES[kind],
            "launches": launches[kind],
            "max_abs_err": checks[kind]["max_abs_err"],
            "max_ulp": checks[kind]["max_ulp"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": "torch.mul" if kind == "sgd" else None,
            "ms_one_buffer": t["ms_one_buffer"],
            "shapes": f"{len(shapes[kind])} {model} leaves, {n_el} f32",
        })
    for name in ("flash_block_step", "flash_bwd_dq", "flash_bwd_dkv"):
        t = timings[name]
        kernels.append({
            "name": f"flash_attention.{name}",
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/flash_attention.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            # the largest over every case, the long-context shape's too
            "max_abs_err": max(checks[name], long_errs[name]),
            "max_abs_err_long": long_errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t["library"],
            "shapes": f"timed at {ATTN_SHAPE} bf16 causal",
        })
    for kind in CODECS:
        t, tl = (codec_times[kind][k] for k in CODEC_BUFFERS)
        kernels.append({
            "name": f"quantization.{kind}",
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/quantization.cu",
            "replaces": REPLACES[kind],
            # the compressors' round trips of the 161 ResNet-50 leaves
            "launches": wire["launches"][kind],
            "max_abs_err": max(codec_errs[kind], wire["errs"][kind]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": CODEC_LIBRARY[kind] or NO_LIBRARY,
            "ms_transformer": tl["ms"], "plain_ms_transformer": tl["plain_ms"],
            "bound_ms_transformer": tl["bound_ms"],
            "library_ms_transformer": tl["library_ms"],
            "shapes": (f"timed at the ResNet-50 fused buffer "
                       f"({-(-N_PARAMS // QBLOCK)}, {QBLOCK}) f32; "
                       "*_transformer at (433227, 256)"),
        })
    log(json.dumps({"kernels": kernels}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="also profile a few steps of each path; write the "
                         "profiler's tables to FILE, FILE_transformer and "
                         "FILE_long")
    args = ap.parse_args()
    try:
        return run(args)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
