#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``horovod_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``horovod_tpu_torch/csrc`` (``nvcc``);
3. each kernel (B1 momentum, B2 sgd, B3 adam) against its plain PyTorch
   version on the card at 2,359,296 (the largest ResNet-50 leaf),
   25,557,032 (all parameters in one buffer) and 1,000 elements, float32
   and bfloat16, Adam at steps 1 and 3: float32 bit for bit, bfloat16
   within 1 bf16 ulp; then each timed over the 161 ResNet-50 leaves of
   one step beside its plain version, its memory bound and, where one
   PyTorch call computes the same function, that call;
4. a small ResNet (f32, TF32 off) trained 3 steps on the card through
   the fused tail and on the CPU through the plain optimizer: losses and
   weights must agree;
5. the main path: ``init()`` (world 1, NCCL), ResNet-50 at 224x224,
   1000 classes, batch 256, bf16 compute, ``DistributedOptimizer(
   fused_update.sgd(0.1, momentum=0.9))`` with ``HOROVOD_FUSED_UPDATE=1``
   on a seeded synthetic batch; every loss finite and exactly 161
   momentum-kernel launches per step.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``.  ``--profile FILE`` adds a
device-time breakdown of the main path and writes the profiler's full
table to FILE.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

MEM_BW = 3.35e12       # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
F32_PEAK = 67e12       # H100 SXM float32 outside the tensor cores, FLOP/s
STEPS, BATCH = 6, 256  # main path: bench.py's batch per chip
N_LEAF_MAX = 2_359_296
N_PARAMS = 25_557_032
REPLACES = {
    "momentum": "horovod_tpu/optim/fused_update.py:314",
    "sgd": "horovod_tpu/optim/fused_update.py:299",
    "adam": "horovod_tpu/optim/fused_update.py:331",
}
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


def kernel_checks(TF, torch) -> dict:
    """Phase 3a: kernel against plain version; returns per-kernel
    max_abs_err (and max ulp)."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    res = {k: {"max_abs_err": 0.0, "max_ulp": 0} for k in REPLACES}
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
                for a, b in zip(got, want):
                    err = float((a.float() - b.float()).abs().max().item())
                    ulp = ulp_diff(a, b)
                    r = res[kind]
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                    r["max_ulp"] = max(r["max_ulp"], ulp)
                    tol = 0 if dtype == torch.float32 else 1
                    if ulp > tol:
                        raise AssertionError(
                            f"{kind} n={n} {dtype} navg={navg} step={step}:"
                            f" kernel is {ulp} ulp from its plain version "
                            f"(max abs {err})")
            log(f"[kernels] n={n} {str(dtype)[6:]}: sgd, momentum, adam "
                "agree with their plain versions")
            del g, t, v
    return res


def kernel_timings(TF, torch, shapes) -> dict:
    """Phase 3b: each kernel over one step's leaves (the main path's
    shapes), its plain version, and a one-call library equivalent."""
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
    for kind, (kern, plain, lib) in calls.items():
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
    log(f"[main] ResNet-50 224x224 batch {batch} bf16, fused momentum SGD,"
        f" {steps} steps on {gpu}: losses {losses}")
    log(f"[main] step times (s) {times}; steady step {step_s:.4f} s = "
        f"{batch / step_s:.1f} img/s; peak memory "
        f"{peak / 2**30:.2f} GiB; kernel launches {launches}; on {gpu}")
    if profile:
        profile_steps(torch, lambda: train_step(model, opt, images, labels),
                      step_s, profile)
    return {"launches": launches, "losses": losses, "step_s": step_s,
            "peak_bytes": peak}


def profile_steps(torch, step, step_s: float, out: str,
                  steps: int = 3) -> None:
    """``--profile``: device kernel time per main-path step by class
    (``torch.profiler``) and the device's busy share of the profiled
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    ka = prof.key_averages()
    # device activity only: aten:: rows repeat their kernels' time, and
    # "Command Buffer Full" marks the host waiting, not device work
    kern = {e.key: e.self_device_time_total / steps / 1e3 for e in ka
            if e.self_device_time_total > 0
            and not e.key.startswith(("aten::", "cuda"))
            and "Command Buffer" not in e.key}
    if not kern:
        raise AssertionError("the profiler recorded no device time")
    classes = {"convolution (cuDNN)": ("xmma", "conv", "gemm", "cudnn",
                                       "implicit", "cutlass"),
               "fused tail B1": ("momentum_kernel",),
               "NCCL": ("nccl",)}
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
    log(f"[profile] {steps} profiled steps: wall {wall * 1e3:.3f} ms/step "
        f"(unprofiled {step_s * 1e3:.3f}); device kernels "
        f"{busy:.3f} ms/step, busy share {busy / 1e3 / wall:.3f}")
    for name, ms in totals.items():
        log(f"[profile]   {name}: {ms:.3f} ms/step "
            f"({ms / busy:.3f} of device time)")
    for k, ms in sorted(kern.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {ms:9.3f} ms/step  {k[:100]}")


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
        from horovod_tpu_torch.optim import fused_update as TF
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc}); run "
              "from the repository root", file=sys.stderr)
        return 2

    gpu = nvidia_smi_line(card)
    log(f"[gpu] {gpu}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.load("fused_update")
    info = _build.build_info["fused_update"]
    log(f"[build] fused_update.cu: nvcc {info['seconds']:.1f} s (load "
        f"{time.perf_counter() - t0:.1f} s)\n{info['log'].strip()}")

    checks = kernel_checks(TF, torch)
    hvd.init()
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    shapes = [tuple(p.shape) for p in ResNet50(device="cpu").parameters()]
    timings = kernel_timings(TF, torch, shapes)
    small_reference(hvd, torch)
    torch.backends.cudnn.benchmark = True
    path = main_path(hvd, torch, STEPS, BATCH, gpu, args.profile)
    hvd.shutdown()

    kernels = []
    for kind in ("momentum", "sgd", "adam"):
        t = timings[kind]
        kernels.append({
            "name": f"fused_update.{kind}",
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/fused_update.cu",
            "replaces": REPLACES[kind],
            "launches": path["launches"][kind],
            "max_abs_err": checks[kind]["max_abs_err"],
            "max_ulp": checks[kind]["max_ulp"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": "torch.mul" if kind == "sgd" else None,
            "ms_one_buffer": t["ms_one_buffer"],
            "shapes": f"{len(shapes)} ResNet-50 leaves, {N_PARAMS} f32",
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
                    help="also profile a few main-path steps; write the "
                         "profiler's table to FILE")
    args = ap.parse_args()
    try:
        return run(args)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
