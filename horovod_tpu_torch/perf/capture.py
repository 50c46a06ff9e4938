"""Sampled continuous capture: device truth from a live training job
(counterpart of ``horovod_tpu/perf/capture.py``, with ``torch.profiler``
in place of ``jax.profiler``).

``HOROVOD_PROFILE_EVERY_N_STEPS=N`` makes ``hvd.trace_step`` capture one
full step every N (CPU and CUDA activities) into a rotating per-rank
directory (``HOROVOD_PROFILE_DIR/rank<k>/step<nnnnnnnn>/``, newest
``HOROVOD_PROFILE_KEEP`` kept), analyze its Chrome trace on a background
thread with the stdlib reader (:mod:`~horovod_tpu_torch.perf.kineto`),
and feed the result into the metrics registry:

* ``hvd_device_compute_seconds`` -- merged device compute per step;
* ``hvd_device_comm_seconds`` / ``hvd_device_comm_hidden_seconds`` /
  ``hvd_device_comm_exposed_seconds`` -- device collective time and how
  much of it the overlap/ZeRO schedules hid under compute;
* ``hvd_device_comm_kind_seconds{kind=...}`` -- per-collective split;
* ``hvd_mfu`` -- when a flops-per-step hint is registered
  (:func:`set_step_flops`) and the card's peak is known (spec table or
  ``HOROVOD_PEAK_FLOPS_PER_CHIP``).

The gauges ride the KV snapshot publisher to the launcher's fleet
``/metrics`` merge and land on flight-recorder dumps.

Design constraints:

* the module imports stdlib-only (torch lazily inside the hooks) -- the
  metrics plane pulls this in from ``trace_step``;
* every hook is advisory: a capture/analysis failure increments a
  counter and never takes a training step down;
* analysis runs off the training thread, and off its process: a
  background thread hands the trace to a child interpreter that loads
  the reader and the attribution alone (stdlib only) and waits for its
  JSON.  Parsing a step's trace in a thread would hold the interpreter
  lock for seconds, and every op the training thread dispatches in
  that time waits for it; :func:`drain` joins outstanding analyzers.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log

_lock = threading.Lock()
_state = {
    "count": 0,            # trace_step spans seen
    "active": None,        # in-flight capture dict
    "threads": [],         # outstanding analyzer threads
    "last": None,          # last analysis result dict
    "flops": None,         # flops per trace_step span (hint)
    "warned": False,
    "wire0": 0.0,          # wire-byte counter at capture start
}


def _metrics():
    from horovod_tpu_torch.runtime import metrics as _m

    return _m


def set_step_flops(flops: float | None) -> None:
    """Register the flops executed per ``trace_step`` span (a
    ``torch.utils.flop_counter.FlopCounterMode`` count of one step;
    multiply by the steps a span chains).  Enables the ``hvd_mfu`` gauge
    and the report's MFU column."""
    with _lock:
        _state["flops"] = float(flops) if flops else None


def last_analysis() -> dict | None:
    """Most recent completed capture analysis (or None)."""
    with _lock:
        return _state["last"]


def reset() -> None:  # test hook
    with _lock:
        _state.update(count=0, active=None, threads=[], last=None,
                      flops=None, warned=False, wire0=0.0)


def _profile_root() -> str:
    return str(_config.get("profile_dir") or "hvd_profile")


def _rank() -> int:
    try:
        from horovod_tpu_torch.common import basics as _basics

        st = _basics.state()
        return st.rank if st.initialized else 0
    except Exception:
        return 0


def _bridge_active() -> bool:
    """True when the whole-run TorchProfilerBridge capture owns the
    profiler -- CUPTI serves one profiler per process, so sampling must
    yield."""
    try:
        from horovod_tpu_torch.common import basics as _basics

        prof = _basics.state().profiler
        return bool(prof is not None and getattr(prof, "_active", True))
    except Exception:
        return False


def _count_failure() -> None:
    try:
        _metrics().counter(
            "hvd_profile_capture_failures_total",
            "Sampled-capture start/stop/analyze failures.").inc()
    except Exception:
        pass


def _cuda_device():
    """The card this rank computes on, or None (a CPU run, or CUDA not
    initialized in this process)."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    try:
        from horovod_tpu_torch.common import basics as _basics

        dev = _basics.state().device
        if dev.type == "cuda":
            return dev
    except Exception:
        pass
    return torch.device("cuda", torch.cuda.current_device())


def _open_profiler():
    """A started ``torch.profiler.profile`` over the CPU and, where this
    rank computes on a card, CUDA activities."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if _cuda_device() is not None:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def maybe_start(step: int | None) -> dict | None:
    """Called by ``trace_step`` on span entry (BEFORE the step
    annotation opens, so the annotation lands inside the capture).
    Returns a capture token to pass to :func:`stop_and_analyze`, or
    None when this span is not sampled.  Never raises."""
    try:
        every = int(_config.get("profile_every_n") or 0)
    except (TypeError, ValueError):
        every = 0
    if every <= 0:
        return None
    with _lock:
        count = _state["count"]
        _state["count"] = count + 1
        if _state["active"] is not None:
            return None  # a prior span's capture never stopped; bail
        # skip span 0: the first traced span usually pays the warm-up
        # (kernel builds, cuDNN autotuning) and would dominate every
        # rotating window
        if count == 0 or count % every != 0:
            return None
        # Backpressure: when steps outpace the analyzer, piling up a
        # thread per sample would burn host memory/GIL against training
        # AND let _rotate delete capture dirs whose queued analysis
        # never ran.  Skip sampling until the in-flight analysis
        # finishes -- the next due span picks up.
        _state["threads"] = [x for x in _state["threads"]
                             if x.is_alive()]
        backlog = bool(_state["threads"])
    if backlog:
        try:
            _metrics().counter(
                "hvd_profile_skips_total",
                "Sampled spans skipped because the previous capture's "
                "analysis was still in flight (analyzer backpressure)."
            ).inc()
        except Exception:
            pass
        return None
    if _bridge_active():
        with _lock:
            if not _state["warned"]:
                _state["warned"] = True
                _log.warning(
                    "HOROVOD_PROFILE_EVERY_N_STEPS is set but the "
                    "whole-run torch.profiler capture "
                    "(HOROVOD_TIMELINE_JAX_PROFILER) owns the profiler; "
                    "sampled captures are disabled for this run")
        return None
    step_id = int(step) if step is not None else count
    out_dir = os.path.join(_profile_root(), f"rank{_rank()}",
                           f"step{step_id:08d}")
    try:
        os.makedirs(out_dir, exist_ok=True)
        prof = _open_profiler()
    except Exception as exc:
        _count_failure()
        with _lock:
            if not _state["warned"]:
                _state["warned"] = True
                _log.warning(f"sampled profiler capture unavailable: "
                             f"{exc!r}")
        return None
    token = {"dir": out_dir, "step": step_id, "t0": time.time(),
             "prof": prof}
    with _lock:
        _state["active"] = token
        try:
            _state["wire0"] = _metrics().counter(
                "hvd_data_wire_bytes_total").total()
        except Exception:
            _state["wire0"] = 0.0
    return token


def _sync_devices() -> None:
    """Drain in-flight device work before the profiler stops: dispatch
    is asynchronous, so without a fence the sampled step's kernels would
    still be running when the capture ends -- it would hold the host's
    dispatch but little of the device work it exists to measure."""
    import torch

    dev = _cuda_device()
    if dev is not None:
        torch.cuda.synchronize(dev)


def trace_path(capture_dir: str) -> str:
    """Where a capture of this process writes its Chrome trace (the
    ``tensorboard_trace_handler`` file name)."""
    return os.path.join(
        capture_dir, f"{socket.gethostname()}_{os.getpid()}."
        f"{time.time_ns() // 1_000_000}.pt.trace.json")


def stop_and_analyze(token: dict) -> None:
    """Called by ``trace_step`` on span exit for a sampled span: stop
    the capture, write its trace, and analyze it on a background thread.
    Never raises."""
    prof = token.pop("prof", None)
    try:
        try:
            # fence cost lands only on sampled spans (1/N), which are
            # already perturbed by the capture itself
            _sync_devices()
        except Exception:
            pass  # advisory: the capture still holds what executed
        prof.stop()
        prof.export_chrome_trace(trace_path(token["dir"]))
    except Exception:
        _count_failure()
        with _lock:
            _state["active"] = None
        return
    with _lock:
        _state["active"] = None
        flops = _state["flops"]
        wire0 = _state["wire0"]
        try:
            wire_bytes = max(
                0.0,
                _metrics().counter("hvd_data_wire_bytes_total").total()
                - wire0)
        except Exception:
            wire_bytes = 0.0
    t = threading.Thread(
        target=_analyze, args=(token, flops, wire_bytes),
        name="hvd-perf-analyze", daemon=True)
    with _lock:
        _state["threads"] = [x for x in _state["threads"]
                             if x.is_alive()] + [t]
    t.start()


def drain(timeout_s: float = 30.0) -> None:
    """Join outstanding analyzer threads (bounded), before reading
    :func:`last_analysis` or the gauges."""
    deadline = time.monotonic() + timeout_s
    with _lock:
        threads = list(_state["threads"])
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))


def _device_kind() -> str:
    try:
        import torch

        dev = _cuda_device()
        return torch.cuda.get_device_name(dev) if dev is not None else ""
    except Exception:
        return ""


def _analyze(token: dict, flops, wire_bytes) -> None:
    try:
        result = analyze_capture(token["dir"], flops_per_step=flops,
                                 wire_bytes=wire_bytes)
        if result is None:
            raise RuntimeError("no trace landed in the capture dir")
        result["rank"] = _rank()
        result["capture_dir"] = token["dir"]
        result["captured_step"] = token["step"]
        with open(os.path.join(token["dir"], "analysis.json"), "w") as f:
            json.dump(result, f)
        _publish(result)
        with _lock:
            _state["last"] = result
        from horovod_tpu_torch.runtime import flight as _flight

        tot = result.get("totals", {})
        _flight.record("device_truth", step=token["step"],
                       compute_s=tot.get("compute_s"),
                       comm_exposed_s=tot.get("comm_exposed_s"),
                       mfu=tot.get("mfu"))
    except Exception as exc:
        _count_failure()
        try:
            _log.debug(f"sampled-capture analysis failed: {exc!r}")
        except Exception:
            pass
    finally:
        try:
            _rotate(os.path.dirname(token["dir"]))
        except Exception:
            pass


# The analyzer's child: this package's reader and attribution load as
# submodules of stand-in packages, so neither package's __init__ (torch)
# runs there.
_CHILD = r"""
import json, sys, types
for name, path in zip(("horovod_tpu_torch", "horovod_tpu_torch.perf"),
                      sys.argv[1:3]):
    sys.modules[name] = types.ModuleType(name)
    sys.modules[name].__path__ = [path]
from horovod_tpu_torch.perf import attribution, kineto
a = json.loads(sys.argv[3])
json.dump(attribution.attribute(
    kineto.read_trace(a["path"]), flops_per_step=a["flops"],
    peak_flops=a["peak"], wire_bytes=a["wire"]), sys.stdout)
"""


def analyze_capture(capture_dir: str, flops_per_step=None,
                    wire_bytes=None) -> dict | None:
    """Parse + attribute the newest Chrome trace under ``capture_dir``
    in a child interpreter.  Returns the attribution dict (with
    ``trace_path``) or None when no trace file exists."""
    from horovod_tpu_torch.perf import attribution as _attr

    path = newest_trace(capture_dir)
    if path is None:
        return None
    peak = _attr.peak_flops_per_chip(_device_kind())
    perf_dir = os.path.dirname(os.path.abspath(__file__))
    args = {"path": path, "flops": flops_per_step, "peak": peak,
            "wire": wire_bytes}
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, os.path.dirname(perf_dir), perf_dir,
         json.dumps(args)], capture_output=True, text=True, check=True,
        timeout=600)
    result = json.loads(out.stdout)
    result["trace_path"] = path
    if peak:
        result["peak_flops_per_chip"] = peak
    return result


def newest_trace(root: str) -> str | None:
    """The most recently written Chrome trace below ``root``."""
    from horovod_tpu_torch.perf import kineto as _kt

    newest, newest_m = None, -1.0
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            if _kt.is_trace_file(fn):
                p = os.path.join(dirpath, fn)
                try:
                    m = os.path.getmtime(p)
                except OSError:
                    continue
                if m > newest_m:
                    newest, newest_m = p, m
    return newest


def _publish(result: dict) -> None:
    """Device-truth gauges into the metrics registry (KV-published to
    the launcher fleet merge by the snapshot publisher)."""
    m = _metrics()
    tot = result.get("totals") or {}
    step_pairs = (
        ("hvd_device_compute_seconds",
         "Device compute seconds in the last sampled step (xplane "
         "truth).", "compute_s_per_step"),
        ("hvd_device_comm_seconds",
         "Device collective seconds in the last sampled step.",
         "comm_s_per_step"),
        ("hvd_device_comm_hidden_seconds",
         "Device collective seconds overlapped under compute in the "
         "last sampled step.", "comm_hidden_s_per_step"),
        ("hvd_device_comm_exposed_seconds",
         "Device collective seconds NOT hidden under compute in the "
         "last sampled step — the overlap schedules' true residual.",
         "comm_exposed_s_per_step"),
    )
    for name, help_, key in step_pairs:
        if key in tot:
            m.gauge(name, help_).set(tot[key])
    if tot.get("mfu") is not None:
        m.gauge("hvd_mfu",
                "Model flops utilization of the last sampled step "
                "(cost_analysis flops / peak chip flops).").set(
            tot["mfu"])
    kinds: dict = {}
    for s in result.get("steps") or []:
        for k, v in (s.get("comm_by_kind") or {}).items():
            kinds[k] = kinds.get(k, 0.0) + v
    n = max(1, len(result.get("steps") or []))
    # The gauge reflects ONE capture: kinds absent from it (schedule
    # change, re-form) must not linger as phantom series in the fleet
    # merge -- atomic swap, so a concurrent snapshot never sees the
    # partially-populated window between a reset and the re-sets.
    m.gauge(
        "hvd_device_comm_kind_seconds",
        "Per-collective device seconds per step in the last "
        "sampled capture.").replace(
        [({"kind": k}, round(v / n, 6)) for k, v in kinds.items()])
    m.counter("hvd_profile_captures_total",
              "Sampled step captures analyzed.").inc()
    m.gauge("hvd_profile_last_step",
            "Step index of the last sampled capture.").set(
        result.get("captured_step", -1))


def _rotate(rank_dir: str) -> None:
    """Keep the newest HOROVOD_PROFILE_KEEP step dirs per rank."""
    try:
        keep = max(1, int(_config.get("profile_keep")))
    except (TypeError, ValueError):
        keep = 4
    try:
        entries = sorted(
            e for e in os.listdir(rank_dir) if e.startswith("step"))
    except OSError:
        return
    for stale in entries[:-keep]:
        shutil.rmtree(os.path.join(rank_dir, stale), ignore_errors=True)
