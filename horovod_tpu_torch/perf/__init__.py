"""Device-truth performance observatory of the port (counterpart of
``horovod_tpu/perf``).

The write half is ``torch.profiler``: the whole-run
``TorchProfilerBridge`` (``HOROVOD_TIMELINE_JAX_PROFILER``), the
framework scopes ``hvd_overlap_rs/math/ag<k>``, ``hvd_zero2_rs<k>``,
``hvd_zero3_ag<k>``, ``hvd_localsgd_outer<g>`` (``record_function``
spans while a profiler records), and ``hvd.trace_step``'s
``hvd_step#<n>`` span.  This package is the read half:

* :mod:`horovod_tpu_torch.perf.kineto` -- a stdlib-only reader of the
  Chrome traces ``torch.profiler`` writes, into the xplane reader's
  shapes;
* :mod:`horovod_tpu_torch.perf.attribution` -- maps device events onto
  the framework's scopes: per-step device comm hidden under compute vs
  exposed, per-collective device seconds, compute seconds, MFU;
* :mod:`horovod_tpu_torch.perf.capture` -- sampled continuous capture
  (``HOROVOD_PROFILE_EVERY_N_STEPS``) feeding the ``hvd_device_*`` /
  ``hvd_mfu`` gauges of the metrics plane;
* :mod:`horovod_tpu_torch.perf.report` / :mod:`~.compare` --
  ``python -m horovod_tpu_torch.perf report <dir>`` and the noise-aware
  regression gate (``baseline`` / ``compare``);
* :mod:`horovod_tpu_torch.perf.goodput` -- the wall-clock ledger: every
  second of a run classified into exclusive phases (init / compile /
  input_wait / compute / comm_exposed / checkpoint / reform /
  unattributed), fleet goodput, the dominant bottleneck and SLO burn
  alerts; ``python -m horovod_tpu_torch.perf goodput <dir>``.

The modules of this package import only the stdlib (torch inside the
capture hooks): no tensorflow, tensorboard or prometheus_client, and
``kineto`` loads with nothing beyond the stdlib.
"""

from __future__ import annotations

from horovod_tpu_torch.perf.attribution import attribute, peak_flops_per_chip
from horovod_tpu_torch.perf.capture import (
    drain,
    last_analysis,
    maybe_start,
    set_step_flops,
    stop_and_analyze,
)
from horovod_tpu_torch.perf.compare import build_baseline, compare_result
from horovod_tpu_torch.perf.goodput import (
    FleetGoodput,
    GoodputLedger,
    fleet_report,
)
from horovod_tpu_torch.perf.kineto import parse_trace, read_trace
from horovod_tpu_torch.perf.report import analyze_dir, format_report

__all__ = [
    "FleetGoodput",
    "GoodputLedger",
    "analyze_dir",
    "attribute",
    "build_baseline",
    "compare_result",
    "drain",
    "fleet_report",
    "format_report",
    "last_analysis",
    "maybe_start",
    "parse_trace",
    "peak_flops_per_chip",
    "read_trace",
    "set_step_flops",
    "stop_and_analyze",
]
