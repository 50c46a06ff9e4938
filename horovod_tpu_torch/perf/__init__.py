"""Performance observatory of the port (counterpart of
``horovod_tpu/perf``).

* :mod:`horovod_tpu_torch.perf.goodput` -- the wall-clock ledger: every
  second of a run classified into exclusive phases (init / compile /
  input_wait / compute / comm_exposed / checkpoint / reform /
  unattributed), fleet goodput, the dominant bottleneck and SLO burn
  alerts; ``python -m horovod_tpu_torch.perf goodput <dir>``.

The device-truth half of the JAX package (``xplane``, ``attribution``,
``capture``, ``report``, ``compare``) becomes ``torch.profiler`` traces
in ROADMAP.md Queue A item 12i.  Importing this package stays
stdlib-only.
"""

from __future__ import annotations

from horovod_tpu_torch.perf.goodput import (
    FleetGoodput,
    GoodputLedger,
    fleet_report,
)

__all__ = [
    "FleetGoodput",
    "GoodputLedger",
    "fleet_report",
]
