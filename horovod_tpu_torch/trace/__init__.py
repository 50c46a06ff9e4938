"""Offline flight-recorder tooling: ``python -m horovod_tpu_torch.trace``
(counterpart of ``horovod_tpu/trace``; the same dump format, offsets,
report and Chrome trace, so either package's tool reads either's dumps).

Consumes the per-rank JSONL dumps the runtime's flight recorder
(:mod:`horovod_tpu_torch.runtime.flight`) writes into ``HOROVOD_FLIGHT_DIR``:

* ``merge`` — align rank clocks from the heartbeat-piggybacked offset
  samples, emit ONE Perfetto/Chrome trace JSON with a process per rank
  and rows for rounds / collectives / wire / heartbeat / waits /
  lifecycle, and print the analyzer report;
* ``analyze`` — the critical-path / straggler / death report alone.

The modules themselves are stdlib-only — no live job, no device access;
running via ``python -m`` pulls the parent package in, so the host
needs what ``import horovod_tpu_torch`` needs, nothing more.
See docs/flight-recorder.md.
"""

from horovod_tpu_torch.trace.merge import (  # noqa: F401
    RankDump,
    compute_offsets,
    load_dumps,
)
# NOT re-exported as `merge`: that would shadow the submodule on the
# package (import horovod_tpu_torch.trace.merge as m; m.load_dumps -> the
# function's AttributeError).
from horovod_tpu_torch.trace.merge import merge as merge_dumps  # noqa: F401
from horovod_tpu_torch.trace.analyze import analyze, format_report  # noqa: F401
from horovod_tpu_torch.trace.perfetto import chrome_trace  # noqa: F401
