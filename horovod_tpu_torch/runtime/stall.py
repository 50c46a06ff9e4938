"""Stall inspector: rank 0's detection of tensors some ranks submitted
and others did not (counterpart of ``horovod_tpu/runtime/stall.py``).

Parity with reference ``horovod/common/stall_inspector.{h,cc}``: warn
after ``HOROVOD_STALL_CHECK_TIME_SECONDS`` (default 60), and, when
``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS`` is positive, fail the stalled
tensors after it (``stall_inspector.h:67-92``).  ``clock`` (default
``time.monotonic``) is injectable, so a test can age a tensor without
sleeping.  It keeps the JAX package's ``hvd_stalled_tensors`` gauge and
records a ``stall`` flight event per warning and at the shutdown
escalation.
"""

from __future__ import annotations

import time

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.runtime import flight as _flight
from horovod_tpu_torch.runtime import metrics as _metrics

_M_STALLED = _metrics.gauge(
    "hvd_stalled_tensors",
    "Pending collectives older than HOROVOD_STALL_CHECK_TIME_SECONDS "
    "on the coordinator (ranks are missing their submissions).")


class StallInspector:
    def __init__(self, world_size: int, clock=time.monotonic) -> None:
        self.world_size = world_size
        self.clock = clock
        self._first_seen: dict[str, float] = {}
        self._warned: set[str] = set()
        self._last_check = 0.0

    def observe(self, name: str) -> None:
        self._first_seen.setdefault(name, self.clock())

    def resolve(self, name: str) -> None:
        self._first_seen.pop(name, None)
        self._warned.discard(name)

    def check(self, pending: dict[str, set[int]]) -> str | None:
        """Called by the coordinator each cycle with the message table's
        pending names -> reporting ranks.  Returns an error string when a
        stall must escalate to shutdown, else None.  The 1 s throttle
        gates only the warning scan; the shutdown threshold is checked on
        every call."""
        if _config.get("stall_check_disable"):
            return None
        now = self.clock()
        warn_window = now - self._last_check >= 1.0
        if warn_window:
            self._last_check = now
        warn_after = _config.get("stall_warning_time")
        shutdown_after = _config.get("stall_shutdown_time")
        stalled_msgs = []
        stalled_count = 0
        for name, ranks in pending.items():
            first = self._first_seen.get(name)
            if first is None:
                continue
            age = now - first
            missing = sorted(set(range(self.world_size)) - ranks)
            if age > warn_after:
                stalled_count += 1
            if shutdown_after > 0 and age > shutdown_after:
                _M_STALLED.set(stalled_count)
                _flight.record("stall", level="shutdown", name=name,
                               missing=missing, age_s=round(age, 1))
                return (f"Stalled collective operation {name}: ranks "
                        f"{missing} have not submitted it for {age:.0f}s "
                        f"(> HOROVOD_STALL_SHUTDOWN_TIME_SECONDS); "
                        "shutting down. One or more ranks may have "
                        "crashed or diverged.")
            if warn_window and age > warn_after \
                    and name not in self._warned:
                self._warned.add(name)
                _flight.record("stall", level="warn", name=name,
                               missing=missing, age_s=round(age, 1))
                stalled_msgs.append(
                    f"{name} [missing ranks: {missing}]")
        _M_STALLED.set(stalled_count)
        if stalled_msgs:
            _log.warning(
                "One or more tensors were submitted to be reduced, "
                "gathered or broadcasted by subset of ranks and are "
                "waiting for remainder of ranks for more than %d seconds. "
                "This may indicate that different ranks are trying to "
                "submit different tensors or that only subset of ranks is "
                "submitting tensors, which will cause deadlock.\n"
                "Stalled ops:\n%s"
                % (int(warn_after), "\n".join(stalled_msgs)))
        return None
