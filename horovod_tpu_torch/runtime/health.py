"""Training-health plane: numerics telemetry, NaN culprit attribution,
divergence sentinels (counterpart of ``horovod_tpu/runtime/health.py``;
the same metric series, flight events, dump files and report).

The other observability planes watch the machinery; this one watches
the model.  A NaN injected by one rank poisons every rank's allreduce
and surfaces as everyone's NaN; here it names its culprit:

* **stat taps** -- ``DistributedOptimizer`` (every ZeRO stage, overlap
  on or off, the ``(cross, local)`` pair) and the eager executor's
  allreduce/reducescatter compute per-dtype-group statistics of this
  rank's PRE-reduction gradients: the finite-part norm, the max-abs and
  the nonfinite count (:func:`group_stats`, a handful of launches per
  chunk, no full-size copy).  One small packed per-rank verdict vector
  is all-gathered per step, so a nonfinite names its rank and dtype
  group.
* **update-to-weight ratio** after the update, rank-locally
  (shard-locally under ZeRO), with no communication.
* **HealthMonitor** on the host -- EWMA divergence sentinels with
  hysteresis over the loss and the grad norm (``HOROVOD_HEALTH_*``),
  publishing ``hvd_grad_norm`` / ``hvd_update_ratio`` /
  ``hvd_nonfinite_total{group,rank}`` / ``hvd_health_alert{reason}``,
  recording ``health`` events on the flight ring, and giving the
  compression guardrail its loss verdict (:func:`loss_guard`).
* **skip-step contract** -- ``HOROVOD_HEALTH_SKIP_NONFINITE=1``: a step
  whose verdict carries a nonfinite changes no parameter and no
  optimizer state.

Where the JAX package publishes through ``jax.debug.callback``, the
port copies the small verdict without blocking into pinned host memory
and publishes it one step late (at the next tap) or at :func:`flush`,
so the stats add no device-to-host synchronisation to a step; the skip
knob reads the verdict on the host once per step.  Import stays
torch-free: the taps import torch lazily.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log
from horovod_tpu_torch.runtime import flight as _flight
from horovod_tpu_torch.runtime import metrics as _metrics

# ---------------------------------------------------------------------------
# Metric surface (docs/metrics.md catalog)
# ---------------------------------------------------------------------------

_M_GRAD_NORM = _metrics.gauge(
    "hvd_grad_norm",
    "Pre-reduction global gradient norm per dtype group: sqrt of the "
    "sum over ranks of each rank's finite-part local ||g||^2 (from "
    "the health verdict allgather — zero extra full-size buffers).  "
    "group=all is the all-group total the divergence sentinel "
    "watches.")
_M_GRAD_MAXABS = _metrics.gauge(
    "hvd_grad_max_abs",
    "Largest finite |gradient| element across ranks per dtype group "
    "(pre-reduction).")
_M_UPDATE_RATIO = _metrics.gauge(
    "hvd_update_ratio",
    "Post-update ||update|| / ||param|| per dtype group, computed "
    "rank-locally (shard-locally under ZeRO) — the update-to-weight "
    "divergence leading indicator.")
_M_NONFINITE = _metrics.counter(
    "hvd_nonfinite_total",
    "Nonfinite gradient elements observed PRE-reduction, labeled by "
    "culprit rank and dtype group — the attribution a post-reduction "
    "NaN cannot give.")
_M_ALERT = _metrics.gauge(
    "hvd_health_alert",
    "1 while a health alert is active, labeled reason=nonfinite | "
    "loss_divergence | grad_norm_divergence | loss_nonfinite "
    "(docs/health.md sentinel semantics).")
_M_LOSS = _metrics.gauge(
    "hvd_loss",
    "Last loss value observed by hvd.health.observe_loss() — the real "
    "convergence signal the compression guardrail consumes.")
_M_SKIPPED = _metrics.counter(
    "hvd_health_skipped_steps_total",
    "Optimizer steps suppressed by HOROVOD_HEALTH_SKIP_NONFINITE "
    "(update zeroed, state held) after a nonfinite verdict.")

#: Samples a sentinel's EWMA must absorb before it may breach — a
#: noisy first loss value must not trip the alarm (docs/health.md).
WARMUP_SAMPLES = 5

_TINY = 1e-12


def enabled() -> bool:
    """The ``HOROVOD_HEALTH`` master switch (validated at the round-0
    handshake: the taps change the negotiated programs)."""
    return bool(_config.get("health"))


def skip_enabled() -> bool:
    return bool(_config.get("health_skip_nonfinite"))


# ---------------------------------------------------------------------------
# Divergence sentinel (EWMA + hysteresis)
# ---------------------------------------------------------------------------


class Sentinel:
    """One signal's divergence detector: an EWMA baseline and a
    trip/clear hysteresis counter pair.

    A sample *breaches* when it exceeds ``ratio x EWMA`` (or is
    nonfinite).  ``trip_steps`` consecutive breaches raise the alert;
    ``clear_steps`` consecutive healthy samples clear it.  The EWMA
    absorbs only healthy finite samples — a baseline that chased the
    divergence would never trip (pinned by the hysteresis unit
    tests)."""

    def __init__(self, reason: str, alpha: float, ratio: float,
                 trip_steps: int, clear_steps: int):
        self.reason = reason
        self.alpha = max(min(float(alpha), 1.0), 1e-6)
        self.ratio = float(ratio)
        self.trip_steps = max(1, int(trip_steps))
        self.clear_steps = max(1, int(clear_steps))
        self.mean: float | None = None
        self.samples = 0
        self.last: float | None = None
        self.breaches = 0
        self.healthy = 0
        self.active = False
        self.trips = 0

    def observe(self, value: float) -> str | None:
        """Feed one sample; returns ``"trip"`` / ``"clear"`` on a state
        change, else None."""
        self.last = value
        finite = isinstance(value, (int, float)) and math.isfinite(value)
        warm = self.samples >= WARMUP_SAMPLES and self.mean is not None
        # Ratio breaches need a POSITIVE baseline: against a negative
        # EWMA (e.g. an ELBO/negative-log-likelihood loss) the
        # threshold would collapse to ~0 and normal noise around zero
        # would false-trip — such signals rely on the nonfinite and
        # grad-norm sentinels instead (docs/health.md).
        breach = (not finite) or (
            warm and self.ratio > 0 and self.mean > _TINY
            and value > self.ratio * self.mean)
        event = None
        if breach:
            self.breaches += 1
            self.healthy = 0
            if not self.active and self.breaches >= self.trip_steps:
                self.active = True
                self.trips += 1
                event = "trip"
        else:
            self.healthy += 1
            self.breaches = 0
            if self.active and self.healthy >= self.clear_steps:
                self.active = False
                event = "clear"
        if finite and not breach:
            self.mean = (value if self.mean is None else
                         (1 - self.alpha) * self.mean
                         + self.alpha * value)
            self.samples += 1
        return event

    def state(self) -> dict:
        return {"reason": self.reason, "active": self.active,
                "trips": self.trips, "ewma": self.mean,
                "last": self.last, "samples": self.samples,
                "breaches": self.breaches}


class HealthMonitor:
    """Host-side consumer of the in-trace stats: sentinels, alert
    gauges, flight events, dumps and the guardrail's loss verdict.
    ``clock`` is injectable for the fake-clock unit tests."""

    def __init__(self, clock=time.time):
        self._lock = threading.RLock()
        self._clock = clock
        ratio = float(_config.get("health_sentinel_ratio"))
        alpha = float(_config.get("health_ewma_alpha"))
        trip = int(_config.get("health_trip_steps"))
        clear = int(_config.get("health_clear_steps"))
        self.loss = Sentinel("loss_divergence", alpha, ratio, trip, clear)
        self.grad = Sentinel("grad_norm_divergence", alpha, ratio, trip,
                             clear)
        self.nonfinite_events = 0      # verdicts that carried a nonfinite
        self.nonfinite_elems = 0.0
        self.culprits: dict = {}       # (rank, group) -> elem count
        self.first_nonfinite: dict | None = None
        # Clean-streak counters for the latched-alert clears: the
        # nonfinite alerts are raised by single events, so their
        # hysteresis rides consecutive CLEAN observations (clear_steps
        # verdicts without a nonfinite / finite losses) — a transient
        # NaN recovered by the skip contract must not pin the alert
        # (and the guardrail) for the rest of a long run.
        self._nf_clean_streak = 0
        self._loss_finite_streak = 0
        self._loss_obs_at_last_nf: int | None = None
        # Wire-round bookkeeping (eager regime): a negotiation round
        # whose dispatches produced no nonfinite verdict counts as one
        # clean step toward the clear hysteresis — per ROUND, not per
        # fused buffer, so K buffers per step cannot shrink the
        # configured clear window K-fold.
        self._wire_round: int | None = None
        self._nf_events_at_round = 0
        self.skipped_steps = 0
        self.last_grad_norm: float | None = None
        self.last_loss: float | None = None
        self.loss_observed = 0
        self._alerts: dict[str, bool] = {}
        self._alert_log: list = []

    # -- alert bookkeeping -------------------------------------------------

    def _raise_alert(self, reason: str, **detail) -> None:
        with self._lock:
            fresh = not self._alerts.get(reason)
            self._alerts[reason] = True
            if fresh:
                rec = {"reason": reason, "time": self._clock(), **detail}
                self._alert_log.append(rec)
        if fresh:
            _M_ALERT.set(1, reason=reason)
            _flight.record("health", event="sentinel_trip", reason=reason,
                           **{k: v for k, v in detail.items()
                              if isinstance(v, (int, float, str))})
            _log.warning(f"[health] alert {reason}: {detail}")

    def _clear_alert(self, reason: str) -> None:
        with self._lock:
            # Never INSERT the key: clearing a reason that never
            # tripped would publish a phantom hvd_health_alert series
            # at 0 on healthy runs (and live-endpoint reports count
            # every series toward the lifetime total).
            if not self._alerts.get(reason):
                return
            self._alerts[reason] = False
        _M_ALERT.set(0, reason=reason)
        _flight.record("health", event="sentinel_clear", reason=reason)

    def alerts_total(self) -> int:
        with self._lock:
            return len(self._alert_log)

    def active_alerts(self) -> list[str]:
        with self._lock:
            return sorted(r for r, on in self._alerts.items() if on)

    # -- observations ------------------------------------------------------

    def observe_loss(self, value: float, step: int | None = None) -> None:
        value = float(value)
        with self._lock:
            self.last_loss = value
            self.loss_observed += 1
        _M_LOSS.set(value)
        if not math.isfinite(value):
            with self._lock:
                self._loss_finite_streak = 0
            self._raise_alert("loss_nonfinite", value=repr(value),
                              step=step if step is not None else -1)
            return
        with self._lock:
            self._loss_finite_streak += 1
            clear_nf = (self._loss_finite_streak
                        >= self.loss.clear_steps)
            # The gradient-nonfinite alert's loss-streak clear (the
            # eager regime's recovery evidence — its per-buffer wire
            # verdicts deliberately do not drive the clear hysteresis,
            # see note_verdict) additionally requires clear_steps loss
            # observations since the LAST nonfinite event: under
            # persistent poisoning with the skip contract on, the loss
            # stays finite while verdicts keep arriving poisoned, and
            # clearing on the loss streak alone would flap the alert
            # (and momentarily unpin the compression guardrail) every
            # clear_steps losses.
            clear_grad_nf = clear_nf and (
                self._loss_obs_at_last_nf is None
                or self.loss_observed - self._loss_obs_at_last_nf
                >= self.loss.clear_steps)
        if clear_nf:
            self._clear_alert("loss_nonfinite")
        if clear_grad_nf:
            self._clear_alert("nonfinite")
        with self._lock:  # sentinel state must never tear in a dump
            ev = self.loss.observe(value)
        if ev == "trip":
            self._raise_alert(self.loss.reason, value=value,
                              ewma=self.loss.mean)
        elif ev == "clear":
            self._clear_alert(self.loss.reason)

    def observe_grad_norm(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.last_grad_norm = value
        if not math.isfinite(value):
            return
        with self._lock:  # sentinel state must never tear in a dump
            ev = self.grad.observe(value)
        if ev == "trip":
            self._raise_alert(self.grad.reason, value=value,
                              ewma=self.grad.mean)
        elif ev == "clear":
            self._clear_alert(self.grad.reason)

    def note_verdict(self, had_nonfinite: bool) -> None:
        """Once per WHOLE-STEP verdict (the in-trace optimizer tap):
        drives the nonfinite alert's clear side — ``clear_steps``
        consecutive clean verdicts clear a latched nonfinite alert
        (the raise side is :meth:`note_nonfinite`).  Per-buffer wire
        verdicts must NOT call this: several fused buffers per step
        would shrink the configured hysteresis buffer-count-fold (the
        eager regime's clear evidence is the finite-loss streak in
        :meth:`observe_loss` instead)."""
        with self._lock:
            if had_nonfinite:
                self._nf_clean_streak = 0
                return
            self._nf_clean_streak += 1
            clear = self._nf_clean_streak >= self.loss.clear_steps
        if clear:
            self._clear_alert("nonfinite")

    def note_wire_round(self, rnd: int) -> None:
        """Once per negotiated data-plane round with health on (the
        background dispatch calls it): a COMPLETED round whose
        verdicts were all clean advances the nonfinite alert's clear
        streak by one — the eager regime's per-step clear evidence
        for jobs that never feed a loss (per round, not per fused
        buffer, so the configured hysteresis holds)."""
        with self._lock:
            if self._wire_round is None:
                self._wire_round = rnd
                self._nf_events_at_round = self.nonfinite_events
                return
            if rnd == self._wire_round:
                return
            clean = self.nonfinite_events == self._nf_events_at_round
            self._wire_round = rnd
            self._nf_events_at_round = self.nonfinite_events
            if clean:
                self._nf_clean_streak += 1
            clear = (clean and self._nf_clean_streak
                     >= self.loss.clear_steps)
        if clear:
            self._clear_alert("nonfinite")

    def note_nonfinite(self, count: float, group: str, rank: int) -> None:
        """One verdict row reported ``count`` nonfinite elements from
        ``rank``'s ``group`` buffer — culprit attribution."""
        first = False
        with self._lock:
            self._nf_clean_streak = 0
            self._loss_obs_at_last_nf = self.loss_observed
            self.nonfinite_events += 1
            self.nonfinite_elems += float(count)
            key = (int(rank), str(group))
            self.culprits[key] = self.culprits.get(key, 0.0) + float(count)
            if self.first_nonfinite is None:
                first = True
                self.first_nonfinite = {
                    "time": self._clock(), "rank": int(rank),
                    "group": str(group), "count": float(count)}
        if first:
            _flight.record("health", event="first_nonfinite",
                           culprit=int(rank), group=str(group),
                           count=float(count))
        self._raise_alert("nonfinite", rank=int(rank), group=str(group))

    def note_skip(self) -> None:
        with self._lock:
            self.skipped_steps += 1
        _M_SKIPPED.inc()
        _flight.record("health", event="skip_step")

    # -- guardrail / snapshot surfaces -------------------------------------

    def loss_guard(self) -> dict | None:
        """The compression guardrail's PRIMARY signal (docs/health.md,
        docs/compression.md): a verdict on the real loss trajectory,
        or None when no loss has been observed (the residual-ratio
        proxy then stays in charge as the fallback)."""
        with self._lock:
            if self.loss_observed < WARMUP_SAMPLES:
                return None
            diverged = (self._alerts.get("loss_divergence", False)
                        or self._alerts.get("loss_nonfinite", False)
                        or self._alerts.get("nonfinite", False))
            ratio = None
            if (self.loss.mean is not None and self.last_loss is not None
                    and math.isfinite(self.last_loss)):
                ratio = self.last_loss / max(self.loss.mean, _TINY)
            return {"diverged": bool(diverged), "ratio": ratio,
                    "samples": self.loss_observed}

    def refresh(self) -> None:
        """Metrics snapshot hook: re-publish the alert gauge series so
        every scrape/publish carries the current alert states (a rank
        that never re-observes after a trip must still export it)."""
        with self._lock:
            series = [({"reason": r}, 1.0 if on else 0.0)
                      for r, on in sorted(self._alerts.items())]
        if series:
            _M_ALERT.replace(series)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "time": self._clock(),
                "last_loss": self.last_loss,
                "last_grad_norm": self.last_grad_norm,
                "loss_observed": self.loss_observed,
                "nonfinite_events": self.nonfinite_events,
                "nonfinite_elems": self.nonfinite_elems,
                "culprits": [{"rank": r, "group": g, "count": c}
                             for (r, g), c in sorted(self.culprits.items())],
                "first_nonfinite": dict(self.first_nonfinite)
                if self.first_nonfinite else None,
                "skipped_steps": self.skipped_steps,
                "alerts_total": len(self._alert_log),
                "active_alerts": sorted(
                    r for r, on in self._alerts.items() if on),
                "alert_log": [dict(a) for a in self._alert_log],
                "sentinels": {"loss": self.loss.state(),
                              "grad_norm": self.grad.state()},
            }


_monitor: HealthMonitor | None = None
_monitor_lock = threading.Lock()


def monitor() -> HealthMonitor:
    global _monitor
    m = _monitor
    if m is None:
        with _monitor_lock:
            m = _monitor
            if m is None:
                m = _monitor = HealthMonitor()
                _metrics.add_snapshot_hook(_refresh_hook)
    return m


def _refresh_hook() -> None:
    _deferred.flush()
    m = _monitor
    if m is not None:
        m.refresh()


def reset() -> None:
    """Test hook: fresh monitor + cleared health gauge series."""
    global _monitor
    _deferred.clear()
    with _monitor_lock:
        _metrics.remove_snapshot_hook(_refresh_hook)
        _monitor = None
    for m in (_M_ALERT, _M_GRAD_NORM, _M_GRAD_MAXABS, _M_UPDATE_RATIO,
              _M_NONFINITE, _M_LOSS, _M_SKIPPED):
        m.reset()


def observe_loss(value: float, step: int | None = None) -> None:
    """Feed the real loss trajectory to the health plane — the
    divergence sentinel's and the compression guardrail's primary
    signal.  Host-side and cheap; call it once per step (bench does)."""
    monitor().observe_loss(value, step=step)


def loss_guard() -> dict | None:
    m = _monitor
    return m.loss_guard() if m is not None else None


def note_wire_round(rnd: int) -> None:
    """Background-dispatch hook (eager regime): see
    :meth:`HealthMonitor.note_wire_round`.  Touches the monitor only
    if one already exists — a clean round is only evidence once a
    verdict has been observed."""
    m = _monitor
    if m is not None:
        m.note_wire_round(int(rnd))


# ---------------------------------------------------------------------------
# Verdict publication (host side)
# ---------------------------------------------------------------------------


def _own_rank() -> int:
    try:
        from horovod_tpu_torch.common import basics as _basics

        st = _basics.state()
        if st.initialized:
            return int(st.rank)
    except Exception:
        pass
    return 0


def publish_verdict(gathered, idx=None, groups: tuple = (),
                    sentinel: bool = True) -> None:
    """Host side of the packed per-rank verdict allgather.  ``gathered``
    is ``(n, 1 + 3G)``: per rank ``[rank, (sumsq, maxabs, nonfinite)
    x G]`` with sumsq/maxabs over the FINITE part (NaN-proof) and the
    nonfinite element count carrying the poison signal.

    ``idx`` is the executing device's axis index: under a
    single-process multi-device mesh the host callback fires once per
    device with the identical replicated verdict, so counters would be
    multiplied device-fold — only the invocation whose device IS this
    process's rank publishes (exactly one publication per process in
    every regime; in the one-device-per-process regime idx == rank by
    the mesh construction).

    ``sentinel=False`` (the per-buffer wire taps): publish the gauges
    and culprit attribution but do NOT feed the grad-norm divergence
    sentinel — the eager wire fires once per negotiated fused buffer,
    and an EWMA fed per-buffer norms of wildly different magnitudes
    would false-trip on every big buffer.  The sentinel eats only
    whole-step verdicts (the in-trace optimizer tap) and the loss
    trajectory."""
    import numpy as np

    if idx is not None and int(np.asarray(idx)) != _own_rank():
        return
    arr = np.asarray(gathered, dtype=np.float64)
    g = max(1, len(groups))
    arr = arr.reshape(-1, 1 + 3 * g)
    m = monitor()
    total_sumsq = 0.0
    had_nonfinite = False
    for gi, gname in enumerate(groups):
        col = 1 + 3 * gi
        sumsq = float(np.sum(np.maximum(arr[:, col], 0.0)))
        maxab = float(np.max(arr[:, col + 1])) if arr.size else 0.0
        _M_GRAD_NORM.set(math.sqrt(max(sumsq, 0.0)), group=str(gname))
        if math.isfinite(maxab):
            _M_GRAD_MAXABS.set(maxab, group=str(gname))
        for row in arr:
            cnt = float(row[col + 2])
            if math.isfinite(cnt) and cnt > 0:
                had_nonfinite = True
                rk = int(row[0]) if math.isfinite(row[0]) else -1
                _M_NONFINITE.inc(cnt, group=str(gname), rank=str(rk))
                m.note_nonfinite(cnt, str(gname), rk)
        total_sumsq += max(sumsq, 0.0)
    if sentinel:
        # whole-step verdicts only: sentinel EWMA + the nonfinite
        # alert's clean-streak clear (per-buffer wire verdicts would
        # shrink the clear hysteresis buffer-count-fold)
        m.note_verdict(had_nonfinite)
        norm = math.sqrt(total_sumsq)
        _M_GRAD_NORM.set(norm, group="all")
        m.observe_grad_norm(norm)


def publish_update_ratio(ratios, groups: tuple) -> None:
    import numpy as np

    arr = np.asarray(ratios, dtype=np.float64).reshape(-1)
    for gname, v in zip(groups, arr):
        if math.isfinite(float(v)):
            _M_UPDATE_RATIO.set(float(v), group=str(gname))


# ---------------------------------------------------------------------------
# Deferred publication: the taps' small device vectors reach the host
# without a synchronisation of the step
# ---------------------------------------------------------------------------


class _Deferred:
    """Small device results waiting for their host-side publisher (the
    counterpart of ``jax.debug.callback``).  A CUDA tensor is copied
    without blocking into pinned host memory behind an event; it is
    published once the event has completed: at the next tap, or at
    :func:`flush` (``synchronize``, a metrics snapshot, a dump,
    ``shutdown``).  A CPU tensor is published at once.  Publishing is
    advisory: its failure never reaches the step."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: collections.deque = collections.deque()
        # published pinned buffers by (shape, dtype), reused: a new
        # pinned allocation is a cudaHostAlloc, far dearer than a step's
        # verdict
        self._free: dict = {}

    def add(self, fn, t) -> None:
        t = t.detach()
        if not t.is_cuda:
            self._publish(fn, t.numpy())
            return
        import torch

        key = (tuple(t.shape), t.dtype)
        with self._lock:
            free = self._free.get(key)
            host = free.pop() if free else None
        if host is None:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        with self._lock:
            self._items.append((fn, host, ev))

    def flush(self, block: bool = False) -> None:
        while True:
            with self._lock:
                if not self._items:
                    return
                fn, host, ev = self._items[0]
                if not block and not ev.query():
                    return
                self._items.popleft()
            if block:
                ev.synchronize()
            self._publish(fn, host.numpy())
            with self._lock:
                self._free.setdefault((tuple(host.shape), host.dtype),
                                      []).append(host)

    def clear(self) -> None:
        with self._lock:
            self._items.clear()

    @staticmethod
    def _publish(fn, arr) -> None:
        try:
            fn(arr)
        except Exception:  # noqa: BLE001 -- a stat must never cost a step
            pass


_deferred = _Deferred()


def flush(block: bool = True) -> None:
    """Publish every verdict and ratio the taps have queued (``block``:
    wait for the device to produce them; else only those ready)."""
    _deferred.flush(block)


# ---------------------------------------------------------------------------
# The taps (torch): multi-tensor statistics, one verdict all-gather
# ---------------------------------------------------------------------------

#: Elements per staging chunk of :func:`group_stats` (64 MB of float32):
#: the statistics run over bounded copies, never a full-size one.
STATS_CHUNK = 1 << 24


def dtype_label(dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the JAX package's group
    names)."""
    return str(dtype).replace("torch.", "")


def flat_view(t):
    """``t`` as a 1-D view in memory order, without a copy for a
    contiguous or a channels-last tensor (a convolution's gradient on
    CUDA); the statistics do not depend on the order of the elements."""
    import torch

    t = t.detach()
    if t.is_contiguous():
        return t.view(-1)
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return t.permute(0, 2, 3, 1).view(-1)
    return t.reshape(-1)


def float_groups(tensors) -> dict:
    """dtype label -> tensors, floating tensors only, in first-appearance
    order (the fused-buffer group layout the optimizer already uses)."""
    groups: dict = {}
    for t in tensors:
        if t is not None and t.is_floating_point():
            groups.setdefault(dtype_label(t.dtype), []).append(t)
    return groups


def group_stats(tensors):
    """``(sumsq, maxabs, nonfinite)`` of a list of same-dtype tensors as
    a float32 ``(3,)`` tensor on their device, NaN-proof as the JAX
    package's ``_leaf_stats``: the norm and the max are over the finite
    part, the count carries the poison.

    The tensors are read in chunks of at most ``STATS_CHUNK`` elements
    and at most half the group (ResNet-50's 25.5M float32 gradients:
    two chunks), each copied into one staging buffer
    (``torch.cat``), so no full-size copy of the group is made and a
    chunk takes a handful of launches: the nonzero count, the nonfinite
    values zeroed in place, the nonzero count again (their difference is
    the nonfinite count), the inf-norm and the 2-norm."""
    import torch

    flats = [flat_view(t) for t in tensors if t.numel()]
    dev = tensors[0].device
    total = sum(f.numel() for f in flats)
    if not total:
        return torch.zeros(3, dtype=torch.float32, device=dev)
    cap = min(STATS_CHUNK, max(1, (total + 1) // 2))
    buf = torch.empty(cap, dtype=flats[0].dtype, device=dev)
    norms, maxes, counts = [], [], []

    def chunk(pieces, n):
        st = buf[:n]
        if len(pieces) == 1:
            st.copy_(pieces[0])
        else:
            torch.cat(pieces, out=st)
        before = torch.count_nonzero(st)
        st.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
        counts.append(before - torch.count_nonzero(st))
        maxes.append(torch.linalg.vector_norm(st, float("inf"),
                                              dtype=torch.float32))
        norms.append(torch.linalg.vector_norm(st, 2, dtype=torch.float32))

    pieces, fill = [], 0
    for f in flats:
        off = 0
        while off < f.numel():
            take = min(cap - fill, f.numel() - off)
            pieces.append(f[off:off + take])
            fill += take
            off += take
            if fill == cap:
                chunk(pieces, fill)
                pieces, fill = [], 0
    if fill:
        chunk(pieces, fill)
    return torch.stack([torch.stack(norms).square().sum(),
                        torch.stack(maxes).max(),
                        torch.stack(counts).sum().to(torch.float32)])


def nonfinite_count(tensors):
    """The nonfinite elements of the floating ``tensors``, as a 0-dim
    device tensor (the skip verdict of the eager regime), or None when
    none is floating."""
    groups = float_groups(tensors)
    if not groups:
        return None
    return sum(group_stats(ts)[2] for ts in groups.values())


def _emulated(hop) -> bool:
    """Several ranks of ``hop`` live in this process (an emulated world
    of threads): only the one whose index is this process's rank
    publishes the shared verdict."""
    from horovod_tpu_torch.common import basics as _basics

    st = _basics.state()
    return hop.size > (st.size if st.initialized else 1)


def _gather_verdict(vec, hop):
    """Every member's verdict vector over ``hop``, as ``(n, len)``."""
    import torch

    if hop.size == 1:
        return vec.view(1, -1)
    out = torch.empty(hop.size * vec.numel(), dtype=vec.dtype,
                      device=vec.device)
    hop.all_gather(out, vec)
    return out.view(hop.size, -1)


def tap_gradients(tensors, hop):
    """The optimizer's stat tap: per float dtype group the finite-part
    sum of squares, max-abs and nonfinite count of this rank's
    PRE-reduction gradients, packed with the rank's index over ``hop``
    into one small float32 vector and all-gathered over ``hop`` (the one
    collective health adds to a step).  The gathered verdict is
    published through :func:`publish_verdict` (deferred); returns the
    gathered ``(n, 1 + 3G)`` device tensor, or None when nothing is
    floating.  No full-size buffer is made (:func:`group_stats`)."""
    import torch

    _deferred.flush()
    groups = float_groups(tensors)
    if not groups:
        return None
    dev = next(iter(groups.values()))[0].device
    vec = torch.cat([torch.full((1,), float(hop.index),
                                dtype=torch.float32, device=dev)]
                    + [group_stats(ts) for ts in groups.values()])
    gathered = _gather_verdict(vec, hop)
    idx = hop.index if _emulated(hop) else None
    _deferred.add(lambda a: publish_verdict(a, idx, tuple(groups)),
                  gathered)
    return gathered


def verdict_bad(gathered) -> bool:
    """Whether any rank of a gathered verdict reported a nonfinite (the
    nonfinite-count columns are 3, 6, 9, ... of ``(rank, [ss, ma, nf] x
    G)``): one device-to-host read, paid only under the skip knob."""
    return bool((gathered[:, 3::3].sum() > 0).item())


def tap_block(flat, hop, group: str) -> None:
    """The eager executor's stat tap: the local statistics of this
    rank's pre-reduction fused buffer, the verdict all-gathered over the
    executor's own hop and published with ``sentinel=False`` (one
    verdict per fused buffer; the grad-norm sentinel eats whole-step
    verdicts only)."""
    import torch

    _deferred.flush()
    vec = torch.cat([torch.full((1,), float(hop.index),
                                dtype=torch.float32, device=flat.device),
                     group_stats([flat])])
    gathered = _gather_verdict(vec, hop)
    idx = hop.index if _emulated(hop) else None
    _deferred.add(lambda a: publish_verdict(a, idx, (group,),
                                            sentinel=False), gathered)


def tap_update_ratio(updates, params) -> None:
    """Post-update update-to-weight ratio per dtype group, over the
    local (shard-resident under ZeRO) views, with no communication:
    ``||update|| / ||param||`` from multi-tensor norms (one
    ``_foreach_norm`` per side and group), published deferred.
    ``params`` are the values before the update."""
    import torch

    ug, pg = float_groups(updates), float_groups(params)
    names = [g for g in ug if g in pg]
    if not names:
        return
    ratios = []
    for g in names:
        un = torch.stack(torch._foreach_norm(ug[g])).square().sum().sqrt()
        pn = torch.stack(torch._foreach_norm(pg[g])).square().sum().sqrt()
        ratios.append((un / pn.clamp_min(_TINY)).to(torch.float32))
    _deferred.add(lambda a: publish_update_ratio(a, tuple(names)),
                  torch.stack(ratios))


def note_skip() -> None:
    """One step suppressed by the skip contract."""
    monitor().note_skip()


# ---------------------------------------------------------------------------
# Dumps + report (the `python -m horovod_tpu_torch.perf health` surface)
# ---------------------------------------------------------------------------


def health_dir() -> str:
    return str(_config.get("health_dir") or "").strip() \
        or _flight.flight_dir()


def dump(reason: str = "explicit", directory: str | None = None
         ) -> str | None:
    """Write this rank's health snapshot as ``health-r<k>-g<g>.json``
    next to the flight dumps (idempotent per rank+generation, like the
    goodput ledger's).  Advisory — never takes a dying process further
    down."""
    d = directory or health_dir()
    if not d:
        return None
    try:
        _deferred.flush(block=True)
        meta = _flight._process_meta()
        snap = monitor().snapshot()
        snap["meta"] = {"rank": meta.get("rank", 0),
                        "size": meta.get("size", 1),
                        "generation": meta.get("generation", 0),
                        "host": meta.get("host", ""),
                        "reason": reason}
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"health-r{meta.get('rank', 0)}"
               f"-g{meta.get('generation', 0)}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(snap, f)
        os.replace(tmp, path)
        return path
    except Exception:
        return None


def from_metrics_snapshot(snap: dict) -> dict | None:
    """Health view from a ``/metrics.json`` (or KV-published) snapshot
    — the live-endpoint source of the report."""
    metrics = (snap or {}).get("metrics") or {}
    meta = (snap or {}).get("meta") or {}

    def series(name):
        return (metrics.get(name) or {}).get("series") or []

    if not any(series(n) for n in
               ("hvd_grad_norm", "hvd_nonfinite_total",
                "hvd_health_alert", "hvd_loss")):
        return None
    out = {"meta": {"rank": meta.get("rank", 0),
                    "size": meta.get("size", 1),
                    "generation": meta.get("generation", 0),
                    "host": meta.get("host", ""),
                    "reason": "metrics_snapshot"},
           "last_loss": None, "last_grad_norm": None,
           "culprits": [], "active_alerts": [], "alerts_total": 0,
           "nonfinite_elems": 0.0, "skipped_steps": 0,
           "update_ratio": {}}
    for s in series("hvd_loss"):
        out["last_loss"] = s.get("value")
    for s in series("hvd_grad_norm"):
        if (s.get("labels") or {}).get("group") == "all":
            out["last_grad_norm"] = s.get("value")
    for s in series("hvd_update_ratio"):
        out["update_ratio"][(s.get("labels") or {}).get("group", "?")] = \
            s.get("value")
    for s in series("hvd_nonfinite_total"):
        lab = s.get("labels") or {}
        cnt = float(s.get("value") or 0)
        out["nonfinite_elems"] += cnt
        try:
            rank = int(lab.get("rank", -1))
        except (TypeError, ValueError):  # merged pages relabel ranks
            rank = -1
        out["culprits"].append({"rank": rank,
                                "group": lab.get("group", "?"),
                                "count": cnt})
    for s in series("hvd_health_alert"):
        # every series counts toward the lifetime total: a cleared
        # alert's gauge persists at 0, so the reason set IS the
        # tripped-ever set (keeps live endpoints consistent with the
        # dump files' alerts_total after a trip-then-clear)
        out["alerts_total"] += 1
        if float(s.get("value") or 0) > 0:
            out["active_alerts"].append(
                (s.get("labels") or {}).get("reason", "?"))
    for s in series("hvd_health_skipped_steps_total"):
        out["skipped_steps"] += int(float(s.get("value") or 0))
    return out


def _snapshot_from_bench(obj: dict) -> dict | None:
    extra = (obj or {}).get("extra") or {}
    if "health_alerts" not in extra and "nonfinite_steps" not in extra:
        return None
    return {"meta": {"rank": 0, "size": 1, "generation": 0,
                     "reason": "bench_result"},
            "last_loss": None,
            "last_grad_norm": extra.get("grad_norm_final"),
            # bench records verdict EVENTS, not element counts — keep
            # the semantics distinct (format_report labels them apart)
            "nonfinite_events": extra.get("nonfinite_steps", 0),
            "culprits": [], "update_ratio": {},
            "active_alerts": extra.get("health_active_alerts") or [],
            "skipped_steps": extra.get("health_skipped_steps", 0),
            "alerts_total": extra.get("health_alerts", 0)}


def load_snapshots(path: str) -> list:
    """Per-rank health snapshots from: a directory of health-*.json
    dumps (deduped to each rank's newest generation), a single dump or
    bench-result JSON, or a live endpoint URL (``/metrics.json`` is
    fetched)."""
    if path.startswith(("http://", "https://")):
        from urllib.request import urlopen

        url = path.rstrip("/")
        if not url.endswith("/metrics.json"):
            url += "/metrics.json"
        with urlopen(url, timeout=10) as r:
            snap = json.loads(r.read().decode())
        out = from_metrics_snapshot(snap)
        return [out] if out else []
    if os.path.isdir(path):
        best: dict = {}
        for name in sorted(os.listdir(path)):
            if not (name.startswith("health-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(path, name)) as f:
                    snap = json.load(f)
            except (OSError, ValueError):
                continue
            meta = snap.get("meta") or {}
            rank = int(meta.get("rank", 0))
            gen = int(meta.get("generation", 0))
            if rank not in best or gen >= best[rank][0]:
                best[rank] = (gen, snap)
        return [s for _, s in
                (best[r] for r in sorted(best))]
    with open(path) as f:
        obj = json.load(f)
    if "metric" in obj and "extra" in obj:  # bench result line
        snap = _snapshot_from_bench(obj)
        return [snap] if snap else []
    if "metrics" in obj and "meta" in obj:  # metrics snapshot
        snap = from_metrics_snapshot(obj)
        return [snap] if snap else []
    return [obj]


def load_report(path: str) -> dict:
    snaps = load_snapshots(path)
    culprits: dict = {}
    for s in snaps:
        for c in s.get("culprits") or []:
            key = (c.get("rank", -1), c.get("group", "?"))
            # MAX, not sum: every rank's monitor observed the SAME
            # allgathered verdict, so rank dumps carry identical
            # fleet-wide counts — summing them would multiply the
            # element count world-fold (the goodput double-counted-
            # wall bug class).
            culprits[key] = max(culprits.get(key, 0.0),
                                float(c.get("count", 0)))
    return {"ranks": snaps,
            "culprits": [{"rank": r, "group": g, "count": c}
                         for (r, g), c in sorted(culprits.items())],
            "alerts_total": max(
                (int(s.get("alerts_total", 0) or 0) for s in snaps),
                default=0)}


def format_report(report: dict) -> str:
    lines = ["=== training-health report ==="]
    ranks = report.get("ranks") or []
    if not ranks:
        return "=== training-health report ===\nno health data found"
    for s in ranks:
        meta = s.get("meta") or {}
        gn = s.get("last_grad_norm")
        loss = s.get("last_loss")
        alerts = s.get("active_alerts") or []
        gn_s = f"{gn:.4g}" if isinstance(gn, (int, float)) else "-"
        if "nonfinite_elems" in s:
            nf_s = f"nonfinite {float(s.get('nonfinite_elems') or 0):g}"
        else:  # bench artifacts record verdict events, not elements
            nf_s = (f"nonfinite_events "
                    f"{float(s.get('nonfinite_events', 0) or 0):g}")
        lines.append(
            f"  rank {meta.get('rank', '?')} g{meta.get('generation', 0)}"
            f": loss {loss if loss is not None else '-'}"
            f", grad_norm {gn_s}"
            f", {nf_s}"
            f", skipped {s.get('skipped_steps', 0)}"
            + (f", ALERTS: {','.join(alerts)}" if alerts else ""))
        ur = s.get("update_ratio") or {}
        for g, v in sorted(ur.items()):
            if isinstance(v, (int, float)):
                lines.append(f"      update_ratio[{g}] = {v:.3e}")
        fn = s.get("first_nonfinite")
        if fn:
            lines.append(
                f"      first nonfinite: rank {fn.get('rank')} "
                f"group {fn.get('group')} ({fn.get('count'):g} elems)")
    culprits = report.get("culprits") or []
    if culprits:
        lines.append("  culprit attribution (pre-reduction):")
        for c in culprits:
            lines.append(f"    rank {c['rank']} / {c['group']}: "
                         f"{c['count']:g} nonfinite element(s)")
    else:
        lines.append("  no nonfinite gradients observed")
    lines.append(f"  alerts (all ranks, lifetime): "
                 f"{report.get('alerts_total', 0)}")
    return "\n".join(lines)
