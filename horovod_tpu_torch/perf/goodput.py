"""Goodput ledger: fleet-wide wall-clock attribution (counterpart of
``horovod_tpu/perf/goodput.py``, docs/goodput.md; the same phases,
snapshot and dump schema, fleet report and CLI text).

The three earlier observability planes each answer "what happened" —
live aggregates (:mod:`horovod_tpu_torch.runtime.metrics`), postmortem order
(:mod:`horovod_tpu_torch.runtime.flight`) — but none answers the production
question: *what fraction of fleet wall-clock was useful device work,
and when it wasn't, what exactly ate it*.  This module is that layer:
a per-rank **wall-clock ledger** that classifies every second of a run
into exclusive phases:

* ``init``        — framework/runtime bring-up (``hvd.init()``);
* ``compile``     — materialization (``span("compile")``; the
  ``hvd_compile_seconds_total`` counter counts the CUDA kernel and
  host-library builds and AOT cache loads of ``_build.py``);
* ``input_wait``  — the training thread starved on the input pipeline
  (the ``hvd.data_wait()`` span / iterator-wrapper hook — the
  bottleneck the device observatory cannot see);
* ``compute``     — the useful bucket: step wall the runtime cannot
  blame on anything else.  Goodput = compute / elapsed;
* ``comm_exposed``— communication the overlap schedules failed to
  hide: device truth when a sampled capture is live
  (``perf/capture.py``), the ``trace_step`` blocked split otherwise;
* ``checkpoint``  — checkpoint save/restore wall;
* ``reform``      — elastic re-form wall (teardown/rendezvous/compile/
  resync split carried alongside);
* ``unattributed``— the honesty bucket: elapsed wall no hook claimed.
  It must stay small (``HOROVOD_GOODPUT_UNATTRIBUTED_MAX``) and is
  itself a gauge — a growing honesty bucket is a bug report against
  the ledger, not something to hide.

Conservation is by construction: attributed phases are clamped so they
never exceed elapsed wall-clock, and ``unattributed`` is the exact
remainder — per-rank phase seconds always sum to elapsed.

Surfaces:

* gauges on the metrics plane (``hvd_goodput_ratio``,
  ``hvd_wallclock_seconds_total{phase=...}``), which
  :class:`FleetGoodput` merges into fleet goodput
  (useful-device-seconds / world x wall-clock), names the dominant
  bottleneck over a sliding window with an evidence line (which rank,
  which phase, how many seconds), and exposes SLO burn-rate alerts
  (``hvd_goodput_alert{reason=...}``);
* ``python -m horovod_tpu_torch.perf goodput <dir|file|url>`` — the
  attribution table per rank and fleet-wide (``--json`` for machines);
* per-rank JSON dumps (``goodput-r<k>-g<g>.json``) on shutdown/abort
  next to the flight-recorder dumps, plus a ``goodput`` event on every
  flight ring dump.

Import discipline: stdlib + the stdlib-only runtime modules (config,
logging, metrics) — no torch anywhere in this module.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log

# Exclusive attributable phases; "unattributed" is synthesized at
# snapshot time as the exact remainder (and "compute" is what goodput
# measures).  Order is the report's display order.
PHASES = ("init", "compile", "input_wait", "compute", "comm_exposed",
          "checkpoint", "reform")
ALL_PHASES = PHASES + ("unattributed",)


def _metrics():
    from horovod_tpu_torch.runtime import metrics as _m

    return _m


def _compile_counter_total() -> float:
    """The kernel and host-library build wall (cold + warm paths,
    ``runtime/aot_cache.py``)."""
    try:
        return float(_metrics().counter("hvd_compile_seconds_total")
                     .total())
    except Exception:
        return 0.0


def _compile_counter_split() -> tuple[float, float]:
    try:
        c = _metrics().counter("hvd_compile_seconds_total")
        return float(c.value(path="cold")), float(c.value(path="warm"))
    except Exception:
        return 0.0, 0.0


class GoodputLedger:
    """Per-rank wall-clock ledger.

    Hook-driven: :meth:`observe` / :meth:`span` record exclusive
    out-of-step phase seconds (init, checkpoint, reform, compile,
    out-of-step input waits), :meth:`observe_step` records one
    ``hvd.trace_step`` span's priority-budget split (input_wait ->
    comm_exposed -> compile -> compute, each clamped to the remaining
    step wall so a step's phases sum to its wall exactly).  Negotiated
    compiles that happen *between* steps (eager warmup) are recovered
    at snapshot time from the ``hvd_compile_seconds_total`` counter
    delta, clamped into otherwise-unattributed wall.

    The recording hot path is one lock + a few float adds — no
    syscalls, no IO (the metrics-registry cost discipline)."""

    def __init__(self, clock=None):
        self._clock = clock or time.monotonic
        # RLock: publish() runs from metrics snapshot hooks which may
        # fire re-entrantly under callers already inside the ledger.
        self._lock = threading.RLock()
        self._t0: float | None = None
        self._wall0: float | None = None
        self._phases = {p: 0.0 for p in PHASES}
        self._steps = 0
        self._exposed_src = {"device": 0, "trace_step": 0}
        self._compile_base = 0.0   # counter total at start()
        self._compile_seen = 0.0   # counter seconds attributed in steps
        self._reform_split: dict = {}
        self._warned_unattributed = False

    # -- lifecycle ---------------------------------------------------------

    def started(self) -> bool:
        with self._lock:
            return self._t0 is not None

    def start(self, now: float | None = None) -> None:
        """Start the wall-clock (idempotent — the first hook wins, so
        elapsed covers the run from ``hvd.init()`` on)."""
        with self._lock:
            if self._t0 is None:
                self._t0 = self._clock() if now is None else now
                self._wall0 = time.time()
                self._compile_base = _compile_counter_total()

    # -- recording ---------------------------------------------------------

    def observe(self, phase: str, seconds: float,
                split: dict | None = None) -> None:
        """Attribute ``seconds`` of wall to an out-of-step ``phase``."""
        if phase not in self._phases:
            raise ValueError(f"unknown goodput phase {phase!r}; "
                             f"expected one of {PHASES}")
        s = max(0.0, float(seconds))
        with self._lock:
            self.start()
            self._phases[phase] += s
            if split and phase == "reform":
                for k, v in split.items():
                    if isinstance(v, (int, float)):
                        self._reform_split[k] = round(
                            self._reform_split.get(k, 0.0) + float(v), 6)
                # compile seconds inside the re-form are wall already
                # attributed under "reform": mark them consumed so the
                # snapshot-time counter-delta recovery cannot claim
                # unattributed wall for them a second time
                comp = split.get("compile_s")
                if isinstance(comp, (int, float)) and comp > 0:
                    self._compile_seen += float(comp)

    @contextlib.contextmanager
    def span(self, phase: str):
        """Time a with-block into ``phase``.  Starts the ledger clock
        at span ENTRY: an observe-at-exit-only start would leave the
        first span's duration outside elapsed and scale it away."""
        self.start()
        t0 = self._clock()
        try:
            yield
        finally:
            self.observe(phase, self._clock() - t0)

    def observe_step(self, wall: float, compute: float,
                     comm_exposed: float, input_wait: float = 0.0,
                     compile_s: float = 0.0,
                     exposed_source: str = "trace_step") -> None:
        """Record one step span's split (already budgeted by the caller
        so the parts sum to ``wall``; clamped here regardless)."""
        wall = max(0.0, float(wall))
        with self._lock:
            self.start()
            budget = wall
            for phase, s in (("input_wait", input_wait),
                             ("comm_exposed", comm_exposed),
                             ("compile", compile_s)):
                s = min(max(0.0, float(s)), budget)
                self._phases[phase] += s
                budget -= s
            # compute is the remainder: a caller-supplied value beyond
            # the budget would break conservation.
            self._phases["compute"] += min(max(0.0, float(compute)),
                                           budget)
            self._steps += 1
            self._compile_seen += max(0.0, float(compile_s))
            if exposed_source in self._exposed_src:
                self._exposed_src[exposed_source] += 1

    # -- reading -----------------------------------------------------------

    def snapshot(self, now: float | None = None) -> dict:
        """The ledger as a dict: elapsed, per-phase seconds (summing to
        elapsed with ``unattributed`` as the exact remainder), goodput
        ratio, and provenance fields."""
        with self._lock:
            if self._t0 is None:
                return {"elapsed_s": 0.0, "phases": {}, "steps": 0,
                        "unattributed_s": 0.0, "unattributed_ratio": 0.0,
                        "goodput_ratio": 0.0}
            t = (self._clock() if now is None else now)
            elapsed = max(0.0, t - self._t0)
            phases = dict(self._phases)
            steps = self._steps
            exposed_src = dict(self._exposed_src)
            reform_split = dict(self._reform_split)
            wall0 = self._wall0
            compile_base = self._compile_base
            compile_seen = self._compile_seen
        # Out-of-step negotiated compiles (eager warmup, elastic
        # recompiles): counter delta not already attributed inside
        # steps, clamped into otherwise-unattributed wall.  The counter
        # measures background-thread busy time, which can overlap
        # attributed main-thread phases — the clamp keeps the ledger's
        # conservation guarantee over honesty of THIS split.
        compile_out = max(0.0,
                          _compile_counter_total() - compile_base
                          - compile_seen)
        attributed = sum(phases.values())
        if compile_out > 0 and attributed < elapsed:
            phases["compile"] += min(compile_out, elapsed - attributed)
            attributed = sum(phases.values())
        # Attributed spans can overshoot elapsed (hook nesting, clock
        # skew between perf_counter-based callers and this clock):
        # scale down proportionally so the contract "phases sum to
        # elapsed" holds, and report the overshoot.
        over = 0.0
        if attributed > elapsed and attributed > 0:
            over = attributed - elapsed
            scale = elapsed / attributed
            phases = {k: v * scale for k, v in phases.items()}
            attributed = elapsed
        unattributed = max(0.0, elapsed - attributed)
        compute = phases.get("compute", 0.0)
        out = {
            "elapsed_s": round(elapsed, 6),
            "phases": {k: round(v, 6) for k, v in phases.items()},
            "unattributed_s": round(unattributed, 6),
            "unattributed_ratio": round(unattributed / elapsed, 6)
            if elapsed > 0 else 0.0,
            "goodput_ratio": round(compute / elapsed, 6)
            if elapsed > 0 else 0.0,
            "steps": steps,
            "exposed_source": exposed_src,
            "time": time.time(),
        }
        if wall0 is not None:
            out["wall_start"] = wall0
        if over > 0:
            out["overattributed_s"] = round(over, 6)
        if reform_split:
            out["reform_split"] = reform_split
        cold, warm = _compile_counter_split()
        if cold or warm:
            out["compile_cold_s"] = round(cold, 6)
            out["compile_warm_s"] = round(warm, 6)
        try:
            from horovod_tpu_torch.common import basics as _basics

            st = _basics.state()
            if st.initialized or st.epoch:
                out["rank"] = st.rank
                out["generation"] = st.epoch
        except Exception:
            pass
        # Fallback before basics is importable/initialized: the flight
        # recorder's meta resolver already handles the launcher-env /
        # probe-child cases (and owns the allowlisted identity reads).
        if "rank" not in out:
            try:
                from horovod_tpu_torch.runtime import flight as _flight

                out["rank"] = _flight._process_meta().get("rank", 0)
            except Exception:
                out["rank"] = 0
        return out

    # -- publication -------------------------------------------------------

    def publish(self) -> None:
        """Refresh the goodput gauges on the metrics plane (called from
        the registry's snapshot hooks, so scrapes and KV publishes
        always carry a current ledger — including the unattributed gap
        growing during a stall nothing else reports)."""
        snap = self.snapshot()
        if not snap.get("elapsed_s"):
            return
        m = _metrics()
        m.gauge(
            "hvd_goodput_ratio",
            "Useful-compute fraction of this rank's wall-clock since "
            "init (docs/goodput.md).").set(snap["goodput_ratio"])
        m.gauge(
            "hvd_goodput_elapsed_seconds",
            "Wall-clock seconds the goodput ledger has attributed "
            "over.").set(snap["elapsed_s"])
        series = [({"phase": k}, v) for k, v in snap["phases"].items()]
        series.append(({"phase": "unattributed"},
                       snap["unattributed_s"]))
        m.gauge(
            "hvd_wallclock_seconds_total",
            "Exclusive wall-clock attribution by phase; phases sum to "
            "hvd_goodput_elapsed_seconds (docs/goodput.md).").replace(
            series)
        m.gauge(
            "hvd_goodput_unattributed_ratio",
            "The honesty bucket: wall-clock fraction no ledger hook "
            "claimed.  Growth past HOROVOD_GOODPUT_UNATTRIBUTED_MAX "
            "is a ledger bug or an uninstrumented stall.").set(
            snap["unattributed_ratio"])
        try:
            limit = float(_config.get("goodput_unattributed_max") or 0)
        except (TypeError, ValueError):
            limit = 0.0
        if (limit > 0 and snap["elapsed_s"] > 60
                and snap["unattributed_ratio"] > limit
                and not self._warned_unattributed):
            self._warned_unattributed = True
            _log.warning(
                f"goodput ledger: {snap['unattributed_ratio']:.0%} of "
                f"wall-clock is unattributed (> "
                f"{limit:.0%} HOROVOD_GOODPUT_UNATTRIBUTED_MAX) — an "
                "uninstrumented phase is eating the run "
                "(docs/goodput.md)")

    def dump(self, reason: str = "explicit",
             directory: str | None = None) -> str | None:
        """Write the ledger snapshot as JSON into ``directory`` (or
        ``HOROVOD_GOODPUT_DIR``, falling back to the flight-recorder
        dir so abort forensics land together).  Advisory — returns the
        path or None, never raises."""
        try:
            d = directory or goodput_dir()
            if not d:
                return None
            snap = self.snapshot()
            if not snap.get("elapsed_s"):
                return None
            snap["reason"] = reason
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"goodput-r{snap.get('rank', 0)}"
                   f"-g{snap.get('generation', 0)}.json")
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(snap, f)
            os.replace(tmp, path)
            return path
        except Exception:
            return None


# ---------------------------------------------------------------------------
# Process-global ledger
# ---------------------------------------------------------------------------

_ledger: GoodputLedger | None = None
_ledger_lock = threading.Lock()


def ledger() -> GoodputLedger:
    """The process-global ledger; created on first use and registered
    as a metrics snapshot hook so every scrape/KV publish refreshes the
    goodput gauges."""
    global _ledger
    led = _ledger
    if led is None:
        with _ledger_lock:
            led = _ledger
            if led is None:
                led = _ledger = GoodputLedger()
                try:
                    _metrics().add_snapshot_hook(led.publish)
                except Exception:
                    pass
    return led


def reset() -> None:
    """Test hook: drop the global ledger (its snapshot hook is
    re-registered by the next ledger() call)."""
    global _ledger
    with _ledger_lock:
        old, _ledger = _ledger, None
    if old is not None:
        try:
            _metrics().remove_snapshot_hook(old.publish)
        except Exception:
            pass


def start() -> None:
    ledger().start()


def observe(phase: str, seconds: float, split: dict | None = None) -> None:
    ledger().observe(phase, seconds, split=split)


def span(phase: str):
    return ledger().span(phase)


def observe_step(*args, **kwargs) -> None:
    ledger().observe_step(*args, **kwargs)


def record_outer_sync(seconds: float) -> None:
    """One local-SGD outer pseudo-gradient sync (docs/local-sgd.md):
    its wall is exposed communication by definition (the whole fleet
    stalls on the cross-hop exchange), so it lands in ``comm_exposed``, plus
    the dedicated ``hvd_outer_sync_total`` counter and cumulative
    ``hvd_outer_sync_seconds_total`` gauge so the H-vs-goodput
    trade-off is scrapeable directly."""
    s = max(0.0, float(seconds))
    ledger().observe("comm_exposed", s)
    reg = _metrics()
    reg.counter(
        "hvd_outer_sync_total",
        "Outer pseudo-gradient syncs fired by the local-SGD regime "
        "(one per HOROVOD_LOCAL_SGD_H inner steps).").inc(1)
    reg.gauge(
        "hvd_outer_sync_seconds_total",
        "Cumulative wall seconds spent in local-SGD outer syncs "
        "(also attributed to the goodput ledger's comm_exposed "
        "phase).").inc(s)


def goodput_dir() -> str:
    d = str(_config.get("goodput_dir") or "").strip()
    if d:
        return d
    return str(_config.get("flight_dir") or "").strip()


def dump(reason: str = "explicit", directory: str | None = None
         ) -> str | None:
    return ledger().dump(reason, directory)


# ---------------------------------------------------------------------------
# Fleet-side: merge per-rank ledgers, name the bottleneck, burn alerts
# ---------------------------------------------------------------------------


def dominant_bottleneck(snapshot: dict) -> dict | None:
    """The phase that ate the most non-compute wall in one ledger
    snapshot (``unattributed`` included — the honesty bucket can BE the
    bottleneck and must be nameable as such)."""
    phases = dict(snapshot.get("phases") or {})
    phases.pop("compute", None)
    phases["unattributed"] = float(snapshot.get("unattributed_s", 0.0))
    if not phases:
        return None
    phase = max(phases, key=lambda k: phases[k])
    if phases[phase] <= 0:
        return None
    elapsed = float(snapshot.get("elapsed_s") or 0.0)
    return {"phase": phase, "seconds": round(phases[phase], 3),
            "share": round(phases[phase] / elapsed, 4) if elapsed else 0.0}


def from_metrics_snapshot(snap: dict) -> dict | None:
    """Recover a ledger-snapshot-shaped dict from a published metrics
    snapshot (``{"meta": ..., "metrics": ...}``) — the live-fleet path:
    ranks publish gauges, the launcher reassembles ledgers."""
    metrics_d = (snap or {}).get("metrics") or {}
    wall = metrics_d.get("hvd_wallclock_seconds_total", {})
    series = wall.get("series") or []
    if not series:
        return None
    phases = {}
    unattributed = 0.0
    for s in series:
        phase = (s.get("labels") or {}).get("phase")
        v = float(s.get("value", 0.0))
        if phase == "unattributed":
            unattributed = v
        elif phase:
            phases[phase] = v

    def gauge_value(name):
        ser = metrics_d.get(name, {}).get("series") or []
        return float(ser[0].get("value", 0.0)) if ser else None

    elapsed = gauge_value("hvd_goodput_elapsed_seconds")
    if elapsed is None:
        elapsed = sum(phases.values()) + unattributed
    meta = (snap or {}).get("meta") or {}
    out = {"elapsed_s": elapsed, "phases": phases,
           "unattributed_s": unattributed,
           "unattributed_ratio": (unattributed / elapsed
                                  if elapsed else 0.0),
           "goodput_ratio": gauge_value("hvd_goodput_ratio")
           or (phases.get("compute", 0.0) / elapsed if elapsed else 0.0)}
    if meta.get("rank") is not None:
        try:
            out["rank"] = int(meta["rank"])
        except (TypeError, ValueError):
            return None  # the launcher's own rank="launcher" snapshot
    if meta.get("host"):
        out["host"] = meta["host"]
    if meta.get("time"):
        out["time"] = meta["time"]
    return out


def fleet_report(rank_snapshots: list) -> dict:
    """Whole-run fleet aggregation over per-rank ledger snapshots:
    fleet goodput = sum(useful compute seconds) / sum(rank wall-clock)
    (= useful-device-seconds / (world x wall-clock) when ranks ran the
    same wall), the per-phase fleet totals, and the dominant bottleneck
    with its evidence (which rank, which phase, how many seconds)."""
    ranks = [s for s in rank_snapshots if s and s.get("elapsed_s")]
    ranks.sort(key=lambda s: s.get("rank", 0))
    total_elapsed = sum(float(s["elapsed_s"]) for s in ranks)
    phase_totals = {p: 0.0 for p in ALL_PHASES}
    for s in ranks:
        for k, v in (s.get("phases") or {}).items():
            phase_totals[k] = phase_totals.get(k, 0.0) + float(v)
        phase_totals["unattributed"] += float(
            s.get("unattributed_s", 0.0))
    compute = phase_totals.get("compute", 0.0)
    report = {
        "world": len(ranks),
        "elapsed_s": round(total_elapsed, 3),
        "fleet_goodput": round(compute / total_elapsed, 6)
        if total_elapsed else 0.0,
        "phase_totals": {k: round(v, 3) for k, v in phase_totals.items()
                         if v or k in ("compute", "unattributed")},
        "ranks": ranks,
    }
    candidates = {k: v for k, v in phase_totals.items()
                  if k != "compute" and v > 0}
    if candidates:
        phase = max(candidates, key=lambda k: candidates[k])
        ev_rank, ev_s = None, 0.0
        for s in ranks:
            v = (float(s.get("unattributed_s", 0.0))
                 if phase == "unattributed"
                 else float((s.get("phases") or {}).get(phase, 0.0)))
            if v >= ev_s:
                ev_rank, ev_s = s.get("rank"), v
        report["dominant_bottleneck"] = {
            "phase": phase,
            "fleet_seconds": round(candidates[phase], 3),
            "rank": ev_rank,
            "rank_seconds": round(ev_s, 3),
        }
    return report


def evidence_line(report: dict, window_s: float | None = None) -> str:
    """One operator-readable line naming the bottleneck with evidence."""
    dom = report.get("dominant_bottleneck")
    scope = (f"over the last {window_s:.0f}s" if window_s
             else "over the run")
    head = (f"fleet goodput {report.get('fleet_goodput', 0.0):.1%} "
            f"({report.get('world', 0)} rank(s), "
            f"{report.get('elapsed_s', 0.0):.0f} rank-seconds {scope})")
    if not dom:
        return head + "; no bottleneck observed"
    return (head + f"; dominant bottleneck: {dom['phase']} "
            f"({dom['fleet_seconds']:.1f}s fleet-wide, worst rank "
            f"{dom['rank']}: {dom['rank_seconds']:.1f}s)")


class FleetGoodput:
    """Launcher-side fleet merge: sliding-window goodput, dominant
    bottleneck naming, SLO burn-rate alerts.

    Feed it the per-rank ledger snapshots each time the aggregate
    ``/metrics`` renders (or on any poll cadence); it keeps a bounded
    history so the window survives irregular scrape intervals.  An SLO
    (``HOROVOD_GOODPUT_SLO`` in (0,1]) plus the window
    (``HOROVOD_GOODPUT_WINDOW_SECONDS``) arm the alert: when windowed
    goodput falls below the SLO, ``hvd_goodput_alert{reason=<phase>}``
    goes to 1 with the burn rate ((1 - goodput) / (1 - slo)) beside it
    — the standard error-budget spend-speed number."""

    def __init__(self, slo: float | None = None,
                 window_s: float | None = None, clock=None):
        if slo is None:
            try:
                slo = float(_config.get("goodput_slo") or 0.0)
            except (TypeError, ValueError):
                slo = 0.0
        if window_s is None:
            try:
                window_s = float(_config.get("goodput_window") or 300.0)
            except (TypeError, ValueError):
                window_s = 300.0
        self.slo = min(max(float(slo), 0.0), 1.0)
        self.window_s = max(1.0, float(window_s))
        self._clock = clock or time.monotonic
        self._hist: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self.last: dict | None = None

    def update(self, rank_snapshots: list, now: float | None = None
               ) -> dict:
        now = self._clock() if now is None else now
        report = fleet_report(rank_snapshots)
        sample = {}
        for s in report["ranks"]:
            r = s.get("rank")
            if r is None:
                continue
            sample[r] = {
                "elapsed": float(s["elapsed_s"]),
                "compute": float((s.get("phases") or {})
                                 .get("compute", 0.0)),
                "phases": dict(s.get("phases") or {},
                               unattributed=float(
                                   s.get("unattributed_s", 0.0))),
            }
        with self._lock:
            self._hist.append((now, sample))
            # keep one sample at-or-beyond the window boundary as the
            # delta base, drop everything older
            while (len(self._hist) >= 2
                   and self._hist[1][0] <= now - self.window_s):
                self._hist.popleft()
            base_t, base = self._hist[0]
        # The label must state the span the deltas actually cover: the
        # retained base can be OLDER than window_s when updates are
        # sparse (a 20-minute scrape cadence with a 5-minute window),
        # and clamping would sell a 20-minute average as a 5-minute
        # burn rate.
        window = {"seconds": round(now - base_t, 3)}
        d_elapsed = d_compute = 0.0
        d_phases: dict = {}
        for r, cur in sample.items():
            prev = base.get(r)
            if prev is None:
                continue
            d_elapsed += max(0.0, cur["elapsed"] - prev["elapsed"])
            d_compute += max(0.0, cur["compute"] - prev["compute"])
            for k, v in cur["phases"].items():
                dv = max(0.0, v - prev["phases"].get(k, 0.0))
                if dv > 0 and k != "compute":
                    d_phases.setdefault(k, {})[r] = dv
        if d_elapsed > 0:
            window["goodput"] = round(d_compute / d_elapsed, 6)
            totals = {k: sum(v.values()) for k, v in d_phases.items()}
            if totals:
                phase = max(totals, key=lambda k: totals[k])
                by_rank = d_phases[phase]
                ev_rank = max(by_rank, key=lambda r: by_rank[r])
                window["dominant_bottleneck"] = {
                    "phase": phase,
                    "fleet_seconds": round(totals[phase], 3),
                    "rank": ev_rank,
                    "rank_seconds": round(by_rank[ev_rank], 3),
                }
        else:
            # first sample / idle window: fall back to cumulative
            window["goodput"] = report["fleet_goodput"]
            if report.get("dominant_bottleneck"):
                window["dominant_bottleneck"] = \
                    report["dominant_bottleneck"]
        report["window"] = window
        if self.slo > 0 and report["ranks"]:
            wg = window.get("goodput", 0.0)
            firing = wg < self.slo
            dom = window.get("dominant_bottleneck") or {}
            alert = {
                "slo": self.slo,
                "firing": firing,
                "reason": dom.get("phase", "unattributed")
                if firing else "none",
                "burn_rate": round((1.0 - wg) / max(1e-9, 1.0 - self.slo),
                                   4),
            }
            report["alert"] = alert
        self.last = report
        return report

    def synthetic_snapshot(self, snaps: list, now: float | None = None
                           ) -> dict:
        """Build the launcher-side synthetic metrics snapshot from the
        fleet's published snapshots — called by the aggregate render
        (metrics.aggregate_render(..., fleet=...)) so the fleet page
        carries goodput truth next to the per-rank series."""
        rank_snaps = []
        for s in snaps:
            led = from_metrics_snapshot(s)
            if led is not None:
                rank_snaps.append(led)
        report = self.update(rank_snaps, now=now)
        window = report.get("window") or {}
        gauges = {
            "hvd_goodput_fleet_ratio": {
                "kind": "gauge",
                "help": "Fleet goodput: useful compute seconds / "
                        "(world x wall-clock), cumulative "
                        "(docs/goodput.md).",
                "series": [{"labels": {},
                            "value": report["fleet_goodput"]}]},
            "hvd_goodput_fleet_window_ratio": {
                "kind": "gauge",
                "help": "Fleet goodput over the sliding "
                        "HOROVOD_GOODPUT_WINDOW_SECONDS window.",
                "series": [{"labels": {},
                            "value": window.get(
                                "goodput", report["fleet_goodput"])}]},
        }
        dom = window.get("dominant_bottleneck") \
            or report.get("dominant_bottleneck")
        if dom:
            gauges["hvd_goodput_bottleneck_seconds"] = {
                "kind": "gauge",
                "help": "Windowed fleet seconds of the dominant "
                        "non-compute phase, labeled with its name and "
                        "the worst-offender rank (the evidence line).",
                "series": [{"labels": {"phase": dom["phase"],
                                       "rank": str(dom["rank"])},
                            "value": dom["fleet_seconds"]}]}
        alert = report.get("alert")
        if alert is not None:
            gauges["hvd_goodput_alert"] = {
                "kind": "gauge",
                "help": "1 while windowed fleet goodput is below "
                        "HOROVOD_GOODPUT_SLO; reason names the "
                        "dominant bottleneck phase.",
                "series": [{"labels": {"reason": alert["reason"]},
                            "value": 1 if alert["firing"] else 0}]}
            gauges["hvd_goodput_burn_rate"] = {
                "kind": "gauge",
                "help": "SLO error-budget burn rate: "
                        "(1 - windowed goodput) / (1 - slo); > 1 means "
                        "the budget is being spent faster than "
                        "allotted.",
                "series": [{"labels": {},
                            "value": alert["burn_rate"]}]}
        return {"meta": {}, "metrics": gauges}


# ---------------------------------------------------------------------------
# Report loading / rendering (the CLI surface)
# ---------------------------------------------------------------------------


def _snapshot_from_obj(obj: dict) -> list:
    """Ledger snapshots out of one parsed JSON object of any supported
    shape: a raw ledger dump, a bench result (extras.goodput), or a
    metrics /metrics.json snapshot."""
    if not isinstance(obj, dict):
        return []
    if "phases" in obj and "elapsed_s" in obj:
        return [obj]
    if "metrics" in obj and "meta" in obj:
        led = from_metrics_snapshot(obj)
        return [led] if led else []
    extra = obj.get("extra") or {}
    gp = extra.get("goodput")
    if isinstance(gp, dict):
        phases = {k[:-2]: float(v) for k, v in gp.items()
                  if k.endswith("_s") and k[:-2] in PHASES}
        return [{
            "elapsed_s": float(gp.get("elapsed_s", 0.0)),
            "phases": phases,
            "unattributed_s": float(gp.get("unattributed_s", 0.0)),
            "unattributed_ratio": float(gp.get("unattributed_ratio",
                                               0.0)),
            "goodput_ratio": float(extra.get("goodput_ratio", 0.0)),
            "rank": 0,
        }]
    return []


def load_snapshots(path: str) -> list:
    """Collect per-rank ledger snapshots from ``path``: a directory of
    ``goodput-*.json`` dumps, a single JSON file (dump / bench result /
    metrics snapshot), or a live ``http(s)://`` metrics endpoint
    (``/metrics.json`` is appended when the URL names a bare host)."""
    snaps: list = []
    if path.startswith(("http://", "https://")):
        from urllib.request import urlopen

        url = path if path.endswith(".json") else \
            path.rstrip("/") + "/metrics.json"
        with urlopen(url, timeout=10) as resp:
            obj = json.loads(resp.read().decode())
        objs = obj if isinstance(obj, list) else [obj]
        for o in objs:
            snaps.extend(_snapshot_from_obj(o))
        return snaps
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path)
                       if n.startswith("goodput-")
                       and n.endswith(".json"))
        for n in names:
            try:
                with open(os.path.join(path, n)) as f:
                    snaps.extend(_snapshot_from_obj(json.load(f)))
            except (OSError, ValueError):
                continue
        # Dedupe per rank: the ledger is cumulative and run-long, but
        # every elastic re-form's teardown dumps it again under the
        # new generation (goodput-r<k>-g<g>.json) — summing those
        # overlapping snapshots would double-count the same rank's
        # wall.  Keep each rank's NEWEST ledger (highest generation,
        # then longest elapsed); a dead rank's last dump remains its
        # whole story.
        by_rank: dict = {}
        keyless = []
        for s in snaps:
            r = s.get("rank")
            if r is None:
                keyless.append(s)
                continue
            cur = by_rank.get(r)
            if cur is None or (
                    (s.get("generation", 0), s.get("elapsed_s", 0.0))
                    > (cur.get("generation", 0),
                       cur.get("elapsed_s", 0.0))):
                by_rank[r] = s
        return list(by_rank.values()) + keyless
    with open(path) as f:
        obj = json.load(f)
    return _snapshot_from_obj(obj)


def load_report(path: str, slo: float | None = None,
                window_s: float | None = None) -> dict:
    """``load_snapshots`` + :func:`fleet_report` (+ an SLO verdict when
    one is armed via argument or knob)."""
    snaps = load_snapshots(path)
    report = fleet_report(snaps)
    report["source"] = path
    if slo is None:
        try:
            slo = float(_config.get("goodput_slo") or 0.0)
        except (TypeError, ValueError):
            slo = 0.0
    if slo and report["ranks"]:
        report["alert"] = {
            "slo": slo,
            "firing": report["fleet_goodput"] < slo,
            "reason": (report.get("dominant_bottleneck") or {}).get(
                "phase", "unattributed")
            if report["fleet_goodput"] < slo else "none",
            "burn_rate": round((1.0 - report["fleet_goodput"])
                               / max(1e-9, 1.0 - slo), 4),
        }
    return report


def format_report(report: dict) -> str:
    """Human-readable attribution table, per rank and fleet-wide."""
    lines = [f"goodput report: {report.get('source', '')} "
             f"({report.get('world', 0)} rank(s))"]
    for s in report.get("ranks") or []:
        elapsed = float(s.get("elapsed_s") or 0.0)
        head = f"== rank {s.get('rank', '?')}"
        if s.get("host"):
            head += f" ({s['host']})"
        head += (f": {elapsed:.1f}s wall, goodput "
                 f"{float(s.get('goodput_ratio', 0.0)):.1%}")
        lines.append(head)
        phases = dict(s.get("phases") or {})
        phases["unattributed"] = float(s.get("unattributed_s", 0.0))
        for p in ALL_PHASES:
            v = phases.get(p)
            if not v:
                continue
            share = v / elapsed if elapsed else 0.0
            bar = "#" * int(round(share * 30))
            lines.append(f"   {p:<13} {v:>9.2f}s  {share:>6.1%}  {bar}")
        if s.get("reform_split"):
            lines.append("   reform split: " + "  ".join(
                f"{k}={v}" for k, v in sorted(
                    s["reform_split"].items())))
    lines.append("-- " + evidence_line(report))
    alert = report.get("alert")
    if alert:
        state = "FIRING" if alert["firing"] else "ok"
        lines.append(
            f"-- slo {alert['slo']:.0%}: {state} "
            f"(burn rate {alert['burn_rate']:.2f}x"
            + (f", reason {alert['reason']}" if alert["firing"] else "")
            + ")")
    if not report.get("ranks"):
        lines.append("no goodput ledgers found (expected goodput-*.json "
                     "dumps, a bench result with extras.goodput, or a "
                     "/metrics.json snapshot)")
    return "\n".join(lines)
