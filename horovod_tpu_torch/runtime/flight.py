"""Distributed flight recorder: crash-surviving per-rank event rings
(counterpart of ``horovod_tpu/runtime/flight.py``; same event kinds and
fields, same dump names and JSONL schema, so either package's ``trace``
tool reads the other's dumps).

The metrics plane (:mod:`horovod_tpu_torch.runtime.metrics`) answers
"how much"; this module answers the postmortem question -- *in what
order, on which rank* -- when a round hangs or a peer dies.  Every
rank's runtime keeps a fixed-size in-memory ring of structured events
(negotiation rounds, coordinator arrivals, wire messages, collective
dispatches, heartbeats, clock samples, stalls, handle waits, steps),
each stamped with BOTH clocks -- ``time.monotonic()`` for within-rank
precision and ``time.time()`` for cross-rank alignment.  The hot path
is one reentrant lock and one slot write of a preallocated ring
(``HOROVOD_FLIGHT_EVENTS`` slots, old events overwritten in place): no
syscalls, no IO, no growth.

On :class:`~horovod_tpu_torch.common.types.RanksDownError`, a
background failure, a coordinated stop, a fatal signal (SIGTERM/SIGABRT
-- handlers installed at ``hvd.init()``), or an explicit
``hvd.dump_flight_recorder()``, the ring dumps atomically (tmp + rename)
as JSONL into ``HOROVOD_FLIGHT_DIR``.  ``python -m horovod_tpu_torch.trace
merge <dir>`` aligns rank clocks from the heartbeat-piggybacked ``clk``
samples, writes one Perfetto/Chrome trace with a process per rank, and
runs the straggler / critical-path analyzer.

Import stays stdlib-only: the process meta reads ``common.basics``
lazily.  A dump records the goodput ledger's and the health monitor's
checkpoint events first, and a failure dump writes their dumps beside
the ring.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time

# Resolved lazily (module import must stay dependency-free); the knob
# names are owned by common/config.py.
_ENV_EVENTS = "HOROVOD_FLIGHT_EVENTS"
_ENV_DIR = "HOROVOD_FLIGHT_DIR"
_DEFAULT_EVENTS = 4096


class FlightRecorder:
    """Fixed-capacity event ring.

    ``record()`` is the hot path: stamp both clocks, take the lock,
    write one preallocated slot, bump the sequence counter.  Everything
    that costs (snapshotting, JSON, file IO) happens only in
    :meth:`dump` / :meth:`snapshot`, which copy under the lock and
    work outside it."""

    def __init__(self, capacity: int = _DEFAULT_EVENTS):
        self.capacity = max(0, int(capacity))
        # RLock, not Lock: the SIGTERM/SIGABRT dump handler runs on the
        # main thread between bytecodes — if the signal lands while the
        # main thread is inside record() (handle waits and trace_step
        # record from it), the handler's own record()/snapshot() would
        # self-deadlock on a non-reentrant lock and the dump would
        # never be written.
        self._lock = threading.RLock()
        self._slots: list = [None] * self.capacity
        self._seq = 0

    def record(self, kind: str, ph: str = "i", **fields) -> None:
        """Record one event.  ``ph`` follows Chrome-trace phases:
        ``"B"``/``"E"`` bracket a span on the same rank, ``"i"`` is an
        instant.  ``fields`` must be JSON-serializable scalars/lists."""
        if not self.capacity:
            return
        mono, wall = time.monotonic(), time.time()
        with self._lock:
            s = self._seq
            self._slots[s % self.capacity] = (s, mono, wall, kind, ph,
                                              fields or None)
            self._seq = s + 1

    def snapshot(self) -> list[dict]:
        """Ordered copy of the ring as dicts (oldest first)."""
        with self._lock:
            seq = self._seq
            slots = list(self._slots)
        if seq <= self.capacity:
            ordered = [s for s in slots[:seq] if s is not None]
        else:
            head = seq % self.capacity
            ordered = [s for s in slots[head:] + slots[:head]
                       if s is not None]
        out = []
        for s, mono, wall, kind, ph, fields in ordered:
            ev = {"seq": s, "mono": mono, "wall": wall, "kind": kind,
                  "ph": ph}
            if fields:
                ev.update(fields)
            out.append(ev)
        return out

    def recorded_total(self) -> int:
        """Events recorded over the ring's lifetime (>= len(snapshot))."""
        with self._lock:
            return self._seq

    def clear(self) -> None:
        """Drop every event (capacity unchanged).  Used after an
        elastic re-form dump: round numbers and rank identities restart
        with the new generation, so carrying the old generation's
        events into the next dump would duplicate them across trace
        processes and merge unrelated rounds in the straggler
        analyzer."""
        with self._lock:
            self._slots = [None] * self.capacity
            self._seq = 0

    def dump(self, path: str, meta: dict | None = None) -> str:
        """Atomically write the ring as JSONL: a ``{"meta": ...}``
        header line, then one event per line.  tmp + rename so a
        sweeper never reads a torn dump."""
        events = self.snapshot()
        header = {"meta": dict(meta or {})}
        header["meta"].setdefault("dump_wall", time.time())
        header["meta"].setdefault("dump_mono", time.monotonic())
        header["meta"]["events"] = len(events)
        header["meta"]["recorded_total"] = self.recorded_total()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(header) + "\n")
            for ev in events:
                f.write(json.dumps(ev) + "\n")
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# Process-global recorder + dump surface
# ---------------------------------------------------------------------------

_recorder: FlightRecorder | None = None
# RLock for the same reason as the ring lock: the fatal-signal handler
# may create the recorder while the main thread is inside this very
# creation block.
_recorder_lock = threading.RLock()


def _capacity() -> int:
    raw = os.environ.get(_ENV_EVENTS, "")
    try:
        return int(raw) if raw else _DEFAULT_EVENTS
    except ValueError:
        return _DEFAULT_EVENTS


def recorder() -> FlightRecorder:
    """The process-global ring (created on first use at the
    ``HOROVOD_FLIGHT_EVENTS`` capacity in force then)."""
    global _recorder
    r = _recorder
    if r is None:
        with _recorder_lock:
            r = _recorder
            if r is None:
                r = _recorder = FlightRecorder(_capacity())
    return r


def record(kind: str, ph: str = "i", **fields) -> None:
    """Module-level hot-path record into the global ring."""
    recorder().record(kind, ph, **fields)


def reset() -> None:
    """Test hook: drop the global ring so the next record() rebuilds it
    at the current HOROVOD_FLIGHT_EVENTS capacity."""
    global _recorder
    with _recorder_lock:
        _recorder = None


def flight_dir() -> str:
    return os.environ.get(_ENV_DIR, "")


def _process_meta() -> dict:
    meta = {"pid": os.getpid()}
    try:
        import socket

        meta["host"] = socket.gethostname()
    except Exception:
        pass
    try:  # lazily: basics pulls torch
        from horovod_tpu_torch.common import basics as _basics

        st = _basics.state()
        if st.initialized or st.epoch:
            # epoch survives shutdown(): a rank dying AFTER teardown
            # still stamps the generation it lived in
            meta.update({"rank": st.rank, "size": st.size,
                         "generation": st.epoch,
                         "initialized": st.initialized})
    except Exception:
        pass
    for env_key, name in (("HOROVOD_RANK", "rank"),
                          ("HOROVOD_SIZE", "size")):
        if name not in meta and os.environ.get(env_key, "").isdigit():
            meta[name] = int(os.environ[env_key])
    meta.setdefault("rank", 0)
    meta.setdefault("size", 1)
    return meta


def dump(reason: str = "explicit", directory: str | None = None
         ) -> str | None:
    """Dump the global ring into ``HOROVOD_FLIGHT_DIR`` (or
    ``directory``).  Returns the dump path, or None when no directory
    is configured or the write failed — dumping is forensics and must
    never take a dying-but-recoverable process further down.

    Idempotent per (rank, generation): repeated dumps overwrite the
    same file, so abort + signal + teardown firing in sequence leave
    one coherent record whose reason is the LAST trigger."""
    d = directory or flight_dir()
    if not d:
        return None
    meta = _process_meta()
    meta["reason"] = reason
    # Ledger checkpoint event (docs/goodput.md): the wall-clock
    # attribution at dump time rides the postmortem record, so a
    # merged trace can say not just WHAT died but what the run's
    # seconds were spent on up to that point.  sys.modules lookup, not
    # an import: this can run inside the fatal-signal handler, where
    # entering the import machinery against a main thread that holds a
    # module lock would deadlock the dump (and an unimported goodput
    # module means no ledger exists to report anyway).  Skipped
    # entirely on the signal path: the ledger snapshot reads metrics
    # counters guarded by PLAIN locks — a signal landing while the
    # main thread holds one would deadlock the handler before the ring
    # dump lands (the ring itself is RLock'd for exactly this case).
    try:
        _goodput = (None if _in_signal_handler
                    else sys.modules.get("horovod_tpu_torch.perf.goodput"))
        snap = (_goodput.ledger().snapshot()
                if _goodput is not None else {})
        if snap.get("elapsed_s"):
            record("goodput", reason=reason,
                   elapsed_s=round(snap["elapsed_s"], 3),
                   goodput_ratio=snap["goodput_ratio"],
                   unattributed_s=round(snap["unattributed_s"], 3),
                   **{f"{k}_s": round(v, 3)
                      for k, v in snap["phases"].items()})
    except Exception:
        pass
    # Health checkpoint event beside the goodput one: the postmortem
    # record carries the model-health verdict at dump time (nonfinite
    # totals, active alerts), so the trace analyzer can answer "did it
    # die BECAUSE it diverged".  Same sys.modules + signal-path rules as
    # above (the monitor takes plain locks).
    try:
        _health = (None if _in_signal_handler
                   else sys.modules.get("horovod_tpu_torch.runtime.health"))
        if _health is not None and _health._monitor is not None:
            hs = _health._monitor.snapshot()
            if hs.get("nonfinite_events") or hs.get("alerts_total") \
                    or hs.get("loss_observed"):
                record("health", event="checkpoint", reason=reason,
                       nonfinite_events=int(hs["nonfinite_events"]),
                       skipped_steps=int(hs["skipped_steps"]),
                       alerts_total=int(hs["alerts_total"]),
                       active_alerts=list(hs["active_alerts"]))
    except Exception:
        pass
    record("dump", reason=reason)
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"flight-r{meta['rank']}-g{meta.get('generation', 0)}"
               f"-p{meta['pid']}.jsonl")
        return recorder().dump(path, meta)
    except Exception:
        # Broad on purpose: record() asks for JSON scalars but nothing
        # enforces it, and a numpy int or set in a field would raise
        # TypeError out of json.dumps — which here would kill the
        # background thread before it fails outstanding handles (a
        # forever-hang), or crash the fatal-signal handler.
        return None


def _flush_metrics() -> None:
    """Best-effort final KV metrics snapshot (the metrics-plane
    terminal-flush companion of a dump): a process dying on an abort
    or a signal usually never reaches shutdown(), so the launcher
    aggregate would keep serving the last PERIODIC publish — missing
    the terminal counters (aborts, final staleness) that explain the
    death."""
    try:
        from horovod_tpu_torch.common import basics as _basics

        pub = _basics.state().metrics_publisher
        if pub is not None:
            pub.publish()
    except Exception:
        pass


def dump_on_failure(reason: str, flush_metrics: bool = True) -> str | None:
    """The abnormal-exit dump path (coordinated abort, background
    failure, fatal signal): ring dump + terminal metrics flush.
    Callers that still hold threads blocked on pending handles pass
    ``flush_metrics=False`` and call :func:`flush_terminal_metrics`
    after releasing them — the KV publish retries with backoff against
    a possibly-dead store, and that wait must not delay handle
    failure."""
    path = dump(reason)
    # Goodput ledger dump beside the ring dump (docs/goodput.md): an
    # aborted/partial run must not lose its wall-clock accounting —
    # that is exactly when the attribution matters most.  sys.modules
    # lookup + signal-path skip for the same handler-safety reasons as
    # in dump() (coordinated aborts run on ordinary threads and keep
    # the ledger dump; a signalled process loses only the ledger).
    try:
        _goodput = (None if _in_signal_handler
                    else sys.modules.get("horovod_tpu_torch.perf.goodput"))
        if _goodput is not None:
            _goodput.dump(reason)
    except Exception:
        pass
    # the health snapshot too: a diverged or NaN-poisoned run's verdict
    # must survive the abort it probably caused
    try:
        _health = (None if _in_signal_handler
                   else sys.modules.get("horovod_tpu_torch.runtime.health"))
        if _health is not None and _health._monitor is not None:
            _health.dump(reason)
    except Exception:
        pass
    if flush_metrics:
        _flush_metrics()
    return path


def flush_terminal_metrics() -> None:
    """Public alias for the terminal KV metrics flush (see
    :func:`dump_on_failure`)."""
    _flush_metrics()


# ---------------------------------------------------------------------------
# Fatal-signal handlers
# ---------------------------------------------------------------------------

_signals_installed = False
_prev_handlers: dict = {}
# True only while the fatal-signal handler runs: the goodput hooks in
# dump()/dump_on_failure() check it and stand down (their metric reads
# take plain locks the interrupted main thread may hold).
_in_signal_handler = False


def _on_fatal_signal(signum, frame):
    global _in_signal_handler
    del frame
    try:
        name = signal.Signals(signum).name
    except ValueError:
        name = str(signum)
    record("signal", sig=name)
    _in_signal_handler = True
    try:
        dump_on_failure(f"signal:{name}")
    finally:
        _in_signal_handler = False
    prev = _prev_handlers.get(signum)
    if callable(prev):
        prev(signum, None)
    elif prev == signal.SIG_IGN:
        return
    else:
        # Default disposition: re-deliver so the exit status still says
        # "killed by <sig>" (the launcher keys its blacklist on it).
        signal.signal(signum, signal.SIG_DFL)
        try:
            os.kill(os.getpid(), signum)
        except OSError:
            os._exit(128 + int(signum))


def install_signal_handlers() -> bool:
    """Install SIGTERM/SIGABRT dump handlers (idempotent; main thread
    only — ``signal.signal`` raises elsewhere, and a re-init from a
    worker thread must not kill the re-form).  SIGKILL is unhookable by
    design: a SIGKILLed rank's story is told by its PEERS' dumps, which
    is why every rank records, not just rank 0."""
    global _signals_installed
    if _signals_installed:
        return True
    try:
        for sig in (signal.SIGTERM, signal.SIGABRT):
            _prev_handlers[sig] = signal.getsignal(sig)
            signal.signal(sig, _on_fatal_signal)
    except (ValueError, OSError):  # not the main thread / exotic platform
        return False
    _signals_installed = True
    return True


# ---------------------------------------------------------------------------
# Launcher-side sweep
# ---------------------------------------------------------------------------


def sweep(directory: str) -> list[str]:
    """List the completed dumps under ``directory`` (sorted; tmp files
    from in-flight writers are skipped).  The launcher calls this at
    wrap-up and after observed re-forms to tell the operator what
    forensics exist and how to merge them."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(
        os.path.join(directory, n) for n in names
        if n.startswith("flight-") and n.endswith(".jsonl"))
