"""Graceful-preemption plane: notice-driven drain (the copy of
``horovod_tpu/runtime/preemption.py``; docs/fault-tolerance.md).

Production fleets lose hosts mostly to *announced* preemptions (spot
reclaim, maintenance events), not silent crashes — yet a crash is the
only degradation path the elastic layer had: wait out the heartbeat
timeout, raise :class:`RanksDownError`, re-form having lost everything
since the last commit.  This module turns an advance notice into a
coordinated drain that costs almost nothing:

1. a notice reaches the doomed rank — SIGTERM/SIGUSR1 delivered to the
   process, the launcher/autopilot addressing it over the rendezvous KV
   (``el/preempt/u/<uid>``), a ``preempt:`` fault-spec rule
   (:mod:`horovod_tpu_torch.runtime.faults`), or a pluggable cloud-metadata
   source (:func:`set_metadata_source`);
2. the rank publishes the notice under the current generation
   (``el/preempt/g<gen>/<rank>``) at its next step boundary;
3. rank 0 observes it (every rank calls :func:`maybe_interrupt` from
   ``hvd.elastic.poll()``) and publishes a **drain order**
   (``el/drain/g<gen>``) targeting a step boundary one past its own, so
   every rank — noticed and survivor alike — raises
   :class:`PreemptionInterrupt` at the SAME boundary (a rank raising
   one step apart from its peers would deadlock the others' collectives);
4. the elastic driver catches it: one emergency
   ``ElasticState`` snapshot (durable when ``checkpoint_dir`` is set),
   then the noticed rank exits cleanly (exit code 0 — the launcher sees
   the ``el/preempt/u/<uid>`` marker and neither blacklists the host
   nor counts a death) and survivors re-form *proactively* through the
   existing generation machinery, skipping the heartbeat-timeout settle
   cushion entirely (the departure was announced, not detected).

Everything lands on the flight ring (``preempt`` events) and the
metrics plane (``hvd_preemptions_total``, ``hvd_preempt_drain_seconds``)
so a postmortem can answer "did the drain beat the grace deadline"
(``HOROVOD_PREEMPT_GRACE_SECONDS``) without guessing.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import threading
import time

from horovod_tpu_torch.common import basics as _basics
from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common import logging as _log

# Local notice state.  ``_notice`` is set exactly once per process (a
# second notice escalates, see _on_notice_signal); ``_boundary`` counts
# step boundaries WITHIN the current generation — the drain-order
# protocol compares boundary indexes across ranks, and every rank
# re-enters its training loop from the top after a re-form, so the
# counter must restart with the generation to stay aligned.
_lock = threading.Lock()
_notice: dict | None = None
_pending_signal: str | None = None
_published = False
_boundary = 0
_boundary_gen = -1
_metadata_source = None
_prev_handlers: dict = {}
_handlers_installed = False


class PreemptionInterrupt(Exception):
    """Raised out of ``hvd.elastic.poll()`` on EVERY rank at the agreed
    drain boundary.  ``hvd.elastic.run`` catches it: emergency commit,
    clean exit for the noticed rank(s), proactive re-form for the
    survivors.  Do not swallow it in ``train_fn``."""

    def __init__(self, order: dict):
        self.order = dict(order)
        self.ranks = sorted(int(r) for r in order.get("ranks", ()))
        super().__init__(
            f"preemption drain of rank(s) {self.ranks} at generation "
            f"{order.get('gen')}")


def grace_seconds() -> float:
    """``HOROVOD_PREEMPT_GRACE_SECONDS`` — the advance-notice window
    the drain must finish inside.  <= 0 disables the plane (a SIGTERM
    then means death again, flight.py's fatal-signal behavior)."""
    try:
        return float(_config.get("preempt_grace"))
    except (TypeError, ValueError):
        return 0.0


def enabled() -> bool:
    """True when the graceful-preemption plane is active: elastic mode
    on and a positive grace window."""
    from horovod_tpu_torch import elastic as _elastic

    return _elastic.enabled() and grace_seconds() > 0


def noticed() -> bool:
    """True once this process has received a preemption notice (from
    any source); it will drain at the next agreed step boundary."""
    return _notice is not None


def reset() -> None:
    """Test hook: forget any local notice / drain-protocol progress
    (installed signal handlers stay installed)."""
    global _notice, _pending_signal, _published, _boundary, _boundary_gen
    with _lock:
        _notice = None
        _pending_signal = None
        _published = False
        _boundary = 0
        _boundary_gen = -1


def notice(source: str = "api", grace_s: float | None = None) -> bool:
    """Deliver an advance preemption notice to THIS process.  Safe from
    any thread (the faults module delivers from the background wire
    thread) — but NOT from signal handlers: it takes ``_lock`` and the
    logging/metrics locks, any of which the interrupted frame may
    already hold.  Signal deliveries set :data:`_pending_signal` (a
    plain store) and the training thread adopts it at the next step
    boundary.  Returns False when a notice was already pending."""
    global _notice
    g = float(grace_s) if grace_s is not None else grace_seconds()
    with _lock:
        if _notice is not None:
            return False
        _notice = {"source": str(source), "grace_s": g,
                   "wall": time.time()}
    _log.warning(
        f"preemption notice received (source={source}): emergency "
        f"commit + drain at the next step boundary, grace {g:.0f}s")
    try:
        from horovod_tpu_torch.runtime import flight as _flight

        _flight.record("preempt", event="notice", source=str(source),
                       grace_s=g)
    except Exception:
        pass
    try:
        from horovod_tpu_torch.runtime import metrics as _metrics

        _metrics.counter(
            "hvd_preemptions_total",
            "Advance preemption notices received by this rank, by "
            "source (docs/fault-tolerance.md).").inc(source=str(source))
    except Exception:
        pass
    return True


def set_metadata_source(fn) -> None:
    """Pluggable cloud-metadata notice stub: ``fn()`` is polled once
    per step boundary and should return falsy normally, truthy (or a
    dict with an optional ``grace_s``) when the host is scheduled for
    preemption — the shape of a GCE/TPU maintenance-event endpoint
    without baking any one cloud's API in.  ``None`` unplugs it."""
    global _metadata_source
    _metadata_source = fn


# ---------------------------------------------------------------------------
# Signal-delivered notices (SIGTERM / SIGUSR1 in the rank)
# ---------------------------------------------------------------------------


def _chain_previous(signum, frame) -> None:
    prev = _prev_handlers.get(signum)
    if callable(prev):
        prev(signum, frame)
        return
    if prev == signal.SIG_IGN:
        return
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def _on_notice_signal(signum, frame) -> None:
    # Async-signal-safe by construction: a single plain store, no locks
    # (not even logging's) — the signal may have landed inside any
    # critical section of the interrupted frame.  The training thread
    # adopts the pending name at its next maybe_interrupt() tick.
    global _pending_signal
    if not enabled() or _notice is not None or _pending_signal is not None:
        # Plane off, or a SECOND notice while one is already draining:
        # escalate to the previous handler (flight.py's fatal dump /
        # the default action) so TERM,TERM still kills a stuck rank.
        _chain_previous(signum, frame)
        return
    _pending_signal = signal.Signals(signum).name


def _adopt_pending_signal() -> None:
    """Turn a signal delivery into a full notice, from the training
    thread where locks are safe to take."""
    global _pending_signal
    sig = _pending_signal
    if sig is None:
        return
    _pending_signal = None
    notice(source=f"signal:{sig}")


def install_signal_handlers() -> bool:
    """Turn SIGTERM/SIGUSR1 into preemption notices for this rank.
    Installed by the elastic driver when the plane is enabled — AFTER
    flight.py's fatal-signal hooks, deliberately: with the plane on,
    SIGTERM means "drain gracefully", not "dump and die"; the saved
    previous handlers remain the escalation path.  Main thread only
    (signal module restriction); idempotent."""
    global _handlers_installed
    if _handlers_installed:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    for signum in (signal.SIGTERM, signal.SIGUSR1):
        try:
            _prev_handlers[signum] = signal.signal(
                signum, _on_notice_signal)
        except (ValueError, OSError):
            return False
    _handlers_installed = True
    return True


# ---------------------------------------------------------------------------
# Rendezvous keys: publication, external notices, the drain order
# ---------------------------------------------------------------------------


def request_drain(t, uid: str, grace_s: float | None = None,
                  source: str = "external") -> None:
    """Address an advance notice to a rank process by its stable
    elastic uid, over any rendezvous KV client ``t`` — the launcher's
    ``--preempt`` actuator, the autopilot and tests all use this.  The
    rank adopts the notice at its next step boundary; the key doubles
    as the launcher's exit-disposition marker (a rank that exits with
    it present was preempted, not lost — no blacklist, no death)."""
    g = float(grace_s) if grace_s is not None else grace_seconds()
    t.set_overwrite(
        f"el/preempt/u/{uid}",
        json.dumps({"source": str(source), "grace_s": g,
                    "wall": time.time()}, sort_keys=True))


def drain_requested(t, uid: str) -> bool:
    """True when a notice is (or was) addressed to ``uid`` — the
    launcher's reap loop reads this to tell a graceful preemption exit
    from a death."""
    try:
        return t.try_get(f"el/preempt/u/{uid}") is not None
    except Exception:
        return False


def _check_external(t) -> None:
    """Adopt a notice addressed to this process over the KV, or one
    surfaced by the pluggable metadata source."""
    if _notice is not None:
        return
    from horovod_tpu_torch import elastic as _elastic

    v = t.try_get(f"el/preempt/u/{_elastic._uid()}")
    if v is not None:
        try:
            rec = json.loads(v)
        except ValueError:
            rec = {}
        notice(source=str(rec.get("source") or "external"),
               grace_s=rec.get("grace_s"))
        return
    fn = _metadata_source
    if fn is None:
        return
    try:
        hit = fn()
    except Exception as exc:
        _log.warning(f"preemption metadata source failed: {exc}")
        return
    if hit:
        grace = hit.get("grace_s") if isinstance(hit, dict) else None
        notice(source="metadata", grace_s=grace)


def _publish_pending(t, gen: int, rank: int) -> None:
    """Publish a locally-received notice under the current generation
    (plus the dirty bit rank 0's scan keys on, and the uid-keyed marker
    the launcher reads).  Runs in the training thread — signal/fault
    deliveries only set the flag."""
    global _published
    if _notice is None or _published:
        return
    from horovod_tpu_torch import elastic as _elastic

    rec = dict(_notice)
    rec.update({"rank": int(rank), "gen": int(gen),
                "uid": _elastic._uid(), "host": socket.gethostname()})
    t.set_overwrite(f"el/preempt/g{gen}/{rank}",
                    json.dumps(rec, sort_keys=True))
    t.set_overwrite(f"el/preempt_any/g{gen}", "1")
    t.set_overwrite(f"el/preempt/u/{rec['uid']}",
                    json.dumps(rec, sort_keys=True))
    _published = True
    try:
        from horovod_tpu_torch.runtime import flight as _flight

        _flight.record("preempt", event="notice_published",
                       rank=int(rank), gen=int(gen),
                       source=rec["source"], grace_s=rec["grace_s"])
    except Exception:
        pass


def _scan_notices(t, gen: int, size: int) -> dict:
    out = {}
    for r in range(size):
        v = t.try_get(f"el/preempt/g{gen}/{r}")
        if v is None:
            continue
        try:
            out[r] = json.loads(v)
        except ValueError:
            out[r] = {}
    return out


# ---------------------------------------------------------------------------
# The drain protocol (driven from hvd.elastic.poll at step boundaries)
# ---------------------------------------------------------------------------


def maybe_interrupt() -> None:
    """One protocol tick — MUST be called at the same loop points on
    every rank (``hvd.elastic.poll()`` does; see docs/elastic.md).

    Publishes any pending local notice, adopts external ones, and
    drives the drain-order agreement: rank 0, on first observing a
    notice at boundary ``b``, orders the drain for boundary ``b + 1``;
    every rank (rank 0 included) raises :class:`PreemptionInterrupt`
    once its own boundary counter reaches the target.  Ordering one
    boundary AHEAD is what makes the raise collective-safe: a peer
    whose boundary-``b`` poll raced the order's publication still reads
    it at ``b + 1`` — its step ``b + 1`` collectives completed against
    rank 0's, which happened after the write — so nobody is left
    running a training step against a peer that already left the
    loop."""
    from horovod_tpu_torch import elastic as _elastic

    _adopt_pending_signal()
    st = _basics.state()
    if not st.initialized or not enabled():
        return
    global _boundary, _boundary_gen, _published
    gen = _elastic.generation()
    if gen != _boundary_gen:
        _boundary_gen = gen
        _boundary = 0
        _published = False
    _boundary += 1
    b = _boundary
    t = _elastic._rv()
    _check_external(t)
    _publish_pending(t, gen, st.rank)
    raw = t.try_get(f"el/drain/g{gen}")
    if raw is None:
        if st.rank != 0 or t.try_get(f"el/preempt_any/g{gen}") is None:
            return
        notices = _scan_notices(t, gen, st.size)
        if not notices:
            return
        walls = [float(n.get("wall") or 0) for n in notices.values()]
        graces = [float(n.get("grace_s") or grace_seconds())
                  for n in notices.values()]
        order = {"gen": gen, "boundary": b + 1,
                 "ranks": sorted(notices),
                 "wall": min(walls) if walls else None,
                 "deadline": min(w + g for w, g in zip(walls, graces))
                 if walls else None}
        t.set_overwrite(f"el/drain/g{gen}",
                        json.dumps(order, sort_keys=True))
        _log.warning(
            f"elastic: drain ordered for preempted rank(s) "
            f"{order['ranks']} at step boundary {b + 1} of generation "
            f"{gen}", rank=st.rank)
        try:
            from horovod_tpu_torch.runtime import flight as _flight

            _flight.record("preempt", event="drain_order", gen=gen,
                           ranks=order["ranks"], boundary=b + 1,
                           deadline=order["deadline"])
        except Exception:
            pass
        return
    order = json.loads(raw)
    if b < int(order.get("boundary") or 0):
        return
    raise PreemptionInterrupt(order)
