"""Chrome/Perfetto trace writer for merged flight-recorder dumps.

Emits the Trace Event Format (the JSON ``chrome://tracing`` and
Perfetto both load): one *process* per rank dump (pid encodes
generation + rank), named *threads* as rows — negotiation rounds,
coordinator arrivals, collectives, wire, heartbeat/clock, handle
waits, lifecycle — ``B``/``E`` spans for bracketed events and ``i``
instants for ticks.  Spans left open at death are closed at the
dump's own timestamp and flagged ``unfinished`` so "died blocked in
round 41" is a visible bar running to the end of the process row.
"""

from __future__ import annotations

# kind -> (tid, row name).  Unlisted kinds land on the lifecycle row.
_ROWS = {
    "step": (8, "steps"),
    "round": (1, "negotiation rounds"),
    "arrive": (2, "arrivals@coordinator"),
    "dispatch": (3, "collectives"),
    "wait": (4, "handle waits"),
    "wire": (5, "wire"),
    "kv_retry": (5, "wire"),
    "kv_fail": (5, "wire"),
    "wire_timeout": (5, "wire"),
    "hb_pub": (6, "heartbeat"),
    "hb_pub_fail": (6, "heartbeat"),
    "hb_stale": (6, "heartbeat"),
    "hb_fresh": (6, "heartbeat"),
    "clk": (6, "heartbeat"),
    "stall": (7, "lifecycle"),
    "abort": (7, "lifecycle"),
    "elastic": (7, "lifecycle"),
    "init": (7, "lifecycle"),
    "shutdown": (7, "lifecycle"),
    "signal": (7, "lifecycle"),
    "dump": (7, "lifecycle"),
}
_LIFECYCLE_TID = 7

_META_KEYS = ("seq", "mono", "wall", "kind", "ph")


def _span_name(ev: dict) -> str:
    kind = ev.get("kind", "?")
    if kind == "round" and "round" in ev:
        return f"round {ev['round']}"
    if kind == "step" and "step" in ev:
        return f"step {ev['step']}" if ev["step"] >= 0 else "step"
    if kind == "dispatch" and "collective" in ev:
        return str(ev.get("collective"))
    if kind == "wait" and "handle" in ev:
        return f"wait h{ev['handle']}"
    if kind == "arrive" and "peer" in ev:
        return f"rank {ev['peer']} arrived"
    if kind == "elastic" and "event" in ev:
        return f"elastic:{ev['event']}"
    if kind == "stall":
        return f"stall:{ev.get('level', '?')}"
    return kind


def _args(ev: dict) -> dict:
    return {k: v for k, v in ev.items() if k not in _META_KEYS}


def chrome_trace(dumps, offsets) -> dict:
    """Build the trace dict (``{"traceEvents": [...], ...}``) from
    loaded :class:`~horovod_tpu_torch.trace.merge.RankDump` objects and the
    :func:`~horovod_tpu_torch.trace.merge.compute_offsets` result."""
    events: list[dict] = []

    def emit(pid, tid, ph, ts_us, name, args=None, span_id=None):
        ev = {"pid": pid, "tid": tid, "ph": ph, "ts": round(ts_us, 1),
              "name": name}
        if ph == "i":
            ev["s"] = "t"
        elif ph in ("b", "e"):  # async pair: id + cat are mandatory
            # Legacy async events are matched globally by (cat, id) —
            # NOT per pid — and handle numbers restart per rank, so the
            # pid must be folded in or rank 0's b pairs with rank 1's e.
            ev["id"] = f"{pid}:{span_id if span_id is not None else name}"
            ev["cat"] = "hvd"
        if args:
            ev["args"] = args
        events.append(ev)

    for d in dumps:
        info = offsets.get(d.path, {})
        off = float(info.get("offset_s", 0.0) or 0.0)
        pid = d.generation * 10_000 + d.rank
        host = d.meta.get("host", "?")
        bound = info.get("bound_s")
        label = (f"rank {d.rank} gen {d.generation} ({host})"
                 + (f" ±{bound * 1e3:.1f}ms" if bound else ""))
        events.append({"pid": pid, "tid": 0, "ph": "M", "ts": 0,
                       "name": "process_name",
                       "args": {"name": label}})
        events.append({"pid": pid, "tid": 0, "ph": "M", "ts": 0,
                       "name": "process_sort_index",
                       "args": {"sort_index": pid}})
        for tid, row in sorted(set(_ROWS.values())):
            events.append({"pid": pid, "tid": tid, "ph": "M", "ts": 0,
                           "name": "thread_name", "args": {"name": row}})

        # open-span bookkeeping per (tid, name): a B with no matching E
        # closes at the dump stamp, flagged unfinished.  "wait" spans
        # can overlap (several framework threads blocked on different
        # handles at once, all on one row) — Chrome matches sync B/E
        # stack-wise regardless of name, which would swap overlapping
        # durations, so waits ride ASYNC events keyed by handle id.
        open_spans: dict[tuple, dict] = {}
        end_us = (float(d.meta.get("dump_wall", 0.0)) + off) * 1e6
        for ev in d.events:
            kind = ev.get("kind", "?")
            tid = _ROWS.get(kind, (_LIFECYCLE_TID, ""))[0]
            ts_us = (float(ev.get("wall", 0.0)) + off) * 1e6
            end_us = max(end_us, ts_us)
            ph = ev.get("ph", "i")
            name = _span_name(ev)
            is_async = kind == "wait"
            key = (tid, name, is_async)
            sid = ev.get("handle") if is_async else None
            if ph == "B":
                open_spans[key] = ev
                emit(pid, tid, "b" if is_async else "B", ts_us, name,
                     _args(ev), span_id=sid)
            elif ph == "E":
                if open_spans.pop(key, None) is not None:
                    emit(pid, tid, "e" if is_async else "E", ts_us,
                         name, _args(ev), span_id=sid)
                else:
                    # The ring overwrote this span's B: degrade to an
                    # instant instead of emitting an unbalanced E.
                    emit(pid, tid, "i", ts_us, name, _args(ev))
            else:
                emit(pid, tid, "i", ts_us, name, _args(ev))
        for (tid, name, is_async), ev in open_spans.items():
            emit(pid, tid, "e" if is_async else "E", end_us, name,
                 {"unfinished": True},
                 span_id=ev.get("handle") if is_async else None)

    # Chrome requires B/E nesting per (pid, tid) in timestamp order.
    events.sort(key=lambda e: (e["pid"], e["tid"], e["ts"],
                               0 if e["ph"] == "M" else 1))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "horovod_tpu_torch.trace",
            "clock_offsets": {
                str(k): v for k, v in sorted(offsets.items())},
        },
    }
