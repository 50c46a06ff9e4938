"""Critical-path / straggler / death analyzer for flight dumps.

Three questions, in the order an on-call asks them:

* **who killed this job** — dead ranks (named by abort events and by
  the holes in the dump set), the last negotiation round each dead
  rank participated in, and the fleet's final seconds as one
  interleaved, clock-aligned event tail;
* **who is slow** — per-round straggler attribution from the
  coordinator's ``arrive`` ticks (all on rank 0's single clock, so no
  alignment error pollutes the ranking): who arrived last, how late,
  per-rank lateness histograms;
* **where did the time go** — per-rank wall split into blocked
  (framework threads waiting on handles), comm (background dispatch
  busy) and the compute remainder.
"""

from __future__ import annotations

import math

_HIST_LO, _HIST_HI = -10, 6  # 2^-10 s (~1 ms) .. 2^6 s buckets


def _lateness_hist() -> dict:
    return {f"le_2^{k}": 0 for k in range(_HIST_LO, _HIST_HI + 1)}


def _hist_add(hist: dict, value: float) -> None:
    k = _HIST_LO if value <= 0 else min(
        _HIST_HI, max(_HIST_LO, math.ceil(math.log2(value))))
    hist[f"le_2^{k}"] += 1


def _coordinator_dumps(dumps) -> list:
    return [d for d in dumps if d.of_kind("arrive")]


def _stragglers(dumps) -> dict:
    """Per-rank lateness from coordinator ``arrive`` events.  One entry
    per (generation, peer rank): rounds observed, times it arrived
    last, total / max lateness seconds, and a log2 lateness histogram.
    Ranked worst first by total lateness.  Rank identities are
    reassigned at each elastic re-form, so lateness is never merged
    across generations — gen-1 "rank 1" and gen-2 "rank 1" can be
    different hosts."""
    per_rank: dict[tuple, dict] = {}
    rounds_seen = 0
    for d in _coordinator_dumps(dumps):
        by_round: dict[int, dict] = {}
        for ev in d.of_kind("arrive"):
            try:
                by_round.setdefault(int(ev["round"]), {})[
                    int(ev["peer"])] = float(ev["mono"])
            except (KeyError, TypeError, ValueError):
                continue
        for rnd, arrivals in by_round.items():
            if len(arrivals) < 2:
                continue
            rounds_seen += 1
            first = min(arrivals.values())
            last_peer = max(arrivals, key=arrivals.get)
            for peer, t in arrivals.items():
                rec = per_rank.setdefault((d.generation, peer), {
                    "rank": peer, "generation": d.generation,
                    "rounds": 0, "last_count": 0,
                    "total_lateness_s": 0.0, "max_lateness_s": 0.0,
                    "hist": _lateness_hist()})
                late = t - first
                rec["rounds"] += 1
                rec["total_lateness_s"] += late
                rec["max_lateness_s"] = max(rec["max_lateness_s"], late)
                _hist_add(rec["hist"], late)
                if peer == last_peer and late > 0:
                    rec["last_count"] += 1
    ranking = sorted(per_rank.values(),
                     key=lambda r: (-r["total_lateness_s"],
                                    -r["generation"], r["rank"]))
    for rec in ranking:
        rec["total_lateness_s"] = round(rec["total_lateness_s"], 4)
        rec["max_lateness_s"] = round(rec["max_lateness_s"], 4)
        rec["mean_lateness_s"] = round(
            rec["total_lateness_s"] / max(rec["rounds"], 1), 4)
    return {"rounds": rounds_seen, "ranking": ranking}


def _span_seconds(dump, kind: str) -> float:
    """Sum of closed B→E span durations of ``kind`` (mono clock);
    spans left open at death extend to the dump stamp.  Opens are
    keyed by span identity (handle for waits) — several framework
    threads can be blocked on different handles at once, and a single
    open-slot would drop the overlapped spans."""
    total = 0.0
    opens: dict = {}
    for ev in dump.of_kind(kind):
        key = ev.get("handle", ev.get("round", ev.get("step", 0)))
        if ev.get("ph") == "B":
            opens[key] = float(ev.get("mono", 0.0))
        elif ev.get("ph") == "E" and key in opens:
            total += max(0.0, float(ev.get("mono", 0.0)) - opens.pop(key))
    for open_t in opens.values():
        total += max(0.0, float(dump.meta.get("dump_mono", open_t))
                     - open_t)
    return total


def _phases(dumps) -> list:
    """Per-rank wall split: blocked (handle waits) / comm (dispatch
    busy) / compute (remainder of the observed span)."""
    out = []
    for d in dumps:
        monos = [float(e["mono"]) for e in d.events if "mono" in e]
        span = (max(monos) - min(monos)) if len(monos) > 1 else 0.0
        blocked = _span_seconds(d, "wait")
        comm = _span_seconds(d, "dispatch")
        rounds = sum(1 for e in d.of_kind("round")
                     if e.get("ph") == "E")
        rec = {
            "rank": d.rank, "generation": d.generation,
            "span_s": round(span, 3),
            "blocked_s": round(blocked, 3),
            "comm_s": round(comm, 3),
            "compute_s": round(max(0.0, span - blocked), 3),
            "rounds": rounds,
        }
        # hvd.trace_step() spans, when the job used them: the per-step
        # comm/compute/blocked split straight off the record.
        steps = [e for e in d.of_kind("step") if e.get("ph") == "E"]
        if steps:
            walls = [float(e.get("wall_s", 0.0)) for e in steps]
            rec["steps"] = len(steps)
            rec["step_mean_s"] = round(sum(walls) / len(walls), 4)
            rec["step_max_s"] = round(max(walls), 4)
            for k in ("compute_s", "comm_s", "blocked_s"):
                rec[f"step_{k[:-2]}_total_s"] = round(
                    sum(float(e.get(k, 0.0)) for e in steps), 4)
        out.append(rec)
    return out


def _deaths(dumps) -> dict:
    """Dead ranks: named by abort events, plus ranks of the newest
    generation whose dumps never appeared (SIGKILL leaves no dump —
    the peers' rings are the record).  ``last_round`` per dead rank is
    the last coordinator-observed arrival."""
    if not dumps:
        return {"dead": [], "last_round": {}, "reasons": {}}
    gen = max(d.generation for d in dumps)
    newest = [d for d in dumps if d.generation == gen]
    size = max(d.size for d in newest)
    present = {d.rank for d in newest}
    dead = set()
    reasons: dict = {}
    for d in newest:
        for ev in d.of_kind("abort"):
            for r in ev.get("ranks") or []:
                dead.add(int(r))
        reason = d.meta.get("reason", "")
        if reason:
            reasons[d.rank] = reason
    # A missing dump alone is NOT death evidence — a healthy job where
    # only some ranks called hvd.dump_flight_recorder() (or one dump
    # write failed) must not read as a massacre.  Infer death from
    # absence only when the surviving dumps corroborate an abnormal
    # end: an abort event, or a survivor whose dump was itself
    # triggered by a failure path (ranks-down / background failure /
    # coordinated stop / fatal signal / re-form).  Only "explicit"
    # operator dumps carry no such weight.
    failure_evidence = bool(dead) or any(
        str(reasons.get(d.rank, "")).startswith(
            ("ranks_down", "background_failure", "coordinated",
             "signal:", "reform:"))
        for d in newest)
    if failure_evidence:
        dead |= set(range(size)) - present
    last_round: dict = {}
    for d in _coordinator_dumps(newest):
        for ev in d.of_kind("arrive"):
            try:
                peer, rnd = int(ev["peer"]), int(ev["round"])
            except (KeyError, TypeError, ValueError):
                continue
            if peer in dead:
                last_round[peer] = max(last_round.get(peer, -1), rnd)
    return {"generation": gen, "size": size,
            "dead": sorted(dead), "missing_dumps": sorted(
                set(range(size)) - present),
            "last_round": {str(k): v
                           for k, v in sorted(last_round.items())},
            "survivor_reasons": {str(k): v
                                 for k, v in sorted(reasons.items())}}


def _health(dumps, offsets) -> dict:
    """Training-health postmortem (docs/health.md): the first
    nonfinite event per rank on the aligned clock, and every sentinel
    trip/clear interleaved with the round and abort events around it —
    so the report answers "did this job die BECAUSE it diverged" with
    an ordered timeline, not two disconnected logs.  Each row carries
    the last negotiation round its dump had opened, anchoring the
    health event against the control plane's progress."""
    first_nonfinite = []
    timeline = []
    for d in dumps:
        off = offsets.get(d.path, {}).get("offset_s", 0.0)
        last_round = None
        seen_first = False
        for ev in d.events:
            kind = ev.get("kind")
            if kind == "round" and ev.get("ph") == "B":
                try:
                    last_round = int(ev.get("round"))
                except (TypeError, ValueError):
                    pass
            if kind not in ("health", "abort"):
                continue
            wall = float(ev.get("wall", 0.0)) + off
            row = {"t_wall": wall, "rank": d.rank,
                   "generation": d.generation, "kind": kind,
                   "round": last_round}
            row.update({k: v for k, v in ev.items()
                        if k not in ("seq", "mono", "wall", "kind",
                                     "ph")})
            timeline.append(row)
            if kind == "health" \
                    and ev.get("event") == "first_nonfinite" \
                    and not seen_first:
                seen_first = True
                first_nonfinite.append({
                    "rank": d.rank, "generation": d.generation,
                    "t_wall": wall, "round": last_round,
                    "culprit": ev.get("culprit"),
                    "group": ev.get("group"),
                    "count": ev.get("count")})
    timeline.sort(key=lambda r: r["t_wall"])
    t0 = timeline[0]["t_wall"] if timeline else 0.0
    for row in timeline:
        row["t_s"] = round(row.pop("t_wall") - t0, 4)
    for row in first_nonfinite:
        row["t_s"] = round(row.pop("t_wall") - t0, 4)
    trips = [r for r in timeline
             if r.get("event") in ("sentinel_trip", "sentinel_clear")]
    return {"first_nonfinite": first_nonfinite,
            "sentinel_trips": trips, "timeline": timeline}


def _last_events(dumps, offsets, tail: int = 12) -> list:
    """The fleet's final seconds: each rank's last ``tail`` events,
    clock-aligned and interleaved — the black-box readout."""
    rows = []
    for d in dumps:
        off = offsets.get(d.path, {}).get("offset_s", 0.0)
        for ev in d.events[-tail:]:
            rows.append((float(ev.get("wall", 0.0)) + off, d.rank,
                         d.generation, ev))
    rows.sort(key=lambda r: r[0])
    if not rows:
        return []
    t0 = rows[0][0]
    out = []
    for wall, rank, gen, ev in rows:
        fields = {k: v for k, v in ev.items()
                  if k not in ("seq", "mono", "wall", "kind", "ph")}
        out.append({"t_s": round(wall - t0, 4), "rank": rank,
                    "generation": gen, "kind": ev.get("kind"),
                    "ph": ev.get("ph"), "fields": fields})
    return out


def analyze(dumps, offsets, tail: int = 12) -> dict:
    """Full report dict over loaded dumps + clock offsets."""
    # Keys carry the generation once more than one appears: rank
    # numbers repeat across elastic re-forms, and a rank-only key would
    # silently overwrite one generation's offsets with the other's.
    clock_multi_gen = len({info.get("generation")
                           for info in offsets.values()}) > 1
    return {
        "clock": {(f"{info.get('rank')}@g{info.get('generation')}"
                   if clock_multi_gen else str(info.get("rank"))): {
            "rank": info.get("rank"),
            "offset_ms": round(
                float(info.get("offset_s", 0.0) or 0.0) * 1e3, 3),
            "bound_ms": (round(float(info["bound_s"]) * 1e3, 3)
                         if info.get("bound_s") is not None else None),
            "mode": info.get("mode"),
            "generation": info.get("generation")}
            for info in offsets.values()},
        "stragglers": _stragglers(dumps),
        "phases": _phases(dumps),
        "deaths": _deaths(dumps),
        "health": _health(dumps, offsets),
        "last_events": _last_events(dumps, offsets, tail=tail),
    }


def format_report(report: dict, top: int = 5) -> str:
    """The human "why was this slow / who killed this job" text."""
    lines = ["=== flight-recorder report ==="]
    deaths = report.get("deaths") or {}
    if deaths.get("dead"):
        lines.append(
            f"DEAD rank(s): {deaths['dead']} (generation "
            f"{deaths.get('generation')}, world {deaths.get('size')})")
        for r in deaths["dead"]:
            rnd = (deaths.get("last_round") or {}).get(str(r))
            lines.append(
                f"  rank {r}: last participated in round "
                f"{rnd if rnd is not None else '<unknown>'}"
                + (" — no dump (killed before it could write one)"
                   if r in (deaths.get("missing_dumps") or []) else ""))
        for r, reason in (deaths.get("survivor_reasons") or {}).items():
            lines.append(f"  survivor rank {r} dumped on: {reason}")
    else:
        lines.append("no rank deaths observed")

    st = report.get("stragglers") or {}
    ranking = st.get("ranking") or []
    if ranking:
        lines.append(f"straggler ranking over {st.get('rounds', 0)} "
                     "negotiation round(s) (worst first):")
        multi_gen = len({rec.get("generation") for rec in ranking}) > 1
        for rec in ranking[:top]:
            gen = (f" g{rec['generation']}" if multi_gen else "")
            lines.append(
                f"  rank {rec['rank']}{gen}: "
                f"last-in {rec['last_count']}x, "
                f"total lateness {rec['total_lateness_s']:.3f}s "
                f"(mean {rec['mean_lateness_s']:.3f}s, "
                f"max {rec['max_lateness_s']:.3f}s over "
                f"{rec['rounds']} rounds)")
    else:
        lines.append("no coordinator arrival data "
                     "(rank 0's dump missing or no rounds ran)")

    phases = report.get("phases") or []
    if phases:
        lines.append("per-rank time split (span = first..last event):")
        for p in phases:
            extra = ""
            if p.get("steps"):
                extra = (f"; {p['steps']} steps, mean "
                         f"{p['step_mean_s']:.3f}s, max "
                         f"{p['step_max_s']:.3f}s")
            lines.append(
                f"  rank {p['rank']} g{p['generation']}: "
                f"span {p['span_s']:.2f}s — blocked {p['blocked_s']:.2f}s"
                f", comm {p['comm_s']:.2f}s, compute {p['compute_s']:.2f}s"
                f" ({p['rounds']} rounds{extra})")

    health = report.get("health") or {}
    if health.get("first_nonfinite") or health.get("sentinel_trips"):
        lines.append("training health (docs/health.md):")
        for fn in health.get("first_nonfinite") or []:
            rnd = fn.get("round")
            lines.append(
                f"  rank {fn['rank']} g{fn['generation']}: first "
                f"nonfinite at +{fn['t_s']:.4f}s — culprit rank "
                f"{fn.get('culprit')} / {fn.get('group')} "
                f"({float(fn.get('count') or 0):g} elem(s))"
                + (f", around round {rnd}" if rnd is not None else ""))
        for ev in (health.get("timeline") or [])[:4 * top]:
            what = ev.get("event") or ev.get("kind")
            if ev.get("kind") == "abort":
                what = f"ABORT ranks={ev.get('ranks')}"
            elif what == "sentinel_trip":
                what = f"sentinel TRIP reason={ev.get('reason')}"
            elif what == "sentinel_clear":
                what = f"sentinel clear reason={ev.get('reason')}"
            elif what == "first_nonfinite":
                what = (f"first nonfinite culprit={ev.get('culprit')}"
                        f"/{ev.get('group')}")
            elif what == "checkpoint":
                what = (f"health checkpoint nonfinite="
                        f"{ev.get('nonfinite_events')} alerts="
                        f"{ev.get('alerts_total')}")
            rnd = ev.get("round")
            lines.append(
                f"  +{ev['t_s']:9.4f}s rank {ev['rank']} [{what}]"
                + (f" round={rnd}" if rnd is not None else ""))
    elif "health" in report:
        lines.append("training health: no nonfinite gradients or "
                     "sentinel trips recorded")

    clock = report.get("clock") or {}
    if clock:
        parts = []
        multi_gen = len({i.get("generation")
                         for i in clock.values()}) > 1
        for r, info in sorted(clock.items()):
            b = info.get("bound_ms")
            label = f"rank {info.get('rank', r)}" + (
                f" g{info.get('generation')}" if multi_gen else "")
            parts.append(f"{label}: {info['offset_ms']:+.2f}ms"
                         + (f" ±{b:.2f}ms" if b is not None else " (no "
                            "samples)"))
        lines.append("clock offsets vs reference: " + "; ".join(parts))

    tail = report.get("last_events") or []
    if tail:
        lines.append(f"last events before the end (interleaved, "
                     f"{len(tail)} shown):")
        for ev in tail[-4 * top:]:
            fields = ", ".join(f"{k}={v}" for k, v in
                               sorted((ev.get("fields") or {}).items()))
            lines.append(
                f"  +{ev['t_s']:9.4f}s rank {ev['rank']} "
                f"[{ev['kind']}{'/' + ev['ph'] if ev['ph'] != 'i' else ''}]"
                + (f" {fields}" if fields else ""))
    return "\n".join(lines)
