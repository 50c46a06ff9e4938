"""Dump loading + cross-rank clock alignment for the flight recorder.

Every rank stamps its events with its OWN ``time.time()``; merging the
fleet into one timeline needs per-rank offsets.  The raw material is
the ``clk`` events the runtime records piggyback on heartbeat sweeps:
a beat value carries the publisher's wall clock, so the observer's
event gives one sample of ``(observer_clock - publisher_clock) +
one_way_delay`` with ``one_way_delay >= 0``.  The sweep topology
(coordinator sweeps every worker, workers sweep the coordinator) makes
every rank pair with rank 0 sampled in BOTH directions, which is the
NTP trick: with ``o1 = min samples of rank0-observing-r`` and
``o2 = min samples of r-observing-rank0``,

    true_offset(rank0 - r)  in  [-o2, o1]

so the midpoint ``(o1 - o2) / 2`` estimates the offset with error at
most ``(o1 + o2) / 2`` — the measured bound reported next to every
offset.  One-way-only links (the other side's dump is missing) fall
back to the single direction with the sample itself as the bound.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field


@dataclass
class RankDump:
    """One flight-recorder dump file: a meta header + ordered events."""

    path: str
    meta: dict
    events: list = field(default_factory=list)

    @property
    def rank(self) -> int:
        return int(self.meta.get("rank", 0))

    @property
    def generation(self) -> int:
        return int(self.meta.get("generation", 0))

    @property
    def size(self) -> int:
        return int(self.meta.get("size", 1))

    def of_kind(self, kind: str) -> list:
        return [e for e in self.events if e.get("kind") == kind]


def load_dump(path: str) -> RankDump:
    meta: dict = {}
    events: list = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if i == 0 and "meta" in rec:
                meta = rec["meta"]
            else:
                events.append(rec)
    events.sort(key=lambda e: e.get("seq", 0))
    return RankDump(path=path, meta=meta, events=events)


def load_dumps(directory: str) -> list[RankDump]:
    """Every completed flight dump under ``directory`` (recursively a
    flat dir; tmp files from in-flight writers are ignored), sorted by
    (generation, rank)."""
    out = []
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("flight-") and name.endswith(".jsonl")):
            continue
        try:
            out.append(load_dump(os.path.join(directory, name)))
        except (OSError, ValueError):
            continue  # torn/foreign file: skip, never die on forensics
    out.sort(key=lambda d: (d.generation, d.rank))
    return out


def _min_offset_samples(dumps: list[RankDump]) -> dict:
    """``(observer_rank, publisher_rank) -> min offset sample`` within
    one generation group (minimum over samples = the sample with the
    least one-way delay, the tightest bound)."""
    link: dict[tuple, float] = {}
    for d in dumps:
        for ev in d.of_kind("clk"):
            try:
                peer = int(ev["peer"])
                sample = float(ev["wall"]) - float(ev["peer_wall"])
            except (KeyError, TypeError, ValueError):
                continue
            key = (d.rank, peer)
            if key not in link or sample < link[key]:
                link[key] = sample
    return link


def compute_offsets(dumps: list[RankDump]) -> dict:
    """Per-dump clock correction: ``dump.path -> {"offset_s", "bound_s",
    "mode"}`` where ``offset_s`` is ADDED to that rank's wall stamps to
    land on the reference rank's clock (the lowest rank of each
    generation group; rank 0 when its dump exists).

    ``bound_s`` is the measured error bound ((o1+o2)/2 for two-way
    links, the raw sample for one-way, None when no samples exist —
    e.g. liveness disabled).  Offsets compose through rank 0 because
    the sweep topology stars on it."""
    out: dict = {}
    by_gen: dict[int, list[RankDump]] = {}
    for d in dumps:
        by_gen.setdefault(d.generation, []).append(d)
    for gen, group in by_gen.items():
        link = _min_offset_samples(group)
        # offset of each rank's clock vs rank 0's clock (c0 - cr)
        vs0: dict[int, tuple] = {0: (0.0, 0.0, "self")}
        for d in group:
            r = d.rank
            if r == 0:
                continue
            o1 = link.get((0, r))      # rank0 observed r: (c0-cr)+d1
            o2 = link.get((r, 0))      # r observed rank0: (cr-c0)+d2
            if o1 is not None and o2 is not None:
                vs0[r] = ((o1 - o2) / 2.0, (o1 + o2) / 2.0, "two-way")
            elif o1 is not None:
                vs0[r] = (o1, abs(o1), "one-way")
            elif o2 is not None:
                vs0[r] = (-o2, abs(o2), "one-way")
            else:
                vs0[r] = (0.0, None, "none")
        ref = min(d.rank for d in group)
        ref_off, ref_bound, _ = vs0.get(ref, (0.0, 0.0, "self"))
        for d in group:
            off, bound, mode = vs0.get(d.rank, (0.0, None, "none"))
            # rebase: t_ref = t_r + (c0-cr) - (c0-cref)
            total = off - ref_off
            if bound is None or ref_bound is None:
                total_bound = None if d.rank != ref else 0.0
            else:
                total_bound = bound + (0.0 if d.rank == ref else ref_bound)
            out[d.path] = {"offset_s": total, "bound_s": total_bound,
                           "mode": mode, "generation": gen,
                           "rank": d.rank}
    return out


def merge(directory: str, out_path: str | None = None) -> tuple:
    """Load every dump under ``directory``, align clocks, write the
    Chrome/Perfetto trace JSON (default ``<directory>/trace.json``) and
    return ``(trace_path, dumps, offsets)``."""
    from horovod_tpu_torch.trace.perfetto import chrome_trace

    dumps = load_dumps(directory)
    if not dumps:
        raise FileNotFoundError(
            f"no flight-recorder dumps (flight-*.jsonl) under "
            f"{directory!r}; set HOROVOD_FLIGHT_DIR on the job and "
            "re-run, or trigger hvd.dump_flight_recorder()")
    offsets = compute_offsets(dumps)
    trace = chrome_trace(dumps, offsets)
    out_path = out_path or os.path.join(directory, "trace.json")
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, out_path)
    return out_path, dumps, offsets
