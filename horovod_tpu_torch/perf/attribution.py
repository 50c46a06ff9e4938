"""Attribution: device events -> framework scopes -> per-step truth
(counterpart of ``horovod_tpu/perf/attribution.py``: the same result
dict, interval arithmetic and never-raise contract).

Turns a parsed :class:`~horovod_tpu_torch.perf.kineto.XSpace` (a
``torch.profiler`` Chrome trace) into:

* step windows from ``hvd.trace_step``'s ``hvd_step#<n>`` spans;
* per-step **device** comm seconds split into *hidden under compute* vs
  *exposed*, by interval intersection;
* per-collective device seconds by kind (all-reduce, all-gather,
  reduce-scatter, collective-permute, all-to-all), from NCCL's kernel
  names, c10d's and gloo's op names and ``record_param_comms``'
  collective;
* per-scope seconds for the framework's named buckets
  (``hvd_overlap_rs/math/ag<k>``, ``hvd_zero2_rs<k>``,
  ``hvd_zero3_ag<k>``, ...): a device event's scope is the outermost
  ``hvd_*`` ``record_function`` around the call that launched it;
* MFU when a flops-per-step hint is given, against the card's peak
  (spec-sheet table below, ``HOROVOD_PEAK_FLOPS_PER_CHIP`` override).

Three rules differ from the xplane reader's, because a Kineto trace
differs from an xplane:

* a step's window on the card wins over its host span: the
  ``gpu_user_annotation`` of the step, else from the first to the last
  device event whose launch lies inside the host span (the host span
  only brackets the dispatch on an asynchronous card);
* on a capture without device events (the CPU) the work is the host's
  ops, each where no op nested inside it runs (its self time): the
  ``cpu_op`` events and the backends' own collective spans
  (``gloo:all_reduce``).  A parent counted whole (``aten::matmul`` over
  ``aten::mm``, a ``c10d`` op over its copies, an annotation over the
  step) would cover the collective and read every comm as hidden (the
  reference skips its ``call`` and ``while`` thunks for the same
  reason);
* a scope's name never makes an op a collective of some kind (the eager
  plane's ``hvd_allreduce`` also packs buffers); the op's own name and
  the ops around its launch do.
"""

from __future__ import annotations

import bisect
import re

from horovod_tpu_torch.perf import kineto as _kt

# Dense bf16 tensor-core peak FLOP/s per card, from NVIDIA's data sheets
# (the sheets' sparse figures halved), keyed by a substring of
# torch.cuda.get_device_name() with spaces and dashes removed.  The H100
# SXM5 ("NVIDIA H100 80GB HBM3") figure assumes its full 700 W board
# power; a card capped lower runs below it.
_PEAK_FLOPS = [
    ("h200", 989e12), ("h100nvl", 835e12), ("h100pcie", 756e12),
    ("h100", 989e12), ("a100", 312e12), ("l40s", 362e12), ("l4", 121e12),
]

_PS = 1e-12

# Collective kinds by canonical name; matched against the event name and
# the scope path of its launch (NCCL: ncclDevKernel_AllReduce_Sum_f32_*,
# ncclKernel_*; c10d: c10d::allreduce_, c10d::_reduce_scatter_base_;
# gloo: gloo:all_reduce; record_param_comms[<collective>]).
_COMM_KINDS = (
    ("all-reduce", ("all-reduce", "allreduce", "all_reduce", "psum")),
    ("reduce-scatter", ("reduce-scatter", "reducescatter",
                        "reduce_scatter", "psum-scatter", "psum_scatter")),
    ("all-gather", ("all-gather", "allgather", "all_gather")),
    ("collective-permute", ("collective-permute", "collective_permute",
                            "ppermute", "sendrecv", "c10d::send",
                            "c10d::recv", "gloo:send", "gloo:recv")),
    ("all-to-all", ("all-to-all", "alltoall", "all_to_all")),
)

# Framework scopes whose WORK is communication even when the individual
# ops inside are copies around the wire op.
_COMM_SCOPE = re.compile(
    r"^hvd_(overlap_(rs|ag)|zero2_(rs|ag)|zero3_(rs|ag))\d*$")
# hvd_step is trace_step's annotation of the whole step, not a scope
_HVD_SCOPE = re.compile(r"^hvd_(?!step$)\w+$")


def peak_flops_per_chip(device_name: str) -> float | None:
    """Spec-sheet dense bf16 peak for a ``torch.cuda.get_device_name()``
    string; the ``HOROVOD_PEAK_FLOPS_PER_CHIP`` knob overrides (a card
    the table lacks, or a CPU run that still wants an MFU
    denominator)."""
    from horovod_tpu_torch.common import config as _config

    try:
        override = float(_config.get("peak_flops"))
    except (TypeError, ValueError):
        override = 0.0
    if override > 0:
        return override
    name = (device_name or "").lower().replace(" ", "").replace("-", "")
    for tag, peak in _PEAK_FLOPS:
        if tag in name:
            return peak
    return None


# ---------------------------------------------------------------------------
# Interval arithmetic (ps integers; events can nest and overlap freely)
# ---------------------------------------------------------------------------


def _merge(intervals: list) -> list:
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [list(intervals[0])]
    for s, e in intervals[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _total(merged: list) -> int:
    return sum(e - s for s, e in merged)


def _intersect(a: list, b: list) -> list:
    out = []
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if s < e:
            out.append([s, e])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


# ---------------------------------------------------------------------------
# Event extraction
# ---------------------------------------------------------------------------


def _scope_of(op_name: str) -> str | None:
    """First ``hvd_*`` component of a scope path, e.g.
    ``hvd_overlap_rs0/c10d::_reduce_scatter_base_/cudaLaunchKernel`` ->
    that bucket.  Nested scopes resolve to the outermost hvd component."""
    for part in op_name.split("/"):
        if _HVD_SCOPE.match(part):
            return part
    return None


def _unscoped(op_name: str) -> str:
    """The scope path without its ``hvd_*`` components."""
    return "/".join(p for p in op_name.split("/")
                    if not p.startswith("hvd_"))


def _comm_kind(*names) -> str | None:
    for text in names:
        if not text:
            continue
        low = text.lower()
        for kind, pats in _COMM_KINDS:
            for pat in pats:
                if pat in low:
                    return kind
    return None


def _has_device_work(space: _kt.XSpace) -> bool:
    return any(True for p in space.planes if p.name.startswith("/device:")
               for _ in _kt.device_work(p))


def _op_events(space: _kt.XSpace, scopes: dict):
    """Yield ``(event, scope, comm_kind)`` for every event that is work:
    the device events, or on a capture without any, the self-time
    pieces of the host's ops."""
    if _has_device_work(space):
        for plane in space.planes:
            if not plane.name.startswith("/device:"):
                continue
            for ev in _kt.device_work(plane):
                if ev.duration_ps <= 0:
                    continue
                op_name = scopes.get(ev.stats.get("correlation"), "")
                yield (ev, _scope_of(op_name),
                       _comm_kind(ev.name, _unscoped(op_name)))
        return
    for plane in space.planes:
        for line in plane.lines:
            for ev in line.events:
                cat = ev.stats.get("cat")
                if cat != "cpu_op" and not (cat == "user_annotation"
                                            and _comm_kind(ev.name)):
                    continue
                op_name = ev.stats.get("path", "")
                scope = _scope_of(op_name)
                kind = _comm_kind(ev.name, _unscoped(op_name))
                for s, e in ev.stats.get("self_ps", ()):
                    yield _kt.XEvent(ev.name, s, e - s, ev.stats), scope, kind


def _launch_windows(space: _kt.XSpace, host: list) -> list:
    """``(step_num, start_ps, end_ps)`` on the card for host step spans:
    from the first to the last device event whose launch lies inside
    the span (steps without one are left out)."""
    if not host:
        return []
    launch = {c: ev.start_ps for c, ev in _kt.launches(space).items()}
    work = sorted(
        (launch[c], ev.start_ps, ev.start_ps + ev.duration_ps)
        for p in space.planes if p.name.startswith("/device:")
        for ev in _kt.device_work(p)
        if (c := ev.stats.get("correlation")) in launch)
    at = [w[0] for w in work]
    out = []
    for num, lo, hi in host:
        ks = work[bisect.bisect_left(at, lo):bisect.bisect_right(at, hi)]
        if ks:
            out.append((num, min(k[1] for k in ks), max(k[2] for k in ks)))
    return out


def _step_events(space: _kt.XSpace, step_name: str) -> list:
    """``(step_num, start_ps, end_ps)`` per ``step_name`` span.

    Device windows win when present: they bound actual device execution,
    while on an asynchronous card the host span only brackets the
    dispatch and can end before the card starts.  A step's device window
    is its ``gpu_user_annotation`` span, else the span of the device
    events it launched.  Host spans are the fallback (a CPU capture runs
    the step inside the host span anyway).
    """
    host, device = [], []
    for plane in space.planes:
        on_device = plane.name.startswith("/device:")
        for line in plane.lines:
            if on_device and line.name != _kt.STEPS_LINE:
                continue
            for ev in line.events:
                num = ev.stats.get("step_num")
                if ev.duration_ps <= 0 or ev.name != step_name or \
                        num is None:
                    continue
                (device if on_device else host).append(
                    (int(num), ev.start_ps, ev.start_ps + ev.duration_ps))
    annotated = {num for num, _, _ in device}
    device += _launch_windows(
        space, [h for h in host if h[0] not in annotated])
    # Every stream restates the step on its own annotation: merge
    # windows sharing a step_num into one [min start, max end] span, so
    # the totals are not counted once per stream or device.
    merged: dict = {}
    for num, s, e in (device or host):
        if num in merged:
            s0, e0 = merged[num]
            merged[num] = (min(s0, s), max(e0, e))
        else:
            merged[num] = (s, e)
    return sorted((n, s, e) for n, (s, e) in merged.items())


# ---------------------------------------------------------------------------
# The attribution itself
# ---------------------------------------------------------------------------


def attribute(space: _kt.XSpace, flops_per_step: float | None = None,
              peak_flops: float | None = None,
              wire_bytes: float | None = None,
              step_name: str = "hvd_step") -> dict:
    """Per-step device-truth attribution for one capture.

    Returns a plain dict (JSON-ready)::

        {"steps": [{"step", "wall_s", "compute_s", "comm_s",
                    "comm_hidden_s", "comm_exposed_s", "overlap_eff",
                    "comm_by_kind": {...}, "scopes": {...}, "mfu"}],
         "totals": {... same keys summed/averaged ...},
         "op_events": N, "planes": [...], "truncated": bool,
         "scopes_resolved": N}

    ``scopes_resolved`` counts the op events resolved to an ``hvd_*``
    scope.  With no step annotations in the capture the whole trace
    collapses to one synthetic step (``step = -1``) so totals still
    land.  Never raises.
    """
    try:
        return _attribute(space, flops_per_step, peak_flops, wire_bytes,
                          step_name)
    except Exception as exc:  # background-analyzer contract
        return {"steps": [], "totals": {}, "op_events": 0,
                "planes": [p.name for p in getattr(space, "planes", [])],
                "truncated": True, "scopes_resolved": 0,
                "error": repr(exc)[:200]}


def _attribute(space, flops_per_step, peak_flops, wire_bytes, step_name):
    scopes = _kt.scope_map(space, marker="")
    events = sorted(_op_events(space, scopes),
                    key=lambda t: t[0].start_ps)
    steps = _step_events(space, step_name)
    if not steps:
        if events:
            lo = min(e.start_ps for e, _, _ in events)
            hi = max(e.start_ps + e.duration_ps for e, _, _ in events)
            steps = [(-1, lo, hi)]
        else:
            steps = []
    # A whole-run bridge capture can hold hundreds of annotated steps
    # over the same 100k+ op events; bound the per-step scan to events
    # that can overlap the window (sorted starts + the longest event
    # as the look-back slack) instead of rescanning everything.
    starts = [e.start_ps for e, _, _ in events]
    max_dur = max((e.duration_ps for e, _, _ in events), default=0)

    per_step = []
    for num, lo, hi in steps:
        comm_iv, compute_iv = [], []
        comm_by_kind: dict = {}
        scope_s: dict = {}
        first = bisect.bisect_left(starts, lo - max_dur)
        last = bisect.bisect_left(starts, hi)
        for ev, scope, kind in events[first:last]:
            s, e = ev.start_ps, ev.start_ps + ev.duration_ps
            if e <= lo or s >= hi:
                continue
            s, e = max(s, lo), min(e, hi)
            is_comm = kind is not None or (
                scope is not None and _COMM_SCOPE.match(scope))
            if is_comm:
                comm_iv.append([s, e])
                k = kind or "scoped-comm"
                kiv = comm_by_kind.setdefault(k, [])
                kiv.append([s, e])
            else:
                compute_iv.append([s, e])
            if scope:
                siv = scope_s.setdefault(scope, [])
                siv.append([s, e])
        comm_m = _merge(comm_iv)
        compute_m = _merge(compute_iv)
        comm_s = _total(comm_m) * _PS
        hidden_s = _total(_intersect(comm_m, compute_m)) * _PS
        wall_s = (hi - lo) * _PS
        entry = {
            "step": num,
            "wall_s": round(wall_s, 6),
            "compute_s": round(_total(compute_m) * _PS, 6),
            "comm_s": round(comm_s, 6),
            "comm_hidden_s": round(hidden_s, 6),
            "comm_exposed_s": round(comm_s - hidden_s, 6),
            "overlap_eff": (round(hidden_s / comm_s, 4) if comm_s > 0
                            else None),
            "comm_by_kind": {k: round(_total(_merge(v)) * _PS, 6)
                             for k, v in sorted(comm_by_kind.items())},
            "scopes": {k: round(_total(_merge(v)) * _PS, 6)
                       for k, v in sorted(scope_s.items())},
        }
        if flops_per_step and peak_flops and wall_s > 0:
            entry["mfu"] = round(flops_per_step / (peak_flops * wall_s), 4)
        per_step.append(entry)

    totals: dict = {}
    if per_step:
        n = len(per_step)
        for key in ("wall_s", "compute_s", "comm_s", "comm_hidden_s",
                    "comm_exposed_s"):
            totals[key] = round(sum(s[key] for s in per_step), 6)
            totals[f"{key}_per_step"] = round(totals[key] / n, 6)
        tc = totals["comm_s"]
        totals["overlap_eff"] = (round(totals["comm_hidden_s"] / tc, 4)
                                 if tc > 0 else None)
        mfus = [s["mfu"] for s in per_step if s.get("mfu") is not None]
        if mfus:
            totals["mfu"] = round(sum(mfus) / len(mfus), 4)
        if wire_bytes is not None:
            totals["wire_bytes"] = wire_bytes
            if tc > 0:
                totals["wire_gb_s"] = round(wire_bytes / tc / 1e9, 3)
        totals["steps"] = n
    return {
        "steps": per_step,
        "totals": totals,
        "op_events": len(events),
        "planes": [p.name for p in space.planes],
        "truncated": bool(space.truncated),
        "scopes_resolved": sum(1 for _, scope, _ in events if scope),
    }
