"""Stdlib-only reader for ``torch.profiler``'s Chrome traces (the port's
counterpart of ``horovod_tpu/perf/xplane.py``).

``torch.profiler`` writes Kineto's Chrome trace
(``export_chrome_trace`` / ``tensorboard_trace_handler``:
``*.pt.trace.json``, gzipped as ``*.pt.trace.json.gz``)::

    {"traceEvents": [{"ph": "X", "cat": "kernel", "name": ...,
                      "pid": ..., "tid": ..., "ts": <us>, "dur": <us>,
                      "args": {"correlation": ..., ...}}, ...], ...}

This module reads it into the xplane reader's shapes, so that
:mod:`horovod_tpu_torch.perf.attribution` keeps the reference's
algorithm:

* one ``/host:CPU`` plane with a line per host thread, holding the
  ``cpu_op`` and ``user_annotation`` events and the CUDA API calls
  that launch device work;
* one ``/device:GPU:<k>`` plane per device with a line per stream (its
  kernels, copies and sets), plus the bookkeeping lines the attribution
  skips: ``Steps`` (the ``gpu_user_annotation`` spans of step
  annotations) and ``Framework Name Scope`` (every other
  ``gpu_user_annotation``);
* integer times in picoseconds.  Kineto writes microseconds with up to
  three decimals (integers on older versions); they are converted from
  the decimal text, since a float loses the nanoseconds of an
  epoch-based timestamp.

A step annotation ``<name>#<n>`` (``hvd.trace_step``'s ``hvd_step#12``,
torch's ``ProfilerStep#3``) becomes an event named ``<name>`` with a
``step_num`` stat, the way a ``StepTraceAnnotation`` lands in an xplane.

Stats: every event has ``cat``; runtime and device events carry
``correlation`` (CUPTI's id tying a kernel to its launch), device events
``stream``.  A host event has ``path``, the names of the host events
that enclose it on its thread, outermost first, and its own, joined by
``/`` (the counterpart of a scoped HLO ``op_name``; step annotations are
left out, and ``record_param_comms`` names its collective as
``record_param_comms[allreduce]``), and ``self_ps``, the ``(start,
end)`` pieces of its span that no event nested inside it covers (where
the thread ran the event's own work).

:func:`scope_map` is the counterpart of ``xplane.scope_map``: it maps
each device event (by correlation) to the ``path`` of the runtime call
that launched it, or, where the capture lacks that call, to the
``gpu_user_annotation`` spans that enclose it on its stream.

Contract (the xplane reader's): reading NEVER raises.  A truncated or
garbled file keeps every event read before the damage and sets
``XSpace.truncated``, with ``XSpace.errors`` naming what failed; the
caller is a background analyzer inside a live training job.
"""

from __future__ import annotations

import json
import re
import zlib
from dataclasses import dataclass, field

#: categories of events that ran on a device
DEVICE_CATS = frozenset(
    {"kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation"})
#: device lines the attribution must not count as work
STEPS_LINE, SCOPES_LINE = "Steps", "Framework Name Scope"

_STEP_RE = re.compile(r"^(.+)#(\d+)$")
_CHUNK = 1 << 16


@dataclass
class XEvent:
    name: str = ""
    start_ps: int = 0
    duration_ps: int = 0
    stats: dict = field(default_factory=dict)


@dataclass
class XLine:
    id: int = 0
    name: str = ""
    events: list = field(default_factory=list)


@dataclass
class XPlane:
    id: int = 0
    name: str = ""
    lines: list = field(default_factory=list)

    def line(self, name: str) -> XLine:
        for ln in self.lines:
            if ln.name == name:
                return ln
        ln = XLine(id=len(self.lines), name=name)
        self.lines.append(ln)
        return ln


@dataclass
class XSpace:
    planes: list = field(default_factory=list)
    truncated: bool = False
    errors: list = field(default_factory=list)

    def plane(self, name: str):
        for p in self.planes:
            if p.name == name:
                return p
        return None


def _ps(v) -> int:
    """Microseconds as the trace wrote them (an int, or the decimal text
    of a float) to integer picoseconds."""
    if isinstance(v, bool):
        raise TypeError("a bool is no time")
    if isinstance(v, int):
        return v * 1_000_000
    if isinstance(v, str):
        whole, dot, frac = v.partition(".")
        digits = whole[1:] if whole[:1] == "-" else whole
        if dot and digits.isdigit() and frac.isdigit():
            ps = int(digits) * 1_000_000 + int((frac + "000000")[:6])
            return -ps if whole[:1] == "-" else ps
        if not dot and digits.isdigit():
            return int(whole) * 1_000_000
    return round(float(v) * 1e6)


def _decode(data: bytes, space: XSpace) -> str:
    """The trace's text; a gzip stream is inflated as far as it goes."""
    if data[:2] != b"\x1f\x8b":
        return data.decode("utf-8", errors="replace")
    inflate = zlib.decompressobj(wbits=31)
    out = []
    try:
        for i in range(0, len(data), _CHUNK):
            out.append(inflate.decompress(data[i:i + _CHUNK]))
        out.append(inflate.flush())
    except zlib.error as exc:
        space.truncated = True
        space.errors.append(repr(exc)[:200])
    if not inflate.eof:
        space.truncated = True
    return b"".join(out).decode("utf-8", errors="replace")


def _raw_events(text: str, space: XSpace) -> list:
    """The ``traceEvents`` list; after a parse failure, every whole event
    object before the damage."""
    dec = json.JSONDecoder(parse_float=str)
    try:
        doc = dec.decode(text)
    except ValueError as exc:
        space.truncated = True
        space.errors.append(repr(exc)[:200])
    else:
        evs = doc.get("traceEvents") if isinstance(doc, dict) else doc
        return evs if isinstance(evs, list) else []
    key = text.find('"traceEvents"')
    i = text.find("[", key if key >= 0 else 0)
    out: list = []
    if i < 0:
        return out
    i += 1
    n = len(text)
    while True:
        while i < n and text[i] in " \t\r\n,":
            i += 1
        if i >= n or text[i] == "]":
            return out
        try:
            ev, i = dec.raw_decode(text, i)
        except ValueError:
            return out
        out.append(ev)


def _event(ev: dict):
    """``(XEvent, args)`` of one complete (``ph: X``) trace event, or
    None for anything else."""
    if not isinstance(ev, dict) or ev.get("ph") != "X":
        return None
    try:
        start, dur = _ps(ev.get("ts", 0)), _ps(ev.get("dur", 0))
    except (TypeError, ValueError):
        return None
    args = ev.get("args")
    args = args if isinstance(args, dict) else {}
    name = str(ev.get("name", ""))
    stats = {"cat": str(ev.get("cat", ""))}
    m = _STEP_RE.match(name)
    if m:
        name, stats["step_num"] = m.group(1), int(m.group(2))
    corr = args.get("correlation")
    if isinstance(corr, int) and not isinstance(corr, bool):
        stats["correlation"] = corr
    if args.get("Collective name"):  # record_param_comms' collective
        stats["collective"] = str(args["Collective name"])
    return XEvent(name, start, dur, stats), args


def _nest(line: XLine) -> None:
    """Fill ``path`` and ``self_ps`` of one host thread's events."""
    stack: list = []  # (end_ps, prefix for children, event, children)
    kids: list = []
    for ev in sorted(line.events,
                     key=lambda e: (e.start_ps, -e.duration_ps)):
        end = ev.start_ps + ev.duration_ps
        while stack and stack[-1][0] < end:
            stack.pop()
        prefix = stack[-1][1] if stack else ""
        if stack:
            stack[-1][3].append((ev.start_ps, end))
        own = ev.name
        if "collective" in ev.stats:
            own = f"{own}[{ev.stats['collective']}]"
        ev.stats["path"] = f"{prefix}/{own}" if prefix else own
        children: list = []
        kids.append((ev, children))
        stack.append((end, prefix if "step_num" in ev.stats
                      else ev.stats["path"], ev, children))
    for ev, children in kids:
        pieces, at = [], ev.start_ps
        for s, e in children:  # in start order, nested within ev
            if s > at:
                pieces.append((at, s))
            at = max(at, e)
        end = ev.start_ps + ev.duration_ps
        if end > at:
            pieces.append((at, end))
        ev.stats["self_ps"] = pieces


def _build(space: XSpace, events: list) -> None:
    host = XPlane(id=0, name="/host:CPU")
    threads: dict = {}
    names: dict = {}
    devices: dict = {}
    for raw in events:
        if (isinstance(raw, dict) and raw.get("ph") == "M"
                and raw.get("name") == "thread_name"):
            label = (raw.get("args") or {}).get("name")
            names[(str(raw.get("pid")), str(raw.get("tid")))] = str(label)
            continue
        got = _event(raw)
        if got is None:
            continue
        ev, args = got
        cat = ev.stats["cat"]
        if cat in DEVICE_CATS:
            try:
                dev = int(args.get("device", raw.get("pid")))
            except (TypeError, ValueError):
                continue
            plane = devices.get(dev)
            if plane is None:
                plane = devices[dev] = XPlane(id=dev,
                                              name=f"/device:GPU:{dev}")
            ev.stats["stream"] = args.get("stream", raw.get("tid"))
            if cat == "gpu_user_annotation":
                line = STEPS_LINE if "step_num" in ev.stats else SCOPES_LINE
            else:
                line = f"Stream #{ev.stats['stream']}"
            plane.line(line).events.append(ev)
        elif cat != "Trace":  # the profiler's own span
            key = (str(raw.get("pid")), str(raw.get("tid")))
            if key not in threads:
                threads[key] = XLine(id=len(threads))
                host.lines.append(threads[key])
            threads[key].events.append(ev)
    for key, line in threads.items():
        line.name = names.get(key, f"thread {key[1]}")
        _nest(line)
        line.events.sort(key=lambda e: e.start_ps)
    if host.lines:
        space.planes.append(host)
    for dev in sorted(devices):
        for line in devices[dev].lines:
            line.events.sort(key=lambda e: e.start_ps)
        space.planes.append(devices[dev])


def parse_trace(data) -> XSpace:
    """Parse a Chrome trace (bytes or text, gzipped or not).  Never
    raises: a truncated or corrupt input yields the events read before
    the damage with ``truncated=True``."""
    space = XSpace()
    try:
        text = data if isinstance(data, str) else _decode(bytes(data), space)
        _build(space, _raw_events(text, space))
    except Exception as exc:  # the never-raise contract
        space.truncated = True
        space.errors.append(repr(exc)[:200])
    return space


def read_trace(path: str) -> XSpace:
    """Read and parse a trace file; an IO failure degrades the way a
    parse failure does (an empty XSpace with the error recorded)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as exc:
        space = XSpace()
        space.truncated = True
        space.errors.append(repr(exc)[:200])
        return space
    return parse_trace(data)


def is_trace_file(name: str) -> bool:
    """A file name ``torch.profiler`` gives a Chrome trace."""
    return name.endswith((".pt.trace.json", ".pt.trace.json.gz"))


# ---------------------------------------------------------------------------
# Device event -> framework scope
# ---------------------------------------------------------------------------


def launches(space: XSpace) -> dict:
    """``{correlation: host runtime event}``: the call that launched each
    device event."""
    out: dict = {}
    for plane in space.planes:
        if plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                corr = ev.stats.get("correlation")
                if corr is not None:
                    out[corr] = ev
    return out


def device_work(plane: XPlane):
    """The events of a device plane's stream lines (its kernels, copies
    and sets; the bookkeeping lines left out)."""
    for line in plane.lines:
        if line.name not in (STEPS_LINE, SCOPES_LINE):
            yield from line.events


def _annotation_path(ev: XEvent, spans: list) -> str:
    """The ``gpu_user_annotation`` spans that enclose ``ev`` on its
    stream, outermost first, joined by ``/``."""
    s, e = ev.start_ps, ev.start_ps + ev.duration_ps
    stream = ev.stats.get("stream")
    inside = [a for a in spans
              if a.start_ps <= s and e <= a.start_ps + a.duration_ps
              and a.stats.get("stream") in (stream, None)]
    inside.sort(key=lambda a: (a.start_ps, -a.duration_ps))
    return "/".join(a.name for a in inside)


def scope_map(space: XSpace, marker: str = "hvd_") -> dict:
    """``{correlation of a device event: scoped op name}`` for every
    device event whose scope path mentions ``marker`` (``""``: every
    device event with a path).  The path is the launching call's
    ``path``; without that call in the capture, the enclosing
    ``gpu_user_annotation`` spans'."""
    launch = launches(space)
    out: dict = {}
    for plane in space.planes:
        if not plane.name.startswith("/device:"):
            continue
        spans = [e for ln in plane.lines if ln.name == SCOPES_LINE
                 for e in ln.events]
        for ev in device_work(plane):
            corr = ev.stats.get("correlation")
            if corr is None:
                continue
            host = launch.get(corr)
            path = (host.stats.get("path", host.name) if host is not None
                    else _annotation_path(ev, spans))
            if path and marker in path:
                out[corr] = path
    return out
