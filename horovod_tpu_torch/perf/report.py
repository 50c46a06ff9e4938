"""``python -m horovod_tpu_torch.perf report <dir>``: human/JSON
reports (counterpart of ``horovod_tpu/perf/report.py``).

Walks a directory tree for ``torch.profiler`` captures -- the
sampled-capture layout (``<dir>/rank<k>/step<n>/``), a
``TorchProfilerBridge`` logdir (``<dir>/rank<k>/``,
``<dir>/gen<g>/rank<k>/``), or a bare directory of ``*.pt.trace.json``
files -- and prints per-step device-truth attribution for each.
Pre-computed ``analysis.json`` files (written by the background
analyzer) are reused, so reporting a live job's rotating dir is
instant; raw Chrome traces are parsed with the stdlib reader.
"""

from __future__ import annotations

import json
import os
import re

_RANK_RE = re.compile(r"(?:^|/)(?:gen\d+[-/])?rank(\d+)(?:/|$)")


def _rank_of(path: str) -> int | None:
    m = _RANK_RE.search(path.replace(os.sep, "/"))
    return int(m.group(1)) if m else None


def _find_captures(root: str) -> list:
    """``(capture_dir, analysis.json | None, trace | None)`` per
    capture: every directory's ``analysis.json``, else each Chrome trace
    of a directory that holds none."""
    from horovod_tpu_torch.perf import kineto as _kt

    analyses, traces = [], []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            p = os.path.join(dirpath, fn)
            if fn == "analysis.json":
                analyses.append(p)
            elif _kt.is_trace_file(fn):
                traces.append(p)
    covered = {os.path.dirname(a) for a in analyses}
    out = [(os.path.dirname(a), a, None) for a in sorted(analyses)]
    out += [(os.path.dirname(t), None, t) for t in sorted(traces)
            if os.path.dirname(t) not in covered]
    return out


def analyze_dir(root: str, flops_per_step: float | None = None) -> dict:
    """Analyze every capture under ``root``.  Returns
    ``{"dir": root, "captures": [per-capture attribution dicts]}`` —
    partial on unreadable files, never raises."""
    from horovod_tpu_torch.perf import attribution as _attr
    from horovod_tpu_torch.perf import kineto as _kt

    captures = []
    for cap_dir, analysis, trace in _find_captures(root):
        entry = None
        if analysis is not None:
            try:
                with open(analysis) as f:
                    entry = json.load(f)
                entry.setdefault("capture_dir", cap_dir)
            except (OSError, ValueError):
                entry = None
        if entry is None and trace is not None:
            entry = _attr.attribute(_kt.read_trace(trace),
                                    flops_per_step=flops_per_step)
            entry["capture_dir"] = cap_dir
            entry["trace_path"] = trace
        if entry is None:
            continue
        if entry.get("rank") is None:
            rk = _rank_of(cap_dir)
            if rk is not None:
                entry["rank"] = rk
        captures.append(entry)
    return {"dir": root, "captures": captures}


def _fmt_s(v) -> str:
    return "-" if v is None else f"{v:.4f}"


def format_report(report: dict, top_scopes: int = 6) -> str:
    """Human-readable report (the ``--json`` flag bypasses this)."""
    lines = [f"perf report: {report.get('dir', '')} "
             f"({len(report.get('captures') or [])} capture(s))"]
    for cap in report.get("captures") or []:
        head = []
        if cap.get("rank") is not None:
            head.append(f"rank {cap['rank']}")
        if cap.get("captured_step") is not None:
            head.append(f"step {cap['captured_step']}")
        head.append(cap.get("capture_dir", ""))
        if cap.get("truncated"):
            head.append("[TRUNCATED — partial results]")
        if cap.get("error"):
            head.append(f"[error: {cap['error']}]")
        lines.append("\n== " + "  ".join(str(h) for h in head))
        tot = cap.get("totals") or {}
        if tot:
            eff = tot.get("overlap_eff")
            lines.append(
                f"   per step: wall {_fmt_s(tot.get('wall_s_per_step'))} s"
                f"  compute {_fmt_s(tot.get('compute_s_per_step'))} s"
                f"  comm {_fmt_s(tot.get('comm_s_per_step'))} s"
                f" (hidden {_fmt_s(tot.get('comm_hidden_s_per_step'))},"
                f" exposed {_fmt_s(tot.get('comm_exposed_s_per_step'))}"
                + (f", overlap eff {eff:.0%}" if eff is not None else "")
                + ")")
            if tot.get("mfu") is not None:
                peak = cap.get("peak_flops_per_chip")
                lines.append(
                    f"   mfu {tot['mfu']:.4f}"
                    + (f" (peak {peak / 1e12:.0f} TFLOP/s)" if peak
                       else ""))
            if tot.get("wire_gb_s") is not None:
                lines.append(
                    f"   wire {tot['wire_bytes'] / 1e6:.2f} MB over comm"
                    f" -> {tot['wire_gb_s']:.2f} GB/s effective")
        for s in cap.get("steps") or []:
            kinds = "  ".join(f"{k} {v:.4f}s"
                              for k, v in (s.get("comm_by_kind") or {})
                              .items())
            lines.append(
                f"   step {s['step']}: wall {s['wall_s']:.4f}s"
                f" compute {s['compute_s']:.4f}s"
                f" comm {s['comm_s']:.4f}s"
                f" exposed {s['comm_exposed_s']:.4f}s"
                + (f"  [{kinds}]" if kinds else ""))
            scopes = sorted((s.get("scopes") or {}).items(),
                            key=lambda kv: -kv[1])[:top_scopes]
            if scopes:
                lines.append("     scopes: " + "  ".join(
                    f"{k} {v:.4f}s" for k, v in scopes))
        lines.append(f"   ({cap.get('op_events', 0)} op events, "
                     f"{cap.get('scopes_resolved', 0)} scoped ops, "
                     f"planes: {', '.join(cap.get('planes') or [])})")
    if not report.get("captures"):
        lines.append("no captures found (expected *.pt.trace.json or "
                     "analysis.json below this directory)")
    return "\n".join(lines)
