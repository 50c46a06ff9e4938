"""Noise-aware perf-regression gate over result JSONs (counterpart of
``horovod_tpu/perf/compare.py``: the same baseline schema, directions,
floors and ``--inject`` hook, pure logic over JSON).

``python -m horovod_tpu_torch.perf compare result.json baseline.json``
gates a result against a baseline built from one or more earlier runs::

    python -m horovod_tpu_torch.perf baseline r1.json r2.json -o base.json

The baseline stores, per metric, the run-to-run mean and σ plus a
direction; the gate fails a metric only when it moves beyond
``max(nsigma * sigma, floor * |mean|)`` in the bad direction — σ makes
the gate noise-aware when several baseline runs exist, the relative
floor keeps a single-run baseline from tripping on scheduler jitter.
A result is one JSON object: the headline ``value`` and an ``extra``
dict of metrics (the shape of the JAX package's bench line).

Directions (inferred from the metric name by ``build_baseline``):

* ``higher`` — throughput (img/s, tokens/s, headline ``value``);
* ``lower``  — latencies (``*_s_per_step``, ``step_time_mean_s``,
  ``eager_ms_*``);
* ``lower_ratio`` / ``higher_ratio`` — ratios bounded by 1 with tight
  floors the generous throughput/latency floors would never trip on
  (``wire_compression_ratio`` down-is-good, ``goodput_ratio``
  up-is-good);
* ``exact``  — structural numbers that must not move at all
  (``*_bytes_per_chip``, ``zero_stage``, ``overlap_chunks``);
* ``near``   — bounded drift (``*_final_loss``).

Metrics the baseline names but the run no longer reports FAIL — a
regression must not be able to hide by deleting its metric.
"""

from __future__ import annotations

import json
import math

SCHEMA = 1

# (predicate on key) -> (direction, default floor/tol)
_HIGHER = ("img_s", "tokens_per_sec", "per_sec", "gb_s")
_LOWER = ("_s_per_step", "step_time_mean_s", "_ms_", "_seconds",
          "_reform_s")
# Ratios bounded by 1 ("lower" semantics, but the generous 3x lower
# floor could never trip on them): the achieved wire/logical byte cut
# — a compression regression (packed int4 silently widening to dense,
# topk payloads counted dense) moves it toward 1.0, which a tight
# relative floor catches while byte-count determinism keeps noise nil.
_LOWER_RATIO = ("wire_compression_ratio",)
# ...and the mirror image: ratios bounded by 1 where DOWN is the
# regression — goodput (useful-compute share of wall-clock,
# docs/goodput.md).  The generous 0.75 "higher" floor tuned for
# throughput jitter would let goodput halve without tripping; these get
# the tight ratio floor instead.
_HIGHER_RATIO = ("goodput_ratio",)
_EXACT = ("_bytes_per_chip", "zero_stage", "overlap_chunks",
          "quant_block_size", "_spd")
_NEAR = ("_final_loss",)

# Relative floors: generous by default so a one-run baseline (sigma 0)
# or a checked-in CPU baseline replayed on a different machine only
# trips on a real regression, not on jitter.  Rebuild the baseline from
# several runs on the target machine for a tighter gate (docs/perf.md).
_DEF_REL_FLOOR = {"higher": 0.75, "lower": 3.0, "lower_ratio": 0.25,
                  "higher_ratio": 0.25}
# "lower" also gets a small absolute floor: near-zero latencies (e.g.
# device comm-exposed seconds on a well-overlapped schedule) would
# otherwise gate at 4x-of-nearly-nothing and trip on pure noise.
_DEF_ABS_TOL = {"near": 1.5, "lower": 0.005, "lower_ratio": 0.02,
                "higher_ratio": 0.02}


# Never gated: whole-run wall clock (probe retries, machine load) and
# the capture observatory's own overhead counters.
_UNGATED = ("bench_seconds", "profile_captures",
            "profile_capture_failures", "device_profile_step")


def _direction(key: str) -> str | None:
    for pat in _UNGATED:
        if pat in key:
            return None
    if key == "value":
        return "higher"
    for pat in _EXACT:
        if pat in key:
            return "exact"
    for pat in _NEAR:
        if pat in key:
            return "near"
    for pat in _HIGHER:
        if pat in key:
            return "higher"
    for pat in _LOWER_RATIO:
        if pat in key:
            return "lower_ratio"
    for pat in _HIGHER_RATIO:
        if pat in key:
            return "higher_ratio"
    for pat in _LOWER:
        if pat in key:
            return "lower"
    return None


def lookup(result: dict, key: str):
    """Metric value from a result line: ``value`` is the
    headline; anything else indexes ``extra`` (dots descend into
    nested dicts like ``metrics_summary.step_time_mean_s``)."""
    if key == "value":
        return result.get("value")
    node = result.get("extra", {})
    for part in key.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _numeric_metrics(result: dict, prefix: str = "") -> dict:
    out: dict = {}
    v = result.get("value")
    if isinstance(v, (int, float)) and not prefix:
        out["value"] = float(v)

    def walk(node, pre):
        for k, val in node.items():
            key = f"{pre}{k}"
            if isinstance(val, bool):
                continue
            if isinstance(val, (int, float)) and math.isfinite(val):
                out[key] = float(val)
            elif isinstance(val, dict):
                walk(val, key + ".")

    walk(result.get("extra", {}), prefix)
    return out


def build_baseline(results: list[dict], note: str = "") -> dict:
    """Aggregate result lines into a baseline: per metric mean,
    σ, n, and an inferred direction.  Only metrics present in EVERY
    run and with a recognized direction are gated."""
    if not results:
        raise ValueError("no results to build a baseline from")
    tables = [_numeric_metrics(r) for r in results]
    keys = set(tables[0])
    for t in tables[1:]:
        keys &= set(t)
    metrics: dict = {}
    for key in sorted(keys):
        direction = _direction(key)
        if direction is None:
            continue
        vals = [t[key] for t in tables]
        mean = sum(vals) / len(vals)
        var = sum((v - mean) ** 2 for v in vals) / len(vals)
        entry = {"mean": round(mean, 6), "sigma": round(math.sqrt(var), 6),
                 "n": len(vals), "direction": direction}
        if direction in _DEF_REL_FLOOR:
            entry["rel_floor"] = _DEF_REL_FLOOR[direction]
        if direction in _DEF_ABS_TOL:
            entry["abs_tol"] = _DEF_ABS_TOL[direction]
        metrics[key] = entry
    meta = {"n_runs": len(results), "schema": SCHEMA}
    plat = lookup(results[0], "platform")
    if plat:
        meta["platform"] = plat
    if note:
        meta["note"] = note
    return {"schema": SCHEMA, "meta": meta, "metrics": metrics}


def _allowed_delta(entry: dict, nsigma: float) -> float:
    sigma = float(entry.get("sigma", 0.0))
    mean = float(entry.get("mean", 0.0))
    floor = float(entry.get("rel_floor", 0.0)) * abs(mean)
    tol = float(entry.get("abs_tol", 0.0))
    return max(nsigma * sigma, floor, tol)


def compare_result(result: dict, baseline: dict, nsigma: float = 3.0,
                   inject: dict | None = None) -> dict:
    """Gate ``result`` against ``baseline``.  Returns::

        {"checks": [{"metric", "current", "mean", "allowed",
                     "direction", "ok", "why"}],
         "failures": [metric names], "ok": bool, "injected": {...}}

    ``inject`` maps metric name -> multiplier applied to the measured
    value before gating — the hook proving the gate trips
    (``--inject value=0.1``).
    """
    checks = []
    failures = []
    inject = inject or {}
    for key, entry in (baseline.get("metrics") or {}).items():
        cur = lookup(result, key)
        mean = float(entry.get("mean", 0.0))
        direction = entry.get("direction", "near")
        check = {"metric": key, "mean": mean, "direction": direction}
        if not isinstance(cur, (int, float)) or isinstance(cur, bool):
            check.update(ok=False, current=None,
                         why="metric missing from this run")
            checks.append(check)
            failures.append(key)
            continue
        cur = float(cur)
        if key in inject:
            cur *= float(inject[key])
            check["injected_factor"] = float(inject[key])
        allowed = _allowed_delta(entry, nsigma)
        check.update(current=round(cur, 6), allowed=round(allowed, 6))
        if direction in ("higher", "higher_ratio"):
            ok = cur >= mean - allowed
            why = f"{cur:.6g} < {mean:.6g} - {allowed:.6g}"
        elif direction in ("lower", "lower_ratio"):
            ok = cur <= mean + allowed
            why = f"{cur:.6g} > {mean:.6g} + {allowed:.6g}"
        elif direction == "exact":
            ok = cur == mean
            why = f"{cur:.6g} != {mean:.6g}"
        else:  # near
            ok = abs(cur - mean) <= allowed
            why = f"|{cur:.6g} - {mean:.6g}| > {allowed:.6g}"
        check["ok"] = ok
        if not ok:
            check["why"] = why
            failures.append(key)
        checks.append(check)
    out = {"checks": checks, "failures": failures, "ok": not failures,
           "nsigma": nsigma}
    if inject:
        out["injected"] = {k: float(v) for k, v in inject.items()}
    return out


def format_compare(cmp: dict, baseline_path: str = "") -> str:
    lines = [("PASS" if cmp["ok"] else "FAIL")
             + f": perf gate vs {baseline_path or 'baseline'}"
             f" ({len(cmp['checks'])} metric(s), "
             f"{len(cmp['failures'])} regression(s), "
             f"nsigma={cmp.get('nsigma')})"]
    for c in cmp["checks"]:
        mark = "ok  " if c["ok"] else "FAIL"
        cur = c.get("current")
        cur_s = "missing" if cur is None else f"{cur:.6g}"
        line = (f"  [{mark}] {c['metric']}: {cur_s}"
                f" (baseline {c['mean']:.6g} ±{c.get('allowed', 0):.6g},"
                f" {c['direction']})")
        if c.get("injected_factor") is not None:
            line += f"  [injected x{c['injected_factor']:g}]"
        if not c["ok"]:
            line += f"  <- {c.get('why', '')}"
        lines.append(line)
    return "\n".join(lines)


def parse_inject(spec: str) -> dict:
    """``"value=0.1,resnet50_final_loss=3"`` -> {metric: factor}.
    Malformed entries are ignored (a typo'd CI hook must not turn into
    a vacuous pass — the gate still runs uninjected)."""
    out: dict = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        k, _, v = part.partition("=")
        try:
            out[k.strip()] = float(v)
        except ValueError:
            continue
    return out


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
