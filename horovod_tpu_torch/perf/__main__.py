"""CLI: ``python -m horovod_tpu_torch.perf
{report,baseline,compare,goodput,health}`` (the JAX package's
``python -m horovod_tpu.perf``).

``report <dir>``    -- device-truth attribution for every
                       ``torch.profiler`` capture under a profile
                       directory (``--json`` for machines).
``baseline ...``    -- aggregate result JSONs into a noise-aware
                       baseline (per-metric mean/σ/direction).
``compare r b``     -- gate a result against a baseline (exit 3 on a
                       regression or a broken gate input).
``goodput <path>``  -- wall-clock attribution table per rank and
                       fleet-wide from goodput ledger dumps, a single
                       dump, or a live ``/metrics.json`` endpoint
                       (docs/goodput.md).
``health <path>``   -- the per-rank training-health table and the
                       culprit attribution from ``health-*.json`` dumps,
                       a single dump, or a live endpoint
                       (docs/health.md).
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.perf",
        description="Device-truth perf observatory: torch.profiler "
                    "reports, the regression gate, goodput and "
                    "training-health reports (docs/perf.md).")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("report", help="analyze captures under a "
                                      "profile dir")
    r.add_argument("dir", help="HOROVOD_PROFILE_DIR / "
                               "HOROVOD_TIMELINE_JAX_PROFILER directory")
    r.add_argument("--json", action="store_true",
                   help="machine-readable output")
    r.add_argument("--flops", type=float, default=None,
                   help="flops per step (enables MFU when the capture "
                        "has no recorded hint)")

    b = sub.add_parser("baseline", help="build a regression-gate "
                                        "baseline from result JSONs")
    b.add_argument("results", nargs="+",
                   help="result JSON files (one line each)")
    b.add_argument("-o", "--output", required=True)
    b.add_argument("--note", default="")

    c = sub.add_parser("compare", help="gate a result against a "
                                       "baseline (exit 3 on regression)")
    c.add_argument("result", help="result JSON")
    c.add_argument("baseline", help="baseline JSON (from `baseline`)")
    c.add_argument("--nsigma", type=float, default=3.0)
    c.add_argument("--json", action="store_true")
    c.add_argument("--inject", default="",
                   help="metric=factor[,metric=factor...] multipliers "
                        "applied before gating -- the hook proving the "
                        "gate trips")

    g = sub.add_parser(
        "goodput",
        help="wall-clock attribution per rank + fleet "
             "(docs/goodput.md)")
    g.add_argument("path",
                   help="a directory of goodput-*.json ledger dumps "
                        "(HOROVOD_GOODPUT_DIR / the flight dir), a "
                        "single dump, or a live rank endpoint URL "
                        "(http://host:port -- /metrics.json is fetched)")
    g.add_argument("--json", action="store_true",
                   help="machine-readable output")
    g.add_argument("--slo", type=float, default=None,
                   help="goodput SLO in (0,1] for the report's verdict "
                        "line (default: HOROVOD_GOODPUT_SLO)")
    h = sub.add_parser(
        "health",
        help="per-rank training-health table (docs/health.md)")
    h.add_argument("path",
                   help="a directory of health-*.json dumps "
                        "(HOROVOD_HEALTH_DIR / the flight dir), a "
                        "single dump, or a live rank endpoint URL "
                        "(http://host:port -- /metrics.json is fetched)")
    h.add_argument("--json", action="store_true",
                   help="machine-readable output")
    return p


def _ledger_report(args) -> int:
    """``goodput`` / ``health``: one table from dumps or an endpoint."""
    if args.cmd == "health":
        from horovod_tpu_torch.runtime import health as _report
    else:
        from horovod_tpu_torch.perf import goodput as _report
    try:
        rep = (_report.load_report(args.path) if args.cmd == "health"
               else _report.load_report(args.path, slo=args.slo))
    except Exception as exc:
        print(f"{args.cmd} report failed for {args.path}: {exc!r}",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(rep))
    else:
        print(_report.format_report(rep))
    return 0 if rep["ranks"] else 1


def main(argv=None) -> int:
    from horovod_tpu_torch.perf import compare as _cmp
    from horovod_tpu_torch.perf import report as _report

    args = build_parser().parse_args(argv)
    if args.cmd in ("goodput", "health"):
        return _ledger_report(args)
    if args.cmd == "report":
        rep = _report.analyze_dir(args.dir, flops_per_step=args.flops)
        if args.json:
            print(json.dumps(rep))
        else:
            print(_report.format_report(rep))
        return 0 if rep["captures"] else 1
    if args.cmd == "baseline":
        results = [_cmp.load_json(p) for p in args.results]
        baseline = _cmp.build_baseline(results, note=args.note)
        with open(args.output, "w") as f:
            json.dump(baseline, f, indent=1, sort_keys=True)
        print(f"wrote {args.output}: {len(baseline['metrics'])} gated "
              f"metric(s) from {len(results)} run(s)")
        return 0
    # compare -- a broken gate input (missing/corrupt JSON) exits 3 like
    # a regression: a misconfigured gate must fail the build, not
    # traceback with an unrelated status.
    try:
        result = _cmp.load_json(args.result)
        baseline = _cmp.load_json(args.baseline)
        cmp = _cmp.compare_result(result, baseline, nsigma=args.nsigma,
                                  inject=_cmp.parse_inject(args.inject))
    except Exception as exc:
        print(f"perf gate broken ({args.result} vs {args.baseline}): "
              f"{exc!r}", file=sys.stderr)
        return 3
    if args.json:
        print(json.dumps(cmp))
    else:
        print(_cmp.format_compare(cmp, args.baseline))
    return 0 if cmp["ok"] else 3


if __name__ == "__main__":
    sys.exit(main())
