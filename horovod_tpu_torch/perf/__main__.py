"""CLI: ``python -m horovod_tpu_torch.perf goodput|health <path>``.

``goodput <path>`` -- wall-clock attribution table per rank and
fleet-wide from goodput ledger dumps, a single dump, or a live
``/metrics.json`` endpoint (docs/goodput.md), as the JAX package's
``python -m horovod_tpu.perf goodput``.

``health <path>`` -- the per-rank training-health table and the culprit
attribution from ``health-*.json`` dumps, a single dump, or a live
endpoint (docs/health.md), as ``python -m horovod_tpu.perf health``.

The JAX package's other subcommands read device captures; their
``torch.profiler`` counterparts are ROADMAP.md Queue A item 12i, and
each exits 2 naming it.
"""

from __future__ import annotations

import argparse
import json
import sys

NOT_PORTED = ("report", "baseline", "compare", "xplane", "attribution",
              "capture")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.perf",
        description="Wall-clock goodput and training-health reports "
                    "(docs/goodput.md, docs/health.md).")
    sub = p.add_subparsers(dest="cmd", required=True)
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


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in NOT_PORTED:
        print(f"python -m horovod_tpu_torch.perf {argv[0]}: not ported "
              "yet; it belongs to the torch.profiler observatory "
              "(ROADMAP.md Queue A item 12i)", file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)
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


if __name__ == "__main__":
    sys.exit(main())
