"""CLI: ``python -m horovod_tpu_torch.trace {merge,analyze} ...``.

``merge`` aligns rank clocks, writes one Perfetto/Chrome trace JSON
(open in https://ui.perfetto.dev or chrome://tracing) and prints the
straggler / critical-path / death report; ``analyze`` prints the
report alone (see docs/flight-recorder.md).  ``aot-cache`` delegates
to :func:`horovod_tpu_torch.runtime.aot_cache.main` (``list``,
``info``, ``prune``, ``clear``).
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.trace",
        description="Merge/analyze flight-recorder dumps "
                    "(HOROVOD_FLIGHT_DIR).")
    sub = p.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("merge", help="align clocks, write one "
                                     "Perfetto/Chrome trace, print the "
                                     "analyzer report")
    m.add_argument("dir", help="directory holding flight-*.jsonl dumps")
    m.add_argument("-o", "--output", default=None,
                   help="trace JSON path (default <dir>/trace.json)")
    m.add_argument("--top", type=int, default=5,
                   help="entries per report section (default 5)")
    m.add_argument("--json", action="store_true",
                   help="print the report as JSON instead of text")
    a = sub.add_parser("analyze", help="print the straggler / "
                                       "critical-path / death report")
    a.add_argument("dir")
    a.add_argument("--top", type=int, default=5)
    a.add_argument("--tail", type=int, default=12,
                   help="per-rank events in the interleaved death tail")
    a.add_argument("--json", action="store_true")
    return p


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in ("aot-cache", "aot_cache"):
        # Sibling CLI: inspect/prune the persistent AOT cache with the
        # same entry-point ergonomics.
        from horovod_tpu_torch.runtime.aot_cache import main as _aot_main

        return _aot_main(argv[1:])
    from horovod_tpu_torch.trace.analyze import analyze, format_report
    from horovod_tpu_torch.trace.merge import (compute_offsets, load_dumps,
                                         merge)

    args = build_parser().parse_args(argv)
    try:
        if args.cmd == "merge":
            out_path, dumps, offsets = merge(args.dir, args.output)
            print(f"wrote {out_path} ({len(dumps)} rank dump(s)); "
                  "open in https://ui.perfetto.dev or chrome://tracing")
            report = analyze(dumps, offsets)
        else:
            dumps = load_dumps(args.dir)
            if not dumps:
                print(f"no flight-*.jsonl dumps under {args.dir!r}",
                      file=sys.stderr)
                return 1
            offsets = compute_offsets(dumps)
            report = analyze(dumps, offsets,
                             tail=getattr(args, "tail", 12))
    except (OSError, FileNotFoundError) as exc:
        print(str(exc), file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(format_report(report, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
