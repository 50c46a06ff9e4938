"""CLI: ``python -m horovod_tpu_torch.analysis [schedule|hlo|knobs|
concurrency|all]`` (counterpart of ``python -m horovod_tpu.analysis``).

Exit codes: 0 = clean (every finding allowlisted with a
justification), 1 = at least one active finding (or a stale allowlist
entry on an ``all`` run), 2 = usage/internal error.  ``--json`` emits
the reference's machine-readable schema, plus ``"skipped"``: the rules
that had nothing to read on this checkout, each with its reason.

Recipes (docs/analysis.md):

    python -m horovod_tpu_torch.analysis all          # full suite, on the card
    python -m horovod_tpu_torch.analysis knobs concurrency   # no device
    python -m horovod_tpu_torch.analysis schedule --device cpu
    python -m horovod_tpu_torch.analysis schedule --schedule-file f.json
    python -m horovod_tpu_torch.analysis knobs --package-dir d  # fixture tree
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from horovod_tpu_torch.analysis import ALIASES, PASSES, run_pass
from horovod_tpu_torch.analysis import allowlist as AL
from horovod_tpu_torch.analysis.findings import Finding, sort_findings

JSON_SCHEMA = 1


def main(argv: list | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis",
        description="invariant lint suite of the port (docs/analysis.md)")
    p.add_argument("passes", nargs="*", default=["all"],
                   metavar="pass",
                   help="schedule (alias hlo) | knobs | concurrency | all "
                        "(default: all)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output (stable schema)")
    p.add_argument("--allowlist", default=None,
                   help="allowlist path (default: the package's "
                        f"analysis/{AL.DEFAULT_NAME})")
    p.add_argument("--no-allowlist", action="store_true",
                   help="report every finding as active")
    p.add_argument("--package-dir", default=None,
                   help="lint this tree instead of the installed "
                        "package (knobs: raw-env rule only; "
                        "concurrency: every lock treated as hot) — "
                        "fixture/negative-test hook")
    p.add_argument("--schedule-file", default=None,
                   help="lint one recorded program (JSON) via its "
                        "'directives' instead of the program set")
    p.add_argument("--device", default=None,
                   help="where the schedule pass runs its program set "
                        "(default: the card)")
    args = p.parse_args(argv)

    passes = [ALIASES.get(x, x) for x in (args.passes or ["all"])]
    if "all" in passes:
        passes = list(PASSES)
    unknown = [x for x in passes if x not in PASSES]
    if unknown:
        print(f"unknown pass(es): {unknown}; know "
              f"{list(PASSES) + list(ALIASES)} + all", file=sys.stderr)
        return 2
    # fixture inputs pin the pass they exercise
    if args.schedule_file is not None:
        passes = ["schedule"]
    check_stale = (set(passes) == set(PASSES)
                   and args.package_dir is None
                   and args.schedule_file is None)

    findings: list = []
    skipped: list = []
    try:
        for name in passes:
            if name == "schedule" and args.schedule_file is not None:
                from horovod_tpu_torch.analysis import schedule_lint

                findings.extend(schedule_lint.check_file(args.schedule_file))
            else:
                findings.extend(run_pass(name, package_dir=args.package_dir,
                                         device=args.device))
            if name == "knobs" and args.package_dir is None:
                from horovod_tpu_torch.analysis import knob_lint

                skipped.extend(knob_lint.skipped())
    except Exception as exc:  # an unrunnable pass must fail loudly
        print(f"analysis pass crashed: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return 2

    entries: list = []
    if not args.no_allowlist:
        path = args.allowlist or AL.default_path()
        try:
            entries = AL.load(path) if os.path.exists(path) else []
        except AL.AllowlistError as exc:
            print(f"allowlist error: {exc}", file=sys.stderr)
            return 2
    active, covered, used = AL.split(findings, entries)
    if check_stale and entries:
        for e in AL.stale_entries(entries, used):
            active.append(Finding(
                rule="ALLOWLIST-STALE", severity="warning",
                location=e.location,
                message=f"allowlist entry ({e.rule} @ {e.location!r}) "
                        "matched no finding — the violation it excused "
                        "is gone; delete the entry",
                fix_hint="remove it from horovod_tpu_torch/analysis/"
                         f"{AL.DEFAULT_NAME}",
                pass_name="allowlist"))
    active = sort_findings(active)
    covered = sort_findings(covered)

    if args.as_json:
        doc = {"schema": JSON_SCHEMA,
               "passes": passes,
               "findings": ([dict(f.to_dict(), allowlisted=False)
                             for f in active]
                            + [dict(f.to_dict(), allowlisted=True)
                               for f in covered]),
               "skipped": skipped,
               "summary": {"total": len(active) + len(covered),
                           "active": len(active),
                           "allowlisted": len(covered)}}
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        for f in active:
            print(f.render())
        if covered:
            print(f"({len(covered)} finding(s) allowlisted with "
                  "justifications — see horovod_tpu_torch/analysis/"
                  f"{AL.DEFAULT_NAME})")
        for s in skipped:
            print(f"(skipped {s['rule']}: {s['reason']})")
        verdict = "CLEAN" if not active else f"{len(active)} ACTIVE"
        print(f"analysis [{', '.join(passes)}]: {verdict} "
              f"({len(covered)} allowlisted)")
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
