"""Findings model shared by every analysis pass (counterpart of
``horovod_tpu/analysis/findings.py``, docs/analysis.md).

A finding is one violated invariant at one location.  Rule ids are
stable strings (the allowlist and docs key on them); severities order
as ``error > warning`` and BOTH fail the build unless allowlisted —
the split exists so reports rank hard invariant breaks above hygiene
drift, not so warnings can be ignored.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: Severity names in descending order of badness.  ``error`` = a
#: correctness invariant is violated (deadlock/corruption class);
#: ``warning`` = drift that will become one (missing doc row, help text
#: out of sync).  Both exit non-zero unless allowlisted.
SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    rule: str                 # stable id, e.g. "KNOB-RAW-ENV"
    severity: str             # member of SEVERITIES
    location: str             # "path/to/file.py:123" or "program:<label>"
    message: str              # one-line statement of the violation
    fix_hint: str = ""        # how to fix (or what a justification must say)
    pass_name: str = field(default="", compare=False)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def sort_key(self) -> tuple:
        return (SEVERITIES.index(self.severity), self.rule, self.location)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "location": self.location, "message": self.message,
                "fix_hint": self.fix_hint, "pass": self.pass_name}

    def render(self) -> str:
        hint = f"\n    fix: {self.fix_hint}" if self.fix_hint else ""
        return (f"[{self.severity.upper()}] {self.rule} {self.location}\n"
                f"    {self.message}{hint}")


def sort_findings(findings: list[Finding]) -> list[Finding]:
    return sorted(findings, key=Finding.sort_key)
