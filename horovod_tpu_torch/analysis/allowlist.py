"""Per-finding allowlist with mandatory justifications (counterpart of
``horovod_tpu/analysis/allowlist.py``).

The port's allowlist lives in the package, as
``horovod_tpu_torch/analysis/allowlist.json`` (the repo-root
``analysis_allowlist.json`` is the JAX package's), and is the ONLY way a
finding survives on a green tree.  Every entry must say *why* the
violation is acceptable — an entry with a missing or empty justification
is itself an error (the loader refuses the whole file), and an entry
that matches nothing on an ``all`` run is reported stale, so the file
can only shrink as fixes land.

Format (schema 1)::

    {"schema": 1,
     "entries": [
       {"rule": "KNOB-RAW-ENV",
        "location": "horovod_tpu_torch/runtime/kvstore.py:*",
        "match": "HOROVOD_SECRET_KEY",
        "justification": "job secret, deliberately unregistered ..."}]}

Matching: ``rule`` is exact; ``location`` is an ``fnmatch`` glob over
the finding's location; ``match`` (optional) must be a substring of
the finding's message.  Entries therefore pin to a rule + file, not a
line number, and survive unrelated edits.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from fnmatch import fnmatch

from horovod_tpu_torch.analysis.findings import Finding

SCHEMA = 1
DEFAULT_NAME = "allowlist.json"


class AllowlistError(ValueError):
    pass


@dataclass(frozen=True)
class Entry:
    rule: str
    location: str
    justification: str
    match: str = ""

    def covers(self, f: Finding) -> bool:
        return (self.rule == f.rule
                and fnmatch(f.location, self.location)
                and (self.match in f.message if self.match else True))

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "location": self.location,
             "justification": self.justification}
        if self.match:
            d["match"] = self.match
        return d


def default_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        DEFAULT_NAME)


def load(path: str) -> list[Entry]:
    """Parse an allowlist file; raises :class:`AllowlistError` on a bad
    schema or any entry without a non-empty justification."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        raise AllowlistError(f"unreadable allowlist {path}: {exc}") from exc
    if not isinstance(data, dict) or data.get("schema") != SCHEMA:
        raise AllowlistError(
            f"{path}: expected {{'schema': {SCHEMA}, 'entries': [...]}}, "
            f"got schema {data.get('schema') if isinstance(data, dict) else type(data).__name__!r}")
    entries = []
    for i, raw in enumerate(data.get("entries", [])):
        if not isinstance(raw, dict):
            raise AllowlistError(f"{path}: entry {i} is not an object")
        unknown = set(raw) - {"rule", "location", "match", "justification"}
        if unknown:
            raise AllowlistError(
                f"{path}: entry {i} has unknown keys {sorted(unknown)}")
        just = str(raw.get("justification", "")).strip()
        if not just:
            raise AllowlistError(
                f"{path}: entry {i} ({raw.get('rule')!r} @ "
                f"{raw.get('location')!r}) has no justification — every "
                "allowlisted finding must say why it is acceptable")
        if not raw.get("rule") or not raw.get("location"):
            raise AllowlistError(
                f"{path}: entry {i} must set both 'rule' and 'location'")
        entries.append(Entry(rule=str(raw["rule"]),
                             location=str(raw["location"]),
                             justification=just,
                             match=str(raw.get("match", ""))))
    return entries


def split(findings: list[Finding], entries: list[Entry]
          ) -> tuple[list[Finding], list[Finding], set[int]]:
    """Partition findings into (active, allowlisted); returns the set
    of entry indices that matched at least one finding so ``all`` runs
    can report stale entries."""
    active, covered, used = [], [], set()
    for f in findings:
        hit = None
        for i, e in enumerate(entries):
            if e.covers(f):
                hit = i
                break
        if hit is None:
            active.append(f)
        else:
            covered.append(f)
            used.add(hit)
    return active, covered, used


def stale_entries(entries: list[Entry], used: set[int]) -> list[Entry]:
    return [e for i, e in enumerate(entries) if i not in used]
