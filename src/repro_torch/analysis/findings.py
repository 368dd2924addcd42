"""Findings model shared by every analysis layer.

Counterpart of ``repro/analysis/findings.py``: its ``Finding``,
``Baseline``, ``findings_json`` and inline suppression, copied (the port
imports nothing of ``repro``), so a finding, a baseline file, a noqa
comment and the JSON payload are the same in both packages.

A :class:`Finding` is one violation of one rule at one source location
(trace, graph and lock rules use a pseudo-location naming the checked
entry point).  The CLI subtracts two suppression mechanisms:

* inline ``# repro: noqa[RULE]`` (or bare ``# repro: noqa``) on the
  flagged line — for violations that are *intentional at that site*;
* a committed baseline JSON — for findings accepted for now that must
  not grow.  Entries match on ``(rule, path, message)`` as a multiset,
  NOT on line numbers, so unrelated edits moving code around do not
  resurrect them, while a *new* instance of a baselined pattern in the
  same file still fails.
"""
from __future__ import annotations

import json
import re
from collections import Counter
from dataclasses import asdict, dataclass, field

BASELINE_VERSION = 1
_NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa(?:\[(?P<rules>[A-Za-z0-9_,\- ]+)\])?")


@dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``message`` must be stable under unrelated line-number drift (no
    line numbers inside it) — baseline matching depends on that.
    """

    rule: str
    path: str
    line: int
    message: str
    col: int = 0

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.message)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message}")


def noqa_rules_for_line(source_line: str) -> set[str] | None:
    """Rules suppressed by an inline comment on ``source_line``: None
    when there is no noqa comment, the empty set for a blanket
    ``# repro: noqa`` (every rule), else the named rules (upper-cased)."""
    m = _NOQA_RE.search(source_line)
    if m is None:
        return None
    rules = m.group("rules")
    if rules is None:
        return set()
    return {r.strip().upper() for r in rules.split(",") if r.strip()}


def apply_noqa(findings: list[Finding],
               source_lines: list[str]) -> list[Finding]:
    """Drop findings whose source line carries a matching noqa comment."""
    out = []
    for f in findings:
        if 1 <= f.line <= len(source_lines):
            rules = noqa_rules_for_line(source_lines[f.line - 1])
            if rules is not None and (not rules or f.rule in rules):
                continue
        out.append(f)
    return out


@dataclass
class Baseline:
    """Committed multiset of accepted findings."""

    entries: Counter = field(default_factory=Counter)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path) as f:
            payload = json.load(f)
        if payload.get("version") != BASELINE_VERSION:
            raise ValueError(
                f"baseline {path} has version {payload.get('version')!r}, "
                f"this tool reads version {BASELINE_VERSION}")
        entries = Counter()
        for e in payload["findings"]:
            entries[(e["rule"], e["path"], e["message"])] += int(
                e.get("count", 1))
        return cls(entries)

    @classmethod
    def from_findings(cls, findings: list[Finding]) -> "Baseline":
        return cls(Counter(f.key() for f in findings))

    def save(self, path: str) -> None:
        findings = [
            {"rule": rule, "path": p, "message": msg, "count": n}
            for (rule, p, msg), n in sorted(self.entries.items())
        ]
        with open(path, "w") as f:
            json.dump({"version": BASELINE_VERSION, "findings": findings},
                      f, indent=1, sort_keys=False)
            f.write("\n")

    def filter(self, findings: list[Finding]) -> list[Finding]:
        """Findings NOT covered by the baseline (multiset subtraction:
        a baselined pattern occurring more often than recorded surfaces
        the extra occurrences)."""
        budget = Counter(self.entries)
        out = []
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.col)):
            if budget[f.key()] > 0:
                budget[f.key()] -= 1
            else:
                out.append(f)
        return out


def findings_json(findings: list[Finding], *, suppressed: int = 0) -> dict:
    """Machine-readable payload for ``--out`` / ``--format json``."""
    counts = Counter(f.rule for f in findings)
    return {
        "version": BASELINE_VERSION,
        "total": len(findings),
        "suppressed": suppressed,
        "counts": dict(sorted(counts.items())),
        "findings": [asdict(f) for f in
                     sorted(findings, key=lambda f: (f.path, f.line, f.col))],
    }
