"""Findings model shared by every analysis layer.

Counterpart of ``repro/analysis/findings.py``: its ``Finding``,
``Baseline`` and ``findings_json``, copied (the port imports nothing of
``repro``), so a finding, a baseline file and the JSON payload are the
same in both packages.  The reference's inline ``# repro: noqa``
suppression serves its source lint, which has no port (ROADMAP A16).

A :class:`Finding` is one violation of one rule at one location (the
port's rules name a pseudo-location: the checked log or profile).  A
committed baseline JSON holds accepted findings; entries match on
``(rule, path, message)`` as a multiset, NOT on line numbers, so
unrelated edits moving code around do not resurrect them, while a *new*
instance of a baselined pattern still fails.
"""
from __future__ import annotations

import json
from collections import Counter
from dataclasses import asdict, dataclass, field

BASELINE_VERSION = 1


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
