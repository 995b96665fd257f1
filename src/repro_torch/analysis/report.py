"""Finding/Report plumbing shared by every analysis pass.

A *finding* is one violated invariant; a *report* is the machine-readable
result of an analysis run: every finding plus, per rule, the number of
proof obligations that were actually discharged (so "clean" is
distinguishable from "never ran" — an auditor that silently checks
nothing is worse than none at all).  The port of ``repro.analysis.report``,
unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
from pathlib import Path
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant.

    tool:  which pass produced it (contracts | hazards | kernel_audit |
           lint | selftest).
    rule:  stable kebab-case rule id (the id the ignore mechanism keys on).
    where: location — ``path.py:lineno`` for lint, ``plan[...]`` /
           ``kernel:<name>`` for the semantic passes.
    message: human-readable statement of the violation.
    """

    tool: str
    rule: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"{self.where}: [{self.tool}/{self.rule}] {self.message}"


class Report:
    """Accumulates findings and per-rule obligation counts across passes."""

    def __init__(self) -> None:
        self.findings: list[Finding] = []
        self.checked: Counter = Counter()   # rule id -> obligations proven

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def flag(self, tool: str, rule: str, where: str, message: str) -> None:
        self.add(Finding(tool=tool, rule=rule, where=where, message=message))

    def proved(self, rule: str, n: int = 1) -> None:
        """Record ``n`` discharged proof obligations for ``rule``."""
        self.checked[rule] += n

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.checked.update(other.checked)

    @property
    def ok(self) -> bool:
        return not self.findings

    def by_rule(self) -> dict[str, list[Finding]]:
        out: dict[str, list[Finding]] = {}
        for f in self.findings:
            out.setdefault(f.rule, []).append(f)
        return out

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "n_findings": len(self.findings),
            "obligations": dict(sorted(self.checked.items())),
            "findings": [dataclasses.asdict(f) for f in self.findings],
        }

    def write_json(self, path: str | Path) -> Path:
        out = Path(path)
        out.write_text(json.dumps(self.to_dict(), indent=2) + "\n")
        return out

    def summary(self) -> str:
        lines = []
        for f in self.findings:
            lines.append(str(f))
        total = sum(self.checked.values())
        lines.append(
            f"analysis: {len(self.findings)} finding(s), "
            f"{total} obligation(s) proven across {len(self.checked)} rule(s)")
        return "\n".join(lines)


def merge(reports: Iterable[Report]) -> Report:
    out = Report()
    for r in reports:
        out.extend(r)
    return out
