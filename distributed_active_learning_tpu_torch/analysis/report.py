"""Structured findings: the pre-flight's output layer, the JAX package's
``analysis/report.py`` in the same format.

Every rule of the pre-flight (``analysis/memory.py``'s memory and
shared-memory rules) yields :class:`Finding` records; a :class:`Report`
aggregates them with the list of programs that were actually examined (a
pre-flight that silently priced nothing must not read as "clean"). Two
renderings: ``to_json`` for machines (``python -m
distributed_active_learning_tpu_torch.analysis --json``) and
``render_table`` for humans, both fed by the same records so they can never
disagree; for the same findings both equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

#: Severity ladder, least to most severe. ``max_severity``/gating compare by
#: index in this tuple, so adding a level means inserting it in rank order.
SEVERITIES = ("info", "warn", "error")


def severity_rank(severity: str) -> int:
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        raise ValueError(
            f"unknown severity {severity!r}; one of {SEVERITIES}"
        ) from None


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation: ``program`` names the priced program (e.g.
    ``chunk/uncertainty``), ``location`` where in it the rule fired
    (``<memory>``, or the kernel for a shared-memory finding)."""

    rule: str
    severity: str
    program: str
    location: str
    message: str

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (
            f"[{self.severity}] {self.rule} @ {self.program}"
            f" ({self.location}): {self.message}"
        )


@dataclasses.dataclass
class Report:
    """All findings from one audit run plus what was examined."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    programs: List[str] = dataclasses.field(default_factory=list)
    skipped: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: Per-program accounting the rules computed on the way to their
    #: verdicts — numbers, not judgments, so a reviewer can see HOW FAR
    #: under the gate a program sits.
    stats: Dict[str, dict] = dataclasses.field(default_factory=dict)

    def extend(self, findings: Sequence[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def max_severity(self) -> Optional[str]:
        if not self.findings:
            return None
        return max(self.findings, key=lambda f: severity_rank(f.severity)).severity

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] += 1
        return out

    def at_or_above(self, severity: str) -> List[Finding]:
        floor = severity_rank(severity)
        return [f for f in self.findings if severity_rank(f.severity) >= floor]

    def gate(self, fail_on: str = "error") -> bool:
        """True when the report should FAIL a gate at ``fail_on`` severity."""
        return bool(self.at_or_above(fail_on))

    def to_json(self, indent: Optional[int] = None) -> str:
        payload = {
            "schema": 1,
            "programs_audited": list(self.programs),
            "programs_skipped": dict(self.skipped),
            "counts": self.counts(),
            "max_severity": self.max_severity,
            "findings": [f.asdict() for f in self.findings],
            "program_stats": dict(self.stats),
        }
        return json.dumps(payload, indent=indent)

    def render_table(self) -> str:
        lines = [
            f"audited {len(self.programs)} program(s)"
            + (f", skipped {len(self.skipped)}" if self.skipped else "")
        ]
        for name, why in sorted(self.skipped.items()):
            lines.append(f"  skipped {name}: {why}")
        if not self.findings:
            lines.append("no findings")
            return "\n".join(lines)
        rows = [
            (f.severity, f.rule, f.program, f.location, f.message)
            for f in sorted(
                self.findings,
                key=lambda f: (-severity_rank(f.severity), f.rule, f.program),
            )
        ]
        header = ("severity", "rule", "program", "location", "message")
        widths = [
            max(len(header[i]), *(len(str(r[i])) for r in rows))
            for i in range(4)
        ]
        fmt = lambda r: "  ".join(  # noqa: E731 - tiny local formatter
            [str(r[i]).ljust(widths[i]) for i in range(4)] + [str(r[4])]
        )
        lines.append(fmt(header))
        lines.append(fmt(tuple("-" * w for w in widths) + ("-" * 7,)))
        lines.extend(fmt(r) for r in rows)
        c = self.counts()
        lines.append(
            "totals: " + "  ".join(f"{s}={c[s]}" for s in SEVERITIES if c[s])
        )
        return "\n".join(lines)
