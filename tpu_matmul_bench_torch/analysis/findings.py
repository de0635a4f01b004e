"""Findings: a stable rule ID, where it fired, and the evidence.

The `Finding` dataclass of `tpu_matmul_bench/analysis/findings.py`, with
the rules the port's audits fire today: the flight recorder's span-coverage
audit (`serve/trace.py trace_findings`, TRACE-001/002/003). The findings
ledger and the other rule families come with ROADMAP A15.
"""

from __future__ import annotations

import dataclasses
from typing import Any

Severity = str  # "info" | "warn" | "error"

SEVERITIES = ("info", "warn", "error")

#: rule id -> (default severity, one-line description), the JAX package's
RULES: dict[str, tuple[Severity, str]] = {
    "TRACE-001": ("error", "scheduler shed/breaker raise site with no "
                           "adjacent flight-recorder terminal emission — "
                           "a refused request would vanish from the "
                           "per-request trace record"),
    "TRACE-002": ("error", "terminal-span coverage broken: an emission "
                           "site uses an unknown terminal state, a state "
                           "is emitted at more than one site in a file "
                           "(a request could get two terminal spans), or "
                           "a terminal state has no emission site at all"),
    "TRACE-003": ("error", "unbounded exemplar retention: an exemplar "
                           "reservoir is declared without an "
                           "EXEMPLAR_LIMIT bound, or the limit is outside "
                           "its sane range — trace-id retention behind "
                           "tail quantiles must stay small"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding: a stable rule ID, where it fired, and evidence."""

    rule: str
    where: str
    message: str
    severity: Severity = ""  # defaults to the rule's severity
    details: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.rule not in RULES:
            raise ValueError(f"unknown rule id {self.rule!r}")
        sev = self.severity or RULES[self.rule][0]
        if sev not in SEVERITIES:
            raise ValueError(f"unknown severity {sev!r}")
        object.__setattr__(self, "severity", sev)
