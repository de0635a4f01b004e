"""Findings: a stable rule ID, where it fired, and the evidence.

The `Finding` dataclass of `tpu_matmul_bench/analysis/findings.py`, with
the rules the port's audits fire today: the flight recorder's span-coverage
audit (`serve/trace.py trace_findings`, TRACE-001/002/003) and the pod
layer's audit (`serve/pod.py pod_findings`, POD-001/002/003). The findings
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
    "POD-001": ("error", "replica-group partition does not cover the mesh "
                         "disjointly: a device belongs to zero or to more "
                         "than one group, or a group claims a device "
                         "outside the world — pod placement would route "
                         "traffic onto devices nobody (or everybody) "
                         "owns"),
    "POD-002": ("error", "per-group collective inventory mismatch: a "
                         "recorded group executable's (kind, axis, payload) "
                         "multiset differs from the pod comms model "
                         "(comms_model.pod_expected_collectives) at a "
                         "tested factorization — the sharded serving "
                         "program gathers the wrong way or sizes a shard "
                         "wrong"),
    "POD-003": ("error", "cross-group collective: a dispatched group "
                         "program carries a collective over an axis "
                         "outside its own group mesh — one replica "
                         "group's request would synchronize with another "
                         "group's devices, destroying replica isolation"),
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
