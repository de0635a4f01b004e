"""Findings: a stable rule ID, where it fired, and the evidence.

The `Finding` dataclass of `tpu_matmul_bench/analysis/findings.py`, with
the rules the port's audits fire today: the flight recorder's span-coverage
audit (`serve/trace.py trace_findings`, TRACE-001/002/003), the pod
layer's audit (`serve/pod.py pod_findings`, POD-001/002/003), the fault
subsystem's static audits (`faults/audit.py static_findings`,
FAULT-001/002), the chaos matrix's lint (`faults/audit.py
lint_chaos_data`, SPEC-001/002), the observatory's bus checks (`obs
selftest`, OBS-001/002) and its drift verdicts (`obs/detect.py`,
HIST-001..004), with the findings ledger `obs detect --json-out` writes.
The other rule families come with ROADMAP A15.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

Severity = str  # "info" | "warn" | "error"

SEVERITIES = ("info", "warn", "error")

#: rule id -> (default severity, one-line description), the JAX package's
RULES: dict[str, tuple[Severity, str]] = {
    "SPEC-001": ("error", "spec failed to parse/validate"),
    "SPEC-002": ("error", "unknown key in a spec table (silently ignored at "
                          "run time — almost always a typo)"),
    "OBS-001": ("error", "the kernels' cost books disagree with the hand "
                         "FLOPs model (utils.metrics.matmul_flops) beyond "
                         "tolerance — reported TFLOP/s are computed from "
                         "the wrong op count"),
    "OBS-002": ("error", "instrumented entrypoint emitted no metrics "
                         "snapshot, or its snapshot counters do not "
                         "reconcile with the ledger's extras — the obs bus "
                         "and the ledger disagree about what happened"),
    "FAULT-001": ("error", "subprocess spawn site not routed through "
                           "faults/supervisor.supervised_run (and not on "
                           "its allowlist) — the child escapes the "
                           "heartbeat watchdog and signal-escalation "
                           "ladder"),
    "FAULT-002": ("error", "durable JSONL writer (fsync site) not "
                           "registered in faults/audit.WRITER_REGISTRY — "
                           "crash-consistency certification does not know "
                           "this artifact exists"),
    "HIST-001": ("error", "metric-history regression: the latest ingest "
                          "round's best reading fell beyond the noise "
                          "band vs the series' last-known-good "
                          "(obs detect; store measurements/torch/"
                          "history.jsonl)"),
    "HIST-002": ("warn", "metric-history improvement beyond noise not "
                         "reflected in the recorded last-known-good — "
                         "update the gate baseline / tune DB or the "
                         "evidence rots"),
    "HIST-003": ("warn", "recurring history series gone stale: no "
                         "successful ingest for N rounds — the repo "
                         "stopped measuring a cell it used to measure"),
    "HIST-004": ("error", "analytic-vs-measured attribution residual "
                          "moved beyond noise for a (mode × wire-format "
                          "× shape) cell — the compute+comm model "
                          "stopped explaining the machine"),
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

    def to_record(self) -> dict[str, Any]:
        return {
            "record_type": "lint_finding",
            "rule": self.rule,
            "severity": self.severity,
            "where": self.where,
            "message": self.message,
            "rule_doc": RULES[self.rule][1],
            "details": self.details,
        }


def summarize(findings: list[Finding]) -> dict[str, int]:
    counts = {"info": 0, "warn": 0, "error": 0}
    for f in findings:
        counts[f.severity] += 1
    return counts


def should_fail(findings: list[Finding], fail_on: Severity) -> bool:
    """Exit-code policy: --fail-on warn trips on warn+error, --fail-on
    error trips on error only."""
    threshold = SEVERITIES.index(fail_on)
    return any(SEVERITIES.index(f.severity) >= threshold for f in findings)


def write_ledger(path: str, findings: list[Finding], *,
                 extra: dict[str, Any] | None = None) -> None:
    """Write the findings ledger: manifest + findings + summary trailer.
    The manifest describes the host (`device="cpu"`): a findings ledger
    reads files, never the card."""
    from tpu_matmul_bench_torch.utils.telemetry import build_manifest

    manifest = build_manifest(device="cpu", extra={"lint": extra or {}})
    with open(path, "w") as fh:
        fh.write(json.dumps(manifest) + "\n")
        for f in findings:
            fh.write(json.dumps(f.to_record()) + "\n")
        fh.write(json.dumps({"record_type": "lint_summary",
                             **summarize(findings)}) + "\n")
