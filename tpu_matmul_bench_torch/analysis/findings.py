"""Findings: a stable rule ID, where it fired, and the evidence.

The `Finding` dataclass and the findings ledger of
`tpu_matmul_bench/analysis/findings.py`, with the rules of every audit the
port runs: the `lint` program's groups (`analysis/auditor.py`: DTYPE,
COLL, PURE, DONATE, PALLAS, REG, TUNE, ART, OBS, COLL-Q, DTYPE-Q, COLL-H,
TRAIN, SCHED, MEM, DRIFT, FAULT, TRACE, POD, CONC, SCHEMA) and its spec lint
(`analysis/spec_lint.py`, SPEC-001..010), and the observatory's drift
verdicts (`obs/detect.py`, HIST-001..004). Rule IDs never change meaning:
where the port's object differs from JAX's (a recorded run in place of a
jaxpr, a recorded stream schedule in place of optimized HLO, a Hopper tile
in place of a Pallas block, the card's memory in place of a TPU's), the
rule keeps its ID and its words say what the port checks.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

Severity = str  # "info" | "warn" | "error"

SEVERITIES = ("info", "warn", "error")

#: rule id -> (default severity, one-line description), the JAX package's
RULES: dict[str, tuple[Severity, str]] = {
    "DTYPE-001": ("error", "more than one float downcast a rank in a matmul "
                           "program, products and collectives counted as "
                           "one primitive each (stray round-trip breaks "
                           "single-downcast accumulation discipline)"),
    "DTYPE-002": ("error", "downcast/upcast round-trip: a value is narrowed "
                           "then widened again, losing precision for free"),
    "COLL-001": ("error", "collective inventory mismatch: recorded "
                          "collectives differ in kind or count from the "
                          "analytic comms model for the mode"),
    "COLL-002": ("error", "collective byte-volume mismatch vs the analytic "
                          "comms model"),
    "COLL-003": ("error", "collective inside a compute-only program "
                          "(compute legs must be comm-free or the "
                          "compute/comm split is meaningless)"),
    "PURE-001": ("error", "host round trip inside a timed program (.item(), "
                          "a copy to the host, torch.cuda.synchronize, or "
                          "what the card's sync debug mode refuses): host "
                          "round-trips corrupt timing"),
    "DONATE-001": ("error", "buffer declared reusable is not written in "
                            "place: the chained operand or the given `out` "
                            "changed storage, or was left unwritten"),
    "PALLAS-001": ("error", "Hopper tile named by the tuning surface (table, "
                            "DB cell or default) is not an instantiated "
                            "tile of csrc/matmul.cu, so effective_blocks "
                            "would quietly run another"),
    "PALLAS-002": ("error", "wgmma geometry broken: a consumer warpgroup's "
                            "rows not a multiple of 64, its columns not a "
                            "multiple of 8 or above 256, bk not a multiple "
                            "of 16, or A's swizzle not 32, 64 or 128 bytes"),
    "PALLAS-003": ("error", "a tile plan's dynamic shared memory exceeds "
                            "SMEM_PER_BLOCK (or the card's opt-in limit)"),
    "SPEC-001": ("error", "spec failed to parse/validate"),
    "SPEC-002": ("error", "unknown key in a spec table (silently ignored at "
                          "run time — almost always a typo)"),
    "SPEC-003": ("warn", "sharded size not divisible by the device count "
                         "it will run under"),
    "SPEC-004": ("error", "job fingerprint collision: two distinct jobs "
                          "would share a resume/ledger identity"),
    "SPEC-005": ("error", "invalid tenant definition: weight/priority/SLO "
                          "bounds violated, bad traffic profile, or "
                          "unparseable mix in a [tenants.*] block"),
    "SPEC-006": ("error", "duplicate tenant id: two [tenants.*] blocks "
                          "collide after case/whitespace normalization "
                          "(one tenant's traffic would be billed to the "
                          "other's share)"),
    "REG-001": ("warn", "impl-registry tier routes to a kernel citing no "
                        "measurement artifact"),
    "REG-002": ("info", "impl-registry tier extrapolated by tie policy with "
                        "no tuning-DB cell behind it (promote a cell citing "
                        "a measured artifact or an explicit analytic prior "
                        "— tune promote / tune.regen)"),
    "SCHED-001": ("error", "forced serialization: a collective transitively "
                           "consumes the same step's matmul product in the "
                           "recorded stream schedule (required on no_overlap "
                           "and the serialized ring baselines, fatal on "
                           "overlap paths — no stream may hide it)"),
    "SCHED-002": ("error", "matmul/collective mutual independence broken in "
                           "an overlap step — a product waits on its own "
                           "step's sum, or the step has no product: the "
                           "precondition for the two streams to overlap is "
                           "gone"),
    "SCHED-003": ("error", "ring schedule broken: hop or product count a "
                           "rank, or hop independence, no longer matches "
                           "the ring contract"),
    "SCHED-004": ("error", "event mark/wait pairing broken in the recorded "
                           "schedule (a wait on an event never marked, a "
                           "rank stream the exit barrier does not join, or "
                           "no product issued between a sum's mark and the "
                           "wait that consumes it)"),
    "MEM-001": ("error", "peak live bytes of the live-bytes walk exceed the "
                         "per-device memory budget"),
    "MEM-002": ("warn", "peak live bytes inconsistent with the comms "
                        "model's per-shard payloads (walk or program shape "
                        "self-check failed)"),
    "DRIFT-001": ("error", "program fingerprint drifted from the golden "
                           "baseline — recorded structure changed without a "
                           "baseline regen (python -m tpu_matmul_bench_torch."
                           "analysis.regen_golden)"),
    "DRIFT-002": ("warn", "fingerprint baseline incomplete or stale for a "
                          "recorded program (regen "
                          "tpu_matmul_bench_torch/analysis/golden/"
                          "program_fingerprints.json)"),
    "TUNE-001": ("error", "impl_select route resolves to no tuning-DB cell "
                          "and no declared fallback (a table tier citing a "
                          "committed artifact) — the routing decision has "
                          "no evidence"),
    "TUNE-002": ("warn", "impl_select route resolves to a stale tuning-DB "
                         "cell (torch version moved or the routed program's "
                         "digest drifted) — re-measure or re-promote the "
                         "cell"),
    "COLL-Q-001": ("error", "quantized payload travels without its scale "
                            "side-channel: a wire-dtype collective is not "
                            "paired with a matching fp32 scale collective "
                            "(dequantization downstream is impossible or "
                            "wrong)"),
    "COLL-Q-002": ("error", "quantized collective inventory mismatch: the "
                            "recorded wire-format program's collectives "
                            "differ in kind, count, or payload bytes from "
                            "the analytic wire model "
                            "(comms_model.wire_collectives)"),
    "COLL-Q-003": ("error", "predicted payload-byte reduction below the "
                            "2x floor for a 1-byte wire format vs the "
                            "bf16 baseline (the wire format fails its "
                            "reason to exist)"),
    "DTYPE-Q-001": ("error", "quantized program breaks the one-downcast "
                             "contract: non-wire float downcasts exceed "
                             "the exact program's count by more than the "
                             "format's budget, or a new fp32 round-trip "
                             "appeared (dequant must stay in the fp32 "
                             "accumulator until the single final "
                             "downcast)"),
    "DTYPE-Q-002": ("error", "inert short-circuit broken: a world-1 or "
                             "integer-operand program under --comm-quant "
                             "is not identical to the exact program "
                             "(quantization must vanish, not degrade)"),
    "SPEC-007": ("error", "invalid --comm-quant value in a spec's job "
                          "flags: not in the wire-format grammar, or a "
                          "block size that does not divide the payload "
                          "width implied by --sizes/--num-devices"),
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
    "ART-001": ("error", "artifact store integrity violation: a shipped "
                         "exec_artifact's key does not recompute from its "
                         "own fields, its blob is missing, or the blob "
                         "does not hash to its recorded digest — the "
                         "store would load something other than what was "
                         "certified"),
    "ART-002": ("warn", "stale kernel library: the artifact's torch version "
                        "or recomputed program digest drifted from the "
                        "store's record — the key mismatch makes it dead "
                        "weight (serving will rebuild past it); re-export "
                        "or prune"),
    "TUNE-003": ("error", "measured-online tuning cell cites no serve "
                          "ledger (.jsonl) — an online promotion must "
                          "reference the shadow-traffic stream that "
                          "measured it"),
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
    "COLL-H-001": ("error", "per-axis collective inventory mismatch on a "
                            "factorized mesh: a recorded program's "
                            "(kind, axis) multiset differs from the "
                            "two-level comms model — a collective moved "
                            "to the wrong link class"),
    "COLL-H-002": ("error", "per-axis collective payload mismatch on a "
                            "factorized mesh: right (kind, axis), wrong "
                            "bytes vs the two-level comms model's "
                            "prediction"),
    "COLL-H-003": ("error", "per-link wire-format routing broken: a "
                            "quantized wire dtype appears on an axis whose "
                            "link class the --comm-quant spec left exact, "
                            "or the quantized link's collectives carry no "
                            "wire dtype at all"),
    "MEM-003": ("error", "K-streaming resident window exceeds the "
                         "per-device budget: the analytic window bytes "
                         "(accumulator + staged panel pairs) do not fit "
                         "--mem-budget-gib — the out-of-core mode's one "
                         "job is to bound this"),
    "SPEC-008": ("error", "invalid hierarchical-mesh flag in a spec's job "
                          "flags: --mesh not in the dcn:R,ici:C grammar or "
                          "not covering --num-devices, a malformed "
                          "per-link --comm-quant, or a non-positive "
                          "--stream-k / --mem-budget-gib"),
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
    "TRAIN-001": ("error", "train-step collective inventory mismatch: a "
                           "recorded full-step program's (kind, axis) "
                           "multiset differs from the closed-form "
                           "gradient-collective model "
                           "(comms_model.train_expected_collectives) — a "
                           "collective appeared in fwd/bwd, vanished from "
                           "the sync, or moved to the wrong axis"),
    "TRAIN-002": ("error", "train-step collective payload mismatch: right "
                           "(kind, axis), wrong bytes vs the gradient-"
                           "collective model — the wire format rewrote "
                           "the wrong collective (the ZeRO parameter "
                           "allgather must travel exact) or sized a "
                           "chunk wrong"),
    "TRAIN-003": ("error", "ZeRO shard-ownership violation: the per-"
                           "replica updated weight-row shards do not "
                           "tile the parameter disjointly (reduce_scatter "
                           "chunk, owned update slice, and allgather "
                           "reassembly disagree about who owns which "
                           "rows)"),
    "TRAIN-004": ("error", "train-step downcast budget exceeded: the "
                           "quantized-wire step performs more non-wire "
                           "float downcasts than the exact step — "
                           "dequantized gradients must ride the fp32 "
                           "accumulator into the update's single final "
                           "downcast"),
    "TRAIN-005": ("error", "impure train step: a host round trip (.item(), "
                           "a copy to the host, a synchronize) inside the "
                           "timed optimizer step — the step must be a pure "
                           "function of (x, w) or the timing split and "
                           "drift series measure the host"),
    "SPEC-009": ("error", "invalid train flag in a spec's job flags: "
                          "--grad-quant not in the wire-format grammar "
                          "(or the legacy control tier, which has no "
                          "reduce_scatter half), a per-link value with "
                          "no factorized --mesh, --zero outside {0,1}, "
                          "--steps < 2 when a drift series is measured, "
                          "or a (mode, mesh) pair the collective model "
                          "rejects"),
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
    "SPEC-010": ("error", "invalid pod flag in a serve spec's job flags: "
                          "--replica-groups not a positive integer "
                          "dividing the outer axis of --mesh, pod flags "
                          "with no factorized --mesh, --mesh not covering "
                          "--num-devices, or a per-link --comm-quant the "
                          "pod collective model rejects"),
    "CONC-001": ("error", "shared mutable attribute or module global "
                          "written from two or more thread roots with no "
                          "common guarding lock — a lost-update / torn-"
                          "read race under any interleaving the GIL "
                          "happens not to serialize"),
    "CONC-002": ("error", "lock-order cycle: two code paths acquire the "
                          "same locks in opposite orders — two threads "
                          "interleaving those paths deadlock"),
    "CONC-003": ("error", "appender surface touched from a thread role "
                          "other than its declared sole toucher "
                          "(analysis/concurrency.THREAD_ROLES), or an "
                          "appender-shaped method shipped with no "
                          "declaration at all — the one-writer-per-"
                          "ledger contract behind FlightRecorder and the "
                          "FAULT-002 writer registry, statically checked"),
    "CONC-004": ("error", "blocking call (fsync, subprocess, time.sleep, a "
                          "CUDA-graph capture, a synchronize of the card, a "
                          "stream or an event, an nvcc build, a kernel-"
                          "library import or export) while holding a lock "
                          "— every thread contending that lock stalls "
                          "behind it on the serve hot path"),
    "CONC-005": ("error", "wall-clock or unseeded-randomness call "
                          "reachable from a fault-plan replay root — the "
                          "chaos certifier's converged-state verdict "
                          "assumes replay is a pure function of "
                          "(plan, seed)"),
    "SCHEMA-001": ("error", "record key read by a declared consumer that "
                            "no declared producer writes (and not on the "
                            "family's historical allowlist) — a KeyError "
                            "or silent None waiting for the next ledger"),
    "SCHEMA-002": ("error", "a family's validator does not mention every "
                            "key its schema-scoped producers statically "
                            "write — the validator lags the producer, so "
                            "torn or drifted records pass the gate"),
    "SCHEMA-003": ("warn", "record key written but read by no declared "
                           "consumer anywhere and not on the family's "
                           "OUTPUT_ONLY allowlist with a reviewed reason "
                           "— dead weight in every ledger line"),
    "SCHEMA-004": ("error", "one record key written with structurally "
                            "incompatible value shapes (scalar vs dict "
                            "vs list) across producers of one family — "
                            "consumers cannot branch on luck"),
    "SCHEMA-005": ("error", "record family with a durable writer but no "
                            "declared obs/history.py ingest route and no "
                            "NON_HISTORY reason — the observatory's "
                            "coverage contract made mechanical"),
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
                 extra: dict[str, Any] | None = None,
                 device: str = "cpu") -> None:
    """Write the findings ledger: manifest + findings + summary trailer.
    The manifest describes `device`, where the findings were made: the
    host for a ledger that reads files (`obs detect`), the lint's device
    for `lint`."""
    from tpu_matmul_bench_torch.utils.telemetry import build_manifest

    manifest = build_manifest(device=device, extra={"lint": extra or {}})
    with open(path, "w") as fh:
        fh.write(json.dumps(manifest) + "\n")
        for f in findings:
            fh.write(json.dumps(f.to_record()) + "\n")
        fh.write(json.dumps({"record_type": "lint_summary",
                             **summarize(findings)}) + "\n")
