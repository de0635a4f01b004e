"""Schema-flow certifier: the SCHEMA-* rule family.

Port of `tpu_matmul_bench/analysis/schema_flow.py` over the port's own
record families: its producers, validators and consumers, in its own
package. The real tree is the port's package alone, its own round driver
(`tpu_matmul_bench_torch/bench.py`) included; the repository's `scripts/`
and root `bench.py` belong to the JAX package and are never scanned. The
JAX package's consumers in `scripts/digest_jsonl.py` have no port
counterpart, so every key only they read is declared in its family's
`output_only` table with a reason (or would be a SCHEMA-003 warning):
none is dropped silently. Families whose keys differ from JAX's on
purpose say so in their entries (`exec_artifact` stores K1's kernel
library, `manifest` carries the lint's groups and peak memory,
`round_status` is the port's bench.py ladder).

The port writes about a dozen durable JSONL record families —
bench/serve/train ledgers, the serve_batch and serve_span streams, the
campaign journal, the tune DB, the artifact manifest, the fault-audit
log, obs snapshots, history points — each with a hand-maintained
validator and whatever its consumers happen to read: the producer moves,
the validator lags, and the first evidence is a KeyError (or a silent
None) in a gate an hour into a campaign.

This module promotes the producer/consumer contract to statically
checked rules, under the concurrency certifier's exact operating model:
parse, never execute, stdlib-only, torch-free. From the AST of every file
in scope it extracts

- **written keys** per family — string keys of dict literals, subscript
  stores (``rec["k"] = v``), ``dict(k=...)`` keywords, and
  ``.setdefault("k", v)`` calls inside each *declared* producer
  function (``.update({...})`` literals are covered because every dict
  literal in a producer body is harvested), plus the AnnAssign field
  names of declared record dataclasses (``BenchmarkRecord``,
  ``JobEvent`` — serialized with ``dataclasses.asdict``);
- **read keys** per consumer — Load-context subscripts with constant
  string slices, ``.get("k")`` / ``.pop("k")`` calls, and
  ``"k" in x`` membership tests inside each declared consumer;
- **validator mentions** — the consumer read set *plus* every string
  constant inside tuple/list/set/dict literals in the validator body
  and inside module-level constants the body references by name (so a
  ``(("trace", str), ...)`` type table or a ``SPAN_NAMES`` tuple counts
  as coverage).

Rules (stable IDs in `analysis/findings.RULES`):

- **SCHEMA-001** (error) — a key read by a declared consumer that no
  declared producer (of any family) writes and that is not on the
  family's ``historical`` allowlist: a crash or silent-None waiting for
  the next ledger.
- **SCHEMA-002** (error) — a family's validator does not mention every
  key its schema-scoped producers write: the
  ``validate_serve_record``-lags-the-producer failure mode.
- **SCHEMA-003** (warn) — a key written by some family that no declared
  consumer anywhere reads and that is not on the family's
  ``OUTPUT_ONLY`` allowlist with a reviewed reason.
- **SCHEMA-004** (error) — one key written with structurally
  incompatible value shapes (scalar vs dict vs list) across the
  producers of one family, unless the family declares the key
  polymorphic.
- **SCHEMA-005** (error) — a family with a durable writer but no
  declared `obs/history.py` ingest route and no declared NON_HISTORY
  reason: the observatory's coverage contract, made mechanical.

Conventions are declared, not inferred (the concurrency certifier's
trust-boundary model): `RECORD_FAMILIES` maps each family to its
producer roots, validator surfaces, consumers, and allowlists, and the
selftest fails on any entry naming a vanished surface. The selftest
also ties the table back to the crash-consistency layer: every module
in `faults/audit.WRITER_REGISTRY` (parsed from its AST, never
imported) must host a declared producer or record dataclass, and every
``write_raw({...literal...})`` call site must sit inside a declared
producer — so a new durable record family cannot ship schema-unchecked.

Known limits of the static approximation (JAX's): key
harvesting is flat (a nested dict's keys join the family's key set at
one level — the rules cannot distinguish ``extras["serve"]["queue"]``
from a top-level ``queue``); dynamic keys (``d[name] = v``, dict
comprehensions, ``**splat``) are invisible, which is why
``obs_snapshot``'s per-series keys ride a registry aux producer and the
round-status wrapper keys are `historical`; attribute-style dataclass
reads (``rec.tflops_per_device``) are below the read harvester's
resolution, so dataclass fields are exempt from SCHEMA-003; and
SCHEMA-001's write universe is global across families, because shared
consumer helpers (`campaign/store.py CampaignStore.summary`) read
several families in one body. Everything here is stdlib-only and imports
no torch: the audit runs from `lint` and `lint schema selftest` on
machines without a card, in well under a second.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import sys
import tempfile
from pathlib import Path
from typing import Any, Iterable

from tpu_matmul_bench_torch.analysis.findings import Finding

# --------------------------------------------------------------------------
# declaration model


@dataclasses.dataclass(frozen=True)
class Family:
    """One record family's declared producer/consumer contract.

    Quals are ``"<rel>::<func>"`` or ``"<rel>::<Class>.<method>"`` with
    ``<rel>`` a package-relative posix path. `producers` are the
    schema-scoped writers the validator must cover; `aux_producers`
    contribute written keys (nested stats blocks owned by other
    classes) without widening the validator obligation; record
    dataclasses contribute their AnnAssign field names the same way.
    An empty `validator` skips SCHEMA-002 for the family — a statement
    that the family's schema authority is its dataclass or its
    consumers, not a checking function."""

    producers: tuple[str, ...] = ()
    aux_producers: tuple[str, ...] = ()
    record_dataclasses: tuple[str, ...] = ()
    validator: tuple[str, ...] = ()
    consumers: tuple[str, ...] = ()
    #: key -> reviewed reason: written for downstream tools, read by no
    #: in-repo consumer (SCHEMA-003 allowlist)
    output_only: dict[str, str] = dataclasses.field(default_factory=dict)
    #: key -> reviewed reason: read by consumers but written by no LIVE
    #: producer (legacy keys in committed ledgers, external wrappers) —
    #: SCHEMA-001 allowlist
    historical: dict[str, str] = dataclasses.field(default_factory=dict)
    #: keys deliberately written with more than one value shape
    polymorphic: tuple[str, ...] = ()
    durable: bool = True
    #: `obs/history.py` function that routes this family into the
    #: metric-history store (SCHEMA-005's evidence)
    ingest: str | None = None
    #: reviewed reason a durable family is NOT history-ingested
    non_history: str | None = None


# --------------------------------------------------------------------------
# the shipped declaration table — the checked record-schema model

RECORD_FAMILIES: dict[str, Family] = {
    # the BenchmarkRecord ledger line every benchmark program writes;
    # its schema authority is the dataclass, extras are per-program
    "bench_ledger": Family(
        aux_producers=(
            "utils/timing.py::sample_stats",
            "analysis/comms_model.py::wire_bytes_summary",
            "analysis/comms_model.py::hier_wire_bytes_summary",
            "analysis/memory_model.py::check_stream_budget",
            "parallel/modes.py::validate",
            "parallel/collectives.py::comm_quant_record_extra",
            "parallel/stream_k.py::stream_gate",
            "parallel/overlap.py::_vs_baseline_mode",
            "benchmarks/matmul_benchmark.py::_cost_extras",
            "benchmarks/cuda_tune.py::_candidate_cost",
        ),
        record_dataclasses=("utils/reporting.py::BenchmarkRecord",),
        consumers=(
            "campaign/store.py::CampaignStore.summary",
            "campaign/store.py::_read_ledger",
            "obs/history.py::_bench_labels",
            "obs/history.py::_sample_noise_pct",
            "obs/history.py::_predicted_seconds",
            "obs/history.py::_predicted_comm_seconds",
            "obs/history.py::_attribution",
            "obs/history.py::_ledger_points",
        ),
        historical={
            "block_m": "written via the dynamic f'block_{dim}' "
                       "comprehension in parallel/overlap.py::"
                       "_explicit_blocks — below static resolution",
            "block_n": "dynamic f'block_{dim}' key (see block_m)",
            "block_k": "dynamic f'block_{dim}' key (see block_m)",
        },
        output_only={
            "payload": "per-link wire split (payload vs scale bytes) in "
                       "the analytic summary — forensic detail under "
                       "the consumed totals",
            "scale": "per-link wire split detail (see payload)",
            "block": "wire-format block size echoed into the per-link "
                     "rows so a ledger line names its quantization",
            "comm_seconds_rel": "model-vs-measured ratio kept next to "
                                "the absolute seconds the digest reads",
            "budget_bytes": "stream-budget gate evidence: the digest "
                            "renders the verdict, the operands stay "
                            "for forensics",
            "resident_bytes": "stream-budget gate evidence (see "
                              "budget_bytes)",
            "full_problem_gib": "stream-k gate evidence: why streaming "
                                "was (not) required, for humans reading "
                                "the ledger",
            "nonstreaming_over_budget": "stream-k gate evidence (see "
                                        "full_problem_gib)",
            "min_ms": "sample floor next to the consumed avg/p50/noise "
                      "stats — kept so outlier triage needs no rerun",
            "baseline": "names the serialized leg an overlap speedup "
                        "was measured against; the digest reads the "
                        "speedup",
            "baseline_time_ms": "the serialized leg's wall time (see "
                                "baseline)",
            # read by the JAX package's digest script, which has no port
            # counterpart: the ledger's readers are humans and the tests
            "overlap_speedup_x": "the overlap win over the serialized "
                                 "leg, printed in the human block; no "
                                 "in-package reader",
            "baseline_bytes": "analytic wire summary: the exact "
                              "collective's bytes next to the wire "
                              "format's, for humans comparing the two",
            "wire_payload_bytes": "analytic wire summary (see "
                                  "baseline_bytes)",
            "wire_scale_bytes": "analytic wire summary (see "
                                "baseline_bytes)",
            "payload_reduction_x": "analytic wire summary: the lint's "
                                   "COLL-Q-003 computes it afresh from the "
                                   "comms model, never from a ledger",
            "wire_reduction_x": "analytic wire summary (see "
                                "payload_reduction_x)",
            "bottleneck_link": "per-link wire summary: which link class "
                               "bounds the collective, for humans",
            "window": "stream-k resident window breakdown under the "
                      "budget verdict (see budget_bytes)",
            "budget_gib": "stream-k gate evidence (see budget_bytes)",
            "resident_gib": "stream-k gate evidence (see budget_bytes)",
            "out_of_core": "stream-k gate evidence (see budget_bytes)",
            "ranks_per_card": "the stream's ranks on one card, the "
                              "divisor of its per-card budget (see "
                              "budget_bytes)",
            "mean_ms": "sample mean next to the consumed p50 and noise "
                       "stats (see min_ms)",
            "warmup_drift": "warm-up drift flag next to the consumed "
                            "sample stats, for outlier triage (see "
                            "min_ms)",
            "warmup_drift_pct": "warm-up drift size (see warmup_drift)",
        },
        ingest="_ledger_points",
    ),
    # the serve ledger's extras["serve"] block (+ per-tenant rows,
    # per-bucket rows, and the pod block when --mesh is live)
    "serve_record": Family(
        producers=(
            "serve/service.py::serve_stats",
            "serve/service.py::_percentiles_ms",
            "serve/service.py::_tenant_rows",
            "serve/service.py::_bucket_breakdown",
            "serve/pod.py::_pod_block",
        ),
        aux_producers=(
            "serve/service.py::_serve_record",
            "serve/service.py::run_ab",
            "serve/service.py::_explore_block",
            "serve/service.py::_ab_verdict",
            "serve/pod.py::_pod_arm",
            "serve/queue.py::AdmissionQueue.stats",
            "serve/scheduler.py::ContinuousScheduler.stats",
            "serve/cache.py::ExecutableCache.stats",
            "tune/online.py::OnlineExplorer.summary",
            "tune/online.py::OnlineExplorer.decisions",
            "serve/service.py::_attach_cost_analysis",
        ),
        validator=("serve/service.py::validate_serve_record",),
        consumers=(
            "campaign/store.py::CampaignStore.summary",
            "obs/history.py::_serve_point",
            "obs/history.py::_pod_points",
            # the human renderings and cross-checks read far more of
            # the stats block than the digest tables do
            "serve/service.py::_report_summary",
            "serve/service.py::run_selftest",
            "serve/service.py::_tenant_rows",
            "serve/pod.py::_MergedCaches.stats",
            "serve/pod.py::PodQueue.stats",
            "serve/pod.py::_report_pod",
            "obs/cli.py::_selftest_findings",
        ),
        output_only={
            "window_ms": "fixed-window queue config echoed into stats "
                         "so a ledger line names its admission policy",
            "preemptions": "continuous-scheduler diagnostic counter — "
                           "tail triage evidence, no gate reads it",
            "service_est_ms": "scheduler's internal service estimate, "
                              "kept to explain its batching choices",
            "slo_sheds": "scheduler diagnostic counter (see "
                         "preemptions)",
            "starvation_ms": "starvation-promotion config echo (see "
                             "window_ms)",
            "starvation_promotions": "scheduler diagnostic counter "
                                     "(see preemptions)",
            "db": "path of the explore DB the run promoted into — "
                  "provenance for the online-tuning audit trail",
            "baseline": "A/B verdict context: the digest renders the "
                        "verdict, the arm summaries stay for forensics",
            "candidate": "A/B verdict context (see baseline)",
            "tolerance_pct": "A/B verdict context (see baseline)",
            "min_samples": "explore-gate config echo: why a bucket did "
                           "(not) promote, next to the consumed verdict",
            # read by the JAX package's digest script only (no port
            # counterpart): the human block prints them
            "opens": "breaker diagnostic counter (see preemptions)",
            "consecutive_fails": "breaker diagnostic counter (see "
                                 "preemptions)",
            "promoted": "explore verdict detail: the summary's "
                        "promotions count is the consumed signal",
            "incumbent": "explore decision detail (see promoted)",
            "alternate": "explore decision detail (see promoted)",
            "mean_ms": "explore decision detail (see promoted)",
            "verdict": "explore decision detail (see promoted)",
            "decisions": "explore decision log (see promoted)",
            "shape": "per-bucket shape echo next to the consumed bucket "
                     "label, for humans",
            "ab": "the A/B block on the `serve ab` ledger: `serve ab`'s "
                  "exit code is its verdict, the block is for humans",
            "regressed": "A/B verdict detail (see ab)",
            "goodput_delta_pct": "A/B verdict detail (see ab)",
            "p99_delta_pct": "A/B verdict detail (see ab)",
        },
        ingest="_serve_point",
    ),
    # the train ledger's extras["train"] block (phase split, ZeRO
    # config, update-drift series, analytic wire summary)
    "train_record": Family(
        producers=("train/harness.py::bench_one",),
        aux_producers=(
            "train/harness.py::validate_step",
            "analysis/comms_model.py::train_wire_bytes_summary",
        ),
        validator=("train/harness.py::validate_train_record",),
        consumers=(
            "obs/history.py::_train_points",
        ),
        output_only={
            "validation_tolerance": "verdict context: the digest "
                                    "renders 'validation'; the "
                                    "tolerance keeps a FAILED line "
                                    "self-explanatory",
            "comm_seconds_rel": "model-vs-measured ratio kept next to "
                                "the absolute seconds (bench_ledger "
                                "has the same column)",
            "validation": "the step's verdict, printed in the human "
                          "block; `train bench --validate` exits on it",
            "validation_max_rel_err": "verdict detail (see validation)",
            "baseline_bytes": "analytic wire summary (bench_ledger has "
                              "the same columns)",
            "wire_payload_bytes": "analytic wire summary (see "
                                  "baseline_bytes)",
            "wire_scale_bytes": "analytic wire summary (see "
                                "baseline_bytes)",
            "bottleneck_link": "analytic wire summary (see "
                               "baseline_bytes)",
        },
        ingest="_train_points",
    ),
    # streamed per-batch progress lines on the serve ledger
    "serve_batch": Family(
        producers=("serve/service.py::_worker_drain",),
        validator=("serve/service.py::validate_serve_batch_record",),
        consumers=(
            "faults/audit.py::_validate_serve_line",
        ),
        output_only={
            "batch_ms": "per-batch wall time for humans tailing the "
                        "live ledger; the audit only checks the line's "
                        "shape and ordering",
        },
        non_history="liveness evidence for the crash-consistency "
                    "audit, not a measurement; the headline serve "
                    "record carries the gated numbers",
    ),
    # per-request terminal span records from the flight recorder
    "serve_span": Family(
        producers=(
            "serve/trace.py::FlightRecorder.terminal",
            "serve/trace.py::request_spans",
            "serve/trace.py::failure_spans",
        ),
        aux_producers=("serve/trace.py::tail_attribution",),
        validator=("serve/trace.py::validate_serve_span_record",),
        consumers=(
            "serve/trace.py::read_trace_records",
            "serve/trace.py::tail_attribution",
            "serve/trace.py::render_explain",
            "serve/trace.py::run_explain",
            "obs/history.py::_serve_tail_points",
        ),
        output_only={
            "quantile": "tail-attribution provenance: which quantile "
                        "the threshold was computed at — explain-output "
                        "readers need it, no code path does",
            "wall_ms_sum": "tail-attribution denominator kept so the "
                           "shares block is auditable by hand",
        },
        ingest="_serve_tail_points",
    ),
    # the campaign resume journal (fsynced JobEvent lines)
    "campaign_journal": Family(
        record_dataclasses=("campaign/state.py::JobEvent",),
        consumers=(
            "campaign/state.py::load_events",
        ),
        non_history="execution state (status transitions), not a "
                    "measurement; journal.jsonl is in history's "
                    "_NON_MEASUREMENT_NAMES",
    ),
    # tuning-DB cells (measurements/torch/tune_db.jsonl)
    "tune_cell": Family(
        producers=("tune/db.py::Cell.to_record",),
        validator=(
            "tune/db.py::Cell.from_record",
            "tune/db.py::TuningDB.validate",
        ),
        consumers=(
            "tune/db.py::Cell.from_record",
        ),
        non_history="cells cite measurement artifacts; history tracks "
                    "the measurements themselves (tune_db.jsonl is in "
                    "_NON_MEASUREMENT_NAMES)",
    ),
    # kernel-library store manifest lines: the port stores K1's built
    # library (tune/artifacts.py), where JAX stores a serialized executable
    "exec_artifact": Family(
        producers=("tune/artifacts.py::ArtifactStore.put",),
        validator=("tune/artifacts.py::ArtifactStore.validate",),
        consumers=(
            "tune/artifacts.py::ArtifactStore.load",
            "tune/artifacts.py::ArtifactStore.lookup",
            "tune/artifacts.py::ArtifactStore.get_blob",
            "tune/artifacts.py::ArtifactStore.records",
            "tune/artifacts.py::ArtifactStore.stale_reasons",
        ),
        output_only={
            "size_bytes": "the library blob's size, for humans pruning "
                          "the store; integrity reads the digest",
        },
        non_history="kernel-library provenance, not a measurement; "
                    "integrity is ART-001/002's contract",
    ),
    # obs metrics snapshots (obs_snapshot.jsonl)
    "obs_snapshot": Family(
        producers=("obs/export.py::snapshot_record",),
        aux_producers=(
            "obs/registry.py::MetricsRegistry.snapshot",
            "obs/registry.py::_histogram_summary",
        ),
        consumers=(
            "obs/export.py::read_snapshots",
            "obs/export.py::prometheus_text",
        ),
        output_only={
            "ts_unix": "snapshot wall-clock stamp for humans and the "
                       "Prometheus scrape; `obs status` reads seq and "
                       "flush age",
            "max": "histogram maximum next to the quantiles, for tail "
                   "triage by hand",
        },
        non_history="live gauges for `obs status`, not retained "
                    "measurements; obs_snapshot.jsonl is in "
                    "_NON_MEASUREMENT_NAMES",
    ),
    # the metric-history store's point records
    # (measurements/torch/history.jsonl; the card's points carry the
    # device-kind token `h100`)
    "history_point": Family(
        producers=("obs/history.py::_make_point",),
        aux_producers=(
            "obs/history.py::_round_points",
            "obs/history.py::_bench_labels",
            "obs/history.py::_serve_point",
            "obs/history.py::_pod_points",
            "obs/history.py::_train_points",
            "obs/history.py::_ledger_points",
            "obs/history.py::_serve_tail_points",
            "obs/history.py::_attribution",
            "obs/history.py::_predicted_seconds",
            "obs/history.py::_predicted_comm_seconds",
            "obs/history.py::HistoryStore.append",
        ),
        validator=("obs/history.py::HistoryStore.validate",),
        consumers=(
            "obs/history.py::HistoryStore.series",
            "obs/history.py::HistoryStore.identities",
            "obs/history.py::HistoryStore.max_seq",
            "obs/history.py::_headline_point",
            "obs/history.py::baseline_rows_for_campaign",
            "obs/detect.py::_series_label",
            "obs/detect.py::_best_per_round",
            "obs/detect.py::_series_findings",
            "obs/detect.py::_residual_findings",
            "obs/detect.py::detect_findings",
            "obs/report.py::_trajectory",
            "obs/report.py::_group_rows",
            "obs/report.py::render",
            "obs/report.py::_residual_section",
            "obs/report.py::_verdict_section",
        ),
        historical={
            "bench": "report group label: a value of the point's "
                     "'kind' field used as a local grouping key in "
                     "obs/report.py::render, not a record key",
            "tune": "report group label (see bench)",
            "serve": "report group label (see bench)",
            "serve_tail": "report group label (see bench)",
            "train": "report group label (see bench)",
            "fault_audit": "report group label (see bench)",
        },
        output_only={
            "measured": "residual drill-down: residual_pct is the "
                        "consumed signal; the measured/predicted split "
                        "stays for forensic attribution",
            "predicted": "residual drill-down (see measured)",
            "total_s": "sub-key of the measured block (see measured)",
            "link_formats": "series-identity label: consumed via the "
                            "labels fingerprint, never read by name",
            "implausible_above_peak_tflops": "detail flag explaining "
                                             "why a point was demoted "
                                             "to unavailable — triage "
                                             "evidence for humans",
        },
        ingest="ingest",
    ),
    # fault-audit cell verdicts (the chaos certifier's ledger)
    "fault_audit": Family(
        producers=(
            "faults/audit.py::run_cell",
            "faults/audit.py::run_audit",
        ),
        consumers=(
            "obs/history.py::_ledger_points",
        ),
        output_only={
            "fault": "the injected FaultSpec in inline form — the "
                     "replay recipe for a failed cell; verdict "
                     "consumers key on cell/subsystem",
            "escalation": "the supervisor's signal ladder for the cell, "
                          "forensic detail under the verdict",
            "recovery_s": "time to recover, printed in the audit's "
                          "table; no in-package reader",
            "problems": "the failed checks' texts behind a FAILED "
                        "verdict, for humans",
        },
        ingest="_ledger_points",
    ),
    # schema-v2 manifest lines (every ledger's first record)
    "manifest": Family(
        producers=(
            "utils/telemetry.py::build_manifest",
            "serve/service.py::_config_manifest",
        ),
        aux_producers=(
            "analysis/findings.py::write_ledger",
            "analysis/cli.py::main",
            "obs/context.py::trace_block",
        ),
        consumers=(
            "utils/telemetry.py::is_manifest",
            "campaign/store.py::CampaignStore.merged_records",
            "serve/trace.py::run_explain",
            "obs/history.py::_serve_point",
        ),
        output_only={
            # the manifest IS the forensic record: most of its columns
            # exist so two runs can be diffed by hand, not so code can
            # read them back
            "fail_on": "lint-run provenance: the gate the ledger was "
                       "written under",
            "specs": "lint-run provenance: which audit groups ran",
            "pid": "trace-block provenance for correlating a ledger "
                   "with its process logs",
            "concurrency": "serve-run repro knob, diffed by humans",
            "duration_s": "serve-run repro knob (see concurrency)",
            "explore_db": "serve-run repro knob (see concurrency)",
            "prewarm": "serve-run repro knob (see concurrency)",
            "starvation_ms": "serve-run repro knob (see concurrency)",
            "window_ms": "serve-run repro knob (see concurrency)",
            "cuda_version": "environment provenance, diffed by "
                            "humans chasing a regression",
            "process_count": "environment provenance (see "
                             "cuda_version)",
            "device_count": "environment provenance (see cuda_version)",
            "git_sha": "environment provenance (see cuda_version)",
            "argv": "run-config provenance (see cuda_version)",
            "schema_version": "ledger schema stamp: readers key on "
                              "record_type, the stamp is for humans",
            "precision": "run-config provenance (see cuda_version)",
            "seed": "run-config provenance (see cuda_version)",
            "warmup": "run-config provenance (see cuda_version)",
            "iterations": "run-config provenance (see cuda_version)",
            "chrome_trace": "path of the run's torch.profiler trace "
                            "(--profile-dir), for humans opening it",
            "parent_run_id": "trace-block provenance: the campaign run "
                             "that spawned this one (see pid)",
            # the lint manifest's block (analysis/cli.py): its groups'
            # seconds and findings and the walk's peak memory
            "lint": "the lint run's provenance block (see fail_on)",
            "device": "lint-run provenance: where the audited programs "
                      "ran",
            "findings": "lint group provenance: a group's findings by "
                        "rule, the summary trailer holds the totals",
            "seconds": "lint group provenance: a group's seconds",
            "peak_memory": "the live-bytes walk's peaks under the "
                           "MEM-001 verdict, for humans",
        },
        non_history="provenance, not measurement; manifests ride the "
                    "measurement ledgers and are read as labels "
                    "(serve_config) by the ingest dispatchers",
    ),
    # lint findings ledger lines (`lint --json-out`)
    "lint_finding": Family(
        producers=("analysis/findings.py::Finding.to_record",),
        aux_producers=(
            "analysis/findings.py::write_ledger",
            "analysis/findings.py::summarize",
        ),
        consumers=(),
        output_only={
            # the JAX package's digest script has no port counterpart:
            # the ledger is read by humans, and the campaign's lint gate
            # reads the lint's exit code
            "rule": "the finding's stable ID, for humans and the ledger's "
                    "external readers",
            "severity": "the finding's severity (see rule)",
            "where": "where the finding fired (see rule)",
            "message": "the finding's text (see rule)",
            "error": "summary trailer total (see rule)",
            "warn": "summary trailer total (see rule)",
            "info": "summary trailer total (see rule)",
            "lint": "the manifest's lint block (see the manifest "
                    "family)",
            "details": "structured evidence payload a human (or a "
                       "future tool) drills into; the digest renders "
                       "rule/severity/where/message",
            "rule_doc": "the rule's one-line contract inlined so a "
                        "ledger is readable without the source tree",
        },
        non_history="lint verdicts gate merges directly; the history "
                    "store tracks measured performance, not static "
                    "findings",
    ),
    # the parent round driver's health line on stdout (bench.py)
    "round_status": Family(
        producers=(
            "bench.py::_emit",
        ),
        consumers=("obs/history.py::_round_points",),
        historical={
            "parsed": "BENCH_rNN.json wrapper written by the external "
                      "round driver around bench.py's stdout line",
            "rc": "external round-driver wrapper key",
            "ok": "external MULTICHIP_rNN.json wrapper key",
            "skipped": "external MULTICHIP_rNN.json wrapper key",
            "n_devices": "external MULTICHIP_rNN.json wrapper key",
            "last_known_good": "written by the JAX package's bench.py "
                               "into the committed BENCH_rNN.json rounds "
                               "that _round_points ingests; the port's "
                               "bench.py does not write it",
        },
        output_only={
            "last_rc": "retry breadcrumb on the health line for humans "
                       "tailing the round driver; _round_points reads "
                       "the wrapper's rc, not this echo",
            "by_impl": "each impl's best on the health line (the "
                       "ladder's auto, torch and cuda attempts), for "
                       "humans; the value is the consumed headline",
        },
        ingest="_round_points",
    ),
}

#: `write_raw({...literal...})` call sites that are NOT record
#: producers — qual -> reviewed reason (the selftest's write-site
#: coverage leg; anything else must be a declared producer)
WRITE_SITE_ALLOWLIST: dict[str, str] = {}

#: WRITER_REGISTRY modules exempt from the family tie-in: they host the
#: durable-write *mechanism*, not a record schema
_REGISTRY_EXEMPT = frozenset({"utils/durable.py"})

# --------------------------------------------------------------------------
# tree model


@dataclasses.dataclass
class _Tree:
    #: qual -> function AST node (nested defs are also indexed under
    #: their own name, concurrency-certifier style)
    funcs: dict[str, ast.AST]
    #: "rel::Class" -> AnnAssign field names, in declaration order
    classes: dict[str, list[str]]
    #: rel -> module-level constant name -> string constants under it
    str_consts: dict[str, dict[str, tuple[str, ...]]]
    #: (enclosing qual, lineno) of write_raw(<dict literal>) calls
    write_raw_sites: list[tuple[str, int]]
    #: module rels listed in faults/audit.WRITER_REGISTRY (AST-parsed)
    writer_registry: tuple[str, ...]


def _package_root() -> Path:
    return Path(__file__).resolve().parents[1]


def _scan_files(root: Path | None) -> list[tuple[str, Path]]:
    """(rel, path) pairs in scope. Real tree: the port's package only, its
    own round driver (`bench.py`) included; the repository's `scripts/`
    and root `bench.py` belong to the JAX package and are never scanned.
    Fixture trees are scanned whole, relative to their root."""
    base = _package_root() if root is None else root
    return sorted((p.relative_to(base).as_posix(), p)
                  for p in base.rglob("*.py"))


def _module_str_consts(mod: ast.Module) -> dict[str, tuple[str, ...]]:
    """Module-level `NAME = <literal>` whose literal contains string
    constants — the SPAN_NAMES / TERMINAL_STATES shape a validator
    references by name."""
    out: dict[str, tuple[str, ...]] = {}
    for node in mod.body:
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if value is None or not isinstance(
                value, (ast.Tuple, ast.List, ast.Set, ast.Dict, ast.Call)):
            continue
        strs = tuple(sorted({n.value for n in ast.walk(value)
                             if isinstance(n, ast.Constant)
                             and isinstance(n.value, str)}))
        if not strs:
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                out[tgt.id] = strs
    return out


def _registry_rels(mod: ast.Module) -> tuple[str, ...]:
    """Keys of the module-level WRITER_REGISTRY dict literal."""
    for node in mod.body:
        value = None
        if isinstance(node, ast.Assign):
            if any(isinstance(t, ast.Name) and t.id == "WRITER_REGISTRY"
                   for t in node.targets):
                value = node.value
        elif isinstance(node, ast.AnnAssign):
            if isinstance(node.target, ast.Name) \
                    and node.target.id == "WRITER_REGISTRY":
                value = node.value
        if isinstance(value, ast.Dict):
            return tuple(sorted(
                k.value for k in value.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)))
    return ()


def _index_tree(root: Path | None) -> _Tree:
    funcs: dict[str, ast.AST] = {}
    classes: dict[str, list[str]] = {}
    str_consts: dict[str, dict[str, tuple[str, ...]]] = {}
    write_sites: list[tuple[str, int]] = []
    registry: tuple[str, ...] = ()

    def walk_body(body: Iterable[ast.stmt], rel: str,
                  cls: str | None) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = (f"{rel}::{cls}.{node.name}" if cls
                        else f"{rel}::{node.name}")
                funcs[qual] = node
                for sub in ast.walk(node):
                    if (isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and sub.func.attr == "write_raw"
                            and sub.args
                            and isinstance(sub.args[0], ast.Dict)):
                        write_sites.append((qual, sub.lineno))
                walk_body(node.body, rel, cls)  # nested defs
            elif isinstance(node, ast.ClassDef):
                fields = [s.target.id for s in node.body
                          if isinstance(s, ast.AnnAssign)
                          and isinstance(s.target, ast.Name)]
                classes[f"{rel}::{node.name}"] = fields
                walk_body(node.body, rel, node.name)

    for rel, path in _scan_files(root):
        try:
            mod = ast.parse(path.read_text(errors="replace"))
        except (OSError, SyntaxError):
            continue
        str_consts[rel] = _module_str_consts(mod)
        if rel == "faults/audit.py":
            registry = _registry_rels(mod)
        walk_body(mod.body, rel, None)

    return _Tree(funcs, classes, str_consts, sorted(write_sites), registry)


# --------------------------------------------------------------------------
# per-function harvesters

#: call names whose result is structurally a scalar
_SCALAR_CALLS = frozenset({
    "round", "int", "float", "str", "bool", "len", "min", "max", "sum",
    "abs",
})

#: call names whose result is structurally a dict / a list
_DICT_CALLS = frozenset({"dict"})
_LIST_CALLS = frozenset({"list", "sorted", "tuple", "set"})


def _shape_of(node: ast.expr | None) -> str:
    """Coarse structural class of a written value: 'dict', 'list',
    'scalar', or 'unknown' (never conflicts). Conditionals, names, and
    attribute chains are unknown on purpose — SCHEMA-004 only fires on
    *provable* shape splits."""
    if node is None:
        return "unknown"
    if isinstance(node, (ast.Dict, ast.DictComp)):
        return "dict"
    if isinstance(node, (ast.List, ast.ListComp, ast.Tuple, ast.Set,
                         ast.SetComp, ast.GeneratorExp)):
        return "list"
    if isinstance(node, ast.Constant):
        return "unknown" if node.value is None else "scalar"
    if isinstance(node, ast.UnaryOp):
        return _shape_of(node.operand)
    if isinstance(node, (ast.JoinedStr, ast.Compare, ast.BoolOp)):
        return "scalar"
    if isinstance(node, ast.Call):
        name = ""
        if isinstance(node.func, ast.Name):
            name = node.func.id
        elif isinstance(node.func, ast.Attribute):
            name = node.func.attr
        if name in _SCALAR_CALLS:
            return "scalar"
        if name in _DICT_CALLS:
            return "dict"
        if name in _LIST_CALLS:
            return "list"
    return "unknown"


def _harvest_writes(fn: ast.AST,
                    rel: str) -> dict[str, dict[str, tuple[str, int]]]:
    """key -> {shape: first (rel, lineno) witness} for one producer."""
    out: dict[str, dict[str, tuple[str, int]]] = {}

    def add(key: str, shape: str, lineno: int) -> None:
        out.setdefault(key, {}).setdefault(shape, (rel, lineno))

    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    add(k.value, _shape_of(v), node.lineno)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                if isinstance(tgt, ast.Subscript) \
                        and isinstance(tgt.slice, ast.Constant) \
                        and isinstance(tgt.slice.value, str):
                    add(tgt.slice.value, _shape_of(getattr(node, "value",
                                                           None)),
                        node.lineno)
        elif isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Name) and func.id == "dict":
                for kw in node.keywords:
                    if kw.arg is not None:
                        add(kw.arg, _shape_of(kw.value), node.lineno)
            elif isinstance(func, ast.Attribute) \
                    and func.attr == "setdefault" and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                val = node.args[1] if len(node.args) > 1 else None
                add(node.args[0].value, _shape_of(val), node.lineno)
    return out


def _loop_key_vars(fn: ast.AST) -> dict[str, tuple[str, ...]]:
    """`for key in ("a", "b"):` loop variables -> their constant key
    sets. Function-scoped and name-keyed (no control-flow analysis): a
    reused loop-variable name unions its key sets, which for a read
    harvest only ever adds witnesses."""
    out: dict[str, tuple[str, ...]] = {}
    for node in ast.walk(fn):
        if not isinstance(node, (ast.For, ast.comprehension)):
            continue
        if not isinstance(node.target, ast.Name):
            continue
        it = node.iter
        if not isinstance(it, (ast.Tuple, ast.List, ast.Set)):
            continue
        keys = tuple(e.value for e in it.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str))
        if keys and len(keys) == len(it.elts):
            out[node.target.id] = out.get(node.target.id, ()) + keys
    return out


def _harvest_reads(fn: ast.AST, rel: str) -> dict[str, tuple[str, int]]:
    """key -> first (rel, lineno) witness of a consumer read."""
    out: dict[str, tuple[str, int]] = {}
    loop_keys = _loop_key_vars(fn)

    def add(key: str, lineno: int) -> None:
        out.setdefault(key, (rel, lineno))

    def add_expr(expr: ast.AST, lineno: int) -> None:
        """A key expression: a string constant, or a loop variable
        ranging over string constants (`for k in ("a", "b"): d[k]`)."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            add(expr.value, lineno)
        elif isinstance(expr, ast.Name) and expr.id in loop_keys:
            for key in loop_keys[expr.id]:
                add(key, lineno)

    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load):
            add_expr(node.slice, node.lineno)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("get", "pop") and node.args:
            add_expr(node.args[0], node.lineno)
        elif isinstance(node, ast.Compare) \
                and any(isinstance(op, (ast.In, ast.NotIn))
                        for op in node.ops):
            left = node.left
            if isinstance(left, ast.Constant) \
                    and isinstance(left.value, str):
                # identifier-shaped only: `"{" in series` is substring
                # search, not a key probe
                if left.value.isidentifier():
                    add(left.value, node.lineno)
            elif isinstance(left, ast.Name) and left.id in loop_keys:
                for key in loop_keys[left.id]:
                    add(key, node.lineno)
    return out


def _harvest_mentions(fn: ast.AST, rel: str, tree: _Tree) -> set[str]:
    """The validator coverage set: strict reads plus every string
    constant in tuple/list/set/dict literals in the body, plus the
    string contents of module-level constants the body names."""
    mentions = set(_harvest_reads(fn, rel))
    consts = tree.str_consts.get(rel, {})
    for node in ast.walk(fn):
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            mentions.update(n.value for n in ast.walk(node)
                            if isinstance(n, ast.Constant)
                            and isinstance(n.value, str))
        elif isinstance(node, ast.Dict):
            mentions.update(k.value for k in node.keys
                            if isinstance(k, ast.Constant)
                            and isinstance(k.value, str))
        elif isinstance(node, ast.Name) and node.id in consts:
            mentions.update(consts[node.id])
    return mentions


# --------------------------------------------------------------------------
# the rules


def _family_writes(tree: _Tree, fam: Family, *, validated_only: bool,
                   ) -> dict[str, dict[str, tuple[str, int]]]:
    """Merged key -> {shape: witness} over the family's producers
    (plus aux producers and dataclass fields unless validated_only)."""
    quals = fam.producers if validated_only \
        else fam.producers + fam.aux_producers
    merged: dict[str, dict[str, tuple[str, int]]] = {}
    for qual in quals:
        fn = tree.funcs.get(qual)
        if fn is None:
            continue  # the selftest's staleness leg reports it
        rel = qual.partition("::")[0]
        for key, shapes in _harvest_writes(fn, rel).items():
            slot = merged.setdefault(key, {})
            for shape, wit in shapes.items():
                slot.setdefault(shape, wit)
    if not validated_only:
        for cqual in fam.record_dataclasses:
            rel = cqual.partition("::")[0]
            for field in tree.classes.get(cqual, []):
                merged.setdefault(field, {}).setdefault("unknown", (rel, 0))
    return merged


def _family_reads(tree: _Tree, fam: Family, *, contract: bool,
                  ) -> dict[str, list[tuple[str, int]]]:
    """key -> read witnesses across the family's declared consumers.

    With contract=True, keys a consumer's own body also *writes* are
    dropped for that consumer: a function that builds a dict literal
    and reads it back (a severity-totals table, a per-state counter)
    is locally satisfied, not a record-contract read. The raw
    (contract=False) set is what SCHEMA-003 wants — any read anywhere
    proves a written key is load-bearing."""
    merged: dict[str, list[tuple[str, int]]] = {}
    for qual in fam.consumers:
        fn = tree.funcs.get(qual)
        if fn is None:
            continue
        rel = qual.partition("::")[0]
        self_written = set(_harvest_writes(fn, rel)) if contract else set()
        for key, wit in _harvest_reads(fn, rel).items():
            if key in self_written:
                continue
            merged.setdefault(key, []).append(wit)
    return merged


def schema_findings(
    root: str | Path | None = None, *,
    families: dict[str, Family] | None = None,
) -> list[Finding]:
    """SCHEMA-001..005 over the tree (the port's package by default;
    tests inject fixture trees plus their own family tables).
    Deterministic: findings sort by (rule, where,
    message), so two runs on one tree are byte-identical."""
    base = Path(root) if root is not None else None
    fams = RECORD_FAMILIES if families is None else families
    tree = _index_tree(base)

    writes = {name: _family_writes(tree, fam, validated_only=False)
              for name, fam in fams.items()}
    reads = {name: _family_reads(tree, fam, contract=True)
             for name, fam in fams.items()}
    global_written: set[str] = set()
    for keyed in writes.values():
        global_written.update(keyed)
    # SCHEMA-003's read universe: every raw consumer read plus every
    # validator read — a validator probing a key (reconciliation
    # checks) proves the key is load-bearing
    global_read: set[str] = set()
    for name, fam in fams.items():
        global_read.update(_family_reads(tree, fam, contract=False))
        for vqual in fam.validator:
            fn = tree.funcs.get(vqual)
            if fn is not None:
                global_read.update(
                    _harvest_reads(fn, vqual.partition("::")[0]))

    findings: list[Finding] = []
    for name in sorted(fams):
        fam = fams[name]

        # SCHEMA-001: consumer reads nothing writes
        for key in sorted(reads[name]):
            if key in global_written or key in fam.historical:
                continue
            wit = sorted(reads[name][key])[0]
            findings.append(Finding(
                "SCHEMA-001", f"{wit[0]}:{wit[1]}",
                f"family {name!r}: consumer reads key {key!r} that no "
                "declared producer writes — a KeyError or silent None "
                "waiting for the next ledger (write it, or declare it "
                "in the family's `historical` allowlist with a reason)",
                details={"family": name, "key": key,
                         "readers": sorted(
                             f"{r}:{ln}" for r, ln in reads[name][key])}))

        # SCHEMA-002: validator lags the schema-scoped producers
        if fam.validator:
            mentioned: set[str] = set()
            vrel = fam.validator[0].partition("::")[0]
            for vqual in fam.validator:
                fn = tree.funcs.get(vqual)
                if fn is not None:
                    mentioned |= _harvest_mentions(
                        fn, vqual.partition("::")[0], tree)
            scoped = _family_writes(tree, fam, validated_only=True)
            missing = sorted(set(scoped) - mentioned)
            if missing:
                findings.append(Finding(
                    "SCHEMA-002", vrel,
                    f"family {name!r}: validator "
                    f"{' + '.join(fam.validator)} does not cover "
                    f"statically-written key(s) {missing} — the "
                    "validator lags the producer",
                    details={"family": name, "missing": missing,
                             "validator": list(fam.validator)}))

        # SCHEMA-003: written, read nowhere, not declared output-only
        for key in sorted(writes[name]):
            if key in global_read or key in fam.output_only:
                continue
            shapes = writes[name][key]
            if set(shapes) == {"unknown"} \
                    and all(ln == 0 for _, ln in shapes.values()):
                continue  # dataclass field: attribute reads are invisible
            wit = sorted(writes[name][key].values())[0]
            findings.append(Finding(
                "SCHEMA-003", f"{wit[0]}:{wit[1]}",
                f"family {name!r}: key {key!r} is written but read by "
                "no declared consumer — dead weight in every ledger "
                "line (drop it, or declare it OUTPUT_ONLY with a "
                "reviewed reason)",
                details={"family": name, "key": key}))

        # SCHEMA-004: incompatible shapes across one family's producers
        for key in sorted(writes[name]):
            shapes = {s: w for s, w in writes[name][key].items()
                      if s != "unknown"}
            if len(shapes) > 1 and key not in fam.polymorphic:
                wits = sorted(f"{r}:{ln} ({s})"
                              for s, (r, ln) in shapes.items())
                wit = sorted(shapes.values())[0]
                findings.append(Finding(
                    "SCHEMA-004", f"{wit[0]}:{wit[1]}",
                    f"family {name!r}: key {key!r} is written with "
                    f"structurally incompatible shapes "
                    f"{sorted(shapes)} across producers — consumers "
                    f"cannot branch on luck ({', '.join(wits)})",
                    details={"family": name, "key": key,
                             "shapes": sorted(shapes),
                             "witnesses": wits}))

        # SCHEMA-005: durable family with no history route and no
        # declared reason
        if fam.durable and fam.ingest is None and fam.non_history is None:
            where = (fam.producers + fam.aux_producers
                     + fam.record_dataclasses + (name,))[0]
            findings.append(Finding(
                "SCHEMA-005", where.partition("::")[0],
                f"family {name!r} has a durable writer but no declared "
                "obs/history.py ingest route and no NON_HISTORY reason "
                "— the observatory's coverage contract requires one or "
                "the other",
                details={"family": name}))

    return sorted(findings, key=lambda f: (f.rule, f.where, f.message))


# --------------------------------------------------------------------------
# declaration hygiene (the selftest's staleness leg)


def declaration_problems(
        families: dict[str, Family] | None = None,
        tree: _Tree | None = None) -> list[str]:
    """Stale-table problems on the real tree: quals naming vanished
    surfaces, dead ingest routes, WRITER_REGISTRY modules with no
    declared family, and write_raw dict-literal sites outside every
    declared producer. Empty list = the table is live."""
    fams = RECORD_FAMILIES if families is None else families
    if tree is None:
        tree = _index_tree(None)
    problems: list[str] = []

    declared_producers: set[str] = set(WRITE_SITE_ALLOWLIST)
    producer_rels: set[str] = set()
    for name in sorted(fams):
        fam = fams[name]
        for qual in (fam.producers + fam.aux_producers + fam.validator
                     + fam.consumers):
            if qual not in tree.funcs:
                problems.append(
                    f"family {name!r}: declared surface {qual} does not "
                    "exist")
        for cqual in fam.record_dataclasses:
            if cqual not in tree.classes:
                problems.append(
                    f"family {name!r}: declared record dataclass "
                    f"{cqual} does not exist")
            elif not tree.classes[cqual]:
                problems.append(
                    f"family {name!r}: record dataclass {cqual} has no "
                    "annotated fields to harvest")
        declared_producers.update(fam.producers + fam.aux_producers)
        producer_rels.update(
            q.partition("::")[0]
            for q in fam.producers + fam.aux_producers
            + fam.record_dataclasses)
        if fam.ingest is not None:
            iqual = f"obs/history.py::{fam.ingest}"
            mqual = f"obs/history.py::HistoryStore.{fam.ingest}"
            if iqual not in tree.funcs and mqual not in tree.funcs:
                problems.append(
                    f"family {name!r}: ingest route {fam.ingest!r} is "
                    "not a function in obs/history.py")

    if not tree.writer_registry:
        problems.append("faults/audit.WRITER_REGISTRY not found — the "
                        "durable-writer seed list is gone")
    for rel in tree.writer_registry:
        if rel in _REGISTRY_EXEMPT:
            continue
        if rel not in producer_rels:
            problems.append(
                f"WRITER_REGISTRY module {rel} hosts a durable writer "
                "but no RECORD_FAMILIES entry declares a producer or "
                "record dataclass in it")

    for qual, lineno in tree.write_raw_sites:
        if qual not in declared_producers:
            problems.append(
                f"write_raw dict-literal call at {qual}:{lineno} is not "
                "inside a declared producer (add the enclosing function "
                "to a family, or to WRITE_SITE_ALLOWLIST with a reason)")
    return problems


# --------------------------------------------------------------------------
# selftest (`lint schema selftest`)

#: (rule, {filename: source}, broken family table, repaired table) —
#: each fixture trips exactly its rule; its repaired twin scans clean.
_SELFTEST_FIXTURES: tuple[
        tuple[str, dict[str, str], dict[str, Family],
              dict[str, Family]], ...] = (
    ("SCHEMA-001",
     {"producer.py": "def make():\n    return {'alpha': 1.0}\n",
      "consumer.py": "def read(rec):\n    return rec['beta']\n"},
     {"demo": Family(producers=("producer.py::make",),
                     consumers=("consumer.py::read",),
                     output_only={"alpha": "fixture: written for the "
                                           "repaired twin"},
                     durable=False)},
     {"demo": Family(producers=("producer.py::make",),
                     consumers=("consumer.py::read_ok",),
                     durable=False)}),
    ("SCHEMA-002",
     {"producer.py": "def make():\n"
                     "    return {'alpha': 1.0, 'beta': 2.0}\n",
      "consumer.py": "def read(rec):\n"
                     "    return rec['alpha'], rec['beta']\n",
      "check.py": "def validate(rec):\n"
                  "    return [k for k in ('alpha',) if k not in rec]\n"
                  "def validate_full(rec):\n"
                  "    return [k for k in ('alpha', 'beta')\n"
                  "            if k not in rec]\n"},
     {"demo": Family(producers=("producer.py::make",),
                     validator=("check.py::validate",),
                     consumers=("consumer.py::read",),
                     durable=False)},
     {"demo": Family(producers=("producer.py::make",),
                     validator=("check.py::validate_full",),
                     consumers=("consumer.py::read",),
                     durable=False)}),
    ("SCHEMA-003",
     {"producer.py": "def make():\n"
                     "    return {'alpha': 1.0, 'beta': 2.0}\n",
      "consumer.py": "def read(rec):\n    return rec['alpha']\n"},
     {"demo": Family(producers=("producer.py::make",),
                     consumers=("consumer.py::read",),
                     durable=False)},
     {"demo": Family(producers=("producer.py::make",),
                     consumers=("consumer.py::read",),
                     output_only={"beta": "debug counter for offline "
                                          "tooling"},
                     durable=False)}),
    ("SCHEMA-004",
     {"producer.py": "def make():\n"
                     "    return {'alpha': 1.0}\n"
                     "def make_nested():\n"
                     "    return {'alpha': {'x': 1.0}}\n",
      "consumer.py": "def read(rec):\n"
                     "    return rec['alpha'], rec['alpha']['x']\n"},
     {"demo": Family(producers=("producer.py::make",
                                "producer.py::make_nested"),
                     consumers=("consumer.py::read",),
                     durable=False)},
     {"demo": Family(producers=("producer.py::make",
                                "producer.py::make_nested"),
                     consumers=("consumer.py::read",),
                     polymorphic=("alpha",),
                     durable=False)}),
    ("SCHEMA-005",
     {"producer.py": "def make():\n    return {'alpha': 1.0}\n",
      "consumer.py": "def read(rec):\n    return rec['alpha']\n"},
     {"demo": Family(producers=("producer.py::make",),
                     consumers=("consumer.py::read",),
                     durable=True)},
     {"demo": Family(producers=("producer.py::make",),
                     consumers=("consumer.py::read",),
                     durable=True,
                     non_history="fixture stream: liveness only")}),
)

# SCHEMA-001's repaired twin reads a key that exists; give it a body
_FIXTURE_EXTRA = {
    "SCHEMA-001": {"consumer.py": "def read_ok(rec):\n"
                                  "    return rec['alpha']\n"},
}


def run_schema_selftest() -> list[Any]:
    """`lint schema selftest`: (1) the real tree must certify clean
    (warns included — OUTPUT_ONLY entries are reviewed declarations,
    not suppressions), (2) each seeded SCHEMA-001..005 fixture must
    trip exactly its rule with its registered severity and its repaired
    twin must scan clean, (3) two consecutive real-tree passes must
    render byte-identical findings, and (4) the RECORD_FAMILIES table
    must not have rotted (every declared surface lives, every
    WRITER_REGISTRY module is covered, every write_raw dict-literal
    site is a declared producer). Exits nonzero on any violation."""
    from tpu_matmul_bench_torch.analysis.findings import RULES

    # utils.reporting imports torch; this selftest runs without it, so
    # it prints its header block directly
    bar = "=" * 60
    print("\n".join([
        bar, "Schema-flow lint selftest", bar, "Configuration:",
        "  - Scope: the tpu_matmul_bench_torch package",
        "  - Rules: SCHEMA-001..005",
        f"  - Record families: {len(RECORD_FAMILIES)}", bar,
    ]))

    problems: list[str] = []

    tree_findings = schema_findings()
    problems.extend(
        f"real tree: {f.rule} at {f.where}: {f.message}"
        for f in tree_findings)

    second = schema_findings()
    if json.dumps([f.to_record() for f in second]) != \
            json.dumps([f.to_record() for f in tree_findings]):
        problems.append("nondeterministic findings: two consecutive "
                        "passes over one tree differ")

    with tempfile.TemporaryDirectory(prefix="schema-seeded-") as td:
        for rule, sources, broken, repaired in _SELFTEST_FIXTURES:
            fdir = Path(td) / rule.lower()
            fdir.mkdir()
            merged = dict(sources)
            for fname, extra in _FIXTURE_EXTRA.get(rule, {}).items():
                merged[fname] = merged.get(fname, "") + extra
            for fname, src in merged.items():
                (fdir / fname).write_text(src)
            got = schema_findings(fdir, families=broken)
            fired = {f.rule for f in got}
            if rule not in fired:
                problems.append(
                    f"seeded {rule} fixture did not fire "
                    f"(got {sorted(fired)})")
            for f in got:
                if f.rule == rule and f.severity != RULES[rule][0]:
                    problems.append(
                        f"seeded {rule} fired at severity "
                        f"{f.severity!r}, registered {RULES[rule][0]!r}")
            clean = schema_findings(fdir, families=repaired)
            if clean:
                problems.append(
                    f"repaired {rule} twin is not clean: "
                    f"{[(f.rule, f.message) for f in clean][:2]}")

    problems.extend(f"stale table: {p}" for p in declaration_problems())

    if problems:
        for p in problems:
            print(f"schema selftest FAILED: {p}", file=sys.stderr)
        raise SystemExit(1)
    print(f"schema selftest ok: {len(RECORD_FAMILIES)} record families "
          f"certify clean, {len(_SELFTEST_FIXTURES)} seeded rules fire "
          "with registered severities (repaired twins clean), findings "
          "deterministic, declaration table live")
    return [f.to_record() for f in tree_findings]
