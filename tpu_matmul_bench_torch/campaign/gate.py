"""Regression gate: compare a campaign against a baseline, exit nonzero
on regression — the single pass/fail a CI job consumes.

Port of `tpu_matmul_bench/campaign/gate.py`: the same verdicts, tolerances
and exit codes on the same summaries, and the same baseline snapshot
bytes. `serve ab`'s verdict (`serve/service.py _ab_verdict`) takes its
tolerance from `tolerance_pct` here.

Comparison is fingerprint-to-fingerprint (same program, same argv — the
identity `spec.job_fingerprint` hashes), so only like measurements are
ever compared; jobs present on one side only are reported, and a job the
BASELINE measured that the current campaign lost is itself a failure (a
campaign must not pass by dropping its slowest rows).

The threshold is noise-aware: a job regresses only when its headline
throughput falls more than ``max(threshold, noise_floor, 2·noise_pct)``
below baseline, where `noise_pct` is the per-iteration sample jitter
(`extras["samples"]`, when either side ran `--samples`) and the floor is
the JAX package's drift floor, kept as the gate's rule: a wobble inside
the instrument's drift must not page anyone, a real 5% loss must. The
card's own run-to-run drift of a campaign job is measured by
`chip_smoke.py`'s campaign phase (PERF.md §6).

Serve jobs gate on **p99 latency** (their summary rows carry
`p99_latency_ms`): the same tolerance machinery, with the failing
direction flipped — latency regresses UP. Their `noise_pct` is the serve
harness's capped half-split p99 estimate, not sample stddev/p50 (a
latency distribution under Poisson load is load-spread, not instrument
jitter).

Baselines: another campaign directory, or a baseline snapshot JSON
(written by ``campaign gate --write-baseline BASELINE_CAMPAIGN.json``) so
a round's blessed numbers can be checked in and gated against without
carrying the whole campaign dir.

Exit codes (``campaign gate``): 0 = pass; 1 = regression or lost job;
2 = unusable input (no overlapping fingerprints, unreadable dirs).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

from tpu_matmul_bench_torch.campaign.store import CampaignStore

# the drift floor: no gate is tighter than the instrument (the JAX
# package's value, kept as the rule; the card's measured drift of a
# campaign job is in PERF.md §6)
NOISE_FLOOR_PCT = 1.5
DEFAULT_THRESHOLD_PCT = 5.0

BASELINE_KIND = "campaign_baseline"

EXIT_PASS = 0
EXIT_REGRESSION = 1
EXIT_UNUSABLE = 2


THROUGHPUT_METRIC = "tflops_per_device"  # higher is better
LATENCY_METRIC = "p99_latency_ms"  # lower is better (serve jobs)
# serve jobs also gate on SLO attainment: the WORST per-tenant p99-budget
# attainment (percentage of completions within budget; store.py computes
# the min over tenants). Compared in absolute percentage points with the
# same noise-aware tolerance — a scheduler change that keeps headline p99
# but trades one tenant's SLO misses for another's is a regression.
SLO_METRIC = "slo_attainment_pct"  # higher is better (serve jobs)


@dataclasses.dataclass
class GateRow:
    fingerprint: str
    job_id: str
    verdict: str  # 'ok' | 'regression' | 'missing' | 'new'
    baseline: float | None = None
    current: float | None = None
    delta_pct: float | None = None
    tolerance_pct: float | None = None
    metric: str = THROUGHPUT_METRIC

    def format(self) -> str:
        unit = {LATENCY_METRIC: " ms p99",
                SLO_METRIC: " % SLO"}.get(self.metric, "")
        if self.verdict == "new":
            return (f"  NEW        {self.job_id}: {self.current:.2f}{unit} "
                    "(no baseline row)")
        if self.verdict == "missing":
            return (f"  MISSING    {self.job_id}: baseline has "
                    f"{self.baseline:.2f}{unit}, campaign has no result")
        tag = "REGRESSION" if self.verdict == "regression" else "ok"
        return (f"  {tag:<10} {self.job_id}: {self.baseline:.2f} → "
                f"{self.current:.2f}{unit} ({self.delta_pct:+.2f}%, "
                f"tolerance ±{self.tolerance_pct:.2f}%)")


@dataclasses.dataclass
class GateReport:
    rows: list[GateRow]
    exit_code: int

    @property
    def passed(self) -> bool:
        return self.exit_code == EXIT_PASS

    def format(self) -> str:
        order = {"regression": 0, "missing": 1, "new": 2, "ok": 3}
        lines = [r.format() for r in
                 sorted(self.rows, key=lambda r: (order[r.verdict],
                                                  r.job_id))]
        n_bad = sum(r.verdict in ("regression", "missing")
                    for r in self.rows)
        lines.append(f"gate: {'PASS' if self.exit_code == EXIT_PASS else 'FAIL'}"
                     f" ({len(self.rows)} compared, {n_bad} failing,"
                     f" exit {self.exit_code})")
        return "\n".join(lines)


def load_summary(path: str | Path) -> dict[str, dict[str, Any]]:
    """A gate side: a campaign directory, or a baseline snapshot JSON."""
    p = Path(path)
    if p.is_dir():
        return CampaignStore.load(p).summary()
    try:
        data = json.loads(p.read_text())
    except (OSError, ValueError) as e:
        raise RuntimeError(f"unreadable baseline {p}: {e}") from e
    if not isinstance(data, dict) or data.get("kind") != BASELINE_KIND \
            or not isinstance(data.get("jobs"), dict):
        raise RuntimeError(
            f"{p} is not a campaign baseline snapshot "
            f'(expected {{"kind": "{BASELINE_KIND}", "jobs": ...}})')
    return data["jobs"]


def write_baseline(summary: dict[str, dict[str, Any]],
                   path: str | Path) -> None:
    """Snapshot a campaign's summary as a checked-in-able baseline."""
    payload = {"kind": BASELINE_KIND, "schema_version": 1, "jobs": summary}
    Path(path).write_text(json.dumps(payload, indent=2, sort_keys=True)
                          + "\n")


def history_baseline(campaign_dir: str | Path,
                     store_path: str | None = None,
                     ) -> dict[str, dict[str, Any]]:
    """A gate baseline synthesized from the metric-history store
    (``campaign gate --history``): per campaign job, the last-known-good
    of its headline series across prior ingest rounds — so the gate
    compares against the repo's whole measured past instead of one
    hand-picked snapshot file. Jobs with no prior history gate as 'new';
    a job the past measured but this campaign dropped is NOT detectable
    here (history has no notion of this campaign's intended job set) —
    use --baseline for lost-job coverage."""
    from tpu_matmul_bench_torch.obs.history import (
        HistoryStore,
        baseline_rows_for_campaign,
    )

    store = HistoryStore.load(store_path)
    if len(store) == 0:
        raise RuntimeError(
            f"history store {store.path} is empty or missing — run "
            "`obs ingest` (or python -m tpu_matmul_bench_torch.obs.regen) "
            "first")
    return baseline_rows_for_campaign(store, campaign_dir)


def tolerance_pct(threshold_pct: float,
                  baseline_row: dict[str, Any],
                  current_row: dict[str, Any]) -> float:
    """The noise-aware allowance for one job: the configured threshold,
    never tighter than the drift floor, widened to 2× the measured
    per-iteration jitter when either side sampled it."""
    noises = [r.get("noise_pct") for r in (baseline_row, current_row)
              if isinstance(r.get("noise_pct"), (int, float))]
    measured = max(noises) if noises else 0.0
    return max(threshold_pct, NOISE_FLOOR_PCT, 2.0 * measured)


def _metric_for(*rows: dict[str, Any] | None) -> str:
    """The comparison metric for a fingerprint: latency when EVERY present
    side carries the serve headline (`p99_latency_ms`), else throughput.
    Fingerprints hash (program, argv), so mixed sides only occur against a
    pre-serve baseline snapshot — which gates on throughput, the metric
    both sides have."""
    present = [r for r in rows if r is not None]
    if present and all(isinstance(r.get(LATENCY_METRIC), (int, float))
                       for r in present):
        return LATENCY_METRIC
    return THROUGHPUT_METRIC


def run_gate(current: dict[str, dict[str, Any]],
             baseline: dict[str, dict[str, Any]],
             *, threshold_pct: float = DEFAULT_THRESHOLD_PCT) -> GateReport:
    rows: list[GateRow] = []
    for fp, base in sorted(baseline.items(),
                           key=lambda kv: kv[1].get("job_id", kv[0])):
        cur = current.get(fp)
        metric = _metric_for(base, cur)
        b = base.get(metric)
        if cur is None or not isinstance(cur.get(metric), (int, float)):
            rows.append(GateRow(fp, base.get("job_id", fp), "missing",
                                baseline=b, metric=metric))
            continue
        c = cur[metric]
        if not isinstance(b, (int, float)) or b <= 0:
            rows.append(GateRow(fp, base.get("job_id", fp), "new",
                                current=c, metric=metric))
            continue
        tol = tolerance_pct(threshold_pct, base, cur)
        delta = 100.0 * (c - b) / b
        # latency regresses UP, throughput regresses DOWN — same noise-
        # aware tolerance, opposite failing direction
        if metric == LATENCY_METRIC:
            verdict = "regression" if delta > tol else "ok"
        else:
            verdict = "regression" if delta < -tol else "ok"
        job_id = cur.get("job_id") or base.get("job_id", fp)
        rows.append(GateRow(fp, job_id,
                            verdict, baseline=b, current=c,
                            delta_pct=delta, tolerance_pct=tol,
                            metric=metric))
        # serve fingerprints carry a second verdict: worst-tenant SLO
        # attainment, in absolute percentage points (delta_pct here IS
        # points — attainment is already a percentage)
        bs, cs = base.get(SLO_METRIC), cur.get(SLO_METRIC)
        if metric == LATENCY_METRIC \
                and isinstance(bs, (int, float)) \
                and isinstance(cs, (int, float)):
            pts = cs - bs
            rows.append(GateRow(
                fp, job_id,
                "regression" if pts < -tol else "ok",
                baseline=bs, current=cs, delta_pct=pts,
                tolerance_pct=tol, metric=SLO_METRIC))
    for fp, cur in sorted(current.items(),
                          key=lambda kv: kv[1].get("job_id", kv[0])):
        if fp not in baseline:
            metric = _metric_for(cur, None)
            rows.append(GateRow(fp, cur.get("job_id", fp), "new",
                                current=cur.get(metric), metric=metric))
    compared = [r for r in rows if r.verdict in ("ok", "regression")]
    if not compared:
        return GateReport(rows, EXIT_UNUSABLE)
    failing = any(r.verdict in ("regression", "missing") for r in rows)
    return GateReport(rows, EXIT_REGRESSION if failing else EXIT_PASS)
