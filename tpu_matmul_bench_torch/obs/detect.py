"""Noise-aware drift detection over the metric-history store.

Port of `tpu_matmul_bench/obs/detect.py` (stdlib only), over the port's
store, findings, gate floor and TOML reader; its default spec is
``specs/torch/history.toml``, whose store is the port's.

Generalizes the campaign gate's statistics from one pairwise
baseline-vs-current comparison to every series in
``measurements/torch/history.jsonl``: per-fingerprint changepoint verdicts,
emitted as `analysis/findings.py` findings with stable IDs so CI can
grep them —

- **HIST-001** (error): the latest round's best reading regressed beyond
  noise against the last-known-good of earlier rounds.
- **HIST-002** (warn): the latest reading *improved* beyond noise — real
  progress the recorded last-known-good (baseline file, tune DB) does
  not reflect yet; update it or lose the evidence.
- **HIST-003** (warn): a recurring series has gone stale — no successful
  ingest for N rounds; the repo stopped measuring something it used to
  measure.
- **HIST-004** (error): the analytic-vs-measured residual of a
  (mode × wire-format × shape) cell moved beyond noise — the model
  stopped explaining the machine.

Statistics mirror the gate (`campaign/gate.tolerance_pct`): the
tolerance band is the max of the configured threshold, the 1.5% noise
floor, and twice the observed noise — where observed noise is the larger
of the points' own recorded jitter and a half-split estimate over the
series' per-round best values (the `serve/service._p99_noise_pct`
statistic applied to rounds instead of latencies). Comparisons only ever
cross **distinct ingest rounds**: points of one series inside one round
are concurrent evidence (a sweep's candidates, a rerun pair) ranked
best-of, never a trajectory.

Detection windows live in ``specs/torch/history.toml`` ([history] table) and
are overridable per-invocation (`obs detect --detect-window ...`).
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any

from tpu_matmul_bench_torch.analysis.findings import Finding
from tpu_matmul_bench_torch.campaign.gate import NOISE_FLOOR_PCT
from tpu_matmul_bench_torch.obs.history import (
    LOWER_BETTER_METRICS,
    HistoryStore,
)

#: cap on the half-split series-noise estimate, mirroring
#: serve.service.P99_NOISE_CAP_PCT — one wild round must not widen the
#: band into meaninglessness
SERIES_NOISE_CAP_PCT = 15.0

#: series kinds exempt from drift verdicts: tune candidate sweeps are
#: exploration — individual candidate timings jitter far beyond the
#: bench band and the tune DB's 1%-tie promotion gate already owns
#: ranking them; only promoted winners (which re-measure as bench /
#: serve cells) are tracked
EXPLORATORY_KINDS = frozenset({"tune"})

#: metrics with no "better" direction — a tail-composition share
#: drifting either way beyond the band is a shift in WHERE the tail's
#: latency goes (e.g. execute-dominated → queue-dominated), which is a
#: regression signal in both directions, never an improvement
SYMMETRIC_METRICS = frozenset({"tail_share_pct"})

#: [history] table vocabulary in specs/torch/history.toml
HISTORY_SPEC_KEYS = ("store", "detect_window", "min_rounds",
                     "threshold_pct", "stale_rounds",
                     "residual_threshold_pct")


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """Detection windows; defaults match specs/torch/history.toml."""

    detect_window: int = 8       # most recent ingest rounds considered
    min_rounds: int = 2          # distinct rounds needed for a verdict
    threshold_pct: float = 5.0   # gate.DEFAULT_THRESHOLD_PCT
    stale_rounds: int = 3        # HIST-003 trigger
    residual_threshold_pct: float = 10.0  # HIST-004 floor (abs pp shift)
    store: str | None = None     # store path the spec points at


def load_config(path: str, *,
                overrides: dict[str, Any] | None = None) -> DetectConfig:
    """DetectConfig from a specs/torch/history.toml [history] table, with CLI
    overrides applied last. Raises ValueError on a malformed spec (the
    runtime twin of spec lint's SPEC-001)."""
    from tpu_matmul_bench_torch.campaign.spec import _parse_toml

    with open(path) as fh:
        data = _parse_toml(fh.read())
    table = data.get("history")
    if not isinstance(table, dict):
        raise ValueError(f"{path}: expected a [history] table")
    merged = dict(table)
    merged.update(overrides or {})
    return config_from_table(merged, where=path)


def config_from_table(table: dict[str, Any], *,
                      where: str = "<history>") -> DetectConfig:
    cfg: dict[str, Any] = {}
    for key, value in table.items():
        if key not in HISTORY_SPEC_KEYS:
            raise ValueError(f"{where}: unknown [history] key {key!r}")
        if value is None:
            continue
        if key == "store":
            cfg[key] = str(value)
        elif key in ("detect_window", "min_rounds", "stale_rounds"):
            iv = int(value)
            if iv < 1 or iv != value:
                raise ValueError(f"{where}: {key} must be a positive "
                                 f"integer, got {value!r}")
            cfg[key] = iv
        else:
            fv = float(value)
            if fv <= 0:
                raise ValueError(f"{where}: {key} must be positive, "
                                 f"got {value!r}")
            cfg[key] = fv
    return DetectConfig(**cfg)


def series_noise_pct(values: list[float]) -> float:
    """Half-split noise over a series' per-round best values — the
    serve-loop p99 statistic lifted to rounds: half the relative gap
    between the medians of the first and second halves, capped. Fewer
    than 4 rounds estimate nothing (returns 0; the floor + per-point
    noise still apply), so young series keep the gate's static band."""
    if len(values) < 4:
        return 0.0
    mid = len(values) // 2
    lo = statistics.median(values[:mid])
    hi = statistics.median(values[mid:])
    anchor = statistics.median(values)
    if not anchor:
        return 0.0
    return min(abs(hi - lo) / abs(anchor) * 100.0 / 2.0,
               SERIES_NOISE_CAP_PCT)


def tolerance_pct(cfg: DetectConfig, *, point_noise: float,
                  series_noise: float) -> float:
    """The gate's band shape: threshold vs noise floor vs 2× observed."""
    return max(cfg.threshold_pct, NOISE_FLOOR_PCT,
               2.0 * point_noise, 2.0 * series_noise)


def _num(v: Any) -> float | None:
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else None


def _series_label(points: list[dict[str, Any]]) -> str:
    """Human-readable series identity for `where` strings: the stable
    fingerprint plus the labels that distinguish it."""
    labels = points[-1].get("labels") or {}
    sid = str(points[-1].get("series", ""))[:8]
    parts = [str(labels.get("kind", "?"))]
    for key in ("harness", "benchmark", "mode", "size", "dtype", "world",
                "backend", "comm_quant", "blocks", "mix", "scheduler",
                "qps", "cell", "n_devices", "component"):
        val = labels.get(key)
        if val in (None, "", "none", 1):
            continue
        parts.append(f"{key}={val}")
    return f"{sid} ({' '.join(parts)}, metric={points[-1].get('metric')})"


def _best_per_round(points: list[dict[str, Any]],
                    lower_better: bool) -> dict[int, dict[str, Any]]:
    """Round → best ok point. Within one ingest round every point is a
    concurrent measurement of the same cell; best-of is the reading."""
    out: dict[int, dict[str, Any]] = {}
    for p in points:
        if p.get("status") != "ok" or _num(p.get("value")) is None:
            continue
        seq = int(p.get("ingest_seq") or 0)
        cur = out.get(seq)
        if cur is None or ((p["value"] < cur["value"]) if lower_better
                           else (p["value"] > cur["value"])):
            out[seq] = p
    return out


def detect_findings(store: HistoryStore,
                    cfg: DetectConfig | None = None) -> list[Finding]:
    """All drift verdicts for the store, ordered by series id."""
    cfg = cfg or DetectConfig()
    findings: list[Finding] = []
    max_round = store.max_seq()
    for sid, points in store.series().items():
        kind = (points[-1].get("labels") or {}).get("kind")
        if kind in EXPLORATORY_KINDS:
            continue
        findings.extend(_series_findings(sid, points, cfg, max_round))
    return findings


def _series_findings(sid: str, points: list[dict[str, Any]],
                     cfg: DetectConfig, max_round: int) -> list[Finding]:
    label = _series_label(points)
    metric = str(points[-1].get("metric"))
    lower = metric in LOWER_BETTER_METRICS
    by_round = _best_per_round(points, lower)
    rounds = sorted(by_round)
    all_rounds = {int(p.get("ingest_seq") or 0) for p in points}

    out: list[Finding] = []

    # HIST-003: a series the repo measured more than once has stopped
    # producing ok readings — staleness measured in ingest rounds
    last_ok = rounds[-1] if rounds else 0
    if len(all_rounds) >= 2 and max_round - last_ok >= cfg.stale_rounds:
        out.append(Finding(
            "HIST-003", label,
            f"no successful measurement since ingest round {last_ok} "
            f"(store is at round {max_round}, stale_rounds="
            f"{cfg.stale_rounds}) — the repo stopped measuring this cell",
            details={"series": sid, "last_ok_round": last_ok,
                     "store_round": max_round}))

    if len(rounds) < cfg.min_rounds:
        return out

    window = rounds[-cfg.detect_window:]
    latest = by_round[window[-1]]
    prior = [by_round[r] for r in window[:-1]]
    if not prior:
        return out

    # last-known-good: the best reading across all prior rounds in the
    # window — the same estimator BENCH_r04's fallback machinery records
    pick = min if lower else max
    lkg = pick(prior, key=lambda p: p["value"])
    if lkg["value"]:
        delta_pct = 100.0 * (latest["value"] - lkg["value"]) / abs(lkg["value"])
        point_noise = max(_num(latest.get("noise_pct")) or 0.0,
                          _num(lkg.get("noise_pct")) or 0.0)
        snoise = series_noise_pct([by_round[r]["value"] for r in window])
        tol = tolerance_pct(cfg, point_noise=point_noise,
                            series_noise=snoise)
        if metric in SYMMETRIC_METRICS:
            # composition shares: any beyond-band move is a shift in
            # the tail's cause, flagged as a regression either way
            regressed = abs(delta_pct) > tol
            improved = False
        else:
            regressed = delta_pct > tol if lower else delta_pct < -tol
            improved = delta_pct < -tol if lower else delta_pct > tol
        details = {"series": sid, "metric": metric,
                   "latest": latest["value"], "latest_round": window[-1],
                   "last_known_good": lkg["value"],
                   "lkg_round": int(lkg.get("ingest_seq") or 0),
                   "lkg_source": lkg.get("source"),
                   "delta_pct": round(delta_pct, 3),
                   "tolerance_pct": round(tol, 3)}
        if regressed:
            verb = "shifted" if metric in SYMMETRIC_METRICS \
                else "regressed"
            out.append(Finding(
                "HIST-001", label,
                f"{metric} {verb} {abs(delta_pct):.2f}% beyond the "
                f"{tol:.2f}% noise band vs last-known-good "
                f"{lkg['value']:.4g} (round {details['lkg_round']}, "
                f"{lkg.get('source')})",
                details=details))
        elif improved:
            out.append(Finding(
                "HIST-002", label,
                f"{metric} improved {abs(delta_pct):.2f}% beyond the "
                f"{tol:.2f}% noise band vs last-known-good "
                f"{lkg['value']:.4g} — promote it (gate baseline / "
                f"tune DB) or the evidence rots",
                details=details))

    out.extend(_residual_findings(sid, label, by_round, window, cfg))
    return out


def _residual_findings(sid: str, label: str,
                       by_round: dict[int, dict[str, Any]],
                       window: list[int],
                       cfg: DetectConfig) -> list[Finding]:
    """HIST-004: the analytic model's residual fraction for this cell
    shifted. Judged in absolute percentage points of run time against the
    median of prior rounds — the residual is already a normalized
    quantity, so its own half-split noise (in pp) widens the band."""
    rows = [(r, _num(by_round[r].get("residual_pct"))) for r in window]
    rows = [(r, v) for r, v in rows if v is not None]
    if len(rows) < max(cfg.min_rounds, 2) or rows[-1][0] != window[-1]:
        return []
    latest_round, latest_res = rows[-1]
    prior = [v for _, v in rows[:-1]]
    base = statistics.median(prior)
    shift = abs(latest_res - base)
    spread = statistics.median([abs(v - base) for v in prior])
    band = max(cfg.residual_threshold_pct, 2.0 * spread)
    if shift <= band:
        return []
    return [Finding(
        "HIST-004", label,
        f"analytic-vs-measured residual moved {shift:.2f}pp (now "
        f"{latest_res:.2f}% of run time, prior median {base:.2f}%) "
        f"beyond the {band:.2f}pp band — the compute+comm model stopped "
        f"explaining this cell",
        details={"series": sid, "latest_residual_pct": latest_res,
                 "latest_round": latest_round,
                 "prior_median_pct": round(base, 3),
                 "shift_pp": round(shift, 3), "band_pp": round(band, 3)})]


# ------------------------------------------------------------- spec lint

def lint_history_data(data: dict[str, Any], where: str) -> list[Finding]:
    """spec_lint entry for a standalone [history] detection-window spec:
    SPEC-002 for unknown keys, SPEC-001 for values the loader would
    reject at run time."""
    findings: list[Finding] = []
    table = data.get("history")
    if not isinstance(table, dict):
        return [Finding("SPEC-001", where,
                        "[history] must be a table of detection windows")]
    for key in sorted(set(table) - set(HISTORY_SPEC_KEYS)):
        findings.append(Finding(
            "SPEC-002", where,
            f"unknown [history] key {key!r} (known: "
            f"{', '.join(HISTORY_SPEC_KEYS)})",
            details={"key": key}))
    try:
        config_from_table({k: v for k, v in table.items()
                           if k in HISTORY_SPEC_KEYS}, where=where)
    except (ValueError, TypeError) as e:
        findings.append(Finding("SPEC-001", where, str(e)))
    return findings
