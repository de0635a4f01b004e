"""Markdown perf-trajectory report over the metric-history store.

Port of `tpu_matmul_bench/obs/report.py` (stdlib only): the same markdown
from the same store.

`python -m tpu_matmul_bench_torch obs report` renders what the repo used to
ask a human to do by diffing BENCH_r*.json files: the round-by-round
headline, per-mode sparkline tables (best reading per ingest round for
every (mode × backend × dtype) group), serve latency trajectories,
fault-audit pass rates, attribution residuals, and the current drift
verdicts from `obs/detect.py`.

Tables follow the `scripts/digest_jsonl.py` house style (pipe-markdown,
best-of ranking); sparklines are the eight-step block ramp with ``·``
for rounds where the cell had no successful reading — an outage is part
of the trajectory, not a gap to hide.
"""

from __future__ import annotations

from typing import Any

from tpu_matmul_bench_torch.obs.detect import DetectConfig, detect_findings
from tpu_matmul_bench_torch.obs.history import (
    LOWER_BETTER_METRICS,
    HistoryStore,
)

_SPARK = "▁▂▃▄▅▆▇█"
_GAP = "·"


def sparkline(values: list[float | None]) -> str:
    """Eight-level sparkline; None renders as the gap glyph."""
    present = [v for v in values if v is not None]
    if not present:
        return _GAP * len(values)
    lo, hi = min(present), max(present)
    span = hi - lo
    out = []
    for v in values:
        if v is None:
            out.append(_GAP)
        elif span <= 0:
            out.append(_SPARK[-1])
        else:
            out.append(_SPARK[min(int((v - lo) / span * 7.999), 7)])
    return "".join(out)


def _num(v: Any) -> float | None:
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else None


def _fmt(v: float | None) -> str:
    if v is None:
        return "—"
    if abs(v) >= 100:
        return f"{v:.1f}"
    return f"{v:.3g}"


def _trajectory(points: list[dict[str, Any]], rounds: list[int],
                lower: bool) -> list[float | None]:
    """Best ok value per ingest round, None where the round went dark."""
    by_round: dict[int, float] = {}
    for p in points:
        if p.get("status") != "ok":
            continue
        v = _num(p.get("value"))
        if v is None:
            continue
        seq = int(p.get("ingest_seq") or 0)
        cur = by_round.get(seq)
        if cur is None or ((v < cur) if lower else (v > cur)):
            by_round[seq] = v
    return [by_round.get(r) for r in rounds]


def _row(cells: list[str]) -> str:
    return "| " + " | ".join(cells) + " |"


def _table(header: list[str], rows: list[list[str]]) -> list[str]:
    return [_row(header), _row(["---"] * len(header))] + \
        [_row(r) for r in rows]


def _group_rows(points_by_series: dict[str, list[dict[str, Any]]],
                rounds: list[int],
                group_keys: tuple[str, ...]) -> list[list[str]]:
    """One table row per label-group: series sharing the group keys are
    merged (best-of across the group per round) — this is the 'per mode'
    view, collapsing e.g. every tune candidate of a mode into one line."""
    groups: dict[tuple, list[dict[str, Any]]] = {}
    for pts in points_by_series.values():
        labels = pts[-1].get("labels") or {}
        key = tuple(str(labels.get(k, "")) for k in group_keys)
        groups.setdefault(key, []).extend(pts)
    rows = []
    for key in sorted(groups):
        pts = groups[key]
        lower = pts[-1].get("metric") in LOWER_BETTER_METRICS
        traj = _trajectory(pts, rounds, lower)
        present = [v for v in traj if v is not None]
        nseries = len({p["series"] for p in pts})
        rows.append(list(key) + [
            str(nseries),
            str(sum(1 for v in traj if v is not None)),
            _fmt(next((v for v in reversed(traj) if v is not None), None)),
            _fmt((min if lower else max)(present) if present else None),
            sparkline(traj),
        ])
    return rows


def render(store: HistoryStore,
           cfg: DetectConfig | None = None) -> str:
    """The full markdown report."""
    cfg = cfg or DetectConfig()
    rounds = sorted({int(p.get("ingest_seq") or 0)
                     for p in store.points()})
    by_kind: dict[str, dict[str, list[dict[str, Any]]]] = {}
    for sid, pts in store.series().items():
        kind = str((pts[-1].get("labels") or {}).get("kind", "?"))
        by_kind.setdefault(kind, {})[sid] = pts

    lines = ["# Perf trajectory — metric-history store", ""]
    lines.append(f"- store: `{store.path}`")
    lines.append(f"- series: {len(store.series())}  ·  points: "
                 f"{len(store)}  ·  ingest rounds: "
                 f"{rounds[-1] if rounds else 0}")
    lines.append(f"- sparkline axis: ingest rounds "
                 f"{rounds} ({_GAP} = no ok reading that round)")
    lines.append("")

    if "round" in by_kind:
        lines.append("## Round headline (BENCH_r* / MULTICHIP_r*)")
        lines.append("")
        rows = _group_rows(by_kind["round"], rounds,
                           ("harness", "metric"))
        lines.extend(_table(
            ["harness", "metric", "series", "rounds", "last", "best",
             "trend"], rows))
        lines.append("")

    if "bench" in by_kind:
        lines.append("## Bench throughput per mode (TFLOP/s per device, "
                     "best-of per round)")
        lines.append("")
        rows = _group_rows(by_kind["bench"], rounds,
                           ("mode", "backend", "dtype", "size",
                            "comm_quant", "world"))
        lines.extend(_table(
            ["mode", "backend", "dtype", "size", "wire", "world",
             "series", "rounds", "last", "best", "trend"], rows))
        lines.append("")

    if "tune" in by_kind:
        lines.append("## Tune candidate sweeps (exploratory — ranked by "
                     "the tune DB's promotion gate, not drift-gated)")
        lines.append("")
        rows = _group_rows(by_kind["tune"], rounds,
                           ("mode", "backend", "dtype", "size"))
        lines.extend(_table(
            ["mode", "backend", "dtype", "size", "series", "rounds",
             "last", "best", "trend"], rows))
        lines.append("")

    if "serve" in by_kind:
        lines.append("## Serve p99 latency (ms, lower is better)")
        lines.append("")
        rows = _group_rows(by_kind["serve"], rounds,
                           ("mix", "qps", "scheduler", "load_mode"))
        lines.extend(_table(
            ["mix", "qps", "scheduler", "load", "series", "rounds",
             "last", "best", "trend"], rows))
        lines.append("")

    if "serve_tail" in by_kind:
        lines.append("## Serve tail composition (p95+ share by "
                     "component, pct of tail wall time)")
        lines.append("")
        rows = _group_rows(by_kind["serve_tail"], rounds,
                           ("component", "mix", "qps", "scheduler"))
        lines.extend(_table(
            ["component", "mix", "qps", "scheduler", "series", "rounds",
             "last", "best", "trend"], rows))
        lines.append("")

    if "train" in by_kind:
        lines.append("## Train step (step-time ms / update-error drift, "
                     "lower is better)")
        lines.append("")
        rows = _group_rows(by_kind["train"], rounds,
                           ("metric", "mode", "mesh", "zero", "grad_quant",
                            "size"))
        lines.extend(_table(
            ["metric", "mode", "mesh", "zero", "wire", "size", "series",
             "rounds", "last", "best", "trend"], rows))
        lines.append("")

    if "fault_audit" in by_kind:
        lines.append("## Fault-audit cells (pass=1)")
        lines.append("")
        rows = _group_rows(by_kind["fault_audit"], rounds,
                           ("subsystem",))
        lines.extend(_table(
            ["subsystem", "series", "rounds", "last", "best", "trend"],
            rows))
        lines.append("")

    lines.extend(_residual_section(store, rounds))
    lines.extend(_verdict_section(store, cfg))
    return "\n".join(lines).rstrip() + "\n"


def _residual_section(store: HistoryStore,
                      rounds: list[int]) -> list[str]:
    """Per (mode × wire × shape × backend) cell: the median attribution
    residual per ingest round. Tracked bench cells only — tune candidate
    sweeps carry residuals too, but per-candidate scatter belongs to the
    promotion gate, not the trajectory."""
    import statistics

    groups: dict[tuple, dict[int, list[float]]] = {}
    for pts in store.series().values():
        labels = pts[-1].get("labels") or {}
        if labels.get("kind") != "bench":
            continue
        key = (str(labels.get("mode", "?")),
               str(labels.get("comm_quant", "none")),
               str(labels.get("size", "?")),
               str(labels.get("backend", "?")))
        for p in pts:
            res = _num(p.get("residual_pct"))
            if res is None:
                continue
            groups.setdefault(key, {}) \
                .setdefault(int(p.get("ingest_seq") or 0), []).append(res)
    rows = []
    for key in sorted(groups):
        by_round = {r: statistics.median(vs)
                    for r, vs in groups[key].items()}
        traj = [by_round.get(r) for r in rounds]
        rows.append(list(key) + [
            _fmt(next((v for v in reversed(traj) if v is not None), None)),
            sparkline(traj),
        ])
    if not rows:
        return []
    return ["## Attribution residuals (measured − model, % of run time)",
            "",
            *_table(["mode", "wire", "size", "backend", "last",
                     "trend"], rows),
            ""]


def _verdict_section(store: HistoryStore,
                     cfg: DetectConfig) -> list[str]:
    findings = detect_findings(store, cfg)
    lines = ["## Drift verdicts", ""]
    if not findings:
        lines.append("clean — every series within its noise band")
        lines.append("")
        return lines
    rows = [[f.rule, f.severity, f.where, f.message]
            for f in findings]
    lines.extend(_table(["rule", "severity", "series", "verdict"], rows))
    lines.append("")
    return lines
