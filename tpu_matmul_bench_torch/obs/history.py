"""Metric-history store — the perf observatory's longitudinal memory.

Port of `tpu_matmul_bench/obs/history.py`, stdlib only, over the port's
tune-DB kind token, peak table, comms model, campaign store and torn-tail
repair. What differs from the JAX module, on purpose:

- the store is ``measurements/torch/history.jsonl`` and its default
  sources are the card's ledgers under ``measurements/torch/`` only: it
  holds the card's runs, never the TPU rounds (`python -m
  tpu_matmul_bench_torch.obs.regen` rebuilds it). Those ledgers are JSON
  lines named ``.ndjson``: the JAX package's history takes every
  ``measurements/**/*.jsonl`` into its own store, whose contents its
  tests pin;
- `backend` is the port's kind token: every SXM H100 name is ``h100``;
- a float32 record that ran with TF32 allowed (its
  ``float32_matmul_precision`` extra is ``high`` or ``medium``) reads
  against the TF32 peak row, the row its own `peak_efficiency_pct` used;
- the comm leg's rate table keeps the TPU ICI rows as reference rows and
  adds the H100's, for ranks that share one card (see `_LINK_GBPS`).

The repo measures the same problems round after round (the BENCH_r*
harness, campaign sweeps, serve runs, tune fills, fault audits), but
until now each round's numbers lived in loose ledgers a human had to
diff by hand. This module ingests every measurement artifact into ONE
append-only JSONL store (``measurements/history.jsonl``) of
**fingerprint-keyed time series**: each point is the best-of reading of
one (kind × mode × shape × dtype × wire-format × backend) cell from one
source ledger, stamped with the *ingest round* it arrived in.

Identity and idempotency: a point's identity is
``(series fingerprint, source digest)`` where the source digest is the
digest of the ledger's schema-v2 manifest record (the hashing convention
of `analysis/fingerprint.digest`) — pre-v2 ledgers and the BENCH_r*/
MULTICHIP_r* round files, which carry no manifest, digest their raw
bytes instead. Re-ingesting an already-ingested ledger is a byte-level
no-op: the store file does not change, which is what makes the committed
store regenerable (`obs/regen.py`) and its digest pinnable in a test.

Durability follows `tune/db.py` / `campaign/state.py`: one fsync'd JSON
line per point, append-only, `utils/durable.repair_torn_tail` before
every append, last-wins on load, torn tails tolerated. The fsync site is
registered in `faults/audit.WRITER_REGISTRY` (FAULT-002).

Attribution residuals: every bench point records the analytic
model-predicted compute + comm seconds (roofline peak from
`utils/metrics`, wire bytes from `analysis/comms_model` over the link
rate of `_LINK_GBPS`) next to the measured split, and the residual
fraction — `obs/detect.py` turns a residual shift beyond noise into a
HIST-004 finding, so "the model stopped explaining the machine" is a
lint failure, not a vibe.

Time axis: points carry an **ingest round** (``ingest_seq``). Drift
verdicts only ever compare across distinct rounds — several points of
one series inside one round (a sweep's candidates, a rerun pair) are
concurrent evidence, not a trajectory, and the per-round best-of is the
reading the repo's ±1.5% single-run drift discipline already uses.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from pathlib import Path
from typing import Any, Iterable

from tpu_matmul_bench_torch.utils.durable import repair_torn_tail

POINT_RECORD_TYPE = "history_point"
POINT_SCHEMA = 1

#: repo-relative committed store (regenerated by obs/regen.py)
HISTORY_RELPATH = os.path.join("measurements", "torch", "history.jsonl")

#: the card's committed ledgers (`default_sources`): repo-relative
#: directory and name pattern
SOURCES_RELDIR = os.path.join("measurements", "torch")
SOURCES_GLOB = "*.ndjson"

#: ledger suffixes a directory given to `obs ingest` is swept for: a
#: campaign's own ledgers (.jsonl) and the card's committed ones (.ndjson)
LEDGER_GLOBS = ("*.jsonl", SOURCES_GLOB)

#: directories under SOURCES_RELDIR whose ledgers append one run a problem
#: to one file (the head-to-head's, `tune/head_to_head.py`): a history
#: source is one run, read through its one manifest
_MULTI_RUN_DIRS = frozenset({"h2h"})

POINT_STATUSES = ("ok", "unavailable")

#: metrics whose regression direction is UP (everything else is
#: higher-is-better)
LOWER_BETTER_METRICS = frozenset(
    {"p99_latency_ms", "step_time_ms", "update_rel_err"})

#: the BENCH_r* harness's headline metric when a round failed before
#: parsing one (rc != 0 rounds still land as `unavailable` points so the
#: series records the outage instead of silently skipping the round)
DEFAULT_ROUND_METRIC = "bf16_matmul_16k_tflops_per_chip"

_ROUND_FILE_RE = re.compile(r"(BENCH|MULTICHIP)_r(\d+)\.json$")

#: ledger basenames that hold no measurements (journals, snapshot
#: streams, the artifact manifest, the tune DB, the store itself) —
#: skipped by default_sources so `obs ingest measurements/` stays a
#: measurement-only sweep
_NON_MEASUREMENT_NAMES = {
    "journal.jsonl", "obs_snapshot.jsonl", "manifest.jsonl",
    "tune_db.jsonl", os.path.basename(HISTORY_RELPATH),
}

#: the comm leg's analytic denominator (GB/s of wire bytes), keyed like
#: utils/metrics._PEAKS (lowercase substring of device_kind). The H100 row
#: prices a hop between ranks that share one card, which is a copy in the
#: card's memory: each wire byte read once and written once at the
#: measured memory rate (utils/metrics._MEASURED_HBM_GBPS, 3087 GB/s on an
#: NVIDIA H100 80GB HBM3 at 700 W), so 3087 / 2. A record whose ranks span
#: cards (its `cards` extra above 1) crosses NVLink, whose rate the port
#: has not measured (ROADMAP A5), and gets no comm prediction. The TPU rows
#: are the JAX package's published per-chip aggregate ICI bandwidths
#: (v5e: 1600 Gb/s per chip; v5p: 4800; v4: 2400; v6e: 3584), kept as
#: reference rows so JAX-format ledgers ingest the same.
_CARD_LINK = "h100 80gb hbm3"
_LINK_GBPS: dict[str, float] = {
    _CARD_LINK: 3087.0 / 2,
    "v6 lite": 448.0,
    "v6e": 448.0,
    "v5p": 600.0,
    "v5 lite": 200.0,
    "v5e": 200.0,
    "v4": 300.0,
}



def repo_root(root: str | None = None) -> str:
    """Repo root inferred from the package location (the tune/db.py and
    fingerprint.golden_path convention)."""
    if root is not None:
        return root
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_path(root: str | None = None) -> str:
    return os.path.join(repo_root(root), HISTORY_RELPATH)


def default_sources(root: str | None = None) -> list[str]:
    """Every ingestible measurement artifact of the card in the repo,
    deterministic order: every ledger under measurements/torch/ (named
    `SOURCES_GLOB`) but the multi-run head-to-head's (the BENCH_r*/
    MULTICHIP_r* round files and the ledgers under measurements/ are TPU
    runs)."""
    base = Path(repo_root(root)) / SOURCES_RELDIR
    out: list[Path] = []
    for p in sorted(base.rglob(SOURCES_GLOB)):
        if p.name in _NON_MEASUREMENT_NAMES \
                or _MULTI_RUN_DIRS & set(p.relative_to(base).parts[:-1]):
            continue
        out.append(p)
    return [str(p) for p in out]


def series_fingerprint(labels: dict[str, Any]) -> str:
    """Stable digest of one series' identity labels — the DRIFT-gate /
    tune-DB hashing convention (analysis/fingerprint.digest), inlined so
    the store stays importable without a jax backend."""
    blob = json.dumps(labels, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def source_digest(path: str | Path) -> tuple[str, dict[str, Any] | None]:
    """(record identity digest, manifest record or None) for one source.

    Schema-v2 ledgers digest their manifest record — the run's identity,
    stable under later appends to the same ledger; manifest-less files
    (round JSONs, pre-v2 ledgers) digest their raw bytes.
    """
    p = Path(path)
    data = p.read_bytes()
    first = data.split(b"\n", 1)[0]
    try:
        head = json.loads(first)
    except ValueError:
        head = None
    if isinstance(head, dict) and head.get("record_type") == "manifest":
        blob = json.dumps(head, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16], head
    return hashlib.sha256(data).hexdigest()[:16], None


def _rel_source(path: str | Path, root: str | None) -> str:
    """Repo-relative source path when the file lives under the repo;
    the absolute path otherwise (tmp-dir tests, injected ledgers)."""
    p = Path(path).resolve()
    try:
        return p.relative_to(Path(repo_root(root)).resolve()).as_posix()
    except ValueError:
        return p.as_posix()


def _kind_token(device_kind: str | None) -> str:
    from tpu_matmul_bench_torch.tune.db import kind_token

    return kind_token(device_kind or "")


def _num(v: Any) -> float | None:
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else None


def _sample_noise_pct(rec: dict[str, Any]) -> float | None:
    """Per-iteration jitter (stddev/p50 %) from extras["samples"] — the
    same statistic campaign/store._noise_pct feeds the gate."""
    smp = (rec.get("extras") or {}).get("samples")
    if not isinstance(smp, dict):
        return None
    sd, p50 = _num(smp.get("stddev_ms")), _num(smp.get("p50_ms"))
    if sd is None or p50 is None or p50 <= 0:
        return None
    return round(100.0 * sd / p50, 4)


# ------------------------------------------------------------ attribution

#: readings this far above the published peak are timing artifacts, not
#: fast machines (110% leaves room for peak-table rounding)
PLAUSIBLE_PEAK_FACTOR = 1.1


def _tf32(rec: dict[str, Any]) -> bool:
    """Whether the record's float32 products ran with TF32 allowed: the
    mark `utils/reporting.BenchmarkRecord.tf32` reads, so the peak row
    here is the one the record's own `peak_efficiency_pct` used."""
    return (rec.get("extras") or {}).get("float32_matmul_precision") \
        in ("high", "medium")


def _plausible_cap(device_kind: str, dtype: Any,
                   tf32: bool = False) -> float | None:
    """Max credible TFLOP/s for a (chip, dtype), or None when the peak
    table does not know the chip (CPU runs are never capped)."""
    from tpu_matmul_bench_torch.utils import metrics

    try:
        peak = metrics.theoretical_peak_tflops(device_kind or "",
                                               dtype or "float32", tf32=tf32)
    except Exception:
        return None
    return PLAUSIBLE_PEAK_FACTOR * peak if peak else None


def _predicted_seconds(rec: dict[str, Any],
                       device_kind: str) -> dict[str, float] | None:
    """Model-predicted per-iteration compute + comm seconds for one bench
    record, or None when the analytic model does not know this chip.

    Compute: the record's own per-device op count (throughput × time —
    the accounting `utils/metrics.calculate_tflops` already did) over the
    published MXU peak. Comm: the static wire bytes the comms model
    prices for this (mode, world, size, format) cell over the published
    per-chip ICI bandwidth. The residual is useful precisely because the
    prediction is *stable*: a shift beyond noise means the machine
    stopped behaving like the model, whatever the absolute error.
    """
    from tpu_matmul_bench_torch.utils import metrics

    avg = _num(rec.get("avg_time_s"))
    tfd = _num(rec.get("tflops_per_device"))
    if avg is None or tfd is None or avg <= 0 or tfd <= 0:
        return None
    try:
        peak = metrics.theoretical_peak_tflops(device_kind,
                                               rec.get("dtype") or "float32",
                                               tf32=_tf32(rec))
    except Exception:
        peak = None
    if not peak:
        return None
    compute_s = (tfd * avg) / peak  # (tflops·s) / peak-tflops
    out = {"compute_s": round(compute_s, 9)}
    world = int(_num(rec.get("world")) or 1)
    if world > 1:
        comm_s = _predicted_comm_seconds(rec, device_kind, world)
        if comm_s is not None:
            out["comm_s"] = round(comm_s, 9)
    else:
        out["comm_s"] = 0.0
    return out


def _predicted_comm_seconds(rec: dict[str, Any], device_kind: str,
                            world: int) -> float | None:
    from tpu_matmul_bench_torch.analysis.comms_model import wire_bytes_summary

    bw = None
    kind = (device_kind or "").lower()
    for key, gbps in _LINK_GBPS.items():
        if key in kind:
            bw = gbps
            break
    if bw is None:
        return None
    cards = _num((rec.get("extras") or {}).get("cards"))
    if key == _CARD_LINK and cards is not None and cards > 1:
        return None  # ranks across cards: NVLink's rate is not measured
    cq = (rec.get("extras") or {}).get("comm_quant")
    fmt = (cq or {}).get("spec") if isinstance(cq, dict) else None
    try:
        summary = wire_bytes_summary(
            rec.get("mode"), world, int(rec.get("size") or 0),
            rec.get("dtype") or "float32", fmt or "none")
    except (ValueError, KeyError, TypeError):
        return None  # mode outside the comms model's table
    return summary["wire_bytes"] / (bw * 1e9)


def _attribution(rec: dict[str, Any],
                 device_kind: str) -> dict[str, Any]:
    """measured/predicted/residual fields for one bench record (all keys
    present; values None when a side is unknown)."""
    avg = _num(rec.get("avg_time_s"))
    measured = None
    if avg is not None:
        measured = {"total_s": avg}
        for key, field in (("compute_s", "compute_time_s"),
                           ("comm_s", "comm_time_s")):
            v = _num(rec.get(field))
            if v is not None:
                measured[key] = v
    predicted = _predicted_seconds(rec, device_kind)
    residual_pct = None
    if predicted is not None and avg and avg > 0 \
            and "comm_s" in predicted:
        pred_total = predicted["compute_s"] + predicted["comm_s"]
        residual_pct = round(100.0 * (avg - pred_total) / avg, 4)
    return {"measured": measured, "predicted": predicted,
            "residual_pct": residual_pct}


# --------------------------------------------------------------- ingesters

def _make_point(labels: dict[str, Any], *, value: float | None, unit: str,
                status: str, source: str, digest_: str,
                round_: int | None = None, noise_pct: float | None = None,
                created_unix: float | None = None, backend: str = "",
                detail: dict[str, Any] | None = None,
                attribution: dict[str, Any] | None = None) -> dict[str, Any]:
    point: dict[str, Any] = {
        "record_type": POINT_RECORD_TYPE,
        "schema": POINT_SCHEMA,
        "series": series_fingerprint(labels),
        "labels": labels,
        "metric": labels["metric"],
        "unit": unit,
        "value": value,
        "status": status,
        "noise_pct": noise_pct,
        "round": round_,
        "created_unix": created_unix,
        "source": source,
        "source_digest": digest_,
        "backend": backend,
        "measured": None,
        "predicted": None,
        "residual_pct": None,
    }
    if attribution:
        point.update(attribution)
    if detail:
        point["detail"] = detail
    return point


def _round_points(path: Path, source: str,
                  digest_: str) -> list[dict[str, Any]]:
    """BENCH_rNN.json / MULTICHIP_rNN.json — the round harness's verdict
    files. Failed rounds (rc != 0, value 0) land as `unavailable` points:
    the outage is part of the trajectory (ROADMAP 'Verification reality'),
    but drift statistics only ever read `ok` points."""
    m = _ROUND_FILE_RE.search(path.name)
    assert m is not None
    harness, round_ = m.group(1), int(m.group(2))
    doc = json.loads(path.read_text())
    if harness == "BENCH":
        parsed = doc.get("parsed") if isinstance(doc.get("parsed"), dict) \
            else {}
        value = _num(parsed.get("value"))
        metric = str(parsed.get("metric") or DEFAULT_ROUND_METRIC)
        ok = doc.get("rc") == 0 and value is not None and value > 0
        labels = {"kind": "round", "metric": metric, "harness": "BENCH"}
        detail = {"rc": doc.get("rc")}
        for key in ("vs_baseline", "backend", "attempts", "last_known_good"):
            if key in parsed:
                detail[key] = parsed[key]
        return [_make_point(
            labels, value=value, unit=str(parsed.get("unit") or "TFLOPS"),
            status="ok" if ok else "unavailable", source=source,
            digest_=digest_, round_=round_, backend="tpu", detail=detail)]
    # MULTICHIP: a smoke verdict, recorded as a 0/1 series so a formerly
    # green multi-chip path going dark is a visible regression
    ok = bool(doc.get("ok")) and not doc.get("skipped")
    labels = {"kind": "round", "metric": "multichip_smoke_ok",
              "harness": "MULTICHIP",
              "n_devices": int(_num(doc.get("n_devices")) or 0)}
    return [_make_point(
        labels, value=1.0 if bool(doc.get("ok")) else 0.0, unit="bool",
        status="ok" if not doc.get("skipped") and doc.get("rc") is not None
        or bool(doc.get("ok")) else "unavailable",
        source=source, digest_=digest_, round_=round_, backend="tpu",
        detail={"rc": doc.get("rc"), "skipped": bool(doc.get("skipped"))})]


def _bench_labels(rec: dict[str, Any], manifest: dict[str, Any] | None,
                  backend: str) -> dict[str, Any]:
    ex = rec.get("extras") or {}
    cq = ex.get("comm_quant")
    blocks = None
    if "block_m" in ex:
        blocks = f"{ex.get('block_m')}x{ex.get('block_n')}x{ex.get('block_k')}"
    cfg = (manifest or {}).get("config") or {}
    # candidate-sweep records (tune fill ledgers) are exploration: the
    # tune DB's promotion gate ranks them, so history keeps them as
    # their own kind and `obs detect` leaves drift verdicts to that gate
    kind = "tune" if rec.get("benchmark") == "tune" else "bench"
    labels = {
        "kind": kind,
        "metric": "tflops_per_device",
        "benchmark": rec.get("benchmark"),
        "mode": rec.get("mode"),
        "size": int(_num(rec.get("size")) or 0),
        "dtype": rec.get("dtype"),
        "world": int(_num(rec.get("world")) or 1),
        "backend": backend,
        "comm_quant": (cq.get("format") if isinstance(cq, dict)
                       else None) or "none",
        "blocks": blocks,
        # dispatch-timed readings are a different experiment than
        # wall-clock ones — never let them share a series
        "timing": cfg.get("timing") or ex.get("timing"),
        "impl": cfg.get("matmul_impl"),
    }
    # hierarchical-mesh identity — added ONLY when present, so
    # every flat-mesh series fingerprint stays byte-identical while a
    # factorized run (or its per-link wire split, or an out-of-core
    # stream plan) can never alias the flat series of the same shape
    if ex.get("mesh"):
        labels["mesh"] = ex["mesh"]
    if isinstance(cq, dict) and isinstance(cq.get("per_link"), dict):
        labels["link_formats"] = ",".join(
            f"{link}={cq['per_link'][link].get('wire_format') or 'none'}"
            for link in sorted(cq["per_link"]))
    if isinstance(ex.get("stream_k"), dict):
        labels["stream_k"] = ex["stream_k"].get("panels")
    return labels


def _serve_point(rec: dict[str, Any], manifest: dict[str, Any] | None,
                 source: str, digest_: str, backend: str,
                 created_unix: float | None) -> dict[str, Any]:
    srv = (rec.get("extras") or {}).get("serve") or {}
    sc = (manifest or {}).get("serve_config") or {}
    labels = {
        "kind": "serve",
        "metric": "p99_latency_ms",
        "mix": sc.get("mix"),
        "qps": _num(sc.get("qps")),
        "scheduler": srv.get("scheduler") or sc.get("scheduler"),
        "load_mode": srv.get("load_mode") or sc.get("load_mode"),
        "tenants": sc.get("tenants"),
        "dtype": rec.get("dtype"),
        "world": int(_num(rec.get("world")) or 1),
        "backend": backend,
    }
    # pod labels join only when set so every pre-pod serve series keeps
    # its fingerprint — without them the exact-wire and quantized pod
    # jobs collide into one series and cross-gate each other
    for key in ("mesh", "comm_quant"):
        if sc.get(key):
            labels[key] = sc[key]
    if int(_num(sc.get("replica_groups")) or 1) > 1:
        labels["replica_groups"] = int(_num(sc.get("replica_groups")) or 1)
    value = _num(srv.get("p99_ms"))
    detail = {k: srv.get(k) for k in
              ("slo_attainment_pct", "goodput_qps", "achieved_qps",
               "requests", "shed_rate_pct") if srv.get(k) is not None}
    return _make_point(
        labels, value=value, unit="ms",
        status="ok" if value is not None else "unavailable",
        source=source, digest_=digest_, backend=backend,
        noise_pct=_num(srv.get("p99_noise_pct")),
        created_unix=created_unix, detail=detail)


def _pod_points(rec: dict[str, Any], manifest: dict[str, Any] | None,
                source: str, digest_: str, backend: str,
                created_unix: float | None) -> list[dict[str, Any]]:
    """Pod serve records add gateable higher-better series beside the
    p99 point: one goodput point per replica group (a sick group hides
    inside a healthy pod aggregate) and the worst-tenant SLO attainment
    headline (the pod-level gate metric)."""
    srv = (rec.get("extras") or {}).get("serve") or {}
    pod = srv.get("pod")
    if not isinstance(pod, dict):
        return []
    sc = (manifest or {}).get("serve_config") or {}
    base = {
        "kind": "serve",
        "mix": sc.get("mix"),
        "qps": _num(sc.get("qps")),
        "scheduler": srv.get("scheduler") or sc.get("scheduler"),
        "load_mode": srv.get("load_mode") or sc.get("load_mode"),
        "mesh": sc.get("mesh"),
        "comm_quant": sc.get("comm_quant"),
        "dtype": rec.get("dtype"),
        "world": int(_num(rec.get("world")) or 1),
        "backend": backend,
    }
    points = []
    for row in pod.get("groups") or []:
        if not isinstance(row, dict):
            continue
        value = _num(row.get("goodput_qps"))
        detail = {k: row.get(k) for k in
                  ("placement", "requests", "shed", "achieved_qps",
                   "slo_attainment_pct", "p99_ms") if row.get(k) is not None}
        points.append(_make_point(
            dict(base, metric="group_goodput_qps", group=row.get("group")),
            value=value, unit="qps",
            status="ok" if value is not None else "unavailable",
            source=source, digest_=digest_, backend=backend,
            created_unix=created_unix, detail=detail))
    attain = _num(pod.get("worst_tenant_attainment_pct"))
    if attain is not None:
        points.append(_make_point(
            dict(base, metric="min_attainment_pct"),
            value=attain, unit="%", status="ok",
            source=source, digest_=digest_, backend=backend,
            created_unix=created_unix,
            detail={"min_group_goodput_qps":
                    _num(pod.get("min_group_goodput_qps"))}))
    return points


def _train_points(rec: dict[str, Any], source: str, digest_: str,
                  backend: str,
                  created_unix: float | None) -> list[dict[str, Any]]:
    """kind="train" — one step-time point per train-step record, plus an
    update_rel_err point when the cell measured a drift series (quantized
    gradient wire vs exact shadow). Both lower-better: the step got
    slower, or the wire format started hurting the weights more."""
    tr = (rec.get("extras") or {}).get("train") or {}
    base = {
        "kind": "train",
        "benchmark": "train",
        "mode": rec.get("mode"),
        "size": int(_num(rec.get("size")) or 0),
        "dtype": rec.get("dtype"),
        "world": int(_num(rec.get("world")) or 1),
        "backend": backend,
        "zero": int(_num(tr.get("zero")) or 0),
        "grad_quant": tr.get("grad_quant") or "none",
        "steps": int(_num(tr.get("steps")) or 0),
    }
    mesh = (rec.get("extras") or {}).get("mesh")
    if mesh:
        base["mesh"] = mesh
    wall = _num(rec.get("avg_time_s"))
    detail = {k: tr.get(k) for k in ("phases", "phase_sum_s", "wall_s")
              if tr.get(k) is not None}
    points = [_make_point(
        dict(base, metric="step_time_ms"),
        value=None if wall is None else round(wall * 1e3, 6), unit="ms",
        status="ok" if wall is not None and wall > 0 else "unavailable",
        source=source, digest_=digest_,
        noise_pct=_sample_noise_pct(rec), created_unix=created_unix,
        backend=backend, detail=detail)]
    drift = _num(tr.get("update_rel_err"))
    if drift is not None:
        points.append(_make_point(
            dict(base, metric="update_rel_err"),
            value=drift, unit="rel",
            status="ok", source=source, digest_=digest_,
            created_unix=created_unix, backend=backend,
            detail={"update_drift": tr.get("update_drift")}))
    return points


def _ledger_points(path: Path, source: str,
                   digest_: str, manifest: dict[str, Any] | None,
                   ) -> list[dict[str, Any]]:
    """Points for one JSONL ledger: per series, the BEST record (max
    throughput / min p99) — the best-of estimator every consumer of these
    ledgers (campaign summary, bake_rows) already applies. Torn or alien
    lines are skipped, as every reader in the repo does."""
    created_unix = _num((manifest or {}).get("created_unix"))
    manifest_kind = (manifest or {}).get("device_kind") or ""
    best: dict[str, dict[str, Any]] = {}
    span_records: list[dict[str, Any]] = []

    def consider(point: dict[str, Any]) -> None:
        sid = point["series"]
        cur = best.get(sid)
        if cur is None:
            best[sid] = point
            return
        # an ok reading always beats a quarantined/failed one, whatever
        # the (untrustworthy) value on the latter says
        a_ok = point.get("status") == "ok"
        b_ok = cur.get("status") == "ok"
        if a_ok != b_ok:
            if a_ok:
                best[sid] = point
            return
        a, b = point.get("value"), cur.get("value")
        if a is None:
            return
        if b is None:
            best[sid] = point
            return
        lower = point["metric"] in LOWER_BETTER_METRICS
        if (a < b) if lower else (a > b):
            best[sid] = point

    for line in path.read_text(errors="replace").splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if not isinstance(rec, dict):
            continue
        if rec.get("record_type") == "fault_audit":
            labels = {"kind": "fault_audit", "metric": "cell_pass",
                      "cell": rec.get("cell"),
                      "subsystem": rec.get("subsystem")}
            consider(_make_point(
                labels, value=1.0 if rec.get("status") == "PASS" else 0.0,
                unit="pass", status="ok", source=source, digest_=digest_,
                created_unix=created_unix, backend="cpu"))
            continue
        if rec.get("record_type") == "serve_span":
            # per-request flight-recorder terminal lines: collected for
            # the tail-attribution series derived after the scan
            span_records.append(rec)
            continue
        if "benchmark" not in rec or rec.get("record_type") == "manifest":
            continue
        backend = _kind_token(rec.get("device_kind") or manifest_kind)
        if rec.get("benchmark") == "serve" \
                and isinstance((rec.get("extras") or {}).get("serve"), dict):
            consider(_serve_point(rec, manifest, source, digest_, backend,
                                  created_unix))
            for point in _pod_points(rec, manifest, source, digest_,
                                     backend, created_unix):
                consider(point)
            continue
        if rec.get("benchmark") == "train" \
                and isinstance((rec.get("extras") or {}).get("train"), dict):
            for point in _train_points(rec, source, digest_, backend,
                                       created_unix):
                consider(point)
            continue
        value = _num(rec.get("tflops_per_device"))
        labels = _bench_labels(rec, manifest, backend)
        status = "ok" if value is not None and value > 0 \
            else "unavailable"
        detail = None
        peak_cap = _plausible_cap(rec.get("device_kind") or manifest_kind,
                                  rec.get("dtype"), _tf32(rec))
        if status == "ok" and peak_cap and value > peak_cap:
            # a reading above the chip's physical peak is a timing
            # artifact (r4's HOISTED ledgers: the compiler hoisted the
            # matmul out of the timed loop) — quarantined, never
            # last-known-good
            status = "unavailable"
            detail = {"implausible_above_peak_tflops": round(peak_cap, 2)}
        consider(_make_point(
            labels, value=value, unit="TFLOPS",
            status=status,
            source=source, digest_=digest_,
            noise_pct=_sample_noise_pct(rec), created_unix=created_unix,
            backend=backend, detail=detail,
            attribution=_attribution(rec, rec.get("device_kind")
                                     or manifest_kind)))
    for point in _serve_tail_points(span_records, manifest, source,
                                    digest_, manifest_kind, created_unix):
        consider(point)
    return [best[sid] for sid in sorted(best)]


def _serve_tail_points(span_records: list[dict[str, Any]],
                       manifest: dict[str, Any] | None, source: str,
                       digest_: str, manifest_kind: str,
                       created_unix: float | None) -> list[dict[str, Any]]:
    """kind="serve_tail" — one point per attribution component (the
    queue_wait / batch_wait / compile / execute share of the p95+ tail's
    summed wall time). Tail *composition* drift is a regression signal
    of its own: p99 can hold steady while the tail's cause migrates from
    execute to queue_wait (an admission problem masquerading as a quiet
    ledger), and these series let `obs detect` gate on that migration
    like any other metric."""
    from tpu_matmul_bench_torch.serve.trace import tail_attribution

    att = tail_attribution(span_records)
    if att is None:
        return []
    sc = (manifest or {}).get("serve_config") or {}
    backend = _kind_token(manifest_kind)
    detail = {k: att[k] for k in ("threshold_ms", "tail_count",
                                  "total_count")}
    points = []
    for component, share in att["shares"].items():
        labels = {
            "kind": "serve_tail",
            "metric": "tail_share_pct",
            "component": component,
            "mix": sc.get("mix"),
            "qps": _num(sc.get("qps")),
            "scheduler": sc.get("scheduler"),
            "load_mode": sc.get("load_mode"),
            "tenants": sc.get("tenants"),
            "dtype": sc.get("dtype"),
            "backend": backend,
        }
        points.append(_make_point(
            labels, value=share, unit="pct", status="ok", source=source,
            digest_=digest_, created_unix=created_unix, backend=backend,
            detail=detail))
    return points


def points_from_source(path: str | Path, *,
                       root: str | None = None) -> list[dict[str, Any]]:
    """All history points one source file yields (pure — nothing is
    written; `ingest` and the gate's history baseline both build on it).
    Unreadable/unparseable sources yield no points."""
    p = Path(path)
    try:
        digest_, manifest = source_digest(p)
    except OSError:
        return []
    source = _rel_source(p, root)
    try:
        if _ROUND_FILE_RE.search(p.name):
            return _round_points(p, source, digest_)
        return _ledger_points(p, source, digest_, manifest)
    except (ValueError, OSError, KeyError):
        return []


# -------------------------------------------------------------------- store

class HistoryStore:
    """The point store: JSONL on disk, identity-deduped in memory.

    Append-only with one fsync per line; `load` keeps the LAST record
    per (series, source_digest) — a correction is an append, never a
    rewrite — and tolerates torn tails and alien lines the way every
    durable reader in the repo does.
    """

    def __init__(self, path: str | None = None) -> None:
        self.path = path or default_path()
        self._points: dict[tuple[str, str], dict[str, Any]] = {}
        self.records_read = 0
        self.parse_errors: list[str] = []

    # ---------------------------------------------------------------- load

    @classmethod
    def load(cls, path: str | None = None) -> "HistoryStore":
        store = cls(path)
        if not os.path.exists(store.path):
            return store
        with open(store.path, errors="replace") as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    # torn trailing line from a crash — tolerated; interior
                    # garbage is reported by selftest via parse_errors
                    store.parse_errors.append(f"line {lineno}: unparseable")
                    continue
                if not isinstance(rec, dict) \
                        or rec.get("record_type") != POINT_RECORD_TYPE:
                    continue
                try:
                    key = (str(rec["series"]), str(rec["source_digest"]))
                except KeyError as e:
                    store.parse_errors.append(f"line {lineno}: missing {e}")
                    continue
                store.records_read += 1
                store._points[key] = rec
        return store

    # --------------------------------------------------------------- write

    def append(self, points: Iterable[dict[str, Any]], *,
               seq: int | None = None, fsync: bool = True) -> int:
        """Append new points (identity-deduped: already-present points are
        skipped, making re-ingest a byte-level no-op). Points that carry
        no ``ingest_seq`` get ``seq`` (default: max existing + 1) — one
        append batch is one ingest round. Returns the count appended."""
        batch: list[dict[str, Any]] = []
        seen: set[tuple[str, str]] = set()
        next_seq = seq if seq is not None else self.max_seq() + 1
        for point in sorted(points,
                            key=lambda p: (str(p.get("source", "")),
                                           str(p.get("series", "")))):
            key = (str(point["series"]), str(point["source_digest"]))
            if key in self._points or key in seen:
                continue
            seen.add(key)
            if point.get("ingest_seq") is None:
                point = dict(point, ingest_seq=next_seq)
            batch.append(point)
        if not batch:
            return 0
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        # crash hygiene: never append after a torn (newline-less) tail
        repair_torn_tail(self.path)
        with open(self.path, "a") as fh:
            for point in batch:
                fh.write(json.dumps(point, sort_keys=True) + "\n")
                fh.flush()
                if fsync:
                    os.fsync(fh.fileno())
        for point in batch:
            self._points[(point["series"], point["source_digest"])] = point
        return len(batch)

    # -------------------------------------------------------------- access

    def points(self) -> list[dict[str, Any]]:
        return [self._points[k] for k in sorted(self._points)]

    def identities(self) -> set[tuple[str, str]]:
        return set(self._points)

    def max_seq(self) -> int:
        return max((int(p.get("ingest_seq") or 0)
                    for p in self._points.values()), default=0)

    def series(self) -> dict[str, list[dict[str, Any]]]:
        """series id → points ordered by (ingest round, created time,
        source) — the axis drift detection walks."""
        out: dict[str, list[dict[str, Any]]] = {}
        for point in self._points.values():
            out.setdefault(str(point["series"]), []).append(point)
        for pts in out.values():
            pts.sort(key=lambda p: (int(p.get("ingest_seq") or 0),
                                    float(p.get("created_unix") or 0.0),
                                    str(p.get("source", ""))))
        return dict(sorted(out.items()))

    def __len__(self) -> int:
        return len(self._points)

    # ------------------------------------------------------------ validate

    def validate(self, root: str | None = None) -> list[str]:
        """Schema/identity problems (empty = healthy) — the `obs history
        selftest` core: parse errors, fingerprint recompute, status
        vocabulary, dead source paths, unsequenced points."""
        base = repo_root(root)
        problems = list(self.parse_errors)
        for point in self.points():
            label = f"{point.get('source')}#{str(point.get('series'))[:8]}"
            if point.get("record_type") != POINT_RECORD_TYPE:
                problems.append(
                    f"{label}: record_type {point.get('record_type')!r} "
                    f"!= {POINT_RECORD_TYPE!r}")
            if point.get("schema") != POINT_SCHEMA:
                problems.append(f"{label}: schema {point.get('schema')!r} "
                                f"!= {POINT_SCHEMA}")
            if not point.get("source_digest"):
                problems.append(f"{label}: point without a source digest "
                                "— half its identity key is missing")
            if not isinstance(point.get("unit"), str) \
                    or not point.get("unit"):
                problems.append(f"{label}: unit {point.get('unit')!r} is "
                                "not a non-empty string")
            if not isinstance(point.get("backend"), str):
                problems.append(f"{label}: backend "
                                f"{point.get('backend')!r} not a string")
            # the nullable columns: absent is a schema hole, null is a
            # legitimate "not known for this point"
            for key, kinds in (("created_unix", (int, float)),
                               ("round", (int,)),
                               ("noise_pct", (int, float)),
                               ("residual_pct", (int, float)),
                               ("measured", (dict,)),
                               ("predicted", (dict,))):
                if key not in point:
                    problems.append(f"{label}: point lacks the {key!r} "
                                    "column")
                elif point[key] is not None \
                        and not isinstance(point[key], kinds):
                    problems.append(f"{label}: {key} {point[key]!r} has "
                                    "the wrong type")
            if "detail" in point and not isinstance(point["detail"], dict):
                problems.append(f"{label}: detail {point['detail']!r} not "
                                "a dict")
            labels = point.get("labels")
            if not isinstance(labels, dict) or "metric" not in labels \
                    or "kind" not in labels:
                problems.append(f"{label}: labels must carry kind + metric")
            elif series_fingerprint(labels) != point.get("series"):
                problems.append(
                    f"{label}: stored series {point.get('series')} does "
                    f"not recompute from its labels — identity drifted")
            if point.get("status") not in POINT_STATUSES:
                problems.append(f"{label}: unknown status "
                                f"{point.get('status')!r}")
            elif point["status"] == "ok" \
                    and _num(point.get("value")) is None:
                problems.append(f"{label}: ok point without a numeric "
                                "value")
            if int(point.get("ingest_seq") or 0) < 1:
                problems.append(f"{label}: point without an ingest round")
            src = str(point.get("source") or "")
            if not src:
                problems.append(f"{label}: point without a source")
            elif not os.path.isabs(src) \
                    and not os.path.exists(os.path.join(base, src)):
                problems.append(f"{label}: source {src!r} does not exist "
                                "in the repo")
        return problems


# ------------------------------------------------------------------- ingest

def ingest(sources: Iterable[str | Path], store: HistoryStore, *,
           seq: int | None = None, root: str | None = None,
           dry_run: bool = False) -> tuple[int, int]:
    """Ingest `sources` into `store` as one ingest round. Returns
    (points appended, points already present). Idempotent: sources whose
    (series, source digest) identities are all present contribute
    nothing, so running the same ingest twice leaves the store file
    byte-identical."""
    fresh: list[dict[str, Any]] = []
    skipped = 0
    have = store.identities()
    for src in sources:
        for point in points_from_source(src, root=root):
            key = (point["series"], point["source_digest"])
            if key in have:
                skipped += 1
            else:
                have.add(key)
                fresh.append(point)
    if dry_run:
        return len(fresh), skipped
    return store.append(fresh, seq=seq), skipped


# -------------------------------------------------- campaign-gate baseline

def baseline_rows_for_campaign(store: HistoryStore,
                               campaign_dir: str | Path,
                               ) -> dict[str, dict[str, Any]]:
    """A gate baseline side synthesized from history: for each job in the
    campaign, the last-known-good value of the job's headline series —
    the best `ok` reading at the most recent ingest round, excluding
    points sourced from this campaign's own ledgers (a campaign already
    ingested must still gate against *prior* rounds, not itself).

    Jobs whose series has no prior history get no baseline row — the
    gate reports them as `new`, which is exactly what they are.
    """
    from tpu_matmul_bench_torch.campaign.store import CampaignStore

    cs = CampaignStore.load(campaign_dir)
    all_series = store.series()
    out: dict[str, dict[str, Any]] = {}
    for fp, jl in cs.jobs.items():
        ledger = Path(campaign_dir) / "jobs" / f"{jl.job_id}.jsonl"
        points = points_from_source(ledger)
        headline = _headline_point(points)
        if headline is None:
            continue
        lower = headline["metric"] in LOWER_BETTER_METRICS
        prior = [p for p in all_series.get(headline["series"], [])
                 if p.get("source_digest") != headline["source_digest"]
                 and p.get("status") == "ok"
                 and _num(p.get("value")) is not None]
        if not prior:
            continue
        last_round = max(int(p.get("ingest_seq") or 0) for p in prior)
        at_last = [p for p in prior
                   if int(p.get("ingest_seq") or 0) == last_round]
        pick = min if lower else max
        lkg = pick(at_last, key=lambda p: p["value"])
        row: dict[str, Any] = {"job_id": jl.job_id,
                               "noise_pct": _num(lkg.get("noise_pct"))}
        metric_key = "p99_latency_ms" if lower else "tflops_per_device"
        row[metric_key] = lkg["value"]
        slo = _num((lkg.get("detail") or {}).get("slo_attainment_pct"))
        if slo is not None:
            row["slo_attainment_pct"] = slo
        out[fp] = row
    return out


def _headline_point(points: list[dict[str, Any]]) -> dict[str, Any] | None:
    """A job ledger's gate headline: its serve p99 point when it has one
    (the summary's convention), else its best ok throughput point."""
    serve = [p for p in points if p["metric"] in LOWER_BETTER_METRICS
             and _num(p.get("value")) is not None]
    if serve:
        return min(serve, key=lambda p: p["value"])
    ok = [p for p in points if p.get("status") == "ok"
          and _num(p.get("value")) is not None]
    if not ok:
        return None
    return max(ok, key=lambda p: p["value"])
