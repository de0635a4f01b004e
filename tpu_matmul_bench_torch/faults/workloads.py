"""Resumable micro-workloads the crash-consistency certifier runs.

Port of `tpu_matmul_bench/faults/workloads.py`, over the port's writers.
Each workload exercises exactly one durable-artifact writer (the
schema-v2 ledger, the tuning DB, the obs snapshot stream) with a
telemetry span per unit of work — the span names (`w:record`, `w:cell`,
`w:snapshot`) are the fault plan's injection vocabulary — and each is
**resumable**: on start it reads whatever a killed predecessor left
behind (torn-tolerantly) and writes only the missing units. That is the
whole certification contract in miniature: run clean, run
faulted-then-resumed, and the two final artifacts must be semantically
identical — no duplicated units, no lost units, no torn tail.

Every value written is a pure function of the unit index, so "resumed
equals clean" is byte-comparable after canonicalization. None of these
touch a device: they import torch through the reporting and DB modules,
and never initialize CUDA.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

from tpu_matmul_bench_torch.utils import telemetry

DEFAULT_UNITS = 4

#: span names, one per workload — the chaos spec's phase vocabulary
LEDGER_SPAN = "w:record"
TUNE_SPAN = "w:cell"
OBS_SPAN = "w:snapshot"

#: the obs workload's progress gauge (read back on resume)
OBS_PROGRESS_GAUGE = "faults_progress"


def _ledger_record(i: int):
    """The i-th deterministic measurement record (values are functions
    of i alone, so clean and resumed runs write identical lines)."""
    from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord

    return BenchmarkRecord(
        benchmark="faults-ledger", mode="chaos", size=128 * (i + 1),
        dtype="float32", world=1, iterations=1, warmup=0,
        avg_time_s=0.001 * (i + 1), tflops_per_device=0.0,
        tflops_total=0.0, device_kind="chaos", flops_per_op=0.0,
        extras={"fault_idx": i})


def ledger_have(path: str | Path) -> set[int]:
    """fault_idx values already durably recorded in a (possibly torn)
    ledger — the resume set. Torn/foreign lines are skipped, exactly as
    every measurement reader does."""
    have: set[int] = set()
    try:
        lines = Path(path).read_text().splitlines()
    except OSError:
        return have
    for line in lines:
        try:
            d = json.loads(line)
        except ValueError:
            continue
        if isinstance(d, dict) and d.get("benchmark") == "faults-ledger":
            idx = (d.get("extras") or {}).get("fault_idx")
            if isinstance(idx, int):
                have.add(idx)
    return have


def run_ledger(json_out: str, records: int = DEFAULT_UNITS) -> int:
    """Write `records` deterministic measurement records through the
    fsync-per-line JsonWriter, skipping indices a prior attempt landed."""
    from tpu_matmul_bench_torch.utils.reporting import (
        JsonWriter,
        force_reporting_process,
    )

    force_reporting_process(True)  # no device init in a chaos child
    have = ledger_have(json_out)
    manifest = {
        "record_type": telemetry.MANIFEST_RECORD_TYPE,
        "schema_version": telemetry.SCHEMA_VERSION,
        "workload": "faults-ledger",
    }
    with JsonWriter(json_out, manifest=manifest, append=True) as writer:
        for i in range(records):
            with telemetry.span(LEDGER_SPAN, idx=i):
                if i in have:
                    continue
                writer.write(_ledger_record(i))
    return 0


def _tune_cell(i: int):
    """The i-th synthetic cell, fully keyed so `put` stays device-free
    beyond the module-import cost (no digest recompute, no clock)."""
    from tpu_matmul_bench_torch.tune.db import Cell

    return Cell(
        m=128 * (i + 1), k=128, n=128, dtype="float32",
        device_kind="chaos", impl="torch",
        provenance_kind="analytic",
        artifact="faults/workloads.py synthetic cell",
        detail=f"chaos workload prior (unit {i})",
        torch_version="0.0-chaos", program_digest=f"chaos-{i}",
        created_at="1970-01-01T00:00:00+00:00")


def run_tune(db_path: str, cells: int = DEFAULT_UNITS) -> int:
    """Append `cells` synthetic tuning cells, skipping keys the store
    already holds (TuningDB.load is torn-tolerant and last-wins)."""
    from tpu_matmul_bench_torch.tune.db import TuningDB

    db = TuningDB.load(db_path)
    for i in range(cells):
        with telemetry.span(TUNE_SPAN, idx=i):
            cell = _tune_cell(i)
            if cell.key in db:
                continue
            db.put(cell)
    return 0


def obs_progress(out_dir: str | Path) -> tuple[int, set[int]]:
    """(last seq, set of progress-gauge values seen) in an obs snapshot
    stream — the obs workload's resume point and the audit's extracted
    state."""
    from tpu_matmul_bench_torch.obs.export import SNAPSHOT_NAME, read_snapshots

    last_seq = 0
    values: set[int] = set()
    for snap in read_snapshots(Path(out_dir) / SNAPSHOT_NAME):
        last_seq = max(last_seq, int(snap.get("seq", 0)))
        v = (snap.get("gauges") or {}).get(OBS_PROGRESS_GAUGE)
        if isinstance(v, (int, float)):
            values.add(int(v))
    return last_seq, values


def run_obs(out_dir: str, snapshots: int = DEFAULT_UNITS) -> int:
    """Advance a progress gauge one step per snapshot tick, continuing
    the stream's seq numbering where a killed predecessor stopped."""
    from tpu_matmul_bench_torch.obs.export import SnapshotExporter
    from tpu_matmul_bench_torch.obs.registry import get_registry

    last_seq, done = obs_progress(out_dir)
    gauge = get_registry().gauge(OBS_PROGRESS_GAUGE)
    exporter = SnapshotExporter(out_dir, seq_start=last_seq)
    for i in range(1, snapshots + 1):
        with telemetry.span(OBS_SPAN, idx=i):
            if i in done:
                continue
            gauge.set(i)
            exporter.write_once()
    return 0


WORKLOADS: dict[str, Any] = {
    "ledger": run_ledger,
    "tune": run_tune,
    "obs": run_obs,
}
