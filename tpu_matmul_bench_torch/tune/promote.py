"""Promote measured sweep winners into the tuning database.

Port of `tpu_matmul_bench/tune/promote.py`: the winner of each (dtype,
precision, shape) group of `tune` ledgers (benchmarks/cuda_tune.py
`--json-out`) becomes a ``measured`` `cuda` cell citing its ledger(s), and
`impl_select` routes on it with no table edit. The ranking rules are the
JAX package's:

- confirm-pass records are authoritative when present: a drift-inflated
  sweep number must not outrank its own interleaved confirm;
- one entry per (tile, grid_order, ksplit), best run wins;
- a top-2 margin under TIE_GATE_PCT of the runner-up is a TIE and is
  **not promoted**, nor is a group whose confirm flagged `tie_margin_pct`;
- structural winners (grid_order or ksplit not the defaults) are reported
  but not promoted: a cell carries the tile only;
- ring sweeps (`tune --ring`) are reported but not promoted.

`seed_cells_from_table` fills the other way: it turns the routing table
(`ops/impl_select.table_select`) into cells over the seed surface, each
keeping its table row's ledger citation; `tune/regen.py` writes the
committed `measurements/torch/tune_db.jsonl` from it.
"""

from __future__ import annotations

import json
import os
import sys
from collections import defaultdict
from typing import Any, Iterable

from tpu_matmul_bench_torch.tune.db import (
    REPO_ROOT,
    Cell,
    TuningDB,
    artifact_paths,
    canonical_dtype,
    kind_token,
)

TIE_GATE_PCT = 1.0  # runner-up-denominator gate, as cuda_tune's confirm pass

#: the card the port's cells are measured on, as torch names it
H100 = "NVIDIA H100 80GB HBM3"


def load_tune_records(paths: Iterable[str]):
    """Group tune ledger records by (dtype, precision, shape label)."""
    groups = defaultdict(list)
    for path in paths:
        try:
            with open(path) as fh:
                lines = fh.read().splitlines()
        except OSError as e:
            print(f"skip {path}: {e}", file=sys.stderr)
            continue
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("benchmark") != "tune":
                continue
            ex = rec.get("extras", {})
            if not {"block_m", "block_n", "block_k"} <= ex.keys():
                continue
            shape = ex.get("shape") or f"{rec['size']}^2"
            if str(rec.get("mode", "")).startswith("tune_cuda_ring"):
                shape = f"{rec['mode'][5:]}:{shape}"
            key = (rec["dtype"], ex.get("precision", "default"), shape)
            groups[key].append((rec, path))
    return groups


def _rank(entries):
    """Confirm-authoritative pool, one entry per candidate keeping its best
    run, sorted by tflops_total descending."""
    confirmed = [e for e in entries if e[0]["extras"].get("confirm_pass")]
    pool = confirmed or entries
    by_blocks: dict = {}
    for rec, path in pool:
        e = rec["extras"]
        k = (e["block_m"], e["block_n"], e["block_k"],
             e.get("grid_order", "mnk"), e.get("ksplit", 1))
        if (k not in by_blocks
                or rec["tflops_total"] > by_blocks[k][0]["tflops_total"]):
            by_blocks[k] = (rec, path)
    return sorted(by_blocks.values(), key=lambda e: -e[0]["tflops_total"])


def _problem_dims(shape: str, best_rec: dict) -> tuple[int, int, int] | None:
    """(m, k, n) for a promotable shape label; None for ring sweeps."""
    if ":" in shape:
        return None  # ring sweep: rings key no cell
    if "^2" in shape:
        size = int(best_rec["size"])
        return size, size, size
    m, k, n = (int(v) for v in shape.split("x"))
    return m, k, n


def promote(paths: Iterable[str], db: TuningDB | None = None, *,
            device_kind: str = H100,
            dry_run: bool = False) -> dict[str, Any]:
    """Rank every group in `paths` and write each clean winner as a
    measured `cuda` cell. Returns {"promoted": [cells], "skipped":
    [reasons]}."""
    if db is None:
        db = TuningDB.load()
    groups = load_tune_records(paths)
    promoted: list[Cell] = []
    skipped: list[str] = []
    for (dtype, precision, shape), entries in sorted(groups.items()):
        label = f"{dtype} {shape}" + (
            "" if precision == "default" else f" precision={precision}")
        ranked = _rank(entries)
        (best, src) = ranked[0]
        ex = best["extras"]
        if "tie_margin_pct" in ex:
            skipped.append(
                f"{label}: confirm margin {ex['tie_margin_pct']}% is inside "
                "run noise — re-measure before promoting")
            continue
        if len(ranked) > 1 and ranked[1][0]["tflops_total"] > 0:
            runner_up = ranked[1][0]
            margin_pct = ((best["tflops_total"] - runner_up["tflops_total"])
                          / runner_up["tflops_total"] * 100.0)
            if margin_pct < TIE_GATE_PCT:
                skipped.append(
                    f"{label}: top-2 margin {margin_pct:.2f}% is inside the "
                    f"{TIE_GATE_PCT}% confirm-noise gate — not promoted")
                continue
        if ex.get("grid_order", "mnk") != "mnk" or ex.get("ksplit", 1) != 1:
            skipped.append(
                f"{label}: structural winner (grid_order/ksplit) — a cell "
                "carries blocks only; extend the cell schema before "
                "promoting")
            continue
        dims = _problem_dims(shape, best)
        if dims is None:
            skipped.append(f"{label}: ring sweep — no cell target")
            continue
        m, k, n = dims
        cell = Cell(
            m=m, k=k, n=n, dtype=canonical_dtype(dtype),
            device_kind=kind_token(device_kind),
            impl="cuda",
            provenance_kind="measured",
            artifact=src,
            detail=(f"cuda_tune sweep winner over {len(ranked)} "
                    f"candidates, {best['tflops_total']:.2f} "
                    f"{'TOPS' if dtype == 'int8' else 'TFLOPS'}"),
            blocks=(ex["block_m"], ex["block_n"], ex["block_k"]),
            tflops=float(best["tflops_total"]),
        )
        if dry_run:
            promoted.append(db._complete(cell))
        else:
            promoted.append(db.put(cell))
    return {"promoted": promoted, "skipped": skipped}


# --------------------------------------------------------------- seeding

#: the JAX package's seed surface: squares, the two MLP rectangles (as
#: (m, n, k)) and three dtypes; float16 shares the bfloat16 cells
SEED_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
SEED_RECTS = ((8192, 28672, 4096), (28672, 8192, 4096))  # (m, n, k)
SEED_DTYPES = ("bfloat16", "int8", "float32")


def seed_problems() -> list[tuple[int, int, int]]:
    """The seed surface's (m, k, n) problems: squares, then rectangles."""
    return [(s, s, s) for s in SEED_SIZES] + [(m, k, n) for (m, n, k) in SEED_RECTS]


def ledger_torch_version(path: str) -> str:
    """The torch version (and CUDA) a committed ledger was measured under,
    from its first manifest, in `db.torch_version`'s form; "" without one."""
    with open(os.path.join(REPO_ROOT, path)) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("record_type") == "manifest":
                return f"{rec['torch_version']} cuda {rec['cuda_version']}"
    return ""


def seed_cells_from_table(device_kind: str = H100) -> list[Cell]:
    """The routing table as cells over the seed surface: each cell keeps
    its row's ledger citation and the torch version those ledgers were
    measured under; a `cuda` cell carries the tile the kernel runs at its
    default request (`effective_blocks`)."""
    from tpu_matmul_bench_torch.ops.cuda_matmul import DEFAULT_TILE, effective_blocks
    from tpu_matmul_bench_torch.ops.impl_select import table_select

    cells = []
    for dtype in SEED_DTYPES:
        for m, k, n in seed_problems():
            choice = table_select(m, n, k, device_kind, dtype)
            if "measurements/" not in choice.provenance:
                raise ValueError(f"table row without a ledger: {choice.provenance!r}")
            blocks = None
            if choice.impl == "cuda":
                blocks = effective_blocks(m, n, k, *DEFAULT_TILE, dtype)
            cells.append(Cell(
                m=m, k=k, n=n, dtype=canonical_dtype(dtype),
                device_kind=kind_token(device_kind),
                impl=choice.impl, provenance_kind="measured",
                artifact=choice.provenance,
                detail="promoted from the H100 head-to-head routing table",
                blocks=blocks,
                torch_version=ledger_torch_version(
                    artifact_paths(choice.provenance)[0])))
    return cells
