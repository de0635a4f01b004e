"""Measured-winner matmul routing — `--matmul-impl auto`.

Port of `tpu_matmul_bench/ops/impl_select.py`. Routing looks in two
places:

1. **The tuning database** (`tune/db.py`, the committed
   `measurements/torch/tune_db.jsonl`): cells keyed by (problem
   fingerprint, device kind), each citing the ledger behind its choice,
   with the torch version and a program digest to tell when it went
   stale. A `cuda` cell carries the kernel's tile, which `auto` runs.
2. **The table** (`table_select`, below): the H100 head-to-head
   (`tune/head_to_head.py`, fused protocol) as code, the fallback for
   problems without a cell and the source `tune/regen.py` seeds the
   committed database from.

A row routes to the hand-written kernel (`cuda`) only where the kernel's
median beat the library's by at least `tune.promote.TIE_GATE_PCT`; a tie
or a problem the head-to-head did not measure goes to the library
(`torch`), the safe default. Every row cites its ledgers. Device kinds
without rows (the CPU, the PCIe and NVL H100s, other cards) are unrouted
and take the library.
"""

from __future__ import annotations

import dataclasses
from typing import Any

# The head-to-head's ledgers, one a dtype (tune/head_to_head.py)
_H2H = "measurements/torch/h2h/{}.ndjson"


@dataclasses.dataclass(frozen=True)
class ImplChoice:
    """A routing decision: which impl, and the measurement that chose it."""

    impl: str         # "torch" | "cuda"
    provenance: str   # committed artifact (or rule) behind the decision
    source: str = "table"            # "db" | "table" | "online"
    blocks: tuple[int, int, int] | None = None  # a DB cell's tile, if any


def _cell_source(cell: Any) -> str:
    """The tier a DB hit reports: cells promoted from online shadow traffic
    (measured-online provenance) surface as their own tier."""
    return "online" if cell.provenance_kind == "measured-online" else "db"


def table_select(m: int, n: int, k: int, device_kind: str,
                 dtype: Any) -> ImplChoice:
    """Tier 2: the H100 head-to-head as a table. A pure lookup, no I/O and
    no device calls, and the source the committed database is seeded from
    (tune/promote.seed_cells_from_table)."""
    from tpu_matmul_bench_torch.tune.db import canonical_dtype, kind_token

    if kind_token(device_kind) != "h100":
        return ImplChoice("torch", "unrouted device kind: the library product "
                                   "(torch.matmul) is the default off the "
                                   "measured card")
    name = canonical_dtype(dtype)
    if name not in ("bfloat16", "int8", "float32"):
        return ImplChoice("torch", f"unrouted dtype {name}: library default")
    ledger = _H2H.format(name)
    if name == "int8":
        if min(m, n, k) >= 2048:
            # the kernel's wmma route leads cuBLAS's int8 product at every
            # measured int8 problem from 2048 up: 7.7% at 2048³, 11.1% at
            # 4096³, 13.4% at 8192³, 13.6% at 16384³, 14.6% at 32768³ and
            # 11.6% / 11.4% on the two MLP rectangles
            return ImplChoice("cuda", f"{ledger} — the kernel leads the library "
                                      "by 7.7-14.6% from 2048 up")
        # 256³-1024³: the library leads by 32.2-37.3%
        return ImplChoice("torch", f"{ledger} — the library leads below 2048")
    if name == "bfloat16":
        # the library leads every square (4.7% at 8192³ to 41.4% at 1024³;
        # 5.2% at 16384³) and both MLP rectangles (11.7%, 9.6%)
        return ImplChoice("torch", f"{ledger} — the library leads at every size")
    # float32: cuBLAS's true-fp32 product leads K1's SIMT tile by 59-70%
    return ImplChoice("torch", f"{ledger} — the library leads at every size")


def resolve_route(m: int, n: int, k: int, device_kind: str, dtype: Any,
                  *, db: Any = None) -> tuple[ImplChoice, Any]:
    """(choice, cell or None): the routing decision with the DB cell behind
    it kept visible, so audits can check the cell's staleness."""
    cell = _db_lookup(m, n, k, device_kind, dtype, db)
    if cell is not None:
        return (ImplChoice(cell.impl, cell.provenance_str,
                           source=_cell_source(cell), blocks=cell.blocks),
                cell)
    return table_select(m, n, k, device_kind, dtype), None


def select_impl(m: int, n: int, k: int, device_kind: str,
                dtype: Any, *, db: Any = None) -> ImplChoice:
    """The implementation for C[m,n] = A[m,k]·B[k,n] of `dtype` on
    `device_kind`: the DB cell first, the table as the fallback. Pure
    lookups, no device calls. `db` (tests and audits inject their own)
    defaults to the committed store, loaded once per process."""
    return resolve_route(m, n, k, device_kind, dtype, db=db)[0]


def _db_lookup(m: int, n: int, k: int, device_kind: str, dtype: Any, db):
    """The DB probe. Note the argument-order seam: routing speaks
    (m, n, k), the DB's problem key (m, k, n)."""
    if db is None:
        from tpu_matmul_bench_torch.tune.db import default_db

        db = default_db()
    return db.lookup(m, k, n, dtype, device_kind)


def auto_extras(matmul_impl: str, m: int, n: int, k: int,
                device_kind: str, dtype: Any) -> dict:
    """Record extras for an `auto` run: the resolved impl and the
    provenance behind the choice. Empty for explicit impls."""
    if matmul_impl != "auto":
        return {}
    choice = select_impl(m, n, k, device_kind, dtype)
    return {"matmul_impl_resolved": choice.impl,
            "impl_provenance": choice.provenance,
            "impl_source": choice.source}
