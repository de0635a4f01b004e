"""Regenerate the committed tuning database from the routing table.

    python -m tpu_matmul_bench_torch.tune.regen [--check] [--out PATH]

Port of the JAX package's `scripts/regen_tune_db.py`. Seeds
`measurements/torch/tune_db.jsonl` with one cell for each seed problem
(`tune/promote.py`: 8 squares and 2 rectangles × bfloat16, int8, float32
on the `h100` token; float16 shares the bfloat16 cells): each cell cites
its table row's head-to-head ledger and carries the torch version that
ledger was measured under. Program digests are recomputed at write time,
so a regen after a kernel source or flag change is how its staleness is
cleared.

Cell payloads are deterministic; `created_at` timestamps are not, so
`--check` compares everything EXCEPT timestamps and exits 1 on any
difference from the committed file. Measured promotions (`tune promote`)
supersede these seeds: the store is append-only and the last record for a
key wins.
"""

from __future__ import annotations

import argparse
import os
import sys


def _semantic(rec: dict) -> dict:
    rec = dict(rec)
    rec.pop("created_at", None)
    return rec


def check(path: str, cells) -> list:
    """The keys whose committed record differs from the regenerated one
    (timestamps aside), and the store's parse errors."""
    from tpu_matmul_bench_torch.tune.db import TuningDB

    committed = TuningDB.load(path)
    fresh = TuningDB(path=path)
    want = {}
    for cell in cells:
        cell = fresh._complete(cell)
        want[cell.key] = _semantic(cell.to_record())
    got = {c.key: _semantic(c.to_record()) for c in committed.cells()}
    diffs: list = [key for key in sorted(set(want) | set(got))
                   if want.get(key) != got.get(key)]
    diffs.extend(("parse", e) for e in committed.parse_errors)
    return diffs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--check", action="store_true",
                        help="compare against the committed DB (ignoring "
                             "timestamps) and exit 1 on any difference")
    parser.add_argument("--out", default=None,
                        help="write somewhere other than the committed "
                             "measurements/torch/tune_db.jsonl")
    args = parser.parse_args(argv)

    from tpu_matmul_bench_torch.tune.db import TuningDB, default_path
    from tpu_matmul_bench_torch.tune.promote import seed_cells_from_table

    path = args.out or default_path()
    cells = seed_cells_from_table()

    if args.check:
        diffs = check(path, cells)
        if diffs:
            print(f"tune DB out of date ({len(diffs)} cell(s) differ): rerun "
                  "python -m tpu_matmul_bench_torch.tune.regen and commit the diff")
            for d in diffs:
                print(f"  {d}")
            return 1
        print(f"tune DB up to date: {len(cells)} cells in {path}")
        return 0

    tmp = path + ".regen"
    if os.path.exists(tmp):
        os.unlink(tmp)
    db = TuningDB(path=tmp)
    for cell in cells:
        db.put(cell)
    os.replace(tmp, path)
    print(f"wrote {len(cells)} cells to {path}")
    for cell in db.cells():
        blocks = "x".join(str(b) for b in cell.blocks) if cell.blocks else "-"
        print(f"  {cell.fingerprint}  {cell.dtype:>8} "
              f"{cell.m}x{cell.k}x{cell.n} → {cell.impl} "
              f"[{cell.provenance_kind}] blocks={blocks}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
