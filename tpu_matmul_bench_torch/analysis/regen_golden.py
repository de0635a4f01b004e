"""Regenerate the golden program-fingerprint baseline.

    python -m tpu_matmul_bench_torch.analysis.regen_golden [--check] [--out PATH]

Port of the JAX package's `scripts/regen_golden.py`. It runs every program
of the fingerprint inventory once on the CPU (8 ranks on one device, the
lint's audit world), whatever the machine has: the golden is written on
the CPU and the lint on the card holds the card's digests to it. The
canonical records hold no timestamps, pointers or event ids, so two runs
give byte-identical output (keys sorted, newline-terminated), and the diff
a regen produces is exactly the set of programs whose recorded structure
moved.

When DRIFT-001 fires: if the change is intentional, rerun this and commit
the updated baseline with the code that moved it; if it is not, fix the
code, not the baseline.

`--check` regenerates in memory and exits 1 on any difference from the
committed file (writes nothing).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="exit 1 if the committed baseline differs from a "
                             "fresh regen (writes nothing)")
    parser.add_argument("--out", default=None,
                        help="write the baseline here instead of the package's "
                             "analysis/golden/ location")
    args = parser.parse_args(argv)

    from tpu_matmul_bench_torch.analysis import fingerprint as fp
    from tpu_matmul_bench_torch.analysis.auditor import audit_devices
    from tpu_matmul_bench_torch.analysis.cli import audit_ranks

    with audit_ranks():
        fingerprints = fp.current_fingerprints(audit_devices("cpu"))
    blob = fp.golden_document(fingerprints)
    path = Path(args.out) if args.out else fp.golden_path()
    count = len(fingerprints)
    if args.check:
        committed = path.read_text() if path.exists() else None
        if committed != blob:
            print(f"golden baseline at {path} is stale — rerun python -m "
                  "tpu_matmul_bench_torch.analysis.regen_golden", file=sys.stderr)
            return 1
        print(f"golden baseline up to date ({count} programs)")
        return 0
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(blob)
    print(f"wrote {count} fingerprints to {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
