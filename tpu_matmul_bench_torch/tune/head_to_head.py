"""The head-to-head that seeds the routing table: the kernel against the
library at every seed problem, on one card.

    python -m tpu_matmul_bench_torch.tune.head_to_head [--out DIR] [--dtypes ...]
    python -m tpu_matmul_bench_torch.tune.head_to_head --report [--out DIR]

The port's counterpart of the JAX package's r4 head-to-head. At each seed
problem (`tune/promote.py`: 8 squares and 2 rectangles, for bfloat16, int8
and float32) it runs `python -m tpu_matmul_bench_torch matmul --timing
fused --validate` with `--matmul-impl torch` and with `--matmul-impl cuda`,
each in a process of its own, in the order torch, cuda, cuda, torch, so
that drift on the card falls on both alike. Each run's manifest and record
are appended to one ledger a dtype, `DIR/<dtype>.ndjson` (default DIR:
measurements/torch/h2h): JSON lines, as every ledger, named `.ndjson`
because the JAX package's perf history (`tpu_matmul_bench/obs/history.py`)
takes every `measurements/**/*.jsonl` for its own committed store, which
holds the JAX package's runs and not the port's. A problem's fused chain
is as long as it takes to hold about 2e14 operations (3 to 200 products),
the same for both impls.

`--report` reads the ledgers back and prints, for each problem, the median
of each impl's runs, the margin (torch ms / cuda ms − 1, in %) and the
impl the routing table takes there: `cuda` only where the kernel wins by
at least `promote.TIE_GATE_PCT`, else `torch` (unmeasured or tied goes to
the library, the safe default). Run from the repository root, on a
machine with one card; the kernels are built first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

from tpu_matmul_bench_torch.tune.db import REPO_ROOT
from tpu_matmul_bench_torch.tune.promote import (
    SEED_DTYPES,
    TIE_GATE_PCT,
    seed_problems,
)

ORDER = ("torch", "cuda", "cuda", "torch")
DEFAULT_DIR = os.path.join("measurements", "torch", "h2h")
CHAIN_OPERATIONS = 2e14
CHILD_TIMEOUT_S = 900

def chain_length(m: int, k: int, n: int) -> int:
    """Products in one problem's fused chain: about CHAIN_OPERATIONS in
    all, at least 3 and at most 200."""
    return min(200, max(3, int(CHAIN_OPERATIONS // (2 * m * k * n))))


def child_argv(impl: str, dtype: str, mkn: tuple[int, int, int], out: str) -> list[str]:
    m, k, n = mkn
    shape = ["--sizes", str(m)] if m == k == n else ["--mkn", str(m), str(k), str(n)]
    return [sys.executable, "-m", "tpu_matmul_bench_torch", "matmul", *shape,
            "--dtype", dtype, "--matmul-impl", impl, "--timing", "fused",
            "--iterations", str(chain_length(m, k, n)), "--validate",
            "--json-out", out]


def run(out_dir: str, dtypes) -> int:
    """Every run of the head-to-head, appended to its dtype's ledger; one
    JSON line a run on stdout. Returns the number of failed runs."""
    from tpu_matmul_bench_torch.ops import _build

    _build.build("matmul")
    os.makedirs(out_dir, exist_ok=True)
    failed = 0
    for dtype in dtypes:
        ledger = os.path.join(out_dir, f"{dtype}.ndjson")
        open(ledger, "w").close()
        for mkn in seed_problems():
            for turn, impl in enumerate(ORDER):
                with tempfile.TemporaryDirectory() as tmp:
                    out = os.path.join(tmp, "run.jsonl")
                    try:
                        proc = subprocess.run(child_argv(impl, dtype, mkn, out), cwd=REPO_ROOT,
                                              capture_output=True, text=True,
                                              timeout=CHILD_TIMEOUT_S)
                        rc, tail = proc.returncode, proc.stderr[-600:] + proc.stdout[-600:]
                    except subprocess.TimeoutExpired:
                        rc, tail = "timeout", ""
                    lines = open(out).read() if os.path.exists(out) else ""
                recs = [json.loads(line) for line in lines.splitlines() if line.strip()]
                rec = recs[-1] if len(recs) == 2 else None
                ok = rc == 0 and rec is not None \
                    and rec["extras"].get("validation") == "ok"
                if ok:
                    with open(ledger, "a") as fh:
                        fh.write(lines)
                else:
                    failed += 1
                print(json.dumps({"dtype": dtype, "mkn": list(mkn), "impl": impl,
                                  "turn": turn, "rc": rc, "ok": ok,
                                  "ms": rec and rec["avg_time_s"] * 1e3,
                                  **({} if ok else {"tail": tail})}), flush=True)
    return failed


def load(path: str) -> dict[tuple[int, int, int], dict[str, list[float]]]:
    """{(m, k, n): {impl: [ms of each run]}} from one ledger, each record's
    impl read from the manifest before it."""
    out: dict = {}
    impl = None
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("record_type") == "manifest":
                impl = rec["config"]["matmul_impl"]
                continue
            shape = rec["extras"].get("shape")
            mkn = tuple(int(v) for v in shape.split("x")) if shape else (rec["size"],) * 3
            out.setdefault(mkn, {}).setdefault(impl, []).append(rec["avg_time_s"] * 1e3)
    return out


def margins(path: str) -> list[dict]:
    """Per problem of one ledger: each impl's median ms, the kernel's
    margin over the library (torch ms / cuda ms − 1, %) and the winner
    under the TIE_GATE_PCT gate (`torch` where either impl is missing)."""
    rows = []
    for (m, k, n), runs in load(path).items():
        torch_ms = statistics.median(runs["torch"]) if runs.get("torch") else None
        cuda_ms = statistics.median(runs["cuda"]) if runs.get("cuda") else None
        margin = (torch_ms / cuda_ms - 1) * 100 if torch_ms and cuda_ms else None
        rows.append({"m": m, "k": k, "n": n, "torch_ms": torch_ms, "cuda_ms": cuda_ms,
                     "runs": {impl: len(v) for impl, v in runs.items()},
                     "margin_pct": margin,
                     "impl": "cuda" if margin is not None and margin >= TIE_GATE_PCT
                     else "torch"})
    return rows


def report(out_dir: str, dtypes) -> None:
    print("| dtype | m×k×n | torch ms | cuda ms | margin % | impl |")
    print("|---|---|---|---|---|---|")
    for dtype in dtypes:
        path = os.path.join(out_dir, f"{dtype}.ndjson")
        if not os.path.exists(path):
            continue
        for r in margins(path):
            print(f"| {dtype} | {r['m']}×{r['k']}×{r['n']} | {r['torch_ms']} | "
                  f"{r['cuda_ms']} | {r['margin_pct']} | {r['impl']} |")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", default=DEFAULT_DIR,
                        help="ledger directory (default: %(default)s)")
    parser.add_argument("--dtypes", nargs="+", default=list(SEED_DTYPES),
                        choices=list(SEED_DTYPES))
    parser.add_argument("--report", action="store_true",
                        help="read the ledgers and print the margins; run nothing")
    args = parser.parse_args(argv)
    if args.report:
        report(args.out, args.dtypes)
        return 0
    failed = run(args.out, args.dtypes)
    report(args.out, args.dtypes)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
