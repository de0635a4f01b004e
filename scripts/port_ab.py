#!/usr/bin/env python3
"""A/B of the PyTorch/CUDA port's GEMM between two checkouts, on one card.

    python3 scripts/port_ab.py BASE_DIR [CHANGE_DIR] [--size 16384] [--runs 20]

BASE_DIR and CHANGE_DIR are checkouts of this repository; CHANGE_DIR
defaults to the one this script sits in. A typical BASE_DIR is the parent
commit unpacked with `git archive` into a directory that .gitignore lists
(`build/parent`). Run it on a machine with one NVIDIA card, from the
repository root.

For each checkout it compiles `tpu_matmul_bench_torch/csrc/matmul.cu` with
`nvcc -Xptxas -v` and prints the registers and spill bytes of its bf16
tensor-core kernels at the default tile. Then it times that checkout's
`cuda_matmul` (default tile) at bf16 SIZE^3 between two CUDA events, one
fresh process per run, in the order base, change, change, base, so that
drift on the card falls on both alike. Standard output is one JSON line
per measurement, after a line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tpu_matmul_bench_torch.ops import _build  # noqa: E402

TIME_K1 = r"""
import sys, torch
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops.matmul import random_operands
size, runs = int(sys.argv[1]), int(sys.argv[2])
a, b = random_operands(0, (size, size), torch.bfloat16, device="cuda")
for _ in range(2):
    cm.cuda_matmul(a, b)
torch.cuda.synchronize()
start = torch.cuda.Event(enable_timing=True)
end = torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(runs):
    cm.cuda_matmul(a, b)
end.record()
end.synchronize()
print(start.elapsed_time(end) / runs)
"""


def default_tile_kernels(checkout: Path) -> dict[str, dict[str, int]]:
    """ptxas's registers and spill bytes of the checkout's bf16 wmma
    kernels at the default tile (a checkout whose kernel has one fixed tile
    names no tile in its template arguments; one with the pickup epilogue
    adds its flag after the tile)."""
    source = checkout / "tpu_matmul_bench_torch" / "csrc" / "matmul.cu"
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", f"{tmp}/lib.so",
             str(source)], capture_output=True, text=True, check=True)
    usage = _build.readable_usage(out.stdout + out.stderr)
    return {name: v for name, v in usage.items()
            if name.startswith("wmma_gemm<__nv_bfloat16")
            and ("128, 128, 32" in name or not re.search(r"\d+, \d+, \d+[,>]", name))}


def time_k1(checkout: Path, size: int, runs: int) -> float:
    out = subprocess.run([sys.executable, "-c", TIME_K1, str(size), str(runs)],
                         cwd=checkout, capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("base", type=Path)
    p.add_argument("change", type=Path, nargs="?", default=REPO)
    p.add_argument("--size", type=int, default=16384)
    p.add_argument("--runs", type=int, default=20)
    args = p.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "size": args.size, "runs": args.runs}),
          flush=True)
    checkouts = {"base": args.base.resolve(), "change": args.change.resolve()}
    for label, path in checkouts.items():
        print(json.dumps({"checkout": label, "dir": str(path),
                          "ptxas": default_tile_kernels(path)}), flush=True)
    for label in ("base", "change", "change", "base"):
        ms = time_k1(checkouts[label], args.size, args.runs)
        print(json.dumps({"checkout": label, "k1_default_tile_ms": ms}),
              flush=True)


if __name__ == "__main__":
    main()
