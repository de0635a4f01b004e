#!/usr/bin/env python3
"""Time K1's library build, split into units as `ops/_build.py` builds it,
against one source file in one nvcc, and compare the kernels ptxas made.

    python3 scripts/k1_build_probe.py [--one-file PATH] [--split-compile]

Run it from the repository root on a machine with nvcc (the CUDA toolkit).
PATH is a `csrc/matmul.cu` that holds K1's whole library in one file, for
example the one of a commit from before the split unpacked with `git
archive` into a directory that .gitignore lists; it compiles against the
headers beside it. With `--split-compile` that file is also built with
nvcc's `--split-compile=0`, `--split-compile=8`, and `--split-compile=0`
for ptxas too.

Standard output: nvcc's version and the machine's cores, then one JSON line
a build (its seconds of wall time, its exit code and its kernels, each
build cold into a directory of its own), then one line a one-file build
that holds its kernels against the split build's by readable name:
registers, stack, spill bytes and ptxas's wgmma warnings, and the kernels
that differ.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpu_matmul_bench_torch.ops import _build  # noqa: E402

KEYS = ("registers", "stack_bytes", "spill_store_bytes", "spill_load_bytes", "warnings")
VARIANTS = {"one_nvcc": [], "split_compile_0": ["--split-compile=0"],
            "split_compile_8": ["--split-compile=8"],
            "split_compile_0_ptxas": ["--split-compile=0", "-Xptxas", "--split-compile=0"]}


def split_build(where: Path) -> tuple[dict, dict]:
    """`_build.build("matmul")` cold into `where`: its line and its kernels."""
    _build.BUILD_DIR = where
    t0, runs = time.perf_counter(), _build.NVCC_RUNS
    try:
        _build.build("matmul")
        rc = 0
    except _build.KernelBuildError as e:
        print(str(e)[-3000:], file=sys.stderr)
        rc = 1
    usage = _build.resource_usage("matmul") if rc == 0 else {}
    return {"build": "split", "units": len(_build.units("matmul")),
            "nvcc_runs": _build.NVCC_RUNS - runs, "seconds": time.perf_counter() - t0,
            "rc": rc, "kernels": len(usage)}, usage


def one_file_build(source: Path, extra: list[str], where: Path) -> tuple[dict, dict]:
    """`source` in one nvcc with the library's flags and `extra`."""
    t0 = time.perf_counter()
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *extra, "-o",
                          str(where / "lib.so"), str(source)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    usage = _build.readable_usage(out.stdout + out.stderr) if out.returncode == 0 else {}
    if out.returncode:
        print((out.stdout + out.stderr)[-3000:], file=sys.stderr)
    return {"seconds": seconds, "rc": out.returncode, "kernels": len(usage)}, usage


def differences(a: dict, b: dict) -> dict:
    """Kernel -> (a's, b's) where their KEYS differ or one lacks it."""
    pick = (lambda u, k: {key: u[k].get(key, [] if key == "warnings" else None)
                          for key in KEYS} if k in u else None)
    return {k: (pick(a, k), pick(b, k)) for k in sorted(set(a) | set(b))
            if pick(a, k) != pick(b, k)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--one-file", type=Path, help="a csrc/matmul.cu of K1's whole library")
    ap.add_argument("--split-compile", action="store_true",
                    help="also build that file with nvcc's --split-compile")
    args = ap.parse_args()
    nvcc = _build.nvcc_path()
    print(subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout.strip())
    print(json.dumps({"cores": os.cpu_count()}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        line, split = split_build(Path(tmp) / "split")
        print(json.dumps(line), flush=True)
        if args.one_file is None:
            return line["rc"]
        failed = line["rc"]
        for label, extra in VARIANTS.items():
            if label != "one_nvcc" and not args.split_compile:
                continue
            where = Path(tmp) / label
            where.mkdir()
            line, usage = one_file_build(args.one_file, extra, where)
            print(json.dumps({"build": label, **line}), flush=True)
            diff = differences(usage, split)
            print(json.dumps({"against_split": label, "same_kernels": set(usage) == set(split),
                              "differ": len(diff), "differences": dict(list(diff.items())[:20])}),
                  flush=True)
            failed |= line["rc"] or bool(diff)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
