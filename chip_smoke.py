#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the repository root, on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port (`tpu_matmul_bench_torch/csrc/`)
from the sources in the checkout, holds each kernel against its plain
PyTorch version on the card, and drives the port's main path — the
single-device bf16 16384x16384 matmul benchmark through the hand-written
kernel — through its normal entry point,
`tpu_matmul_bench_torch.benchmarks.matmul_benchmark.main`, with both timing
protocols, then once through the library product as the yardstick.

Standard output is one JSON object per line: one per phase, then the
`kernels` line, then `{"ok": true, "device": {...}}` as the last line. The
benchmark's own report goes to standard error. The script exits nonzero,
without the last line, at the first phase that fails, when no CUDA device
is present, and when the port's package is not beside it.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time

SIZE = 16384  # the headline: bf16 16384^3 on one device
# kernel-vs-plain cases: (m, k, n) for every dtype, plus the headline shape
# in bf16; tolerances are max|kernel - plain| / max|plain|
SHAPES = [(7, 13, 5), (129, 64, 257), (1000, 1000, 1000), (8192, 4096, 28672)]
TOLERANCE = {"bfloat16": 1e-2, "float16": 2e-3, "float32": 1e-4, "int8": 0.0}
ITERATIONS, WARMUP = 50, 10


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, why: str) -> None:
    emit({"phase": phase, "ok": False, "error": why})
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def events_ms(fn, runs: int) -> float:
    """Mean ms of `fn` over `runs` calls between two CUDA events, after
    one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def check_kernel(dtype_name: str, mkn) -> dict:
    """One kernel-vs-plain case on the card."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops.matmul import random_operands

    m, k, n = mkn
    dtype = getattr(torch, dtype_name)
    (a,) = random_operands(1, (m, k), dtype, device="cuda", count=1)
    (b,) = random_operands(2, (k, n), dtype, device="cuda", count=1)
    got = cm.cuda_matmul(a, b)
    want = cm.matmul_plain(a, b)
    torch.cuda.synchronize()
    ok_shape = tuple(got.shape) == (m, n) and got.dtype == want.dtype
    diff = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item() or 1.0
    rel = diff / scale
    finite = bool(torch.isfinite(got.double()).all().item())
    return {"phase": "kernel_vs_plain", "kernel": "matmul", "dtype": dtype_name,
            "shape": [m, k, n], "max_abs_err": diff, "max_rel_err": rel,
            "tolerance": TOLERANCE[dtype_name],
            "ok": ok_shape and finite and rel <= TOLERANCE[dtype_name]}


def drive(impl: str, timing: str, out_dir: str) -> tuple[dict, int]:
    """One main-path run through the benchmark's entry point; returns the
    record's summary and the kernel launches counted during it."""
    from tpu_matmul_bench_torch.benchmarks import matmul_benchmark
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.utils.telemetry import is_manifest

    path = f"{out_dir}/{impl}-{timing}.jsonl"
    argv = ["--sizes", str(SIZE), "--dtype", "bfloat16", "--num-devices", "1",
            "--matmul-impl", impl, "--validate", "--iterations", str(ITERATIONS),
            "--warmup", str(WARMUP), "--timing", timing, "--json-out", path]
    cm.LAUNCHES = 0
    with contextlib.redirect_stdout(sys.stderr):
        records = matmul_benchmark.main(argv)
    launches = cm.LAUNCHES
    phase = f"main_path[{impl},{timing}]"
    if len(records) != 1:
        fail(phase, f"expected one record, got {len(records)} (the runner "
                    "reports a failed size and returns no record for it)")
    with open(path) as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    rec = records[0]
    peak = rec.peak_efficiency_pct
    summary = {
        "phase": phase, "avg_ms": rec.avg_time_s * 1e3,
        "tflops": rec.tflops_per_device, "peak_efficiency_pct": peak,
        "validation": rec.extras.get("validation"),
        "validation_max_rel_err": rec.extras.get("validation_max_rel_err"),
        "iterations": rec.iterations, "launches": launches,
        "device_kind": rec.device_kind,
    }
    problems = []
    if rec.extras.get("validation") != "ok":
        problems.append("validation is not ok")
    if peak is None or not 0 < peak <= 100:
        problems.append(f"peak_efficiency_pct {peak} outside (0, 100]")
    if not (math.isfinite(rec.avg_time_s) and rec.avg_time_s > 0):
        problems.append(f"avg_time_s {rec.avg_time_s} is not a positive time")
    if not lines or not is_manifest(lines[0]):
        problems.append("the JSONL does not start with its manifest")
    if len(lines) != 2 or lines[1].get("size") != SIZE:
        problems.append("the JSONL does not hold the record after the manifest")
    if impl == "cuda" and launches <= 0:
        problems.append("the hand-written kernel was not launched")
    if impl == "torch" and launches != 0:
        problems.append("the library run launched the hand-written kernel")
    summary["ok"] = not problems
    emit(summary)
    if problems:
        fail(phase, "; ".join(problems))
    return summary, launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    try:
        from tpu_matmul_bench_torch.ops import _build
        from tpu_matmul_bench_torch.ops.cuda_matmul import matmul_plain
        from tpu_matmul_bench_torch.ops.matmul import random_operands
        from tpu_matmul_bench_torch.utils.device import apply_matmul_precision
        from tpu_matmul_bench_torch.utils.metrics import (
            hbm_spec_gbps,
            matmul_flops,
            theoretical_peak_tflops,
        )
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable: {e}",
              file=sys.stderr)
        sys.exit(2)

    # 1. the card
    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail("card", f"nvidia-smi: {e}")
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. the build, from the sources in this checkout
    t0 = time.perf_counter()
    try:
        libs = _build.build()
    except (_build.KernelBuildError, OSError) as e:
        fail("build", str(e))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: str(v) for k, v in libs.items()}})

    # 3. each kernel against its plain version, on the card, in true fp32
    apply_matmul_precision("highest")
    cases = [(d, s) for d in TOLERANCE for s in SHAPES]
    cases.append(("bfloat16", (SIZE, SIZE, SIZE)))
    headline_err = None
    for dtype_name, mkn in cases:
        result = check_kernel(dtype_name, mkn)
        emit(result)
        if not result["ok"]:
            fail("kernel_vs_plain", f"{dtype_name} {mkn}: max rel err "
                                    f"{result['max_rel_err']} > {result['tolerance']}")
        if mkn == (SIZE, SIZE, SIZE):
            headline_err = result["max_abs_err"]
        torch.cuda.empty_cache()

    # 4. the main path through its entry point; launch counts are set to 0
    # just before each run and read just after
    with tempfile.TemporaryDirectory() as out_dir:
        dispatch, launches = drive("cuda", "dispatch", out_dir)
        fused, launches_fused = drive("cuda", "fused", out_dir)
        library, _ = drive("torch", "dispatch", out_dir)

    # 5. the plain version's time at the headline shape
    a, b = random_operands(0, (SIZE, SIZE), torch.bfloat16, device="cuda")
    plain_ms = events_ms(lambda: matmul_plain(a, b), runs=3)
    del a, b
    torch.cuda.empty_cache()

    name = torch.cuda.get_device_name(0)
    peak = theoretical_peak_tflops(name, torch.bfloat16)
    bw = hbm_spec_gbps(name)
    if not peak or not bw:
        fail("bound", f"no peak or bandwidth row for {name!r}")
    ops_s = matmul_flops(SIZE) / (peak * 1e12)
    bytes_s = 3 * SIZE * SIZE * 2 / (bw * 1e9)  # read A and B, write C
    emit({"kernels": [{
        "name": "matmul", "route": "cuda",
        "source": "tpu_matmul_bench_torch/csrc/matmul.cu",
        "replaces": "tpu_matmul_bench/ops/pallas_matmul.py:37",
        "replaces_function": "_matmul_kernel",
        "shape": f"{SIZE}x{SIZE}x{SIZE}", "dtype": "bfloat16",
        "launches": launches, "launches_fused": launches_fused,
        "max_abs_err": headline_err,
        "ms": dispatch["avg_ms"], "kernel_ms": dispatch["avg_ms"],
        "fused_ms": fused["avg_ms"], "plain_ms": plain_ms,
        "bound_ms": max(ops_s, bytes_s) * 1e3,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": library["avg_ms"], "card": card,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
