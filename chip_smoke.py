#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the repository root, on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port (`tpu_matmul_bench_torch/csrc/`)
from the sources in the checkout, prints each kernel's registers and spill
bytes, holds each kernel against its plain PyTorch version on the card
(every tile and grid order of the GEMM, and its split-K form with the
reduction), and drives the port's two paths through their normal entry
points:

- the single-device bf16 16384x16384 matmul benchmark through the
  hand-written kernel, `tpu_matmul_bench_torch.benchmarks.matmul_benchmark
  .main`, with both timing protocols, then once through the library
  product as the yardstick;
- the tile tuner, `tpu_matmul_bench_torch.benchmarks.cuda_tune.main`, over
  every tile at bf16 16384^3 in both grid orders, then with `--ksplit 2`
  at 16384^3 and at the tall-M 28672x4096x8192.

Standard output is one JSON object per line: one per phase, then the
`kernels` line, then `{"ok": true, "device": {...}}` as the last line. The
programs' own reports go to standard error. The script exits nonzero,
without the last line, at the first phase that fails, when no CUDA device
is present, and when the port's package is not beside it.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
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
# every tensor-core tile x grid order: the ragged and the vector load paths
TILE_SHAPES = [(129, 64, 257), (1000, 1000, 1000)]
TILE_DTYPES = ["bfloat16", "float16", "int8"]
TALL = (28672, 4096, 8192)  # (m, k, n): the tall-M rectangle of the split-K
# split-K cases: (dtype, (m, k, n), splits); K=512 with 3 splits has no
# 128-aligned equal split and must run as one pass, with no reduction
KSPLIT_CASES = (
    [(d, (1024, 4096, 1024), s) for s in (2, 4)
     for d in ("bfloat16", "float16", "float32", "int8")]
    + [("bfloat16", TALL, 2), ("bfloat16", (SIZE, SIZE, SIZE), 2),
       ("bfloat16", (256, 512, 256), 3)])
TUNE_ITERATIONS, TUNE_WARMUP, CONFIRM_TOP = 10, 2, 3


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


def compare(dtype_name: str, mkn, kernel, plain) -> dict:
    """One kernel-vs-plain case on the card: both on the same random
    operands, held to the dtype's tolerance."""
    import torch

    from tpu_matmul_bench_torch.ops.matmul import random_operands

    m, k, n = mkn
    dtype = getattr(torch, dtype_name)
    (a,) = random_operands(1, (m, k), dtype, device="cuda", count=1)
    (b,) = random_operands(2, (k, n), dtype, device="cuda", count=1)
    got = kernel(a, b)
    want = plain(a, b)
    torch.cuda.synchronize()
    ok_shape = tuple(got.shape) == (m, n) and got.dtype == want.dtype
    diff = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item() or 1.0
    rel = diff / scale
    finite = bool(torch.isfinite(got.double()).all().item())
    return {"dtype": dtype_name, "shape": [m, k, n], "max_abs_err": diff,
            "max_rel_err": rel, "tolerance": TOLERANCE[dtype_name],
            "ok": ok_shape and finite and rel <= TOLERANCE[dtype_name]}


def check_kernel(dtype_name: str, mkn) -> dict:
    """One kernel-vs-plain case of the default tile on the card."""
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm

    return {"phase": "kernel_vs_plain", "kernel": "matmul",
            **compare(dtype_name, mkn, cm.cuda_matmul, cm.matmul_plain)}


def check_tiles() -> None:
    """Every instantiated tile in both grid orders against the plain
    version, at a ragged and a vector-aligned shape, in every tensor-core
    dtype. One line per (tile, order)."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm

    for tile in cm.TILES:
        for order in cm.GRID_ORDERS:
            before = cm.LAUNCHES
            cases = [compare(d, s, lambda a, b: cm.cuda_matmul(
                         a, b, blocks=tile, grid_order=order), cm.matmul_plain)
                     for d in TILE_DTYPES for s in TILE_SHAPES]
            launched = cm.LAUNCHES - before
            ok = all(c["ok"] for c in cases) and launched == len(cases)
            emit({"phase": "kernel_vs_plain[tiles]", "tile": list(tile),
                  "grid_order": order, "launches": launched,
                  "max_rel_err": {f"{c['dtype']}@{'x'.join(map(str, c['shape']))}":
                                  c["max_rel_err"] for c in cases},
                  "ok": ok})
            if not ok:
                fail("kernel_vs_plain[tiles]",
                     f"tile {tile} {order}: {[c for c in cases if not c['ok']]}"
                     f" (launches {launched})")
    torch.cuda.empty_cache()


def check_ksplit() -> dict:
    """The split-K kernels against their plain version. Returns the max
    abs error per shape (for the kernels line)."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm

    errors = {}
    for dtype_name, mkn, splits in KSPLIT_CASES:
        effective = cm.effective_ksplit(mkn[1], splits)
        gemm0, reduce0 = cm.LAUNCHES, cm.REDUCE_LAUNCHES
        result = compare(
            dtype_name, mkn,
            lambda a, b: cm.cuda_matmul_ksplit(a, b, splits=splits),
            lambda a, b: cm.matmul_ksplit_plain(a, b, splits=splits))
        gemm, reduce = cm.LAUNCHES - gemm0, cm.REDUCE_LAUNCHES - reduce0
        # one GEMM launch either way; the reduction only for a real split
        want_reduce = 1 if effective > 1 else 0
        result.update(phase="kernel_vs_plain[ksplit]", kernel="matmul_ksplit",
                      splits=splits, effective_splits=effective,
                      gemm_launches=gemm, reduce_launches=reduce)
        result["ok"] = result["ok"] and gemm == 1 and reduce == want_reduce
        emit(result)
        if not result["ok"]:
            fail("kernel_vs_plain[ksplit]", f"{dtype_name} {mkn} S={splits}: "
                 f"{result}")
        if dtype_name == "bfloat16" and splits == 2 and mkn[0] > 4096:
            errors[mkn] = result["max_abs_err"]
        torch.cuda.empty_cache()
    return errors


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


def tune(phase: str, extra: list[str], out_dir: str,
         ksplit: int = 1) -> tuple[dict, int, int]:
    """One tune run through the tuner's entry point over every tile.
    Returns {tile: sweep ms} and the GEMM and reduction launches counted
    during it."""
    from tpu_matmul_bench_torch.benchmarks import cuda_tune
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.utils.telemetry import is_manifest

    path = f"{out_dir}/{re.sub(r'[^a-z0-9]+', '_', phase)}.jsonl"
    argv = ["--dtype", "bfloat16",
            "--candidates", *[",".join(map(str, t)) for t in cm.TILES],
            "--iterations", str(TUNE_ITERATIONS), "--warmup", str(TUNE_WARMUP),
            "--validate", "--confirm-top", str(CONFIRM_TOP),
            "--json-out", path, *extra]
    cm.LAUNCHES = 0
    cm.REDUCE_LAUNCHES = 0
    with contextlib.redirect_stdout(sys.stderr):
        records = cuda_tune.main(argv)
    gemm, reduce = cm.LAUNCHES, cm.REDUCE_LAUNCHES
    with open(path) as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    sweep = [r for r in records if not r.extras.get("confirm_pass")]
    confirm = [r for r in records if r.extras.get("confirm_pass")]

    def tile(r):
        return tuple(r.extras[f"block_{d}"] for d in "mnk")

    validated = {tile(r) for r in sweep if r.extras.get("validation") == "ok"}
    problems = []
    if sorted(tile(r) for r in sweep) != sorted(cm.TILES):
        problems.append(f"the sweep measured {[tile(r) for r in sweep]}, "
                        "not every tile once")
    if len(confirm) != CONFIRM_TOP:
        problems.append(f"{len(confirm)} confirm records, not {CONFIRM_TOP}")
    for r in records:
        if tile(r) not in validated:
            problems.append(f"tile {tile(r)} has no validation: ok")
        if not (r.peak_efficiency_pct is not None
                and 0 < r.peak_efficiency_pct <= 100):
            problems.append(f"tile {tile(r)} peak_efficiency_pct "
                            f"{r.peak_efficiency_pct} outside (0, 100]")
        if r.extras.get("ksplit", 1) != ksplit:
            problems.append(f"tile {tile(r)} carries ksplit "
                            f"{r.extras.get('ksplit')}, not {ksplit}")
    if not lines or not is_manifest(lines[0]):
        problems.append("the JSONL does not start with its manifest")
    if len(lines) != 1 + len(records):
        problems.append("the JSONL does not hold every record after the manifest")
    if gemm <= 0:
        problems.append("the GEMM kernel was not launched")
    if ksplit > 1 and reduce <= 0:
        problems.append("the split-K reduction was not launched")
    if ksplit == 1 and reduce != 0:
        problems.append("a single-pass sweep launched the reduction")
    tiles_ms = {"x".join(map(str, tile(r))): r.avg_time_s * 1e3 for r in sweep}
    summary = {"phase": phase, "tiles_ms": tiles_ms,
               "confirm_ms": {"x".join(map(str, tile(r))): r.avg_time_s * 1e3
                              for r in confirm},
               "peak_efficiency_pct": {
                   "x".join(map(str, tile(r))): r.peak_efficiency_pct
                   for r in sweep},
               "gemm_launches": gemm, "reduce_launches": reduce,
               "ok": not problems}
    emit(summary)
    if problems:
        fail(phase, "; ".join(problems))
    return tiles_ms, gemm, reduce


def ksplit_entry(shape, max_abs_err: float, gemm: int, reduce: int,
                 peak: float, bw: float) -> dict:
    """Times and bound of the split-K (S=2, default tile, dispatch) at one
    shape: the kernels, their plain version, and torch.matmul."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops.matmul import random_operands

    m, k, n = shape
    (a,) = random_operands(3, (m, k), torch.bfloat16, device="cuda", count=1)
    (b,) = random_operands(4, (k, n), torch.bfloat16, device="cuda", count=1)
    kernel_ms = events_ms(lambda: cm.cuda_matmul_ksplit(a, b, splits=2), runs=5)
    plain_ms = events_ms(lambda: cm.matmul_ksplit_plain(a, b, splits=2), runs=2)
    library_ms = events_ms(lambda: torch.matmul(a, b), runs=5)
    del a, b
    torch.cuda.empty_cache()
    ops_s = 2.0 * m * n * k / (peak * 1e12)
    # A and B read once, 2 fp32 partials written and read back, C written
    bytes_s = ((m * k + k * n) * 2 + 2 * 2 * m * n * 4 + m * n * 2) / (bw * 1e9)
    return {"shape": f"{m}x{k}x{n}", "splits": 2, "kernel_ms": kernel_ms,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "max_abs_err": max_abs_err,
            "launches": gemm + reduce,
            "launches_by_kernel": {"matmul_ksplit": gemm,
                                   "reduce_partials": reduce}}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    try:
        from tpu_matmul_bench_torch.ops import _build
        from tpu_matmul_bench_torch.ops.cuda_matmul import (
            TILES,
            matmul_plain,
            occupancy,
        )
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

    # 2. the build, from the sources in this checkout, with each kernel's
    # registers and spill bytes as ptxas reports them
    t0 = time.perf_counter()
    try:
        libs = _build.build()
        seconds = time.perf_counter() - t0
        resources = {name: _build.resource_usage(name) for name in libs}
        blocks_per_sm = {"x".join(map(str, t)): occupancy(t, torch.bfloat16)
                         for t in TILES}
    except (_build.KernelBuildError, OSError, RuntimeError) as e:
        fail("build", str(e))
    emit({"phase": "build", "seconds": seconds,
          "libraries": {k: str(v) for k, v in libs.items()},
          "resources": resources, "bf16_blocks_per_sm": blocks_per_sm})

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
    check_tiles()
    ksplit_errors = check_ksplit()

    # 4. the paths through their entry points; launch counts are set to 0
    # just before each run and read just after
    with tempfile.TemporaryDirectory() as out_dir:
        dispatch, launches = drive("cuda", "dispatch", out_dir)
        fused, launches_fused = drive("cuda", "fused", out_dir)
        library, _ = drive("torch", "dispatch", out_dir)
        tiles_mnk, _, _ = tune(f"tune[{SIZE}]", ["--sizes", str(SIZE)], out_dir)
        tiles_nmk, _, _ = tune(f"tune[{SIZE},nmk]", ["--sizes", str(SIZE),
                                                     "--grid-order", "nmk"], out_dir)
        _, gemm_sq, reduce_sq = tune(
            f"tune[ksplit,{SIZE}]", ["--sizes", str(SIZE), "--ksplit", "2"],
            out_dir, ksplit=2)
        _, gemm_tall, reduce_tall = tune(
            "tune[ksplit,{}x{}x{},nmk]".format(*TALL),
            ["--mkn", *map(str, TALL), "--grid-order", "nmk", "--ksplit", "2"],
            out_dir, ksplit=2)

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

    # 6. the split-K at both tune shapes: S=2, default tile, dispatch
    square = ksplit_entry((SIZE, SIZE, SIZE), ksplit_errors[(SIZE, SIZE, SIZE)],
                          gemm_sq, reduce_sq, peak, bw)
    tall = ksplit_entry(TALL, ksplit_errors[TALL], gemm_tall, reduce_tall,
                        peak, bw)
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
        "tiles_ms": {t: {"mnk": tiles_mnk[t], "nmk": tiles_nmk[t]}
                     for t in tiles_mnk},
    }, {
        "name": "matmul_ksplit", "route": "cuda",
        "source": "tpu_matmul_bench_torch/csrc/matmul.cu",
        "replaces": "tpu_matmul_bench/ops/pallas_matmul.py:352",
        "replaces_function": "pallas_matmul_ksplit",
        "dtype": "bfloat16", "card": card,
        **square, "shapes": [square, tall],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
