#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the repository root, on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port (`tpu_matmul_bench_torch/csrc/`)
from the sources in the checkout, prints each kernel's registers and spill
bytes, holds each kernel against its plain PyTorch version on the card
(every tile and grid order of the GEMM, its split-K form with the
reduction, its pickup form, and the two ring matmuls over 1, 2 and 4
ranks, with a 20-call race check of each ring at 2048² and at the main
path's 16384² over 4 ranks), drives the port's paths through their normal
entry points, and then holds every shard of each ring's output at the main
path's shape against its plain version:

- the single-device bf16 16384x16384 matmul benchmark through the
  hand-written kernel, `tpu_matmul_bench_torch.benchmarks.matmul_benchmark
  .main`, with both timing protocols, then once through the library
  product as the yardstick;
- the tile tuner, `tpu_matmul_bench_torch.benchmarks.cuda_tune.main`, over
  every tile at bf16 16384^3 in both grid orders, then with `--ksplit 2`
  at 16384^3 and at the tall-M 28672x4096x8192;
- the overlap program, `tpu_matmul_bench_torch.benchmarks
  .matmul_overlap_benchmark.main`, in its two ring modes at bf16 16384^2
  over 4 ranks that share the card (`TMB_RANKS_PER_CARD=4`, set for these
  phases only): their hops copy within the card's memory, not over NVLink.

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
import os
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
# the pickup kernel (C = A.B + accin) against its plain version
ACC_SHAPES = [(129, 64, 257), (1000, 1000, 1000)]
# the rings: rank counts, and (m, k, n) cases; at 4*136 rows over 4 ranks
# each chunk (136 rows) is ragged for the 128-row tile
RANKS = (1, 2, 4)
RING_SHAPES = [(256, 512, 256), (4 * 136, 264, 4 * 136)]
RING_WORLD = 4  # ranks on the card for the overlap phases and the timings
# the race check runs at 2048² (512-row chunks) and at the main path's
# 16384² (128 MiB chunks)
RACE_REPEATS, RACE_SIZES = 20, (2048, SIZE)
OVERLAP_ITERATIONS, OVERLAP_WARMUP = 10, 2


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


@contextlib.contextmanager
def ranks_per_card(n: int):
    """TMB_RANKS_PER_CARD=n for the phases inside: n ranks share the card."""
    before = os.environ.get("TMB_RANKS_PER_CARD")
    os.environ["TMB_RANKS_PER_CARD"] = str(n)
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("TMB_RANKS_PER_CARD")
        else:
            os.environ["TMB_RANKS_PER_CARD"] = before


def card_mesh(d: int):
    """A world of d ranks on the card."""
    from tpu_matmul_bench_torch.parallel.mesh import make_mesh
    from tpu_matmul_bench_torch.utils.device import resolve_devices

    with ranks_per_card(d):
        return make_mesh(resolve_devices("cuda", d))


def check_matmul_acc() -> None:
    """The pickup kernel against its plain version, at the default tile."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops.matmul import random_operands
    from tpu_matmul_bench_torch.utils.metrics import matmul_out_dtype

    for dtype_name in TOLERANCE:
        for m, k, n in ACC_SHAPES:
            dtype = getattr(torch, dtype_name)
            (acc,) = random_operands(5, (m, n), dtype, device="cuda", count=1)
            accin = acc.to(matmul_out_dtype(dtype))
            before = cm.ACC_LAUNCHES
            result = compare(dtype_name, (m, k, n),
                             lambda a, b: cm.cuda_matmul_acc(a, b, accin),
                             lambda a, b: cm.matmul_acc_plain(a, b, accin))
            launched = cm.ACC_LAUNCHES - before
            result.update(phase="kernel_vs_plain[matmul_acc]", kernel="matmul_acc",
                          launches=launched)
            result["ok"] = result["ok"] and launched == 1
            emit(result)
            if not result["ok"]:
                fail("kernel_vs_plain[matmul_acc]", f"{dtype_name} {(m, k, n)}: {result}")


def ring_fns(reduce_scatter: bool):
    """(label, builder, plain version) of one ring."""
    from tpu_matmul_bench_torch.ops import cuda_ring as cr

    if reduce_scatter:
        return ("ring_rs", cr.ring_reduce_scatter_matmul_hbm,
                cr.ring_reduce_scatter_matmul_plain)
    return "ring_ag", cr.ring_allgather_matmul_hbm, cr.ring_allgather_matmul_plain


def ring_operands(mesh, reduce_scatter: bool, mkn, dtype, seed: int):
    """Random global X[m,k] and W[k,n] made on the card, cut by the ring's
    specs."""
    from tpu_matmul_bench_torch.ops.matmul import random_operands
    from tpu_matmul_bench_torch.parallel.mesh import COLS, ROWS, shard_tensor

    m, k, n = mkn
    (xg,) = random_operands(seed, (m, k), dtype, device="cuda", count=1)
    (wg,) = random_operands(seed + 1, (k, n), dtype, device="cuda", count=1)
    x_spec, w_spec = (COLS, ROWS) if reduce_scatter else (ROWS, COLS)
    return shard_tensor(xg, x_spec, mesh), shard_tensor(wg, w_spec, mesh)


def check_rings() -> None:
    """Each ring on the card against its plain version, over 1, 2 and 4
    ranks, in every dtype, at an even and a ragged chunk. One line per
    (ring, ranks); the step and hop counts must rise by D² and D·(D−1)
    per call."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_ring as cr
    from tpu_matmul_bench_torch.parallel.mesh import gather

    for reduce_scatter in (False, True):
        label, build, plain = ring_fns(reduce_scatter)
        for d in RANKS:
            fn = build(card_mesh(d))
            errors, problems = {}, []
            for dtype_name in TOLERANCE:
                for mkn in RING_SHAPES:
                    x, w = ring_operands(fn.mesh, reduce_scatter, mkn,
                                         getattr(torch, dtype_name), seed=7)
                    steps, hops = cr.RING_STEPS, cr.HOP_LAUNCHES
                    got = gather(fn(x, w))
                    steps, hops = cr.RING_STEPS - steps, cr.HOP_LAUNCHES - hops
                    want = gather(plain(x, w))
                    torch.cuda.synchronize()
                    rel = ((got.double() - want.double()).abs().max().item()
                           / (want.double().abs().max().item() or 1.0))
                    case = f"{dtype_name}@{'x'.join(map(str, mkn))}"
                    errors[case] = rel
                    if got.shape != want.shape or got.dtype != want.dtype:
                        problems.append(f"{case}: {tuple(got.shape)} {got.dtype}")
                    if not (rel <= TOLERANCE[dtype_name]
                            and bool(torch.isfinite(got.double()).all())):
                        problems.append(f"{case}: max rel err {rel}")
                    if (steps, hops) != (d * d, d * (d - 1)):
                        problems.append(f"{case}: {steps} steps, {hops} hops")
            emit({"phase": f"kernel_vs_plain[{label}]", "ranks": d,
                  "max_rel_err": errors, "tolerance": TOLERANCE, "ok": not problems})
            if problems:
                fail(f"kernel_vs_plain[{label}]", f"D={d}: {problems}")
            torch.cuda.empty_cache()


def check_races(s: int) -> None:
    """The JAX tests' placement case (all-gather: X's row block r holds r,
    W = I) and every-rank case (reduce-scatter: X's column block j holds
    2**j, W = I), at s×s, each RACE_REPEATS calls in a row over RING_WORLD
    ranks before one synchronize; every result must equal X exactly. A
    missing event between the streams shows here as a wrong block now and
    then."""
    import torch

    from tpu_matmul_bench_torch.parallel.mesh import COLS, ROWS, gather, shard_tensor

    d = RING_WORLD
    mesh = card_mesh(d)
    block = torch.arange(d, device="cuda", dtype=torch.float32).repeat_interleave(s // d)
    ones = torch.ones(s, device="cuda")
    eye = torch.eye(s, device="cuda", dtype=torch.bfloat16)
    cases = [(False, (block[:, None] * ones[None, :]).to(torch.bfloat16), ROWS, COLS),
             (True, (ones[:, None] * (2.0 ** block)[None, :]).to(torch.bfloat16),
              COLS, ROWS)]
    for reduce_scatter, xg, x_spec, w_spec in cases:
        label, build, _ = ring_fns(reduce_scatter)
        fn = build(mesh)
        x, w = shard_tensor(xg, x_spec, mesh), shard_tensor(eye, w_spec, mesh)
        outs = [fn(x, w) for _ in range(RACE_REPEATS)]
        torch.cuda.synchronize()
        bad = [i for i, y in enumerate(outs) if not torch.equal(gather(y), xg)]
        del outs, x, w
        emit({"phase": f"races[{label}]", "ranks": d, "size": s,
              "calls": RACE_REPEATS, "wrong_calls": bad, "ok": not bad})
        if bad:
            fail(f"races[{label}]", f"calls {bad} of {RACE_REPEATS} differ from X")
    torch.cuda.empty_cache()


def drive_overlap(mode: str, out_dir: str) -> tuple[dict, dict]:
    """One overlap run through the program's entry point, its ranks on the
    card; returns the record's summary and the launches counted during it."""
    from tpu_matmul_bench_torch.benchmarks import matmul_overlap_benchmark
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops import cuda_ring as cr
    from tpu_matmul_bench_torch.utils.telemetry import is_manifest

    path = f"{out_dir}/{mode}.jsonl"
    argv = ["--mode", mode, "--sizes", str(SIZE), "--dtype", "bfloat16",
            "--num-devices", str(RING_WORLD), "--matmul-impl", "cuda",
            "--iterations", str(OVERLAP_ITERATIONS), "--warmup", str(OVERLAP_WARMUP),
            "--validate", "--json-out", path]
    cm.LAUNCHES = cm.ACC_LAUNCHES = 0
    cr.RING_STEPS = cr.HOP_LAUNCHES = 0
    with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr):
        records = matmul_overlap_benchmark.main(argv)
    counts = {"matmul": cm.LAUNCHES, "matmul_acc": cm.ACC_LAUNCHES,
              "ring_steps": cr.RING_STEPS, "ring_hops": cr.HOP_LAUNCHES}
    phase = f"overlap[{mode}]"
    if len(records) != 1:
        fail(phase, f"expected one record, got {len(records)} (the runner "
                    "reports a failed size and returns no record for it)")
    with open(path) as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    rec = records[0]
    peak = rec.peak_efficiency_pct
    x = rec.extras
    summary = {"phase": phase, "avg_ms": rec.avg_time_s * 1e3,
               "baseline_ms": rec.compute_time_s * 1e3,
               "overlap_speedup_x": x.get("overlap_speedup_x"),
               "tflops_per_card": rec.tflops_per_device, "peak_efficiency_pct": peak,
               "world": rec.world, "cards": x.get("cards"),
               "ranks_per_card": x.get("ranks_per_card"),
               "validation": x.get("validation"),
               "validation_max_rel_err": x.get("validation_max_rel_err"),
               "wres_engaged": x.get("wres_engaged"), "launches": counts}
    problems = []
    if x.get("validation") != "ok":
        problems.append("validation is not ok")
    if peak is None or not 0 < peak <= 100:
        problems.append(f"peak_efficiency_pct {peak} outside (0, 100]")
    if rec.world != RING_WORLD or x.get("cards") != 1:
        problems.append(f"world {rec.world} on {x.get('cards')} cards, "
                        f"not {RING_WORLD} on 1")
    if x.get("timing", "dispatch") != "dispatch":
        problems.append(f"timing {x.get('timing')}, not dispatch")
    if x.get("wres_engaged") is not False:
        problems.append(f"wres_engaged {x.get('wres_engaged')}, not False")
    if not lines or not is_manifest(lines[0]):
        problems.append("the JSONL does not start with its manifest")
    if len(lines) != 2 or lines[1].get("mode") != mode:
        problems.append("the JSONL does not hold the record after the manifest")
    if counts["matmul"] <= 0 or counts["ring_steps"] <= 0 or counts["ring_hops"] <= 0:
        problems.append(f"a kernel of the path was not launched: {counts}")
    if mode == "cuda_ring_rs_hbm" and counts["matmul_acc"] <= 0:
        problems.append("the pickup kernel was not launched")
    summary["ok"] = not problems
    emit(summary)
    if problems:
        fail(phase, "; ".join(problems))
    return summary, counts


def ring_bound(reduce_scatter: bool, m: int, k: int, n: int, d: int,
               item: int, out_item: int, peak: float, bw: float) -> tuple[float, str]:
    """The least time for one ring call: its 2mnk operations at the peak,
    or the bytes it must move at the memory rate: X, W read once, Y written
    once, and each of the D·(D−1) hops reading and writing its chunk; K3
    also writes each staged partial once and reads each as accin once."""
    ops_s = 2.0 * m * n * k / (peak * 1e12)
    moved = (m * k + k * n) * item + m * n * out_item
    hops = d * (d - 1)
    if reduce_scatter:
        moved += 4 * hops * (m // d) * n * out_item
    else:
        moved += 2 * hops * (m // d) * k * item
    bytes_s = moved / (bw * 1e9)
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def ring_entry(reduce_scatter: bool, counts: dict, baseline_ms: float,
               card: str, peak: float, bw: float) -> dict:
    """Times and bound of one ring at bf16 SIZE², RING_WORLD ranks on the
    card: the ring, its plain version and torch.matmul of the gathered
    operands, with the main path's launches and its baseline leg. Every
    shard of the ring's output is first held against the plain version's,
    max|ring − plain| / max|plain| within the bf16 tolerance."""
    import torch

    from tpu_matmul_bench_torch.parallel.mesh import gather

    label, build, plain = ring_fns(reduce_scatter)
    fn = build(card_mesh(RING_WORLD))
    x, w = ring_operands(fn.mesh, reduce_scatter, (SIZE, SIZE, SIZE),
                         torch.bfloat16, seed=11)
    got, want = gather(fn(x, w)), gather(plain(x, w))
    torch.cuda.synchronize()
    max_abs_err = (got.float() - want.float()).abs().max().item()
    max_rel_err = max_abs_err / (want.float().abs().max().item() or 1.0)
    finite = bool(torch.isfinite(got.float()).all())
    ok = (tuple(got.shape) == (SIZE, SIZE) and got.dtype == want.dtype == torch.bfloat16
          and finite and max_rel_err <= TOLERANCE["bfloat16"])
    phase = f"kernel_vs_plain[{label},{SIZE}]"
    emit({"phase": phase, "ranks": RING_WORLD, "shape": [SIZE] * 3,
          "max_abs_err": max_abs_err, "max_rel_err": max_rel_err,
          "tolerance": TOLERANCE["bfloat16"], "finite": finite, "ok": ok})
    if not ok:
        fail(phase, f"{tuple(got.shape)} {got.dtype}, finite {finite}, "
                    f"max rel err {max_rel_err}")
    del got, want
    kernel_ms = events_ms(lambda: fn(x, w), runs=5)
    plain_ms = events_ms(lambda: plain(x, w), runs=2)
    xg, wg = gather(x), gather(w)
    library_ms = events_ms(lambda: torch.matmul(xg, wg), runs=5)
    del x, w, xg, wg
    torch.cuda.empty_cache()
    bound_ms, bound_by = ring_bound(reduce_scatter, SIZE, SIZE, SIZE, RING_WORLD,
                                    2, 2, peak, bw)
    products = counts["ring_steps"]
    return {"route": "cuda", "dtype": "bfloat16", "card": card,
            "shape": f"{SIZE}x{SIZE}x{SIZE}", "ranks": RING_WORLD, "cards": 1,
            "launches": products + counts["ring_hops"],
            "launches_by_kernel": {"products": products, "hops": counts["ring_hops"],
                                   **({"matmul_acc": counts["matmul_acc"]}
                                      if reduce_scatter else {})},
            "max_abs_err": max_abs_err, "max_rel_err": max_rel_err,
            "tolerance": TOLERANCE["bfloat16"], "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "baseline_ms": baseline_ms}


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
    check_matmul_acc()
    check_rings()
    for size in RACE_SIZES:
        check_races(size)

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
        ring_ag, ring_ag_counts = drive_overlap("cuda_ring_hbm", out_dir)
        ring_rs, ring_rs_counts = drive_overlap("cuda_ring_rs_hbm", out_dir)

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

    # 7. the rings at bf16 16384^2 over RING_WORLD ranks on the card
    ag = ring_entry(False, ring_ag_counts, ring_ag["baseline_ms"], card, peak, bw)
    rs = ring_entry(True, ring_rs_counts, ring_rs["baseline_ms"], card, peak, bw)
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
    }, {
        "name": "ring_allgather_matmul",
        "source": "tpu_matmul_bench_torch/ops/cuda_ring.py",
        "replaces": "tpu_matmul_bench/ops/pallas_ring_hbm.py:291",
        "replaces_function": "ring_allgather_matmul_hbm",
        "kernels": ["csrc/matmul.cu tmb_matmul", "csrc/ring.cu tmb_ring_hop"],
        **ag,
    }, {
        "name": "ring_reduce_scatter_matmul",
        "source": "tpu_matmul_bench_torch/ops/cuda_ring.py",
        "replaces": "tpu_matmul_bench/ops/pallas_ring_rs_hbm.py:259",
        "replaces_function": "ring_reduce_scatter_matmul_hbm",
        "kernels": ["csrc/matmul.cu tmb_matmul", "csrc/matmul.cu tmb_matmul_acc",
                    "csrc/ring.cu tmb_ring_hop"],
        **rs,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
