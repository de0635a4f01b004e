#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the repository root, on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port (`tpu_matmul_bench_torch/csrc/`)
from the sources in the checkout, prints each kernel's registers and spill
bytes and the resident blocks per SM of the tensor-core kernels, and fails
if ptxas serialised a wgmma kernel's wgmma or ignored its setmaxnreg. It
holds each kernel against its plain PyTorch version on the card (every tile
and grid order of the GEMM, every tile and epilogue of its wgmma route,
its split-K form with the reduction, its pickup form, and the five ring
matmuls over 1, 2 and 4 ranks, with a 20-call race check of each HBM ring
at 2048² and at the main path's 16384² over 4 ranks, and of the fused ring
at its cap; the persistent GEMM of the ring steps at the reduce-scatter
rings' two step shapes and a ragged one, and in its forwarding mode at the
all-gather rings' two step shapes, a ragged one and a step that does not
forward, each with its route rule held against the kernel's own check),
drives the port's paths through their normal entry points,
then holds every shard of each ring's output at the main path's shape (the
fused ring's at its cap) against its plain version, times the fused
ring and its HBM form at half its cap, at the cap and at twice it, times
one step of each ring in turns with its former schedule and its library
call, and times the all-gather rings in turns with their hop schedule and
the library product at the power limit's steady clocks (`ring_turns`). Each
GEMM launch is counted by route (`cuda_matmul.LAUNCHES_BY_ROUTE`): the
headline run and the split-K tune runs must take the wgmma route, every
ring product at 16384² the persistent GEMM (`wgmma_persistent`: the
reduce-scatter rings' pickup, the all-gather rings' forwarding step) with no
hop, the fused ring its wgmma form, and the unaligned shapes the wmma route.
The paths:

- the single-device bf16 16384x16384 matmul benchmark through the
  hand-written kernel, `tpu_matmul_bench_torch.benchmarks.matmul_benchmark
  .main`, with both timing protocols, then through the library product
  with both protocols as the yardstick, with the SM clock and power draw
  sampled during each run and read right after it; then the `c1` phase,
  the same four runs at the power limit's steady clocks, where the port's
  fused/dispatch ratio may exceed cuBLAS's by at most C1_MARGIN;
- the tile tuner, `tpu_matmul_bench_torch.benchmarks.cuda_tune.main`, over
  every tile at bf16 16384^3 in both grid orders, then with `--ksplit 2`
  at 16384^3 and at the tall-M 28672x4096x8192;
- the overlap program, `tpu_matmul_bench_torch.benchmarks
  .matmul_overlap_benchmark.main`, in its four HBM ring modes at bf16
  16384^2 over 4 ranks that share the card (`TMB_RANKS_PER_CARD=4`, set
  for these phases only; the all-gather rings' products store each chunk
  they load into the reader's slot, and the reduce-scatter rings' each
  partial: the data moves within the card's memory, not over NVLink, and
  no hop runs), then in the fused ring mode `cuda_ring`
  and in `cuda_ring_hbm` at the fused ring's cap, the largest size whose
  operands fit the card's L2;
- the scaling and distributed programs, `tpu_matmul_bench_torch.benchmarks
  .matmul_scaling_benchmark.main` and `.matmul_distributed_benchmark.main`,
  in their five parallel modes at bf16 16384² over 4 ranks on the card,
  each through the kernel under both timing protocols and through the
  library, and `matrix_parallel` over one rank (the `scaling` phase): every
  product on K1's wgmma route (its two other shapes, 16384x16384x4096 and
  16384x4096x16384, held against the plain version first), as many
  launches as the mode makes, `validation: ok`, fused runs that ran fused
  with their operands chained;
- `--profile-dir` (the `profile` phase): `batch_parallel` at 16384² and
  the fused ring at its cap, each traced by torch.profiler, with the
  device time per kernel, the device's busy and idle share inside the
  timed windows and the fused ring's device time a launch read from the
  traces.

Standard output is one JSON object per line: one per phase, then the
`kernels` line, then `{"ok": true, "device": {...}}` as the last line. The
programs' own reports go to standard error. The script exits nonzero,
without the last line, at the first phase that fails, when no CUDA device
is present, and when the port's package is not beside it.
"""

from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import re
import statistics
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
# of the wmma route (129x64x257) and the wgmma route (1000^3)
TILE_SHAPES = [(129, 64, 257), (1000, 1000, 1000)]
# SHAPES whose rows TMA cannot describe (26 and 514 bytes): the wmma route
UNALIGNED = [(7, 13, 5), (129, 64, 257)]
# the wgmma route's cases at every tile, in bf16 and f16: the aligned ragged
# SHAPES with the plain and the fp32 store, K-split partials at S = 2 and 3
# (K = 3072 splits both ways into 128-aligned slabs), the pickup at
# ACC_SHAPES' aligned shape and at a ragged one with strided accin and C,
# and a K slab of a wider A (a strided view)
WGMMA_DTYPES = ["bfloat16", "float16"]
WGMMA_SHAPES = [(1000, 1000, 1000), (8192, 4096, 28672)]
WGMMA_KSPLIT = [((1000, 3072, 1000), 2), ((1000, 3072, 1000), 3), ((8192, 4096, 28672), 2)]
WGMMA_PICKUP = [((1000, 1000, 1000), 0), ((520, 264, 1000), 24)]  # (m, k, n), extra row pad
WGMMA_SLAB = (1000, 1000, 1000, 128)  # (m, k, n, k0): A[:, k0:k0+k] of an m x (k + 256) A
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
# the rings that split chunks in halves, and the fused ring, also at odd
# chunks: 137 rows over 4 ranks, halves of 68 and 69 rows
SPLIT_SHAPES = RING_SHAPES + [(4 * 137, 264, 4 * 137)]
RING_WORLD = 4  # ranks on the card for the overlap phases and the timings
# the race check runs at 2048² (512-row chunks) and at the main path's
# 16384² (128 MiB chunks)
RACE_REPEATS, RACE_SIZES = 20, (2048, SIZE)
OVERLAP_ITERATIONS, OVERLAP_WARMUP = 10, 2
# the scaling and distributed programs: (program, mode) at bf16 SIZE² over
# RING_WORLD ranks on the card, each under the kernel (dispatch, fused) and
# the library (dispatch); matrix_parallel also over one rank (its fallback)
SCALING_RUNS = [("scaling", "independent"), ("scaling", "batch_parallel"),
                ("scaling", "matrix_parallel"), ("distributed", "data_parallel"),
                ("distributed", "model_parallel")]
SCALING_ITERATIONS, SCALING_WARMUP = 10, 2
# rounds of the interleaved compute/full timing (utils/timing.py time_variants)
VARIANT_ROUNDS = 3
# K1's shape in each mode over RING_WORLD ranks, (m, k, n): held against the
# plain version in kernel_vs_plain, on the wgmma route
SCALING_SHAPES = {"independent": (SIZE, SIZE, SIZE), "batch_parallel": (SIZE, SIZE, SIZE),
                  "data_parallel": (SIZE, SIZE, SIZE),
                  "matrix_parallel": (SIZE, SIZE, SIZE // RING_WORLD),
                  "model_parallel": (SIZE, SIZE // RING_WORLD, SIZE)}
# the reduce-scatter rings' step products at 16384² over RING_WORLD ranks,
# (m, k, n): K3's whole chunk and K5's half, and a ragged one whose accin
# and dest rows lie RS_RAGGED_PAD elements further apart than n
RS_STEPS = {"ring_rs": (SIZE // RING_WORLD, SIZE // RING_WORLD, SIZE),
            "ring_rs_bidir": (SIZE // RING_WORLD // 2, SIZE // RING_WORLD, SIZE)}
RS_RAGGED, RS_RAGGED_PAD = (520, 264, 1000), 24
# the all-gather rings' step products at 16384² over RING_WORLD ranks,
# (m, k, n): K2's whole chunk and K4's half, each forwarding its A into a
# slot; a ragged one whose dest and slot rows lie AG_RAGGED_PAD elements
# further apart than their width, the slot inside a buffer filled with
# AG_FILL that must keep it; and K2's last step, which does not forward
AG_STEPS = {"ring_ag": (SIZE // RING_WORLD, SIZE, SIZE // RING_WORLD),
            "ring_ag_bidir": (SIZE // RING_WORLD // 2, SIZE, SIZE // RING_WORLD)}
AG_RAGGED, AG_RAGGED_PAD, AG_FILL = (520, 264, 1000), 24, -3.0
# the all-gather rings in turns with their hop schedule and the library
# product, at the power limit's steady clocks: RING_TURN_RUNS calls after
# RING_TURN_WARMUP, in RING_TURN_PASSES passes (as the c1 phase)
RING_TURN_RUNS, RING_TURN_WARMUP, RING_TURN_PASSES = 200, 80, 3
# ROADMAP C1: the fused protocol may read at most C1_MARGIN slower, against
# dispatch, for the port's kernel than for cuBLAS. The main path's runs
# (50 products after 10, or after the 51 of the graph's warm call) time
# the card while its clocks still fall under the power limit, and the
# fused run later into that fall than the dispatch run; so the check
# compares the two protocols once both run at the limit's steady clocks:
# C1_ITERATIONS products after C1_WARMUP (about a second of load), in
# C1_PASSES passes of the four runs, every other pass in the mirrored order.
C1_MARGIN, C1_ITERATIONS, C1_WARMUP, C1_PASSES = 0.02, 200, 80, 3
# `cuda_matmul.step_route`'s cases for a reduce-scatter step, held on the CPU
# against the rule and on the card against csrc/ring_rs.cu's own check
# (`step_check`, tmb_rs_check): (label, dtype,
# (m, n, k), (lda, ldb, ldc, ldacc or None without accin), byte offsets of
# (A, B, dest, accin) from 1 KB aligned bases, tile, route)
_TILE = (128, 256, 64)
RS_ROUTE_CASES = [
    ("K3 step", "bfloat16", (4096, 16384, 4096), (4096, 16384, 16384, 16384),
     (0, 0, 0, 0), _TILE, "wgmma_persistent"),
    ("K3 first step, no accin", "bfloat16", (4096, 16384, 4096),
     (4096, 16384, 16384, None), (0, 0, 0, 0), _TILE, "wgmma_persistent"),
    ("K5 half step, f16", "float16", (2048, 16384, 4096), (4096, 16384, 16384, 16384),
     (0, 0, 32768, 65536), _TILE, "wgmma_persistent"),
    ("ragged, strided accin and dest", "bfloat16", (520, 1000, 264),
     (264, 1000, 1024, 1024), (0, 0, 48, 48), _TILE, "wgmma_persistent"),
    ("dest off 16 bytes", "bfloat16", (256, 256, 256), (256, 256, 256, 256),
     (0, 0, 8, 0), _TILE, "wgmma"),
    ("accin off 16 bytes", "bfloat16", (256, 256, 256), (256, 256, 256, 256),
     (0, 0, 0, 8), _TILE, "wgmma"),
    ("dest rows off 16 bytes", "bfloat16", (256, 256, 256), (256, 256, 260, 256),
     (0, 0, 0, 0), _TILE, "wgmma"),
    ("accin rows off 16 bytes", "float16", (256, 256, 256), (256, 256, 256, 260),
     (0, 0, 0, 0), _TILE, "wgmma"),
    ("accin rows narrower than n", "bfloat16", (256, 256, 256), (256, 256, 256, 128),
     (0, 0, 0, 0), _TILE, "wgmma"),
    ("another tile", "bfloat16", (256, 256, 256), (256, 256, 256, 256),
     (0, 0, 0, 0), (128, 128, 64), "wgmma"),
    ("A rows off 16 bytes", "bfloat16", (256, 256, 256), (260, 256, 256, 256),
     (0, 0, 0, 0), _TILE, "wmma"),
    ("B off 16 bytes", "bfloat16", (256, 256, 256), (256, 256, 256, 256),
     (0, 2, 0, 0), _TILE, "wmma"),
    ("empty K", "bfloat16", (256, 256, 0), (256, 256, 256, 256),
     (0, 0, 0, 0), _TILE, "wmma"),
    ("int8", "int8", (256, 256, 256), (256, 256, 256, 256), (0, 0, 0, 0), _TILE, "wmma"),
    ("fp32", "float32", (256, 256, 256), (256, 256, 256, 256), (0, 0, 0, 0), _TILE, "simt"),
]


# `cuda_matmul.step_route`'s cases for an all-gather step (`forward=True`),
# the same way against csrc/ring_rs.cu's tmb_ag_check: the fourth operand is
# the forwarding slot, m x k with rows ldfwd apart (None: a step that does
# not forward)
AG_ROUTE_CASES = [
    ("K2 step", "bfloat16", (4096, 4096, 16384), (16384, 4096, 4096, 16384),
     (0, 0, 0, 0), _TILE, "wgmma_persistent"),
    ("K2 last step, no slot", "bfloat16", (4096, 4096, 16384),
     (16384, 4096, 4096, None), (0, 0, 0, 0), _TILE, "wgmma_persistent"),
    ("K4 half step, f16", "float16", (2048, 4096, 16384), (16384, 4096, 4096, 16384),
     (65536, 0, 32768, 65536), _TILE, "wgmma_persistent"),
    ("ragged, strided dest and slot", "bfloat16", (520, 1000, 264),
     (264, 1000, 1024, 288), (0, 0, 48, 0), _TILE, "wgmma_persistent"),
    ("dest off 16 bytes", "bfloat16", (256, 256, 256), (256, 256, 256, 256),
     (0, 0, 8, 0), _TILE, "wgmma"),
    ("slot off 16 bytes", "bfloat16", (256, 256, 256), (256, 256, 256, 256),
     (0, 0, 0, 8), _TILE, "wgmma"),
    ("dest rows off 16 bytes", "bfloat16", (256, 256, 256), (256, 256, 260, 256),
     (0, 0, 0, 0), _TILE, "wgmma"),
    ("slot rows off 16 bytes", "float16", (256, 256, 256), (256, 256, 256, 260),
     (0, 0, 0, 0), _TILE, "wgmma"),
    ("slot rows narrower than k", "bfloat16", (256, 256, 256), (256, 256, 256, 128),
     (0, 0, 0, 0), _TILE, "wgmma"),
    ("another tile", "bfloat16", (256, 256, 256), (256, 256, 256, 256),
     (0, 0, 0, 0), (128, 128, 64), "wgmma"),
    ("A rows off 16 bytes", "bfloat16", (256, 256, 256), (260, 256, 256, 256),
     (0, 0, 0, 0), _TILE, "wmma"),
    ("B off 16 bytes", "bfloat16", (256, 256, 256), (256, 256, 256, 256),
     (0, 2, 0, 0), _TILE, "wmma"),
    ("empty K", "bfloat16", (256, 256, 0), (256, 256, 256, 256),
     (0, 0, 0, 0), _TILE, "wmma"),
    ("int8", "int8", (256, 256, 256), (256, 256, 256, 256), (0, 0, 0, 0), _TILE, "wmma"),
    ("fp32", "float32", (256, 256, 256), (256, 256, 256, 256), (0, 0, 0, 0), _TILE, "simt"),
]


def route_args(case) -> tuple:
    """`cuda_matmul.step_route`'s arguments for one of RS_ROUTE_CASES or
    AG_ROUTE_CASES, the pointers made up (1 MB apart plus the case's
    offsets): the rule and the kernel's check read only their alignment."""
    _, dtype, (m, n, k), (lda, ldb, ldc, ldacc), offsets, tile, _ = case
    a, b, c, acc = ((i + 1) * 2**20 + off for i, off in enumerate(offsets))
    return (dtype, m, n, k, lda, ldb, ldc, ldacc, a, b, c,
            None if ldacc is None else acc, tile)


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


def clocks() -> dict:
    """The card's SM clock and power draw now, as `nvidia-smi
    --query-gpu=clocks.sm,power.draw --format=csv,noheader` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    sm, power = (v.strip() for v in out.stdout.strip().splitlines()[0].split(","))
    return {"clocks.sm": sm, "power.draw": power}


@contextlib.contextmanager
def clock_samples(period_ms: int = 50):
    """The card's SM clock (MHz) and power draw (W) every `period_ms` while
    the block runs (nvidia-smi in its loop mode, stopped at the block's
    end); yields a dict that then holds their mean, the lowest clock and
    the sample count (empty when nvidia-smi gave no samples)."""
    stats: dict = {}
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", str(period_ms)], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield stats
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        samples = []
        for line in out.splitlines():
            try:
                samples.append(tuple(float(v) for v in line.split(",")))
            except ValueError:
                continue
        samples = [v for v in samples if len(v) == 2]
        if samples:
            stats.update(sm_mhz_mean=sum(v[0] for v in samples) / len(samples),
                         sm_mhz_min=min(v[0] for v in samples),
                         power_w_mean=sum(v[1] for v in samples) / len(samples),
                         samples=len(samples))


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


def routes() -> dict:
    """A snapshot of the launches by route: the GEMM's ("gemm:wgmma", ...)
    and the fused ring's ("fused:wgmma", ...)."""
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops import cuda_ring_fused as crf

    return {**{f"gemm:{r}": n for r, n in cm.LAUNCHES_BY_ROUTE.items()},
            **{f"fused:{r}": n for r, n in crf.FUSED_LAUNCHES_BY_ROUTE.items()}}


def routes_since(before: dict) -> dict:
    """The launches by route since the snapshot `before`, those that rose."""
    return {r: n - before[r] for r, n in routes().items() if n != before[r]}


def expected_route(dtype_name: str, mkn) -> str:
    """The route a product of these operands must take: fp32 the SIMT
    kernel, int8 and the unaligned shapes wmma, the rest wgmma."""
    if dtype_name == "float32":
        return "simt"
    return "wmma" if dtype_name == "int8" or tuple(mkn) in UNALIGNED else "wgmma"


def check_kernel(dtype_name: str, mkn) -> dict:
    """One kernel-vs-plain case of the default tile on the card, with the
    route its one launch took."""
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm

    before = routes()
    result = compare(dtype_name, mkn, cm.cuda_matmul, cm.matmul_plain)
    launched, want = routes_since(before), f"gemm:{expected_route(dtype_name, mkn)}"
    result.update(phase="kernel_vs_plain", kernel="matmul", routes=launched, want_route=want,
                  ok=result["ok"] and launched == {want: 1})
    return result


def check_tiles() -> None:
    """Every instantiated tile in both grid orders against the plain
    version, at a ragged and a vector-aligned shape, in every tensor-core
    dtype. One line per (tile, order)."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm

    for tile in cm.TILES:
        for order in cm.GRID_ORDERS:
            before, routes0 = cm.LAUNCHES, routes()
            cases = [compare(d, s, lambda a, b: cm.cuda_matmul(
                         a, b, blocks=tile, grid_order=order), cm.matmul_plain)
                     for d in TILE_DTYPES for s in TILE_SHAPES]
            launched, by_route = cm.LAUNCHES - before, routes_since(routes0)
            want = {}
            for d in TILE_DTYPES:
                for s in TILE_SHAPES:
                    r = f"gemm:{expected_route(d, s)}"
                    want[r] = want.get(r, 0) + 1
            ok = all(c["ok"] for c in cases) and launched == len(cases) and by_route == want
            emit({"phase": "kernel_vs_plain[tiles]", "tile": list(tile),
                  "grid_order": order, "launches": launched, "routes": by_route,
                  "max_rel_err": {f"{c['dtype']}@{'x'.join(map(str, c['shape']))}":
                                  c["max_rel_err"] for c in cases},
                  "ok": ok})
            if not ok:
                fail("kernel_vs_plain[tiles]",
                     f"tile {tile} {order}: {[c for c in cases if not c['ok']]}"
                     f" (launches {launched}, routes {by_route}, want {want})")
    torch.cuda.empty_cache()


def check_wgmma() -> None:
    """The wgmma route against the plain versions at every tile, in bf16 and
    f16: the plain and fp32 stores, K-split partials, the pickup (also with
    strided accin and C) and a strided K slab of A. Every case must launch
    the wgmma route once (the split-K's reduction aside). One line per
    (dtype, tile)."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops.matmul import random_operands

    def one(label, dtype_name, mkn, kernel, plain):
        before = routes()
        result = compare(dtype_name, mkn, kernel, plain)
        launched = routes_since(before)
        return label, result, launched == {"gemm:wgmma": 1}, launched

    for dtype_name in WGMMA_DTYPES:
        dtype = getattr(torch, dtype_name)
        for tile in cm.TILES:
            cases = []
            for mkn in WGMMA_SHAPES:
                cases.append(one(f"plain@{mkn}", dtype_name, mkn,
                                 lambda a, b: cm.cuda_matmul(a, b, blocks=tile),
                                 cm.matmul_plain))
                cases.append(one(f"f32_out@{mkn}", dtype_name, mkn,
                                 lambda a, b: cm.cuda_matmul(a, b, blocks=tile,
                                                             out_dtype=torch.float32),
                                 lambda a, b: cm.matmul_plain(a, b, out_dtype=torch.float32)))
            for mkn, splits in WGMMA_KSPLIT:
                cases.append(one(f"ksplit{splits}@{mkn}", dtype_name, mkn,
                                 lambda a, b: cm.cuda_matmul_ksplit(a, b, splits=splits,
                                                                    blocks=tile),
                                 lambda a, b: cm.matmul_ksplit_plain(a, b, splits=splits)))
            for (m, k, n), pad in WGMMA_PICKUP:
                (wide,) = random_operands(5, (m, n + pad), dtype, device="cuda", count=1)
                accin = wide[:, pad:]  # rows n + pad apart when pad > 0
                out = torch.empty((m, n + pad), dtype=dtype, device="cuda")[:, :n]
                cases.append(one(f"pickup(pad {pad})@{(m, k, n)}", dtype_name, (m, k, n),
                                 lambda a, b: cm.cuda_matmul_acc(a, b, accin, out,
                                                                 blocks=tile),
                                 lambda a, b: cm.matmul_acc_plain(a, b, accin)))
            m, k, n, k0 = WGMMA_SLAB
            (wide_a,) = random_operands(6, (m, k + 256), dtype, device="cuda", count=1)
            cases.append(one(f"slab@{(m, k, n)}", dtype_name, (m, k, n),
                             lambda a, b: cm.cuda_matmul(wide_a[:, k0:k0 + k], b, blocks=tile),
                             lambda a, b: cm.matmul_plain(wide_a[:, k0:k0 + k], b)))
            bad = [(label, r, launched) for label, r, routed, launched in cases
                   if not (r["ok"] and routed)]
            emit({"phase": "kernel_vs_plain[wgmma]", "dtype": dtype_name, "tile": list(tile),
                  "max_rel_err": {label: r["max_rel_err"] for label, r, _, _ in cases},
                  "tolerance": TOLERANCE[dtype_name], "ok": not bad})
            if bad:
                fail("kernel_vs_plain[wgmma]", f"{dtype_name} tile {tile}: {bad}")
            del cases
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


def drive(impl: str, timing: str, out_dir: str, iterations: int = ITERATIONS,
          warmup: int = WARMUP, name: str = "main_path") -> tuple[dict, int]:
    """One main-path run through the benchmark's entry point (the `c1`
    phase's longer runs as `name` "c1"); returns the record's summary and
    the kernel launches counted during it, every one of them on the wgmma
    route, with the card's clocks and power during and right after it."""
    from tpu_matmul_bench_torch.benchmarks import matmul_benchmark
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.utils.telemetry import is_manifest

    path = f"{out_dir}/{name}-{impl}-{timing}.jsonl"
    argv = ["--sizes", str(SIZE), "--dtype", "bfloat16", "--num-devices", "1",
            "--matmul-impl", impl, "--validate", "--iterations", str(iterations),
            "--warmup", str(warmup), "--timing", timing, "--json-out", path]
    cm.LAUNCHES = 0
    before = routes()
    with contextlib.redirect_stdout(sys.stderr), clock_samples() as during:
        records = matmul_benchmark.main(argv)
    after = clocks()  # right after the timed loop (validation runs before it)
    launches, by_route = cm.LAUNCHES, routes_since(before)
    phase = f"{name}[{impl},{timing}]"
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
        "launches_by_route": by_route, "device_kind": rec.device_kind,
        "during": during, "after": after,
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
    if impl == "cuda" and by_route != {"gemm:wgmma": launches}:
        problems.append(f"launches by route {by_route}: not all {launches} on wgmma")
    if impl == "torch" and launches != 0:
        problems.append("the library run launched the hand-written kernel")
    summary["ok"] = not problems
    emit(summary)
    if problems:
        fail(phase, "; ".join(problems))
    return summary, launches


def c1_check(main: list[dict], out_dir: str) -> dict:
    """ROADMAP C1: the fused protocol's time over dispatch's, for the port's
    kernel and for cuBLAS. `main` holds the main path's four runs (kernel
    and cuBLAS, dispatch and fused), reported beside the check with their
    clocks; the check itself reads C1_PASSES passes of the same four runs
    at C1_ITERATIONS products after C1_WARMUP, every other pass in the
    mirrored order, and each protocol's median time. It fails when the
    port's ratio exceeds cuBLAS's by more than C1_MARGIN: a gap both share
    is not the port's."""
    order = [("cuda", "dispatch"), ("cuda", "fused"), ("torch", "dispatch"),
             ("torch", "fused")]
    runs = []
    for p in range(C1_PASSES):
        for impl, timing in order if p % 2 == 0 else order[::-1]:
            runs.append(drive(impl, timing, out_dir, C1_ITERATIONS, C1_WARMUP, "c1")[0])

    def ratio(rs: list[dict], impl: str) -> float:
        def ms(timing: str) -> float:
            return statistics.median(r["avg_ms"] for r in rs
                                     if r["phase"].endswith(f"[{impl},{timing}]"))
        return ms("fused") / ms("dispatch")

    port, lib = ratio(runs, "cuda"), ratio(runs, "torch")
    result = {"phase": "c1", "port_fused_over_dispatch": port,
              "library_fused_over_dispatch": lib, "excess": port / lib - 1,
              "margin": C1_MARGIN,
              "main_path": {"port_fused_over_dispatch": ratio(main, "cuda"),
                            "library_fused_over_dispatch": ratio(main, "torch")},
              "runs": [{k: r[k] for k in ("phase", "avg_ms", "during", "after")}
                       for r in main + runs],
              "ok": port <= lib * (1 + C1_MARGIN)}
    emit(result)
    if not result["ok"]:
        fail("c1", f"fused/dispatch {port:.4f} for the port against {lib:.4f} for "
                   f"cuBLAS: more than {C1_MARGIN:.0%} apart")
    return {k: result[k] for k in ("port_fused_over_dispatch",
                                   "library_fused_over_dispatch", "excess", "main_path")}


def tune(phase: str, extra: list[str], out_dir: str,
         ksplit: int = 1) -> tuple[dict, int, int]:
    """One tune run through the tuner's entry point over every tile.
    Returns {tile: sweep ms} and the GEMM and reduction launches counted
    during it; every GEMM launch must take the wgmma route."""
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
    before = routes()
    with contextlib.redirect_stdout(sys.stderr):
        records = cuda_tune.main(argv)
    gemm, reduce, by_route = cm.LAUNCHES, cm.REDUCE_LAUNCHES, routes_since(before)
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
    if by_route != {"gemm:wgmma": gemm}:
        problems.append(f"launches by route {by_route}: not all {gemm} on wgmma")
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
               "launches_by_route": by_route, "ok": not problems}
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
            "launches": gemm + reduce, "gemm_route": "wgmma",
            "launches_by_route": {"gemm:wgmma": gemm},
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


def check_rs_step() -> dict:
    """The persistent pickup GEMM (`cuda_matmul.cuda_matmul_rs` on its
    `wgmma_persistent` route) against `matmul_acc_plain` (`matmul_plain`
    at a first step), in bf16 and f16, at both reduce-scatter step shapes
    (RS_STEPS) and at RS_RAGGED with strided accin and dest, with accin and
    without; each case must launch the kernel once. Then `step_route` against
    the kernel's own check at every one of RS_ROUTE_CASES. Returns the bf16
    max abs error with accin at each step shape, by ring."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops.matmul import random_operands

    errors, bad = {}, []
    shapes = [(label, mkn, 0) for label, mkn in RS_STEPS.items()]
    shapes.append(("ragged", RS_RAGGED, RS_RAGGED_PAD))
    for dtype_name in WGMMA_DTYPES:
        dtype = getattr(torch, dtype_name)
        cases = {}
        for label, (m, k, n), pad in shapes:
            (wide,) = random_operands(5, (m, n + pad), dtype, device="cuda", count=1)
            out = torch.empty((m, n + pad), dtype=dtype, device="cuda")[:, pad:]
            for accin in (wide[:, pad:], None):
                before = routes()
                result = compare(
                    dtype_name, (m, k, n),
                    lambda a, b: cm.cuda_matmul_rs(a, b, accin, out),
                    lambda a, b: (cm.matmul_plain(a, b) if accin is None
                                  else cm.matmul_acc_plain(a, b, accin)))
                launched = routes_since(before)
                case = f"{label}{'' if accin is None else '+accin'}@{m}x{k}x{n}"
                cases[case] = result["max_rel_err"]
                if not result["ok"] or launched != {"gemm:wgmma_persistent": 1}:
                    bad.append((dtype_name, case, result, launched))
                if dtype_name == "bfloat16" and accin is not None and label in RS_STEPS:
                    errors[label] = result["max_abs_err"]
            del wide, out
            torch.cuda.empty_cache()
        emit({"phase": "kernel_vs_plain[rs_step]", "dtype": dtype_name,
              "max_rel_err": cases, "tolerance": TOLERANCE[dtype_name],
              "ok": not [b for b in bad if b[0] == dtype_name]})
    disagree = []
    for case in RS_ROUTE_CASES:
        args = route_args(case)
        route = cm.step_route(*args)
        code = cm.step_check(getattr(torch, case[1]), *args[1:])
        if route != case[-1] or (code == 0) != (route == "wgmma_persistent"):
            disagree.append((case[0], route, code))
    emit({"phase": "rs_route", "cases": len(RS_ROUTE_CASES), "disagree": disagree,
          "ok": not disagree})
    if bad or disagree:
        fail("kernel_vs_plain[rs_step]", f"cases {bad}; rule and kernel check "
                                         f"disagree on {disagree}")
    return errors


def rs_step_ms(label: str, runs: int = 20) -> dict:
    """One step's product of ring `label` at bf16 16384² over RING_WORLD
    ranks (RS_STEPS), timed three ways in turns: the wgmma pickup into a
    staging slot plus its hop into the reader's slot (the schedule before
    the persistent pickup), the persistent pickup into the slot, and
    `torch.addmm(accin, a, b)`, the one library call of the same step."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops import cuda_ring as cr
    from tpu_matmul_bench_torch.ops.matmul import random_operands

    m, k, n = RS_STEPS[label]
    (a,) = random_operands(3, (m, k), torch.bfloat16, device="cuda", count=1)
    (b,) = random_operands(4, (k, n), torch.bfloat16, device="cuda", count=1)
    (accin,) = random_operands(5, (m, n), torch.bfloat16, device="cuda", count=1)
    stage, slot = (torch.empty((m, n), dtype=torch.bfloat16, device="cuda") for _ in range(2))
    current = torch.cuda.current_stream()
    sched = cr._Schedule(card_mesh(1), [(current, current)])

    def pickup_and_hop():
        cm.cuda_matmul_acc(a, b, accin, stage)
        cr._hop(sched, 0, slot, stage)

    def persistent():
        cm.cuda_matmul_rs(a, b, accin, slot)

    turns = {"pickup_hop": [], "persistent": []}
    for name in ("pickup_hop", "persistent", "persistent", "pickup_hop"):
        turns[name].append(events_ms(pickup_and_hop if name == "pickup_hop" else persistent,
                                     runs))
    library = events_ms(lambda: torch.addmm(accin, a, b), runs)
    del a, b, accin, stage, slot
    torch.cuda.empty_cache()
    return {"shape": f"{m}x{k}x{n}",
            "pickup_hop_ms": sum(turns["pickup_hop"]) / 2,
            "persistent_ms": sum(turns["persistent"]) / 2,
            "addmm_ms": library, "turns_ms": turns}


def check_ag_step() -> dict:
    """The persistent GEMM in its forwarding mode (`cuda_matmul
    .cuda_matmul_ag` on its `wgmma_persistent` route) against its plain
    version, `matmul_plain` and the copy of A, in bf16 and f16: at both
    all-gather step shapes (AG_STEPS), at AG_RAGGED with strided dest and
    slot, the slot a view inside a larger buffer filled with AG_FILL, and at
    K2's step shape without a slot (a ring's last step). Each case must
    launch the kernel once; the product must be within the tolerance, the
    slot equal to A exactly (max abs err 0), and the buffer around the slot
    keep its fill. Then `step_route(..., forward=True)` against the kernel's
    own check at every one of AG_ROUTE_CASES. Returns the bf16 max abs error of the product
    at each step shape, by ring."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm

    errors, bad = {}, []
    shapes = [(label, mkn, 0, True) for label, mkn in AG_STEPS.items()]
    shapes += [("ragged", AG_RAGGED, AG_RAGGED_PAD, True),
               ("last step", AG_STEPS["ring_ag"], 0, False)]
    for dtype_name in WGMMA_DTYPES:
        dtype = getattr(torch, dtype_name)
        cases, slot_errors = {}, {}
        for label, (m, k, n), pad, forwards in shapes:
            out = torch.empty((m, n + pad), dtype=dtype, device="cuda")[:, pad:]
            room = torch.full((m + pad, k + pad), AG_FILL, dtype=dtype, device="cuda")
            slot = room[:m, :k] if forwards else None
            held = {}

            def kernel(a, b):
                held["a"] = a
                return cm.cuda_matmul_ag(a, b, out, slot)

            before = routes()
            result = compare(dtype_name, (m, k, n), kernel, cm.matmul_plain)
            launched = routes_since(before)
            case = f"{label}@{m}x{k}x{n}"
            cases[case] = result["max_rel_err"]
            problems = [] if result["ok"] else [result]
            if launched != {"gemm:wgmma_persistent": 1}:
                problems.append(f"routes {launched}")
            if forwards:
                slot_errors[case] = (slot.double() - held["a"].double()).abs().max().item()
                kept = bool((room[m:] == AG_FILL).all()) and bool((room[:m, k:] == AG_FILL).all())
                if slot_errors[case] != 0.0 or not kept:
                    problems.append(f"slot max abs err {slot_errors[case]}, fill kept {kept}")
            if problems:
                bad.append((dtype_name, case, problems))
            if dtype_name == "bfloat16" and label in AG_STEPS:
                errors[label] = result["max_abs_err"]
            del out, room, slot, held
            torch.cuda.empty_cache()
        emit({"phase": "kernel_vs_plain[ag_step]", "dtype": dtype_name,
              "max_rel_err": cases, "slot_max_abs_err": slot_errors,
              "tolerance": TOLERANCE[dtype_name],
              "ok": not [b for b in bad if b[0] == dtype_name]})
    disagree = []
    for case in AG_ROUTE_CASES:
        args = route_args(case)
        route = cm.step_route(*args, forward=True)
        code = cm.step_check(getattr(torch, case[1]), *args[1:], forward=True)
        if route != case[-1] or (code == 0) != (route == "wgmma_persistent"):
            disagree.append((case[0], route, code))
    emit({"phase": "ag_route", "cases": len(AG_ROUTE_CASES), "disagree": disagree,
          "ok": not disagree})
    if bad or disagree:
        fail("kernel_vs_plain[ag_step]", f"cases {bad}; rule and kernel check "
                                         f"disagree on {disagree}")
    return errors


def ag_step_ms(label: str, runs: int = 20) -> dict:
    """One step's product of ring `label` at bf16 16384² over RING_WORLD
    ranks (AG_STEPS), timed four ways in turns (each in order, then in the
    mirrored order): K1 into dest plus the hop of the chunk into the
    reader's slot (the schedule before the forwarding GEMM), the forwarding
    GEMM, the same GEMM without a slot (what forwarding costs), and
    `torch.matmul(a, b, out=dest)`, the one library call of the product."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops import cuda_ring as cr
    from tpu_matmul_bench_torch.ops.matmul import random_operands

    m, k, n = AG_STEPS[label]
    (a,) = random_operands(3, (m, k), torch.bfloat16, device="cuda", count=1)
    (b,) = random_operands(4, (k, n), torch.bfloat16, device="cuda", count=1)
    dest = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    slot = torch.empty((m, k), dtype=torch.bfloat16, device="cuda")
    current = torch.cuda.current_stream()
    sched = cr._Schedule(card_mesh(1), [(current, current)])

    def k1_hop():
        cm.cuda_matmul(a, b, out=dest)
        cr._hop(sched, 0, slot, a)

    ways = {"k1_hop": k1_hop,
            "forward": lambda: cm.cuda_matmul_ag(a, b, dest, slot),
            "no_forward": lambda: cm.cuda_matmul_ag(a, b, dest),
            "matmul": lambda: torch.matmul(a, b, out=dest)}
    turns = {name: [] for name in ways}
    for name in list(ways) + list(ways)[::-1]:
        turns[name].append(events_ms(ways[name], runs))
    del a, b, dest, slot
    torch.cuda.empty_cache()
    return {"shape": f"{m}x{k}x{n}", **{f"{name}_ms": sum(t) / 2 for name, t in turns.items()},
            "turns_ms": turns}


def ring_turns(label: str, card: str) -> dict:
    """K2 or K4 (`label`) at bf16 16384² over RING_WORLD ranks on the card,
    in turns: the ring as a user calls it (the "forward" schedule), the
    "hop" schedule forced on the same ranks (K1 products and a hop a step,
    the schedule of ranks on several cards), and `torch.matmul` of the
    gathered operands. Each run is RING_TURN_RUNS calls after
    RING_TURN_WARMUP, so that the card runs at its power limit's steady
    clocks, in RING_TURN_PASSES passes, every other in the mirrored order;
    the medians and each schedule's ratio to the library call. The hop
    schedule's output is first held against the forward one's."""
    import torch

    from tpu_matmul_bench_torch.parallel.mesh import gather

    _, build, _, _ = rings()[label]
    fn = build(card_mesh(RING_WORLD))
    x, w = ring_operands(fn.mesh, False, (SIZE, SIZE, SIZE), torch.bfloat16, seed=11)
    xg, wg = gather(x), gather(w)
    calls = {"forward": lambda: fn(x, w),
             "hop": lambda: fn._allgather(x, w, "hop"),
             "library": lambda: torch.matmul(xg, wg)}
    before = ring_counts()
    got_hop = gather(calls["hop"]())
    hops = ring_counts()[1] - before[1]
    got = gather(calls["forward"]())
    torch.cuda.synchronize()
    rel = ((got_hop.float() - got.float()).abs().max().item()
           / (got.float().abs().max().item() or 1.0))
    del got, got_hop
    runs: dict[str, list[float]] = {name: [] for name in calls}
    order = list(calls)
    for p in range(RING_TURN_PASSES):
        for name in order if p % 2 == 0 else order[::-1]:
            for _ in range(RING_TURN_WARMUP):
                calls[name]()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(RING_TURN_RUNS):
                calls[name]()
            end.record()
            end.synchronize()
            runs[name].append(start.elapsed_time(end) / RING_TURN_RUNS)
    del x, w, xg, wg
    torch.cuda.empty_cache()
    ms = {name: statistics.median(v) for name, v in runs.items()}
    want_hops = per_call(label, RING_WORLD, forwards=False)[1]
    result = {"phase": f"ring_turns[{label}]", "ranks": RING_WORLD, "shape": [SIZE] * 3,
              "card": card, "runs": RING_TURN_RUNS, "warmup": RING_TURN_WARMUP,
              "passes_ms": runs, "forward_ms": ms["forward"], "hop_ms": ms["hop"],
              "library_ms": ms["library"],
              "forward_over_library": ms["forward"] / ms["library"],
              "hop_over_library": ms["hop"] / ms["library"],
              "hop_schedule_max_rel_err": rel, "hop_schedule_hops": hops,
              "ok": rel <= TOLERANCE["bfloat16"] and hops == want_hops}
    emit(result)
    if not result["ok"]:
        fail(result["phase"], f"the hop schedule differs from the forward one by {rel} "
                              f"or hopped {hops} times, not {want_hops}")
    return result


def rings() -> dict:
    """The rings by label: (reduce-scatter or all-gather, constructor, plain
    version, the shapes of their kernel-vs-plain cases)."""
    from tpu_matmul_bench_torch.ops import cuda_ring as cr
    from tpu_matmul_bench_torch.ops import cuda_ring_fused as crf

    return {
        "ring_ag": (False, cr.ring_allgather_matmul_hbm,
                    cr.ring_allgather_matmul_plain, RING_SHAPES),
        "ring_rs": (True, cr.ring_reduce_scatter_matmul_hbm,
                    cr.ring_reduce_scatter_matmul_plain, RING_SHAPES),
        "ring_ag_bidir": (False, cr.ring_allgather_matmul_bidir_hbm,
                          cr.ring_allgather_matmul_plain, SPLIT_SHAPES),
        "ring_rs_bidir": (True, cr.ring_reduce_scatter_matmul_bidir_hbm,
                          cr.ring_reduce_scatter_matmul_bidir_plain, SPLIT_SHAPES),
        "ring_fused": (False, crf.ring_allgather_matmul,
                       cr.ring_allgather_matmul_plain, SPLIT_SHAPES),
    }


def ring_counts() -> tuple[int, int, int]:
    """The rings' launch counters: products, hops, fused launches."""
    from tpu_matmul_bench_torch.ops import cuda_ring as cr
    from tpu_matmul_bench_torch.ops import cuda_ring_fused as crf

    return cr.RING_STEPS, cr.HOP_LAUNCHES, crf.FUSED_RING_LAUNCHES


def per_call(label: str, d: int, forwards: bool = True) -> tuple[int, int, int]:
    """The launches one call of a ring adds to `ring_counts`, its ranks on
    one card: the reduce-scatter rings store each partial into the reader's
    slot, and the all-gather rings forward each chunk into it, so neither
    hops; but an all-gather call whose steps cannot forward (`forwards`
    False: `ag_forwarding` of its operands) hops every chunk."""
    if label == "ring_fused":
        return 0, 0, 1
    ways = 2 if label.endswith("_bidir") else 1
    hops = 0 if label.startswith("ring_rs") or forwards else ways * d * (d - 1)
    return ways * d * d, hops, 0


def ag_forwarding(dtype_name: str, mkn, d: int) -> bool:
    """Whether an all-gather ring's call takes the forward schedule for
    global (m, k, n) operands of `dtype_name` over d ranks on the card:
    every step that passes a chunk on forwards it in the product's launch
    (a ring of one rank passes none). That is `step_route` of a step (K2's
    whole chunk; K4's halves start at whole rows, so TMA sees the same row
    strides) with the slot and dest rows those of the ring's buffers and the
    bases aligned, as the caching allocator's are."""
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm

    m, k, n = mkn
    mshard, nshard = m // d, n // d
    return d == 1 or cm.step_route(dtype_name, mshard, nshard, k, k, nshard, nshard, k, 0, 0, 0, 0,
                         cm.DEFAULT_TILE, forward=True) == "wgmma_persistent"


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
    ranks, in every dtype, at its shapes (even, ragged and, for the rings
    that split chunks in halves and the fused ring, odd chunks). One line
    per (ring, ranks); the launch counts must rise by `per_call` a call (the
    all-gather rings hop only where `ag_forwarding` says a step cannot
    forward: int8, fp32 and rows TMA cannot describe), and an all-gather
    ring's call must count in `AG_TRANSFERS` as the transfer it took."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_ring as cr
    from tpu_matmul_bench_torch.parallel.mesh import gather

    for label, (reduce_scatter, build, plain, shapes) in rings().items():
        for d in RANKS:
            fn = build(card_mesh(d))
            errors, problems, by_route = {}, [], {}
            for dtype_name in TOLERANCE:
                for mkn in shapes:
                    x, w = ring_operands(fn.mesh, reduce_scatter, mkn,
                                         getattr(torch, dtype_name), seed=7)
                    before, routes0, moved0 = ring_counts(), routes(), dict(cr.AG_TRANSFERS)
                    got = gather(fn(x, w))
                    launched = tuple(a - b for a, b in zip(ring_counts(), before))
                    moved = {t: n - moved0[t] for t, n in cr.AG_TRANSFERS.items() if n != moved0[t]}
                    for r, n in routes_since(routes0).items():
                        by_route[r] = by_route.get(r, 0) + n
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
                    forwards = ag_forwarding(dtype_name, mkn, d)
                    want_launched = per_call(label, d, forwards)
                    if launched != want_launched:
                        problems.append(f"{case}: launched (products, hops, fused) "
                                        f"{launched}, not {want_launched}")
                    want_moved = ({} if reduce_scatter or label == "ring_fused"
                                  else {"forward" if forwards else "hop": 1})
                    if moved != want_moved:
                        problems.append(f"{case}: AG_TRANSFERS rose by {moved}, "
                                        f"not {want_moved}")
            if label != "ring_fused" and not by_route.get("gemm:wgmma_persistent"):
                problems.append(f"no product took the persistent GEMM: {by_route}")
            emit({"phase": f"kernel_vs_plain[{label}]", "ranks": d,
                  "max_rel_err": errors, "tolerance": TOLERANCE,
                  "launches_by_route": by_route, "ok": not problems})
            if problems:
                fail(f"kernel_vs_plain[{label}]", f"D={d}: {problems}")
            torch.cuda.empty_cache()


def check_races(s: int, labels) -> None:
    """The JAX tests' placement case (all-gather: X's row block r holds r,
    W = I) and every-rank case (reduce-scatter: X's column block j holds
    2**j, W = I), at s×s, each RACE_REPEATS calls in a row over RING_WORLD
    ranks before one synchronize; every result must equal X exactly. A
    missing event between the streams, or a missing barrier in the fused
    ring, shows here as a wrong block now and then. Every HBM ring product
    must take the persistent GEMM, on one stream a rank."""
    import torch

    from tpu_matmul_bench_torch.parallel.mesh import COLS, ROWS, gather, shard_tensor

    d = RING_WORLD
    mesh = card_mesh(d)
    block = torch.arange(d, device="cuda", dtype=torch.float32).repeat_interleave(s // d)
    ones = torch.ones(s, device="cuda")
    eye = torch.eye(s, device="cuda", dtype=torch.bfloat16)
    cases = {False: ((block[:, None] * ones[None, :]).to(torch.bfloat16), ROWS, COLS),
             True: ((ones[:, None] * (2.0 ** block)[None, :]).to(torch.bfloat16), COLS, ROWS)}
    for label in labels:
        reduce_scatter, build, _, _ = rings()[label]
        xg, x_spec, w_spec = cases[reduce_scatter]
        fn = build(mesh)
        x, w = shard_tensor(xg, x_spec, mesh), shard_tensor(eye, w_spec, mesh)
        before, routes0 = ring_counts(), routes()
        outs = [fn(x, w) for _ in range(RACE_REPEATS)]
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(ring_counts(), before))
        by_route = routes_since(routes0)
        bad = [i for i, y in enumerate(outs) if not torch.equal(gather(y), xg)]
        del outs, x, w
        want = tuple(RACE_REPEATS * n for n in per_call(label, d))
        # every HBM ring product on the persistent GEMM, with a compute
        # stream a rank and no copy stream
        fused = label == "ring_fused"
        routed = fused or by_route == {"gemm:wgmma_persistent": want[0]}
        streams = [] if fused else [len(rank) for by_count in fn._streams.values()
                                    for rank in by_count]
        emit({"phase": f"races[{label}]", "ranks": d, "size": s,
              "calls": RACE_REPEATS, "wrong_calls": bad, "launches": launched,
              "launches_by_route": by_route, "streams_per_rank": sorted(set(streams)),
              "ok": not bad and launched == want and routed and set(streams) <= {1}})
        if bad or launched != want or not routed or not set(streams) <= {1}:
            fail(f"races[{label}]", f"calls {bad} of {RACE_REPEATS} differ from X; "
                                    f"launched {launched} (want {want}), routes {by_route}, "
                                    f"streams a rank {streams}")
    del cases, eye
    torch.cuda.empty_cache()


def drive_overlap(mode: str, out_dir: str, size: int = SIZE) -> tuple[dict, dict]:
    """One overlap run through the program's entry point, its ranks on the
    card; returns the record's summary and the launches counted during it.
    Every baseline product must take the wgmma route, every HBM ring
    product the persistent GEMM with no hop, and K6 its wgmma form."""
    from tpu_matmul_bench_torch.benchmarks import matmul_overlap_benchmark
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops import cuda_ring as cr
    from tpu_matmul_bench_torch.ops import cuda_ring_fused as crf
    from tpu_matmul_bench_torch.utils.telemetry import is_manifest

    path = f"{out_dir}/{mode}-{size}.jsonl"
    argv = ["--mode", mode, "--sizes", str(size), "--dtype", "bfloat16",
            "--num-devices", str(RING_WORLD), "--matmul-impl", "cuda",
            "--iterations", str(OVERLAP_ITERATIONS), "--warmup", str(OVERLAP_WARMUP),
            "--validate", "--json-out", path]
    cm.LAUNCHES = cm.ACC_LAUNCHES = cm.RS_LAUNCHES = cm.AG_LAUNCHES = 0
    cr.RING_STEPS = cr.HOP_LAUNCHES = 0
    cr.RS_TRANSFERS.update(store=0, hop=0)
    cr.AG_TRANSFERS.update(forward=0, hop=0)
    crf.FUSED_RING_LAUNCHES = 0
    before = routes()
    with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr):
        records = matmul_overlap_benchmark.main(argv)
    counts = {"matmul": cm.LAUNCHES, "matmul_acc": cm.ACC_LAUNCHES,
              "matmul_rs": cm.RS_LAUNCHES, "matmul_ag": cm.AG_LAUNCHES,
              "ring_steps": cr.RING_STEPS, "ring_hops": cr.HOP_LAUNCHES,
              "rs_transfers": dict(cr.RS_TRANSFERS), "ag_transfers": dict(cr.AG_TRANSFERS),
              "fused": crf.FUSED_RING_LAUNCHES, "routes": routes_since(before)}
    phase = f"overlap[{mode}]" if size == SIZE else f"overlap[{mode},{size}]"
    if len(records) != 1:
        fail(phase, f"expected one record, got {len(records)} (the runner "
                    "reports a failed size and returns no record for it)")
    with open(path) as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    rec = records[0]
    peak = rec.peak_efficiency_pct
    x = rec.extras
    fused = mode == "cuda_ring"
    summary = {"phase": phase, "size": size, "avg_ms": rec.avg_time_s * 1e3,
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
    if not fused and x.get("wres_engaged") is not False:
        problems.append(f"wres_engaged {x.get('wres_engaged')}, not False")
    if fused and x.get("superseded_by") != "cuda_ring_hbm":
        problems.append(f"superseded_by {x.get('superseded_by')}, not cuda_ring_hbm")
    if not lines or not is_manifest(lines[0]):
        problems.append("the JSONL does not start with its manifest")
    if len(lines) != 2 or lines[1].get("mode") != mode:
        problems.append("the JSONL does not hold the record after the manifest")
    reduce_scatter = "_rs_" in mode
    step = counts["matmul_rs" if reduce_scatter else "matmul_ag"]
    ring_ran = counts["fused"] > 0 if fused else counts["ring_steps"] > 0 and step > 0
    if counts["matmul"] <= 0 or not ring_ran:
        problems.append(f"a kernel of the path was not launched: {counts}")
    moved = counts["rs_transfers" if reduce_scatter else "ag_transfers"]
    if not fused and (counts["ring_hops"] or moved["hop"] or not sum(moved.values())):
        problems.append(f"the ranks share the card, yet the ring hopped: {counts}")
    # every product on wgmma (the baseline's), the HBM rings' on the
    # persistent GEMM, K6 in its wgmma form
    want = {"gemm:wgmma": counts["matmul"] + counts["matmul_acc"]}
    if counts["matmul_rs"] + counts["matmul_ag"]:
        want["gemm:wgmma_persistent"] = counts["matmul_rs"] + counts["matmul_ag"]
    if fused:
        want["fused:wgmma"] = counts["fused"]
    if counts["routes"] != want:
        problems.append(f"launches by route {counts['routes']}, not {want}")
    summary["ok"] = not problems
    emit(summary)
    if problems:
        fail(phase, "; ".join(problems))
    return summary, counts


def scaling_calls(mode: str, d: int, timing: str) -> int:
    """The mode's program calls in one run of SCALING_ITERATIONS after
    SCALING_WARMUP: the validation's call, then the timed ones. Dispatch
    times each program warmup + iterations calls in the first of
    VARIANT_ROUNDS rounds and 1 + iterations in each other; fused captures
    each program's chain once (one eager call, then `iterations` captured)
    and replays it, which launches nothing from the host. `independent`
    (and `matrix_parallel` over one rank, its fallback) times its one
    program once."""
    it, wu = SCALING_ITERATIONS, SCALING_WARMUP
    single = mode == "independent" or (mode == "matrix_parallel" and d == 1)
    if timing == "fused":
        per_program = 1 + it
    elif single:
        per_program = wu + it
    else:
        per_program = wu + it + (VARIANT_ROUNDS - 1) * (1 + it)
    return 1 + per_program * (1 if single else 2)


def scaling_launches(mode: str, d: int, timing: str) -> int:
    """K1 launches of one `--matmul-impl cuda` run: D ranks × products a
    rank × the calls of both legs (`scaling_calls`), plus the single-device
    baseline of the efficiency modes (its validation and timed calls)."""
    per_rank = max(4 // d, 1) if mode == "batch_parallel" else 1  # the local batch
    launches = d * per_rank * scaling_calls(mode, d, timing)
    if d > 1 and mode in ("independent", "batch_parallel", "data_parallel"):
        launches += 1 + (1 + SCALING_ITERATIONS if timing == "fused"
                         else SCALING_WARMUP + SCALING_ITERATIONS)
    return launches


def drive_scaling(program: str, mode: str, impl: str, timing: str, out_dir: str,
                  d: int = RING_WORLD, profile_dir: str | None = None) -> dict:
    """One run of the scaling or distributed program through its entry
    point, its ranks on the card; returns the record's summary. Every K1
    launch must take the wgmma route, as many as the mode makes
    (`scaling_launches`); the library run launches none."""
    from tpu_matmul_bench_torch.benchmarks import (
        matmul_distributed_benchmark,
        matmul_scaling_benchmark,
    )
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.utils.telemetry import is_manifest

    entry = (matmul_scaling_benchmark if program == "scaling"
             else matmul_distributed_benchmark).main
    tag = f"{mode},{impl},{timing}" + ("" if d == RING_WORLD else f",d={d}")
    path = f"{out_dir}/{program}-{tag.replace(',', '-')}.jsonl"
    argv = ["--mode", mode, "--sizes", str(SIZE), "--dtype", "bfloat16",
            "--num-devices", str(d), "--matmul-impl", impl, "--timing", timing,
            "--iterations", str(SCALING_ITERATIONS), "--warmup", str(SCALING_WARMUP),
            "--validate", "--json-out", path]
    if profile_dir:
        argv += ["--profile-dir", profile_dir]
    # the baseline is measured in this run, not taken from an earlier one
    matmul_scaling_benchmark._BASELINE_CACHE.clear()
    cm.LAUNCHES = 0
    before = routes()
    with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr), \
            clock_samples() as during:
        records = entry(argv)
    launches, by_route = cm.LAUNCHES, routes_since(before)
    phase = f"scaling[{tag}]"
    if len(records) != 1:
        fail(phase, f"expected one record, got {len(records)} (the runner "
                    "reports a failed size and returns no record for it)")
    with open(path) as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    rec, x = records[0], records[0].extras
    baseline = list(matmul_scaling_benchmark._BASELINE_CACHE.values())
    want = scaling_launches(mode, d, timing) if impl == "cuda" else 0
    peak = rec.peak_efficiency_pct
    summary = {"phase": phase, "program": program, "mode": rec.mode, "world": rec.world,
               "k1_shape": "x".join(map(str, SCALING_SHAPES[mode] if d > 1
                                        else (SIZE, SIZE, SIZE))),
               "avg_ms": rec.avg_time_s * 1e3,
               "compute_ms": rec.compute_time_s * 1e3,
               "comm_ms": None if rec.comm_time_s is None else rec.comm_time_s * 1e3,
               "tflops_total": rec.tflops_total, "tflops_per_device": rec.tflops_per_device,
               "peak_efficiency_pct": peak,
               "scaling_efficiency_pct": rec.scaling_efficiency_pct,
               "single_device_tflops": baseline[0] if baseline else None,
               "cards": x.get("cards"), "ranks_per_card": x.get("ranks_per_card"),
               "validation": x.get("validation"),
               "validation_max_rel_err": x.get("validation_max_rel_err"),
               "timing": x.get("timing", "dispatch"), "chain": x.get("chain"),
               "k1_launches": launches, "expected_k1_launches": want,
               "launches_by_route": by_route, "during": during}
    problems = []
    if x.get("validation") != "ok":
        problems.append("validation is not ok")
    if peak is None or not 0 < peak <= 100:
        problems.append(f"peak_efficiency_pct {peak} outside (0, 100]")
    if rec.world != d or x.get("cards") != 1 or x.get("ranks_per_card") != d:
        problems.append(f"world {rec.world} on {x.get('cards')} cards, "
                        f"{x.get('ranks_per_card')} a card, not {d} on 1")
    if timing == "fused" and (x.get("timing"), x.get("chain")) != ("fused", "operand"):
        problems.append(f"fused was asked, yet timing {x.get('timing')}, chain "
                        f"{x.get('chain')}")
    efficiency = d > 1 and mode in ("independent", "batch_parallel", "data_parallel")
    if efficiency != (rec.scaling_efficiency_pct is not None):
        problems.append(f"scaling_efficiency_pct {rec.scaling_efficiency_pct}")
    if not lines or not is_manifest(lines[0]):
        problems.append("the JSONL does not start with its manifest")
    if len(lines) != 2 or lines[1].get("mode") != rec.mode:
        problems.append("the JSONL does not hold the record after the manifest")
    if launches != want:
        problems.append(f"{launches} K1 launches, not the {want} the mode makes")
    if impl == "cuda" and by_route != {"gemm:wgmma": want}:
        problems.append(f"launches by route {by_route}: not all {want} on wgmma")
    if impl == "torch" and by_route:
        problems.append(f"the library run launched the port's kernels: {by_route}")
    summary["ok"] = not problems
    emit(summary)
    if problems:
        fail(phase, "; ".join(problems))
    return summary


def scaling_phase(out_dir: str) -> dict:
    """The five modes at bf16 SIZE² over RING_WORLD ranks on the card under
    K1 (dispatch, fused) and the library (dispatch), and matrix_parallel
    over one rank; returns each mode's runs by label."""
    runs = {}
    for program, mode in SCALING_RUNS:
        runs[mode] = {f"{impl},{timing}": drive_scaling(program, mode, impl, timing, out_dir)
                      for impl, timing in (("cuda", "dispatch"), ("cuda", "fused"),
                                           ("torch", "dispatch"))}
    fallback = drive_scaling("scaling", "matrix_parallel", "cuda", "dispatch", out_dir, d=1)
    table = {mode: {"cuda_ms": r["cuda,dispatch"]["avg_ms"],
                    "cuda_fused_ms": r["cuda,fused"]["avg_ms"],
                    "library_ms": r["torch,dispatch"]["avg_ms"],
                    "cuda_over_library": r["cuda,dispatch"]["avg_ms"]
                    / r["torch,dispatch"]["avg_ms"],
                    "scaling_efficiency_pct": r["cuda,dispatch"]["scaling_efficiency_pct"],
                    "peak_efficiency_pct": r["cuda,dispatch"]["peak_efficiency_pct"]}
             for mode, r in runs.items()}
    table["matrix_parallel,d=1"] = {"cuda_ms": fallback["avg_ms"],
                                    "record_mode": fallback["mode"]}
    emit({"phase": "scaling", "modes": table, "ok": True})
    return runs


def profile_phase(cap: int, out_dir: str) -> dict:
    """--profile-dir on the card: batch_parallel at bf16 SIZE² and the fused
    ring at its cap, each traced by torch.profiler; prints each trace's
    device time per kernel, the device's busy and idle share inside the
    timed windows, and K6's device time a launch beside its event-timed
    ms. Fails when a trace holds no device kernel event; where the profiler
    records no CUDA activity at all, the program raises and the phase
    reports why."""
    from tpu_matmul_bench_torch.benchmarks import matmul_overlap_benchmark
    from tpu_matmul_bench_torch.utils import profiling

    result = {"phase": "profile"}
    scaling_dir, k6_dir = "build/profile/scaling", "build/profile/k6"
    for d in (scaling_dir, k6_dir):
        for old in glob.glob(f"{d}/*.json"):
            os.remove(old)
    try:
        traced = drive_scaling("scaling", "batch_parallel", "cuda", "dispatch", out_dir,
                               profile_dir=scaling_dir)
        argv = ["--mode", "cuda_ring", "--sizes", str(cap), "--dtype", "bfloat16",
                "--num-devices", str(RING_WORLD), "--matmul-impl", "cuda",
                "--iterations", str(OVERLAP_ITERATIONS), "--warmup", str(OVERLAP_WARMUP),
                "--profile-dir", k6_dir]
        with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr):
            (k6_rec,) = matmul_overlap_benchmark.main(argv)
    except RuntimeError as e:
        if "recorded no CUDA activity" not in str(e):
            raise
        result.update(profiler_records_cuda=False, reason=str(e), ok=True)
        emit(result)
        return result
    summaries = {}
    for label, d in (("scaling", scaling_dir), ("k6", k6_dir)):
        (trace,) = glob.glob(f"{d}/*.json")
        summaries[label] = {"trace": trace, "bytes": os.path.getsize(trace),
                            **profiling.device_summary(trace)}
    k6 = profiling.kernel_time_us(summaries["k6"]["trace"], "ring_fused")
    k1 = profiling.kernel_time_us(summaries["scaling"]["trace"], "wgmma_gemm")
    result.update(
        profiler_records_cuda=True, scaling=summaries["scaling"], k6=summaries["k6"],
        scaling_record_ms=traced["avg_ms"], scaling_k1_us_per_launch=k1["us_per_launch"],
        scaling_k1_share=k1["device_us"] / summaries["scaling"]["device_us"],
        k6_device_us_per_launch=k6["us_per_launch"], k6_launches_traced=k6["count"],
        k6_event_ms=k6_rec.avg_time_s * 1e3, k6_baseline_event_ms=k6_rec.compute_time_s * 1e3)
    problems = [f"the {label} trace holds no device kernel event"
                for label, s in summaries.items() if not s["kernel_launches"]]
    if not k6["count"]:
        problems.append("the fused ring's kernel is not in its trace")
    result["ok"] = not problems
    emit(result)
    if problems:
        fail("profile", "; ".join(problems))
    return result


def ring_bound(m: int, k: int, n: int, item: int, out_item: int, peak: float,
               bw: float) -> tuple[float, str]:
    """The least time for the function a ring computes, Y = X·W over the
    world: its 2mnk operations at the peak, or its bytes at the memory
    rate, X and W read once and Y written once. The hops and staged
    partials are the ring's own traffic, not the function's."""
    ops_s = 2.0 * m * n * k / (peak * 1e12)
    bytes_s = ((m * k + k * n) * item + m * n * out_item) / (bw * 1e9)
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def ring_entry(label: str, counts: dict, baseline_ms: float, card: str,
               peak: float, bw: float, size: int = SIZE) -> tuple[dict, tuple]:
    """Times and bound of one ring at bf16 size², RING_WORLD ranks on the
    card: the ring, its plain version and torch.matmul of the gathered
    operands, with the main path's launches and its baseline leg. Every
    shard of the ring's output is first held against the plain version's,
    max|ring − plain| / max|plain| within the bf16 tolerance. Returns the
    entry, the ring and its operands (X, W)."""
    import torch

    from tpu_matmul_bench_torch.parallel.mesh import gather

    reduce_scatter, build, plain, _ = rings()[label]
    fn = build(card_mesh(RING_WORLD))
    x, w = ring_operands(fn.mesh, reduce_scatter, (size, size, size),
                         torch.bfloat16, seed=11)
    got, want = gather(fn(x, w)), gather(plain(x, w))
    torch.cuda.synchronize()
    max_abs_err = (got.float() - want.float()).abs().max().item()
    max_rel_err = max_abs_err / (want.float().abs().max().item() or 1.0)
    finite = bool(torch.isfinite(got.float()).all())
    ok = (tuple(got.shape) == (size, size) and got.dtype == want.dtype == torch.bfloat16
          and finite and max_rel_err <= TOLERANCE["bfloat16"])
    phase = f"kernel_vs_plain[{label},{size}]"
    emit({"phase": phase, "ranks": RING_WORLD, "shape": [size] * 3,
          "max_abs_err": max_abs_err, "max_rel_err": max_rel_err,
          "tolerance": TOLERANCE["bfloat16"], "finite": finite, "ok": ok})
    if not ok:
        fail(phase, f"{tuple(got.shape)} {got.dtype}, finite {finite}, "
                    f"max rel err {max_rel_err}")
    del got, want
    kernel_ms = events_ms(lambda: fn(x, w), runs=5 if size == SIZE else 50)
    plain_ms = events_ms(lambda: plain(x, w), runs=2 if size == SIZE else 20)
    xg, wg = gather(x), gather(w)
    library_ms = events_ms(lambda: torch.matmul(xg, wg), runs=5 if size == SIZE else 50)
    del xg, wg
    torch.cuda.empty_cache()
    bound_ms, bound_by = ring_bound(size, size, size, 2, 2, peak, bw)
    products, hops = counts["ring_steps"], counts["ring_hops"]
    if label == "ring_fused":
        launches = {"ring_fused": counts["fused"]}
    elif reduce_scatter:
        launches = {"products": products, "hops": hops, "rs_step": counts["matmul_rs"]}
    else:
        launches = {"products": products, "hops": hops, "ag_step": counts["matmul_ag"]}
    return {"route": "cuda", "dtype": "bfloat16", "card": card,
            "shape": f"{size}x{size}x{size}", "ranks": RING_WORLD, "cards": 1,
            "launches": counts["fused"] if label == "ring_fused" else products + hops,
            "gemm_route": "wgmma" if label == "ring_fused" else "wgmma_persistent",
            "launches_by_route": counts["routes"], "hop_launches": hops,
            "launches_by_kernel": launches,
            "max_abs_err": max_abs_err, "max_rel_err": max_rel_err,
            "tolerance": TOLERANCE["bfloat16"], "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "baseline_ms": baseline_ms}, (fn, x, w)


def residency_probe(cap: int, l2: int, runs: int = 20) -> dict:
    """K6 and K2 through their wrappers at half the fused ring's cap, at
    the cap and at twice it, bf16 over RING_WORLD ranks on the card: ms and
    TFLOP/s per size, K6's output held against its plain version, and the
    operands' footprint (every rank's X, 2 slots, W and Y) beside the L2 the
    card reports. If residency in L2 set K6's time, its TFLOP/s would drop
    past the cap, where the footprint no longer fits."""
    import torch

    from tpu_matmul_bench_torch.parallel.mesh import gather

    step = 128 * RING_WORLD
    _, fused, plain, _ = rings()["ring_fused"]
    k2 = rings()["ring_ag"][1]
    mesh = card_mesh(RING_WORLD)
    fn, ring = fused(mesh), k2(mesh)
    sizes = {}
    for size in (max(cap // 2 // step * step, step), cap, 2 * cap):
        x, w = ring_operands(mesh, False, (size, size, size), torch.bfloat16, seed=13)
        got, want = gather(fn(x, w)), gather(plain(x, w))
        torch.cuda.synchronize()
        rel = ((got.float() - want.float()).abs().max().item()
               / (want.float().abs().max().item() or 1.0))
        del got, want
        ms = events_ms(lambda: fn(x, w), runs=runs)
        k2_ms = events_ms(lambda: ring(x, w), runs=runs)
        footprint = size * size * (4 * 2 + 2)
        sizes[str(size)] = {
            "footprint_bytes": footprint, "fits_l2": footprint <= l2,
            "ms": ms, "tflops": 2.0 * size ** 3 / (ms * 1e9),
            "k2_ms": k2_ms, "k2_tflops": 2.0 * size ** 3 / (k2_ms * 1e9),
            "grid_blocks": fn.grid_blocks, "route": fn.route, "max_rel_err": rel}
        del x, w
        torch.cuda.empty_cache()
    ok = all(v["max_rel_err"] <= TOLERANCE["bfloat16"] and v["route"] == "wgmma"
             for v in sizes.values())
    emit({"phase": "fused_residency", "ranks": RING_WORLD, "l2_bytes": l2,
          "cap": cap, "sizes": sizes, "ok": ok})
    if not ok:
        fail("fused_residency", f"K6 differs from its plain version or left its "
                                f"wgmma form: {sizes}")
    return sizes


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    try:
        from tpu_matmul_bench_torch.ops import _build
        from tpu_matmul_bench_torch.ops.cuda_matmul import (
            PERSISTENT_TILES,
            TILES,
            matmul_plain,
            occupancy,
        )
        from tpu_matmul_bench_torch.ops.cuda_ring_fused import occupancy as fused_occupancy
        from tpu_matmul_bench_torch.ops.matmul import random_operands
        from tpu_matmul_bench_torch.parallel.overlap import cuda_ring_max_size, l2_bytes
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
        blocks_per_sm = {route: {"x".join(map(str, t)): occupancy(t, torch.bfloat16,
                                                                   route=route)
                                 for t in TILES} for route in ("wmma", "wgmma")}
        for forward in (False, True):
            blocks_per_sm["wgmma_persistent" + ("_forward" if forward else "")] = {
                "x".join(map(str, t)): occupancy(t, torch.bfloat16, route="wgmma_persistent",
                                                 forward=forward)
                for t in PERSISTENT_TILES}
        blocks_per_sm["ring_fused"] = {route: fused_occupancy(torch.bfloat16, route)
                                       for route in ("wmma", "wgmma")}
    except (_build.KernelBuildError, OSError, RuntimeError) as e:
        fail("build", str(e))
    # ptxas must neither serialise a wgmma kernel's wgmma nor ignore its
    # setmaxnreg: either costs most of what the route is for
    warned = {f"{lib}:{kernel}": usage["warnings"] for lib, kernels in resources.items()
              for kernel, usage in kernels.items()
              if "wgmma" in kernel and usage.get("warnings")}
    wgmma_kernels = sum("wgmma" in k for kernels in resources.values() for k in kernels)
    emit({"phase": "build", "seconds": seconds,
          "libraries": {k: str(v) for k, v in libs.items()},
          "resources": resources, "bf16_blocks_per_sm": blocks_per_sm,
          "wgmma_kernels": wgmma_kernels, "wgmma_warnings": warned,
          "ok": not warned and wgmma_kernels > 0})
    if warned or not wgmma_kernels:
        fail("build", f"ptxas warned on wgmma kernels: {warned}" if warned
             else "no wgmma kernel was built")

    # 3. each kernel against its plain version, on the card, in true fp32
    apply_matmul_precision("highest")
    cases = [(d, s) for d in TOLERANCE for s in SHAPES]
    cases.append(("bfloat16", (SIZE, SIZE, SIZE)))
    # K1's two other shapes in the scaling modes (matrix and model parallel)
    cases += [("bfloat16", mkn) for mkn in dict.fromkeys(SCALING_SHAPES.values())
              if mkn != (SIZE, SIZE, SIZE)]
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
    check_wgmma()
    ksplit_errors = check_ksplit()
    check_matmul_acc()
    rs_errors = check_rs_step()
    ag_errors = check_ag_step()
    check_rings()
    for size in RACE_SIZES:
        check_races(size, ["ring_ag", "ring_rs", "ring_ag_bidir", "ring_rs_bidir"])
    # the fused ring's cap: 4 ranks' operands in the card's L2, as it reports it
    l2 = l2_bytes(torch.device("cuda", 0))
    cap = cuda_ring_max_size(RING_WORLD, torch.bfloat16, l2, RING_WORLD)
    emit({"phase": "fused_cap", "l2_bytes": l2, "ranks": RING_WORLD, "cap": cap})
    check_races(cap, ["ring_fused"])

    # 4. the paths through their entry points; launch counts are set to 0
    # just before each run and read just after
    with tempfile.TemporaryDirectory() as out_dir:
        dispatch, launches = drive("cuda", "dispatch", out_dir)
        fused, launches_fused = drive("cuda", "fused", out_dir)
        library, _ = drive("torch", "dispatch", out_dir)
        library_fused, _ = drive("torch", "fused", out_dir)
        c1 = c1_check([dispatch, fused, library, library_fused], out_dir)
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
        overlaps = {label: drive_overlap(mode, out_dir) for label, mode in (
            ("ring_ag", "cuda_ring_hbm"), ("ring_rs", "cuda_ring_rs_hbm"),
            ("ring_ag_bidir", "cuda_ring_bidir_hbm"),
            ("ring_rs_bidir", "cuda_ring_bidir_rs_hbm"))}
        overlaps["ring_fused"] = drive_overlap("cuda_ring", out_dir, size=cap)
        k2_at_cap, _ = drive_overlap("cuda_ring_hbm", out_dir, size=cap)
        scaling = scaling_phase(out_dir)
        profile = profile_phase(cap, out_dir)

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

    # 7. the rings at bf16 16384^2 over RING_WORLD ranks on the card, the
    # fused ring at its cap, beside K2 on the same operands
    fused_summary, fused_counts = overlaps.pop("ring_fused")
    entries = {label: ring_entry(label, counts, summary["baseline_ms"], card, peak, bw)[0]
               for label, (summary, counts) in overlaps.items()}
    entries["ring_fused"], (fused_ring, x, w) = ring_entry(
        "ring_fused", fused_counts, fused_summary["baseline_ms"], card, peak, bw, size=cap)
    k2 = rings()["ring_ag"][1](fused_ring.mesh)
    entries["ring_fused"].update(
        cap=cap, l2_bytes=l2, grid_blocks=fused_ring.grid_blocks, fused_route=fused_ring.route,
        overlap_ms=fused_summary["avg_ms"],
        k2_ms_at_cap=events_ms(lambda: k2(x, w), runs=50),
        k2_overlap_ms_at_cap=k2_at_cap["avg_ms"])
    del fused_ring, x, w, k2
    torch.cuda.empty_cache()
    entries["ring_fused"]["by_size"] = residency_probe(cap, l2)
    for label in RS_STEPS:
        entries[label].update(step=rs_step_ms(label), step_max_abs_err=rs_errors[label])
    # the all-gather rings keep the main path's short timing in ms and
    # library_ms, as every ring does; their turns at steady clocks go beside it
    for label in AG_STEPS:
        turns = ring_turns(label, card)
        entries[label].update(
            turns_ms=turns["forward_ms"], turns_hop_ms=turns["hop_ms"],
            turns_library_ms=turns["library_ms"],
            forward_over_library=turns["forward_over_library"],
            hop_over_library=turns["hop_over_library"],
            step=ag_step_ms(label), step_max_abs_err=ag_errors[label])
    emit({"kernels": [{
        "name": "matmul", "route": "cuda",
        "source": "tpu_matmul_bench_torch/csrc/matmul.cu",
        "replaces": "tpu_matmul_bench/ops/pallas_matmul.py:37",
        "replaces_function": "_matmul_kernel",
        "shape": f"{SIZE}x{SIZE}x{SIZE}", "dtype": "bfloat16",
        "launches": launches, "launches_fused": launches_fused,
        "gemm_route": "wgmma", "launches_by_route": dispatch["launches_by_route"],
        "max_abs_err": headline_err,
        "ms": dispatch["avg_ms"], "kernel_ms": dispatch["avg_ms"],
        "fused_ms": fused["avg_ms"], "plain_ms": plain_ms,
        "bound_ms": max(ops_s, bytes_s) * 1e3,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": library["avg_ms"], "library_fused_ms": library_fused["avg_ms"],
        "c1": c1, "card": card,
        "tiles_ms": {t: {"mnk": tiles_mnk[t], "nmk": tiles_nmk[t]}
                     for t in tiles_mnk},
        # each parallel mode's products over RING_WORLD ranks (dispatch)
        "scaling": {mode: {"shape": r["cuda,dispatch"]["k1_shape"],
                           "launches": r["cuda,dispatch"]["k1_launches"],
                           "mode_ms": r["cuda,dispatch"]["avg_ms"],
                           "library_mode_ms": r["torch,dispatch"]["avg_ms"]}
                    for mode, r in scaling.items()},
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
        "kernels": ["csrc/ring_rs.cu tmb_ag_step (rs_step_wgmma, forwarding)"],
        **entries["ring_ag"],
    }, {
        "name": "ring_reduce_scatter_matmul",
        "source": "tpu_matmul_bench_torch/ops/cuda_ring.py",
        "replaces": "tpu_matmul_bench/ops/pallas_ring_rs_hbm.py:259",
        "replaces_function": "ring_reduce_scatter_matmul_hbm",
        "kernels": ["csrc/ring_rs.cu tmb_rs_step (rs_step_wgmma)"],
        **entries["ring_rs"],
    }, {
        "name": "ring_allgather_matmul_bidir",
        "source": "tpu_matmul_bench_torch/ops/cuda_ring.py",
        "replaces": "tpu_matmul_bench/ops/pallas_ring_bidir_hbm.py:143",
        "replaces_function": "ring_allgather_matmul_bidir_hbm",
        "kernels": ["csrc/ring_rs.cu tmb_ag_step (rs_step_wgmma, forwarding)"],
        **entries["ring_ag_bidir"],
    }, {
        "name": "ring_reduce_scatter_matmul_bidir",
        "source": "tpu_matmul_bench_torch/ops/cuda_ring.py",
        "replaces": "tpu_matmul_bench/ops/pallas_ring_bidir_rs_hbm.py:165",
        "replaces_function": "ring_reduce_scatter_matmul_bidir_hbm",
        "kernels": ["csrc/ring_rs.cu tmb_rs_step (rs_step_wgmma)"],
        **entries["ring_rs_bidir"],
    }, {
        "name": "ring_allgather_matmul_fused",
        "source": "tpu_matmul_bench_torch/csrc/ring_fused.cu",
        "replaces": "tpu_matmul_bench/ops/pallas_ring.py:121",
        "replaces_function": "ring_allgather_matmul",
        "kernels": ["csrc/ring_fused.cu ring_fused_wgmma"],
        **entries["ring_fused"],
        "profiled_device_us_per_launch": profile.get("k6_device_us_per_launch"),
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
