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
  fused/dispatch ratio may exceed cuBLAS's by at most C1_MARGIN; each
  kernel record must carry the kernel's cost books (`cost_analysis`,
  flops_ratio 1.0) and each library record none;
- the headline entry, `python -m tpu_matmul_bench_torch.bench`, in a
  process of its own (the `headline` phase): its ladder of fused attempts
  (`auto`, `torch`, `cuda`) as child processes, its last line `backend`
  "ok" with the best of each impl, the kernel's within HEADLINE_MARGIN of
  the fused run above (`auto` takes whichever impl the tuning DB routes
  bf16 16384³ to; each record's books say which ran);
- the tuning database (the `tune_db` phase): `tune prune` at 16384³, `tune
  promote` of the 16384³ sweep's ledger into a DB of its own, and `auto`
  through a measured `cuda` cell carrying the sweep's winning tile,
  installed as the process's DB: `source` "db" at that tile, one K1 launch
  a call on wgmma, bitwise `cuda_matmul` at the tile and within bf16's
  tolerance of the plain version; an `auto` lookup's host µs (memoised and
  cold fingerprint); `auto` against `cuda_matmul` in turns; `tune selftest`
  on the committed DB; `matmul` at int8 16384³ under `auto` through the
  committed DB's `cuda` cell (K1 on wmma, as many launches as predicted);
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
  operands fit the card's L2; after each HBM ring's overlap run, `tune
  --ring` over it at the same size (the `tune_ring` phase): the default
  tile on the persistent ring-step GEMM within TUNE_RING_MARGIN of the
  overlap run, other tiles off it, on the route `cuda_matmul.step_route`
  gives; the ring overlap lines and the `tune_ring` lines print the
  fastest and slowest single call of their timed loops, with the slowest
  one's host time and allocator events beside the median one's (ROADMAP C3);
- the scaling and distributed programs, `tpu_matmul_bench_torch.benchmarks
  .matmul_scaling_benchmark.main` and `.matmul_distributed_benchmark.main`,
  in their five parallel modes at bf16 16384² over 4 ranks on the card,
  each through the kernel under both timing protocols and through the
  library, and `matrix_parallel` over one rank (the `scaling` phase): every
  product on K1's wgmma route (its two other shapes, 16384x16384x4096 and
  16384x4096x16384, held against the plain version first), as many
  launches as the mode makes, `validation: ok`, fused runs that ran fused
  with their operands chained; then ROADMAP C2's check, each efficiency
  mode's leg timed in turns with the single-device baseline's product at
  steady clocks (`scaling_efficiency_in_turns`, at most 105%);
- the wire formats (the `wire` phase): `wire_psum`, `wire_reduce_scatter`
  and `wire_all_gather` called directly over 4 ranks on the card at bf16
  16384² in int8 (the legacy tier), fp8, int8-block:128 and fp8-block:128,
  each within its error bound of the exact collective and timed beside
  it; then the programs under `--comm-quant` (the `comm_quant` phase):
  `model_parallel` in the four formats, `data_parallel`, `batch_parallel`
  and `matrix_parallel` in one each, and `model_parallel` int8-block:128
  fused, each `validation: ok`, its K1 launches all on wgmma, its
  `comm_quant` extra the port's own and every full-program call on the
  wire; then the collectives program's six ops at a 16384² bf16 payload a
  rank and `collectives selftest` (the `collectives` phase). With ranks
  on one card every wire and collective is a copy within its memory;
- the overlap program's seven library modes (the `overlap_modes` phase):
  `no_overlap`, `overlap` and `pipeline` (8 product+psum steps a call on
  the ranks' compute and communication streams) and the four
  collective-matmul rings (K1 products and hops on copy streams), at bf16
  16384² over 4 ranks on the card, each through the kernel under both
  timing protocols and through the library: as many K1 launches and hops as
  the protocol derives (`overlap_counts`), all on wgmma (K1's four ring
  shapes held against the plain version first), `validation: ok` on the
  rings, fused runs that ran fused and chained, no negative comm or
  overhead time; then each ring in turns with the ring kernel of its
  contract (K2–K5) and the library product (`collective_turns`). A 20-call
  race check of `overlap`, `pipeline` and the four rings at 2048² holds
  each call to the same program run with the card synchronised after every
  launch;
- the 2-D modes (the `hybrid` and `summa` phases): `hybrid --dp 2` and
  SUMMA on its 2x2 grid at bf16 16384² over 4 ranks on the card, each
  through the kernel under both timing protocols and through the library,
  `validation: ok`, K1_PER_CALL launches a call, all on wgmma (their
  product shapes held against the plain version first); hybrid again on
  `--mesh dcn:2,ici:2` with the dcn psum on an fp8-block:128 wire (its
  per-link `comm_quant` extra the port's own); SUMMA validate-only on the
  1x4 and 4x1 grids (each compute leg's K1 products, on panels that are
  views of the resident blocks, held to the library's) and on the mesh;
- the out-of-core stream (the `stream` phase): `parallel stream` at bf16
  32768² in 16 K-panels over one rank under a 5.5 GiB budget (out of core:
  the in-core modes bust it), through the pickup kernel and through the
  library (host operands made once for both), `validation: ok`; its H2D
  copies and its products timed apart; a 10-call race check at 4096² held
  bitwise to a serial call; the stream over 4 ranks on `--mesh
  dcn:2,ici:2`, validate-only;
- `--profile-dir` (the `profile` phase): `batch_parallel` at 16384², the
  fused ring at its cap and K4 at 16384², each traced by torch.profiler,
  with the device time per kernel, the device's busy and idle share inside
  the timed windows, the fused ring's device time a launch and the spread
  of K4's step launches read from the traces;
- the comparison, curve, memory-rate, doctor and train programs at bf16
  16384² over 4 ranks on the card: `curve`
  (batch_parallel over 1, 2 and 4 ranks under K1: a record and a table row
  a count, each `validation: ok` with the scaling phase's launch count, no
  efficiency above 105%); `membw` (its five ops at 8192² and 16384², far
  above the L2, none above the datasheet's rate); `doctor` as a process
  (exit 0); `compare` (the whole table in process, every row there and
  validated, each in-process row's K1 launches the count `resolve_route`
  predicts on the committed DB from the products it routed under `auto`,
  each HBM ring's steps launched; two rows in child processes under
  `--isolate`; K6 and K2 at K6's cap); `train bench` in four runs (dp at
  zero 0 and 1, dp on an fp8-block:128 gradient wire, hybrid on `--mesh
  dcn:2,ici:2` with the dcn sync on the wire), each record valid, its five
  phases summing to its wall time, validated against the dense fp32
  reference, its synced gradient held to the dense one; and `train
  selftest` over 8 ranks on the card;
- the serving path (the `serve` phase), `serve.cli.main` in process: bf16
  requests of a 4096-wide layer (SERVE_MIX) at 500 QPS open loop under
  `cuda` and under `torch` (the same seeded request stream), closed loop at
  8 clients, `ab` (fixed window against continuous batching), `--explore
  0.05` under `auto`, and int8 under `auto` on three squares, every run
  prewarmed and each load window traced by torch.profiler: each record
  valid, no failed and no cold request, the window's K1 kernels equal to
  the requests of its buckets that run K1 (by bucket), the explorer within
  its budget with its K1 kernels equal to its explored requests, int8's
  buckets on the tier and impl `resolve_route` gives; each bucket's
  executable (a CUDA graph of one product) held to the plain version once
  and its replays timed and traced; then `serve selftest`, `serve trace
  selftest`, `tune online selftest` and `serve explain --slowest 3`; `ab`
  runs bare (no ledger, no profiler) and a regressed verdict (exit 1) is
  recorded on the phase's line, any other nonzero exit fails;
- pod serving (the `pod` phase) over 8 ranks that share the card
  (`TMB_RANKS_PER_CARD=8`; every gather a copy within its memory, not
  NVLink): `serve pod selftest`; each group executable (one CUDA graph of
  the group's K1 products and gathers) of `--mesh dcn:2,ici:4` and of
  `dcn:4,ici:2` with its dcn gathers on fp8-block:32, in 2 replica groups,
  held rank by rank to the plain product (bf16 1e-2; the fp8 wire 0.08),
  4 K1 kernels a replay; K1 and cuBLAS at the six per-rank products; then
  SERVE_MIX through `serve bench --mesh` under `cuda` (traced: 4 K1
  kernels a request), `torch`, closed loop, the quantized mesh (its wire
  calls counted), unprewarmed (drain threads capture misses while the
  other group replays: no failed request); the two-process warm start from
  the kernel-library store (`--artifacts`: the second process, in a copy
  whose build directory starts empty and whose `nvcc` fails, starts nvcc
  0 times, imports every executable, serves no cold request and gives the
  first's outputs bitwise); and `serve ab --mesh` bare, its verdict
  recorded as the serve phase's is;
- the campaign runner (the `campaign` phase): `campaign run
  specs/torch/card.toml` (K1 fused at 16384³ traced, the library at the
  same shape, K1b at 28672x4096x8192 S=2 traced, a 2 s serve window under
  `cuda`) as a process of its own, SIGKILLed with its group once the first
  job is done and the next job's child is on the card; every job child
  that outlives the group kill (the supervisor starts each in a session of
  its own) is listed, with whether nvidia-smi's compute apps name it, and
  killed by its session; no process of the killed run may be alive or on
  the card before `campaign resume`; then every job done exactly once with
  one ledger, K1's GEMM in the cuda job's trace and K1b's S=2 grids plus
  `reduce_partials` in the split-K job's, `campaign status` exit 0, the
  gate against itself exit 0 and against a baseline with the cuda job's
  TFLOPS raised 1.5x exit 1, each twice with the same output; the cuda
  job's TFLOPS beside the fused run of this process (printed, not gated),
  the resumed job's beside its pre-kill attempt when one landed; and
  `tune fill` of a
  one-job spec (bf16 8192³, two tiles) into a DB of its own, never the
  committed one, through which `matmul --matmul-impl auto` in this process
  resolves `source` "db", counted by `tune_route_total{source="db"}`, its
  K1 launches counted;
- the fault certifier (the `faults` phase): `faults selftest` and
  `faults audit --smoke --spec specs/chaos.toml` (its first ledger, tune
  and obs cells), processes whose children never touch the card, run
  beside the campaign phase, and `faults audit` of the matrix's serve
  cell, copied verbatim into a spec of its own (`serve selftest` on the
  card killed at its second batch), beside the campaign's resume (whose
  jobs' numbers are recorded, not compared): every exit 0 and every
  verdict PASS, each cell's seconds on the phase's line. The whole matrix took 308.5 s on an NVIDIA H100 80GB
  HBM3 at 700 W, over the phase's share of the script's time;
- the perf observatory (the `obs` phase): `obs status --follow` as a
  process of its own tails the campaign's `obs/` snapshots while its jobs
  run (at least one snapshot seen, the last it printed the file's final
  line); `obs selftest --device cuda` in process (its bucket's executable
  a CUDA graph of K1, launched while it is built, its output held to the
  plain version, its cost books' route, tile and `flops_ratio`), and the
  exporter's HTTP surface on the selftest's registry (`/metrics`,
  `/readyz`); the committed history store (`measurements/torch/
  history.jsonl`, round 1) copied, the campaign's job ledgers ingested
  into the copy as round 2, `obs history selftest` on the committed store,
  `obs detect` and `obs report` on the copy (a regression verdict, exit 1,
  is recorded; exit 2 fails); and `campaign gate --history` of the
  campaign against the copy, where every job must find its round-1
  baseline. With `--keep-ledgers DIR` the campaign's job ledgers and the
  selftest's serve ledger are copied into DIR, unedited but for their
  names (`.ndjson`, as the card's committed ledgers are);
- the contract auditor (the `lint` phase): `lint --fail-on error
  --json-out` in process over 8 ranks that share the card, exit 0, its
  findings by group, rule and severity and each group's seconds, K1's and
  K1b's launches by route (counted from 0 just before it, at least one
  each), K1 and K1b at the `impls` group's shapes held to their plain
  versions; a mode's compute with an added `.item()` firing PURE-001 in
  the recorder and under the sync debug mode, and a fused chain that
  clones its operands firing DONATE-001; the live-bytes walk's peak of
  each mode at 4 and 8 ranks within LINT_WALK_BAND of the allocator's peak
  in the same call; SMEM_PER_BLOCK against the card's opt-in limit;
  `parallel hier selftest` on the card (exit 0, its stream's pickups on
  K1); and the campaign's lint gate, two processes: `campaign run --lint --dry-run` of CAMPAIGN_SPEC (exit 0, no job)
  and a copy with an unknown key in one [[job]] table (a nonzero exit
  before any job); the two run on the CPU beside the campaign phase. The
  lint must report every group (`auditor.audit_groups()`: JAX's 19 and
  `specs`) with no finding in any. Then the last four groups on the card
  (slice 20): `sched`'s programs and the fingerprint inventory run on the
  card with K1's and K1b's launches counted from 0 and held to the count
  of products the recorder saw (`schedule.PRIMITIVES_RUN`); the card's
  fingerprints equal the golden written on the CPU key by key; each
  program's recorded schedule on the card equals the CPU's (canonical
  form); an `overlap` StepProgram whose sum waits on its own step's
  products fires SCHED-001 on the card; `lint conc selftest` and `lint
  schema selftest` exit 0 as child processes; and the executable cache's
  capture under a pod's capture lock waits for no card-wide sync
  (`capture_lock_check`, CONC-004): it returns while a kernel of about a
  second still runs on another stream, holds the lock for a small share of
  that, and calls no `torch.cuda.synchronize` with the lock held.

Standard output is one JSON object per line: one per phase, the
`seconds` line (each stretch's seconds), then the `kernels` line, then `{"ok": true, "device": {...}}` as the last line. The
programs' own reports go to standard error. The script exits nonzero,
without the last line, at the first phase that fails, when no CUDA device
is present, and when the port's package is not beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import io
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
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
# the tune_db phase's turns of `auto` through a DB cell and `cuda_matmul`
TUNE_DB_PASSES, TUNE_DB_RUNS = 3, 10
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
# ROADMAP C2: each efficiency mode's leg that its TFLOPS formula reads,
# timed in turns with the single-device baseline's product at the power
# limit's steady clocks (`efficiency_in_turns`): EFFICIENCY_CALLS calls of
# the leg (RING_WORLD products each) against as many baseline products,
# after EFFICIENCY_WARMUP calls of each, in EFFICIENCY_PASSES passes, every
# other in the mirrored order; no card reads above EFFICIENCY_MAX_PCT
EFFICIENCY_LEGS = {"independent": "compute", "batch_parallel": "full",
                   "data_parallel": "compute"}
EFFICIENCY_CALLS, EFFICIENCY_WARMUP, EFFICIENCY_PASSES = 20, 20, 3
EFFICIENCY_MAX_PCT = 105.0
# the wire formats at bf16 SIZE² over RING_WORLD ranks on the card (the
# `wire` phase): each format's bound on the relative error of the whole
# output (Frobenius norm) against the exact collective, the seeded bounds
# of tests/test_comm_quant_block.py; WIRE_RUNS calls each, the median
WIRE_FORMATS = {"int8": 0.02, "fp8": 0.08, "int8-block:128": 0.02, "fp8-block:128": 0.08}
WIRE_RUNS = 10
# the programs under --comm-quant (the `comm_quant` phase): (program, mode,
# format), cuda dispatch with --validate, and one fused run
COMM_QUANT_RUNS = [("distributed", "model_parallel", spec) for spec in WIRE_FORMATS] + [
    ("distributed", "data_parallel", "int8-block:128"),
    ("scaling", "batch_parallel", "fp8-block:128"),
    ("scaling", "matrix_parallel", "int8-block:128")]
COMM_QUANT_FUSED = ("distributed", "model_parallel", "int8-block:128")
# the collectives program's six ops at a SIZE² bf16 payload a rank
COLLECTIVE_OPS = ("psum", "all_gather", "reduce_scatter", "ppermute", "ppermute_bidir",
                  "all_to_all")
# K1's shape in each mode over RING_WORLD ranks, (m, k, n): held against the
# plain version in kernel_vs_plain, on the wgmma route
# the 2-D modes (the `hybrid` and `summa` phases) at bf16 SIZE² over
# RING_WORLD ranks on the card: hybrid at --dp 2 (each rank's local batch of
# 2 products [SIZE, SIZE]·[SIZE, SIZE/2]), then on a factorized mesh with the
# dcn psum on a wire; SUMMA on its 2x2 grid (2 steps of [SIZE/2]³ products a
# rank), then validate-only on a 1x4 and a 4x1 grid (A panels that are
# column views) and on the factorized mesh
HYBRID_DP = 2
HYBRID_MESH, HYBRID_WIRE = "dcn:2,ici:2", "dcn=fp8-block:128,ici=none"
HYBRID_SHAPE = (SIZE, SIZE, SIZE // HYBRID_DP)  # (m, k, n) of each product
SUMMA_SHAPE = (SIZE // 2, SIZE // 2, SIZE // 2)
K1_PER_CALL = {"hybrid": RING_WORLD * (4 // HYBRID_DP), "summa": RING_WORLD * 2}
SUMMA_ROWS = (1, 4)
# the out-of-core stream (the `stream` phase): one rank, A and B (2 GiB each)
# on the host, a 4 GiB fp32 accumulator and 2 x (256 + 256) MiB of windows
# on the card, under a budget the in-core `independent` (6 GiB) busts
STREAM_SIZE, STREAM_PANELS, STREAM_BUDGET_GIB, STREAM_ITERATIONS = 32768, 16, 5.5, 3
STREAM_RACE_SIZE, STREAM_RACE_PANELS, STREAM_RACE_CALLS = 4096, 8, 10
STREAM_MESH = "dcn:2,ici:2"
# the comparison, curve, memory-rate, doctor and train programs at bf16
# SIZE² over RING_WORLD ranks on the card: the
# scaling curve of batch_parallel over 1, 2 and 4 ranks under K1 (the
# scaling phase's iterations, so each row's K1 launches are
# `scaling_launches` less the baseline the first multi-rank row measured);
# membw's five ops at two sizes far above the card's L2; the doctor as a
# process; the compare table (its rows' K1 launches as `resolve_route`
# predicts them on the committed DB), its isolated rows and K6's cap; and
# the train step
CURVE_MODE, CURVE_COUNTS = "batch_parallel", (1, 2, 4)
MEMBW_SIZES, MEMBW_ITERATIONS, MEMBW_WARMUP = (8192, SIZE), 20, 3
COMPARE_ITERATIONS, COMPARE_WARMUP = 3, 1
COMPARE_ISOLATED = ("single", "batch_parallel")
COMPARE_AT_CAP = ("cuda_ring", "cuda_ring_hbm")
# the step modes' programs give no corner verdict ("n/a ..."), in JAX too
COMPARE_NO_VERDICT = ("no_overlap", "overlap", "pipeline")
# the HBM rings' step launches by row: the all-gather rings forward
# (cuda_matmul.AG_LAUNCHES), the reduce-scatter rings store (RS_LAUNCHES)
COMPARE_RING_STEPS = {"cuda_ring_hbm": "ag", "cuda_ring_bidir_hbm": "ag",
                      "cuda_ring_rs_hbm": "rs", "cuda_ring_bidir_rs_hbm": "rs"}
TRAIN_BATCH, TRAIN_ITERATIONS, TRAIN_WARMUP = 8, 2, 1
TRAIN_RUNS = [("--mode", "dp", "--zero", "0"),
              ("--mode", "dp", "--zero", "1"),
              ("--mode", "dp", "--zero", "1", "--grad-quant", "fp8-block:128", "--steps", "4"),
              ("--mode", "hybrid", "--mesh", "dcn:2,ici:2", "--zero", "1",
               "--grad-quant", "dcn=fp8-block:128,ici=none")]
# the serving path (the `serve` phase): bf16 requests of a 4096-wide
# transformer layer on DEFAULT_GRID points (nothing padded): token batches of
# 1024 and 2048 through a projection and an up-projection, and an 8192³
# square; open loop at SERVE_QPS for SERVE_DURATION s, closed loop at
# SERVE_CONCURRENCY clients, the explorer at SERVE_EXPLORE, and int8 under
# `auto` over three squares the committed DB routes two ways. Each load window
# is traced by torch.profiler; each bucket's executable is replayed
# SERVE_REPLAYS times alone, timed and traced
SERVE_MIX = "1024x4096x4096:1,2048x4096x16384:1,8192:0.25"
SERVE_QPS, SERVE_DURATION, SERVE_CONCURRENCY, SERVE_EXPLORE = 500, 4, 8, 0.05
SERVE_INT8_MIX, SERVE_INT8_QPS = "1024:1,2048:1,4096:1", 200
SERVE_REPLAYS = 20
# traces a bucket's replays (or a load window) may take when one comes back
# short of its K1 kernels: the profiler lost 1 of 20 int8 K1 records once,
# 6 of 20 in both of two traces of one bucket, and 9 of 12268 in a pod window
# (NVIDIA H100 80GB HBM3, 700 W); each trace's count is held exactly
SERVE_TRACES = 4
# the pod cells (slice 16): SERVE_MIX over POD_RANKS ranks that share the
# card, in POD_GROUPS replica groups of POD_MESH (each group `ici:4`) and of
# POD_QUANT_MESH (each group `dcn:2,ici:2`, its dcn gathers on POD_QUANT);
# POD_K1_A_REQUEST K1 products a request, one a rank of its group, whose
# shapes are POD_RANK_SHAPES (m, k, n): the three buckets on each group mesh
POD_RANKS, POD_GROUPS, POD_K1_A_REQUEST = 8, 2, 4
POD_MESH, POD_QUANT_MESH = "dcn:2,ici:4", "dcn:4,ici:2"
POD_QUANT = "dcn=fp8-block:32,ici=none"
POD_RANK_SHAPES = [(1024, 4096, 1024), (2048, 4096, 4096), (8192, 8192, 2048),
                   (512, 4096, 2048), (1024, 4096, 8192), (4096, 8192, 4096)]
# K1's kernels in a trace (the wgmma, wmma and SIMT routes), not cuBLAS's
# (whose names hold "xmma_gemm")
K1_KERNEL = re.compile(r"(?<![A-Za-z0-9_])(wgmma_gemm|wmma_gemm|simt_gemm_f32)\b")

SCALING_SHAPES = {"independent": (SIZE, SIZE, SIZE), "batch_parallel": (SIZE, SIZE, SIZE),
                  "data_parallel": (SIZE, SIZE, SIZE),
                  "matrix_parallel": (SIZE, SIZE, SIZE // RING_WORLD),
                  "model_parallel": (SIZE, SIZE // RING_WORLD, SIZE)}
# the overlap program's seven library modes (the `overlap_modes` phase) at
# bf16 SIZE² over RING_WORLD ranks: the step programs run STEPS_PER_CALL
# steps of one SIZE³ product a rank a call (about 0.4 s), so they time
# STEP_ITERATIONS call after STEP_WARMUP; the collective-matmul rings
# OVERLAP_ITERATIONS after OVERLAP_WARMUP, as the ring kernels
STEP_MODES = {"no_overlap": 1, "overlap": 2, "pipeline": 3}  # mode: buffers (k)
CM_MODES = ("collective_matmul", "collective_matmul_bidir", "collective_matmul_rs",
            "collective_matmul_bidir_rs")
STEP_ITERATIONS, STEP_WARMUP, STEPS_PER_CALL = 1, 1, 8
# K1's new shapes in the collective-matmul rings, (m, k, n): the all-gather
# rings' chunk and half chunk, the reduce-scatter rings' row chunk and half
# (their baselines' products are SCALING_SHAPES' matrix and model parallel)
CM_SHAPES = [(SIZE // RING_WORLD, SIZE, SIZE // RING_WORLD),
             (SIZE // RING_WORLD // 2, SIZE, SIZE // RING_WORLD),
             (SIZE // RING_WORLD, SIZE // RING_WORLD, SIZE),
             (SIZE // RING_WORLD // 2, SIZE // RING_WORLD, SIZE)]
# the race check of the step rings and the collective-matmul rings
OVERLAP_RACE_SIZE = 2048
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
RING_TURN_RUNS, RING_TURN_WARMUP, RING_TURN_PASSES = 100, 80, 2
# ROADMAP C1: the fused protocol may read at most C1_MARGIN slower, against
# dispatch, for the port's kernel than for cuBLAS. The main path's runs
# (50 products after 10, or after the 51 of the graph's warm call) time
# the card while its clocks still fall under the power limit, and the
# fused run later into that fall than the dispatch run; so the check
# compares the two protocols once both run at the limit's steady clocks:
# C1_ITERATIONS products after C1_WARMUP (about a second of load), in
# C1_PASSES passes of the four runs, every other pass in the mirrored order.
C1_MARGIN, C1_ITERATIONS, C1_WARMUP, C1_PASSES = 0.02, 120, 80, 3
# the headline entry (`python -m tpu_matmul_bench_torch.bench`, the
# `headline` phase): its budget (BENCH_TIMEOUT_S), and how far its `cuda`
# rung may read from the matmul phase's fused K1 TFLOPS in the same call
HEADLINE_TIMEOUT_S, HEADLINE_MARGIN = 600, 0.10
# `tune --ring` over the four HBM rings at bf16 SIZE² over RING_WORLD ranks
# (the `tune_ring` phase): the default tile, the persistent ring-step GEMM's
# only one, and tiles that take the steps off it; the default tile's ms may
# read at most TUNE_RING_MARGIN from the overlap phase's ring ms, so each
# ring's sweep runs right after its overlap run, at the same point of the
# clock's fall under the power limit (C1: a ring timed after lighter work
# reads up to 10% fast), over TUNE_RING_ITERATIONS calls: a K4 call alone
# ranges 12.8-16.0 ms, and the overlap run reads the median of 3 rounds
TUNE_RINGS = {"ring_ag": "cuda_ring_hbm", "ring_rs": "cuda_ring_rs_hbm",
              "ring_ag_bidir": "cuda_ring_bidir_hbm",
              "ring_rs_bidir": "cuda_ring_bidir_rs_hbm"}
TUNE_RING_TILES = [(128, 256, 64), (128, 128, 64)]
TUNE_RING_BIDIR_TILES = TUNE_RING_TILES + [(64, 128, 32)]
TUNE_RING_ITERATIONS, TUNE_RING_MARGIN = 20, 0.10
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


@contextlib.contextmanager
def single_calls():
    """Each timed call in the timed loops that run inside the block
    (`utils/timing.py time_jitted`, which the programs' timers and
    `cuda_tune` call), by the timed program: the yielded dict maps the
    order in which each program was first timed (0, 1, ...) to its calls'
    device ms ("ms"), each call's host ms (the host's time to issue it,
    "host_ms") and the caching allocator's device allocations and retries
    in each call ("allocs", "retries": a retry frees the cache and waits
    for the card), and their sums over its windows ("device_allocs",
    "alloc_retries"). A CUDA event is recorded on the current stream after
    each call of the loop, which the loop's own events already bracket, so
    the calls are the ones the phase makes anyway; the allocator's counters
    are read between calls, on the host (ROADMAP C3)."""
    import torch

    from tpu_matmul_bench_torch.benchmarks import cuda_tune
    from tpu_matmul_bench_torch.utils import timing

    spans: dict[int, dict] = {}
    order: dict[int, int] = {}
    timed: list = []  # each timed program, held so that no later one takes its id
    current: list[int | None] = [None]
    time_jitted, timed_loop = timing.time_jitted, timing._timed_loop

    def tagged(fn, args, **kw):
        if id(fn) not in order:
            order[id(fn)] = len(order)
            timed.append(fn)
        current[0] = order[id(fn)]
        try:
            return time_jitted(fn, args, **kw)
        finally:
            current[0] = None

    def counters() -> tuple[int, int]:
        # the allocator's own dict, not memory_stats()'s flattened copy of
        # it: read twice a call, it must cost the host little
        stats = torch.cuda.memory_stats_as_nested_dict()
        return stats["num_device_alloc"], stats["num_alloc_retries"]

    def marked_loop(call, n, card, overhead):
        if not card or current[0] is None:
            return timed_loop(call, n, card, overhead)
        marks = [torch.cuda.Event(enable_timing=True)]
        entry = spans.setdefault(current[0], {"ms": [], "host_ms": [], "allocs": [],
                                              "retries": [], "device_allocs": 0,
                                              "alloc_retries": 0})

        def marked():
            allocs, retries = counters()
            t0 = time.perf_counter()
            out = call()
            entry["host_ms"].append((time.perf_counter() - t0) * 1e3)
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            after = counters()
            entry["allocs"].append(after[0] - allocs)
            entry["retries"].append(after[1] - retries)
            return out

        before = counters()
        marks[0].record()
        out, seconds = timed_loop(marked, n, card, overhead)
        after = counters()
        entry["ms"].extend(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
        entry["device_allocs"] += after[0] - before[0]
        entry["alloc_retries"] += after[1] - before[1]
        return out, seconds

    timing.time_jitted = cuda_tune.time_jitted = tagged
    timing._timed_loop = marked_loop
    try:
        yield spans
    finally:
        timing.time_jitted = cuda_tune.time_jitted = time_jitted
        timing._timed_loop = timed_loop


def spread(entry: dict | None) -> dict:
    """min, max and count of a program's single-call device ms
    (`single_calls`), the allocator's device allocations and retries in its
    windows, the range of its calls' host ms, and the slowest call's device
    ms, host ms, allocations and retries beside the median call's."""
    if not entry or not entry["ms"]:
        return {"n": 0}
    calls = entry["ms"]
    slow = max(range(len(calls)), key=calls.__getitem__)
    mid = sorted(range(len(calls)), key=calls.__getitem__)[len(calls) // 2]

    def call(i: int) -> dict:
        return {"index": i, "ms": calls[i], "host_ms": entry["host_ms"][i],
                "allocs": entry["allocs"][i], "retries": entry["retries"][i]}

    return {"min_ms": min(calls), "max_ms": max(calls), "n": len(calls),
            "device_allocs": entry["device_allocs"], "alloc_retries": entry["alloc_retries"],
            "host_min_ms": min(entry["host_ms"]), "host_max_ms": max(entry["host_ms"]),
            "slowest": call(slow), "median": call(mid)}


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


@contextlib.contextmanager
def auto_routes(routed: list[str]):
    """While the block runs, appends to `routed`, for each product
    `matmul_2d`'s `auto` routes, the impl `resolve_route` gives it on the
    default (committed) DB: its "cuda" entries are the K1 launches the DB
    predicts (a product replayed in a CUDA graph is neither routed nor
    launched from the host). The products are told from a record's extras,
    which route too, by their caller, `_auto`."""
    from tpu_matmul_bench_torch.ops import impl_select

    real = impl_select.select_impl

    def recording(m, n, k, kind, dtype, **kw):
        if sys._getframe(1).f_code.co_name == "_auto":
            routed.append(impl_select.resolve_route(m, n, k, kind, dtype)[0].impl)
        return real(m, n, k, kind, dtype, **kw)

    impl_select.select_impl = recording
    try:
        yield
    finally:
        impl_select.select_impl = real


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
        "cost_analysis": rec.extras.get("cost_analysis"),
    }
    problems = []
    if rec.extras.get("validation") != "ok":
        problems.append("validation is not ok")
    # the kernel's cost books describe its launch: whole tiles at 16384³,
    # so exactly the hand model; the library keeps none
    books = summary["cost_analysis"]
    if impl == "cuda" and not (books and books["flops_ratio"] == 1.0 and books["agrees"]):
        problems.append(f"cost_analysis {books}: not flops_ratio 1.0")
    if impl == "torch" and books is not None:
        problems.append("the library run carries the kernel's cost_analysis")
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


def tune_ledger(phase: str, out_dir: str) -> str:
    """Where the tune phase `phase` writes its JSONL."""
    return f"{out_dir}/{re.sub(r'[^a-z0-9]+', '_', phase)}.jsonl"


def tune(phase: str, extra: list[str], out_dir: str,
         ksplit: int = 1) -> tuple[dict, int, int, dict]:
    """One tune run through the tuner's entry point over every tile.
    Returns {tile: sweep ms}, the GEMM and reduction launches counted
    during it, and the default tile's cost books; every GEMM launch must
    take the wgmma route, and every sweep record carry books that agree
    with the hand model (the tune shapes are whole tiles)."""
    from tpu_matmul_bench_torch.benchmarks import cuda_tune
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.utils.telemetry import is_manifest

    path = tune_ledger(phase, out_dir)
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
        books = r.extras.get("cost_analysis")
        if not r.extras.get("confirm_pass") and not (books and books["flops_ratio"] == 1.0):
            problems.append(f"tile {tile(r)} cost_analysis {books}: not flops_ratio 1.0")
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
    books = next(r.extras.get("cost_analysis") for r in sweep
                 if tile(r) == cm.DEFAULT_TILE)
    return tiles_ms, gemm, reduce, books


def headline_phase(k1_fused_tflops: float, out_dir: str) -> dict:
    """The port's headline entry as a user runs it, `python -m
    tpu_matmul_bench_torch.bench` in a process of its own (its attempts are
    its children), with BENCH_TIMEOUT_S = HEADLINE_TIMEOUT_S. Every stdout
    line must be JSON, the first the provisional 0.0; the last must read
    `backend` "ok", 0 < `value` <= the card's bf16 peak, `by_impl` with both
    `torch` and `cuda`, `impl` the larger of the two, and `by_impl["cuda"]`
    within HEADLINE_MARGIN of `k1_fused_tflops`, the matmul phase's fused
    K1 in this call. The attempts run in processes of their own, so their
    launches cannot be counted here; their records say which product ran
    instead: every record that ran `cuda` (an `auto` record's
    `matmul_impl_resolved`) carries the kernel's cost books (its wrapper
    launches on a card tensor or raises), every other none (the library's).
    Prints the line beside the card's name and power limit;
    stops whatever the entry left running. Returns the last line."""
    import torch

    from tpu_matmul_bench_torch.utils.metrics import theoretical_peak_tflops

    torch.cuda.empty_cache()  # the attempts need the card's memory
    env = {k: v for k, v in os.environ.items()
           if k not in ("BENCH_CHILD_CMD", "TMB_RANKS_PER_CARD")}
    env.update(BENCH_TIMEOUT_S=str(HEADLINE_TIMEOUT_S),
               BENCH_ARTIFACT_DIR=f"{out_dir}/headline")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "tpu_matmul_bench_torch.bench"],
                            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=HEADLINE_TIMEOUT_S + 60)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGTERM)  # the entry emits its best line
        out, _ = proc.communicate(timeout=60)
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)  # attempts it left running
    seconds = time.perf_counter() - t0
    problems = []
    try:
        lines = [json.loads(line) for line in out.splitlines() if line.strip()]
    except ValueError as e:
        lines = []
        problems.append(f"a stdout line is not JSON: {e}")
    last = lines[-1] if lines else {}
    by_impl = last.get("by_impl") or {}
    peak = theoretical_peak_tflops(torch.cuda.get_device_name(0), torch.bfloat16)
    cuda_ratio = by_impl["cuda"] / k1_fused_tflops if "cuda" in by_impl else None
    if not lines or lines[0].get("value") != 0.0:
        problems.append("the first line is not the provisional 0.0")
    if last.get("backend") != "ok":
        problems.append(f"backend {last.get('backend')!r}, not 'ok'")
    if not 0 < (last.get("value") or 0) <= peak:
        problems.append(f"value {last.get('value')} outside (0, {peak}]")
    if not {"torch", "cuda"} <= set(by_impl):
        problems.append(f"by_impl {by_impl} lacks torch or cuda")
    elif last.get("impl") != max(by_impl, key=by_impl.get):
        problems.append(f"impl {last.get('impl')!r} is not the larger of {by_impl}")
    if cuda_ratio is not None and abs(cuda_ratio - 1) > HEADLINE_MARGIN:
        problems.append(f"by_impl cuda {by_impl['cuda']} is {cuda_ratio:.3f}x the "
                        f"matmul phase's fused K1 {k1_fused_tflops:.2f} TFLOPS")
    books = {}  # attempt file -> each record's flops_ratio, None without books
    resolved = {}  # attempt file -> the impl each record ran
    for path in sorted(glob.glob(f"{out_dir}/headline/attempt_*.jsonl")):
        with open(path) as fh:
            recs = [json.loads(line) for line in fh if line.strip()][1:]  # past the manifest
        books[os.path.basename(path)] = [(r["extras"].get("cost_analysis") or {}).get(
            "flops_ratio") for r in recs]
        # the impl each record ran: `auto` names what it resolved to
        resolved[os.path.basename(path)] = [r["extras"].get(
            "matmul_impl_resolved", "cuda" if path.endswith("_cuda.jsonl") else "torch")
            for r in recs]
    for name, ratios in books.items():
        wants = [1.0 if impl == "cuda" else None for impl in resolved[name]]
        if not ratios or ratios != wants:
            problems.append(f"{name}: records' cost_analysis flops_ratio {ratios}, not {wants}")
    emit({"phase": "headline", "nvidia_smi": card_line(), "line": last,
          "lines": len(lines), "k1_fused_tflops": k1_fused_tflops,
          "cuda_over_k1_fused": cuda_ratio, "attempt_books": books,
          "seconds": seconds, "ok": not problems})
    if problems:
        fail("headline", "; ".join(problems))
    return last


def tune_db_phase(ledger: str, out_dir: str) -> dict:
    """The tuning database on the card (the `tune_db` phase): `tune prune
    --size SIZE` (the kept tiles and the trial reduction); `tune promote` of
    the bf16 SIZE³ sweep's ledger `ledger` into a DB of its own (the
    promoted cell, or the skip and its margin); then a measured `cuda` cell
    for bf16 SIZE³ carrying the sweep's winning tile, installed as the
    process's default DB, through which `matmul_2d("auto")` must resolve
    `source: "db"` at that tile, launch K1 once a call on the wgmma route,
    return bitwise what `cuda_matmul(blocks=tile)` returns and agree with
    the plain version within TOLERANCE. Prints an `auto` lookup's host µs
    with a memoised and a cold fingerprint, and `auto` through the cell
    against `cuda_matmul` in turns. The committed DB is reinstalled, and
    `tune selftest` must pass on it; then the `matmul` program at int8 SIZE³
    under `auto` must resolve to the committed DB's `cuda` cell and launch
    K1 on its wmma route as often as `auto_routes` predicts, validated.
    Returns the phase's line."""
    import torch

    from tpu_matmul_bench_torch.benchmarks import matmul_benchmark
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops.impl_select import resolve_route, select_impl
    from tpu_matmul_bench_torch.ops.matmul import matmul_2d, random_operands
    from tpu_matmul_bench_torch.tune import cli as tune_cli
    from tpu_matmul_bench_torch.tune import db as tdb
    from tpu_matmul_bench_torch.tune import promote as tpromote
    from tpu_matmul_bench_torch.tune import prune as tprune

    def cli(argv: list[str]) -> tuple[int, str]:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            try:
                rc = tune_cli.main(argv) or 0
            except SystemExit as e:
                rc = e.code
        return rc, out.getvalue()

    name = torch.cuda.get_device_name(0)
    problems = []
    report = tprune.prune(SIZE, SIZE, SIZE, "bfloat16")
    rc, pruned = cli(["prune", "--size", str(SIZE)])
    if rc != 0 or cm.DEFAULT_TILE not in report.kept:
        problems.append(f"prune rc {rc}, kept {report.kept} without {cm.DEFAULT_TILE}")
    db_path = f"{out_dir}/tune_db.jsonl"
    promote_rc, promoted = cli(["promote", ledger, "--db", db_path, "--device-kind", name])
    store = tdb.TuningDB.load(db_path)
    (group,) = tpromote.load_tune_records([ledger]).values()
    best = tpromote._rank(group)[0][0]
    tile = tuple(best["extras"][f"block_{d}"] for d in "mnk")
    if promote_rc not in (0, 1) or (promote_rc == 0) != (len(store) == 1):
        problems.append(f"promote rc {promote_rc} with {len(store)} cells")
    store.put(tdb.Cell(m=SIZE, k=SIZE, n=SIZE, dtype="bfloat16",
                       device_kind=tdb.kind_token(name), impl="cuda",
                       provenance_kind="measured", artifact=ledger, blocks=tile,
                       detail="the tune phase's sweep winner", tflops=best["tflops_total"]))
    a, b = random_operands(7, (SIZE, SIZE), torch.bfloat16, device="cuda")
    auto = matmul_2d("auto")  # no kind named: the operands' card's name
    tdb.install_default_db(store)
    try:
        choice, cell = resolve_route(SIZE, SIZE, SIZE, name, torch.bfloat16)
        if (choice.source, choice.impl, choice.blocks) != ("db", "cuda", tile):
            problems.append(f"auto resolved {choice}, not the cell at {tile}")
        auto(a, b)  # warm
        torch.cuda.synchronize()
        before, launches = routes(), cm.LAUNCHES
        outs = [auto(a, b) for _ in range(3)]
        by_route, k1 = routes_since(before), cm.LAUNCHES - launches
        if (k1, by_route) != (3, {"gemm:wgmma": 3}):
            problems.append(f"3 auto calls launched {k1} K1 by route {by_route}")
        direct = cm.cuda_matmul(a, b, blocks=tile)
        if not all(torch.equal(o, direct) for o in outs):
            problems.append("auto through the cell is not bitwise cuda_matmul at its tile")
        want = cm.matmul_plain(a, b).double()
        max_abs = (outs[0].double() - want).abs().max().item()
        max_rel = max_abs / (want.abs().max().item() or 1.0)
        if not (torch.isfinite(outs[0]).all().item() and max_rel <= TOLERANCE["bfloat16"]):
            problems.append(f"auto vs plain: max rel err {max_rel} > {TOLERANCE['bfloat16']}")
        del outs, direct, want
        lookups = 20000
        t0 = time.perf_counter()
        for _ in range(lookups):
            select_impl(SIZE, SIZE, SIZE, name, torch.bfloat16)
        memo_us = (time.perf_counter() - t0) / lookups * 1e6
        t0 = time.perf_counter()
        for _ in range(lookups):
            tdb.problem_fingerprint.cache_clear()
            select_impl(SIZE, SIZE, SIZE, name, torch.bfloat16)
        cold_us = (time.perf_counter() - t0) / lookups * 1e6
        turns = {"auto": [], "cuda": []}
        for _ in range(TUNE_DB_PASSES):
            for label in ("auto", "cuda", "cuda", "auto"):
                fn = (lambda: auto(a, b)) if label == "auto" else \
                    (lambda: cm.cuda_matmul(a, b, blocks=tile))
                turns[label].append(events_ms(fn, runs=TUNE_DB_RUNS))
    finally:
        tdb.install_default_db(None)  # the committed store again
    del a, b
    torch.cuda.empty_cache()
    rc, selftest = cli(["selftest"])
    if rc != 0:
        problems.append(f"tune selftest rc {rc}: {selftest[-400:]}")
    # the committed store's own kernel cells: int8 at SIZE³ under `auto`
    routed: list[str] = []
    before, launches = routes(), cm.LAUNCHES
    with auto_routes(routed), contextlib.redirect_stdout(sys.stderr):
        (rec,) = matmul_benchmark.main(["--sizes", str(SIZE), "--dtype", "int8",
                                        "--iterations", str(TUNE_DB_RUNS), "--warmup", "1",
                                        "--validate"])
    int8 = {"resolved": rec.extras.get("matmul_impl_resolved"),
            "source": rec.extras.get("impl_source"), "launches": cm.LAUNCHES - launches,
            "predicted": routed.count("cuda"), "launches_by_route": routes_since(before),
            "ms": rec.avg_time_s * 1e3, "tops": rec.tflops_total,
            "validation": rec.extras.get("validation"),
            "flops_ratio": (rec.extras.get("cost_analysis") or {}).get("flops_ratio")}
    if (int8["resolved"], int8["source"], int8["validation"], int8["flops_ratio"]) != \
            ("cuda", "db", "ok", 1.0) or not 0 < int8["launches"] == int8["predicted"] \
            or int8["launches_by_route"] != {"gemm:wmma": int8["launches"]}:
        problems.append(f"int8 {SIZE}³ under auto on the committed DB: {int8}")
    result = {"phase": "tune_db", "nvidia_smi": card_line(),
              "prune": {"kept": report.kept, "trials_before": report.trials_before,
                        "trials_after": report.trials_after,
                        "reduction_pct": report.reduction_pct, "lines": pruned.splitlines()},
              "promote": {"rc": promote_rc, "lines": promoted.splitlines()},
              "cell": {"tile": tile, "fingerprint": cell and cell.fingerprint,
                       "source": choice.source, "provenance": choice.provenance},
              "launches": k1, "launches_by_route": by_route,
              "max_abs_err": max_abs, "max_rel_err": max_rel,
              "lookup_us": {"memoised": memo_us, "cold": cold_us},
              "auto_ms": statistics.median(turns["auto"]),
              "cuda_ms": statistics.median(turns["cuda"]), "turns_ms": turns,
              "selftest": selftest.strip().splitlines()[-1:], "int8_auto": int8,
              "ok": not problems}
    emit(result)
    if problems:
        fail("tune_db", "; ".join(problems))
    return result


def tune_ring_expected(label: str, tile: tuple[int, int, int]) -> tuple[str, str]:
    """(step_route, transfer) that a ring's `tune --ring` record must read at
    `tile`: `cuda_matmul.step_route` on its step's operands at bf16 SIZE²
    over RING_WORLD ranks (rows packed, pointers made up and aligned as in
    `route_args`; the all-gather rings' with their forwarding slot); on one
    card an all-gather ring whose steps cannot forward hops, and a
    reduce-scatter ring stores."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm

    ag = label.startswith("ring_ag")
    m, k, n = (AG_STEPS if ag else RS_STEPS)[label]
    pointers = [(i + 1) * 2**20 for i in range(4)]
    route = cm.step_route(torch.bfloat16, m, n, k, k, n, n, k if ag else n, *pointers,
                          tile, forward=ag)
    if not ag:
        return route, "store"
    return route, "forward" if route == "wgmma_persistent" else "hop"


def tune_ring(label: str, overlap_ms: float, out_dir: str) -> dict:
    """`tune --ring` through the tuner's entry point for the HBM ring
    `label` at bf16 SIZE² over RING_WORLD ranks on the card, with
    `--validate`: every record `validation: ok`; each tile's steps on the
    route `tune_ring_expected` gives (the default tile on
    `wgmma_persistent`, forwarding or storing, the others off it), and as
    many hops as its calls that hopped make; the default tile's ms within
    TUNE_RING_MARGIN of `overlap_ms`, the ring's in its overlap run just
    before. Returns {tile: ms, step_route, transfer}."""
    from tpu_matmul_bench_torch.benchmarks import cuda_tune
    from tpu_matmul_bench_torch.ops import cuda_ring as cr
    from tpu_matmul_bench_torch.utils.telemetry import is_manifest

    mode = TUNE_RINGS[label]
    phase = f"tune_ring[{mode}]"
    bidir = "bidir" in mode
    tiles = TUNE_RING_BIDIR_TILES if bidir else TUNE_RING_TILES
    path = f"{out_dir}/tune_ring_{mode}.jsonl"
    argv = ["--ring", mode, "--sizes", str(SIZE), "--dtype", "bfloat16",
            "--num-devices", str(RING_WORLD), "--iterations", str(TUNE_RING_ITERATIONS),
            "--warmup", str(OVERLAP_WARMUP), "--validate",
            "--candidates", *[",".join(map(str, t)) for t in tiles], "--json-out", path]
    transfers = cr.RS_TRANSFERS if "_rs_" in mode else cr.AG_TRANSFERS
    cr.HOP_LAUNCHES = 0
    transfers.update(dict.fromkeys(transfers, 0))
    t0 = time.perf_counter()
    with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr), \
            single_calls() as calls:
        records = cuda_tune.main(argv)
    seconds = time.perf_counter() - t0
    hops, moved = cr.HOP_LAUNCHES, dict(transfers)
    with open(path) as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    per_tile = {}
    problems = []
    got = [tuple(r.extras[f"block_{d}"] for d in "mnk") for r in records]
    if got != tiles:
        problems.append(f"the sweep measured {got}, not {tiles}")
    # the tiles are timed in the order of the sweep, one program each
    for i, (r, tile) in enumerate(zip(records, got)):
        key = "x".join(map(str, tile))
        route, transfer = tune_ring_expected(label, tile)
        per_tile[key] = {"ms": r.avg_time_s * 1e3, "step_route": r.extras["step_route"],
                         "transfer": r.extras["transfer"],
                         "peak_efficiency_pct": r.peak_efficiency_pct,
                         "single_calls": spread(calls.get(i))}
        if r.extras.get("validation") != "ok":
            problems.append(f"tile {key}: validation {r.extras.get('validation')}")
        if (r.extras["step_route"], r.extras["transfer"]) != (route, transfer):
            problems.append(f"tile {key}: steps {r.extras['step_route']}, transfer "
                            f"{r.extras['transfer']}, not {route}, {transfer}")
        if r.world != RING_WORLD or r.mode != f"tune_{mode}":
            problems.append(f"tile {key}: world {r.world}, mode {r.mode}")
        if not (r.peak_efficiency_pct and 0 < r.peak_efficiency_pct <= 100):
            problems.append(f"tile {key}: peak_efficiency_pct {r.peak_efficiency_pct}")
    default = per_tile.get("x".join(map(str, TUNE_RING_TILES[0])), {})
    if default.get("step_route") != "wgmma_persistent" or default.get("transfer") not in (
            "forward", "store"):
        problems.append(f"the default tile ran {default}, not on wgmma_persistent "
                        "forwarding or storing")
    # hops only in the calls that took the hop schedule: D(D-1) a call,
    # twice that for the bidirectional rings
    per_call = RING_WORLD * (RING_WORLD - 1) * (2 if bidir else 1)
    if hops != moved["hop"] * per_call:
        problems.append(f"{hops} hops, not {per_call} for each of {moved} calls that hopped")
    ratio = default["ms"] / overlap_ms if default else None
    if ratio is None or abs(ratio - 1) > TUNE_RING_MARGIN:
        problems.append(f"the default tile's ms over the overlap run's {overlap_ms:.3f} "
                        f"is {ratio}")
    if not lines or not is_manifest(lines[0]) or len(lines) != 1 + len(records):
        problems.append("the JSONL does not hold its manifest and every record")
    emit({"phase": phase, "tiles": per_tile, "hops": hops, "transfers": moved,
          "overlap_ms": overlap_ms, "default_over_overlap": ratio, "seconds": seconds,
          "ok": not problems})
    if problems:
        fail(phase, "; ".join(problems))
    return per_tile


def ksplit_entry(shape, max_abs_err: float, gemm: int, reduce: int,
                 kind: str) -> dict:
    """Times and bound of the split-K (S=2, default tile, dispatch) at one
    shape: the kernels, their plain version, and torch.matmul."""
    import torch

    from tpu_matmul_bench_torch.obs import attribution
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
    # A and B read once, C written once, and 2 fp32 partials written and
    # read back
    bound_ms, bound_by = attribution.bound(m, n, k, torch.bfloat16, kind,
                                           extra_bytes=2 * 2 * m * n * 4)
    return {"shape": f"{m}x{k}x{n}", "splits": 2, "kernel_ms": kernel_ms,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
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
    with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr), \
            single_calls() as calls, clock_samples() as during:
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
               "wres_engaged": x.get("wres_engaged"), "launches": counts,
               # the baseline is timed first in each round, then the ring
               "baseline_single_calls": spread(calls.get(0)),
               "ring_single_calls": spread(calls.get(1)), "during": during}
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


def overlap_programs(mode: str, d: int) -> list[tuple[int, int]]:
    """(K1 products a call, hops a call) of each program an overlap mode
    times over d ranks, the compute leg first: the step programs run one
    product a rank a step (compute_only, then the mode's nocomm program
    where it has one, then the mode); the collective-matmul rings' baseline
    one product a rank, the ring d a rank (d − 1 of them half-chunk pairs in
    the bidirectional all-gather form, all of them in the bidirectional
    reduce-scatter form) with d − 1 hops a rank a direction."""
    if mode in STEP_MODES:
        return [(d * STEPS_PER_CALL, 0)] * (2 if mode == "no_overlap" else 3)
    ways = 2 if "bidir" in mode else 1
    ring = (d * (1 + 2 * (d - 1)) if mode == "collective_matmul_bidir"
            else ways * d * d)
    return [(d, 0), (ring, ways * d * (d - 1))]


def overlap_counts(mode: str, d: int, timing: str) -> tuple[int, int]:
    """(K1 launches, hops) of one `--matmul-impl cuda` overlap run of an
    overlap mode: every program's calls (as `scaling_calls` counts them:
    warmup and timed calls over VARIANT_ROUNDS rounds, or one eager call and
    `iterations` captured ones), the ring fill of `overlap` and `pipeline`
    (k products a rank at set-up) and the validation call of the rings."""
    step = mode in STEP_MODES
    it, wu = (STEP_ITERATIONS, STEP_WARMUP) if step else (OVERLAP_ITERATIONS, OVERLAP_WARMUP)
    calls = 1 + it if timing == "fused" else wu + it + (VARIANT_ROUNDS - 1) * (1 + it)
    programs = overlap_programs(mode, d)
    launches = sum(p * calls for p, _ in programs)
    hops = sum(h * calls for _, h in programs)
    if step and STEP_MODES[mode] > 1:
        launches += d * STEP_MODES[mode]
    if not step:
        launches, hops = launches + programs[-1][0], hops + programs[-1][1]
    return launches, hops


def overlap_program(name: str, mesh, s: int, seed: int):
    """One of the programs the overlap race check runs, with its bf16
    operands at s² over the mesh: `overlap` or `pipeline` (8 steps, its
    ring filled), or a collective-matmul ring."""
    import torch

    from tpu_matmul_bench_torch.parallel import overlap as ovl
    from tpu_matmul_bench_torch.parallel.mesh import ROWS, sharded_normal

    d = len(mesh.ranks)
    if name in STEP_MODES:
        k = STEP_MODES[name]
        a, b = sharded_normal(seed, (d * k, s, s), torch.bfloat16, mesh, ROWS)
        ring0 = ovl.fill_ring(mesh, k, "cuda")(a, b)
        return ovl.StepProgram(mesh, name, STEPS_PER_CALL, "cuda"), (a, b, ring0)
    setup = ovl.OVERLAP_MODES[name](_race_config(seed), mesh, s)
    return setup.full, setup.operands


def _race_config(seed: int):
    from tpu_matmul_bench_torch.parallel.overlap import OVERLAP_MODES
    from tpu_matmul_bench_torch.utils.config import parse_config

    return parse_config(["--dtype", "bfloat16", "--matmul-impl", "cuda", "--seed", str(seed)],
                        "race", modes=list(OVERLAP_MODES), default_mode="overlap")


def check_overlap_races(s: int = OVERLAP_RACE_SIZE) -> None:
    """`overlap`, `pipeline` and the four collective-matmul rings at bf16 s²
    over RING_WORLD ranks: RACE_REPEATS calls in a row before one
    synchronize, each of which must equal, bit for bit, the output of the
    same program run with the card synchronised after every launch
    (`serial`). A missing event between the compute, communication and copy
    streams shows here as a call that differs now and then."""
    import torch

    mesh = card_mesh(RING_WORLD)
    for name in (*[m for m in STEP_MODES if STEP_MODES[m] > 1], *CM_MODES):
        program, ops = overlap_program(name, mesh, s, seed=5)
        program.serial = True
        want = [t.clone() for t in program(*ops)]
        torch.cuda.synchronize()
        program.serial = False
        outs = [program(*ops) for _ in range(RACE_REPEATS)]
        torch.cuda.synchronize()
        bad = [i for i, y in enumerate(outs)
               if not all(torch.equal(g, w) for g, w in zip(y, want))]
        emit({"phase": f"races[{name}]", "ranks": RING_WORLD, "size": s,
              "calls": RACE_REPEATS, "wrong_calls": bad, "ok": not bad})
        if bad:
            fail(f"races[{name}]", f"calls {bad} of {RACE_REPEATS} differ from the "
                                   "serialised run")
        del program, ops, want, outs
        torch.cuda.empty_cache()


def drive_overlap_mode(mode: str, impl: str, timing: str, out_dir: str) -> dict:
    """One run of the overlap program in a library mode through its entry
    point, bf16 SIZE² over RING_WORLD ranks on the card; returns the
    record's summary, with the SM clock during the run and K1's launches by
    route. Fails on a K1 launch count or hop count other than
    `overlap_counts`, a launch off the wgmma route, a ring whose validation
    is not ok, a fused run that did not run fused and chained, and a
    negative comm or overhead time."""
    import torch

    from tpu_matmul_bench_torch.benchmarks import matmul_overlap_benchmark
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops import cuda_ring as cr
    from tpu_matmul_bench_torch.utils.telemetry import is_manifest

    step = mode in STEP_MODES
    it, wu = (STEP_ITERATIONS, STEP_WARMUP) if step else (OVERLAP_ITERATIONS, OVERLAP_WARMUP)
    tag = f"{mode},{impl},{timing}"
    path = f"{out_dir}/overlap-{tag.replace(',', '-')}.jsonl"
    argv = ["--mode", mode, "--sizes", str(SIZE), "--dtype", "bfloat16",
            "--num-devices", str(RING_WORLD), "--matmul-impl", impl, "--timing", timing,
            "--iterations", str(it), "--warmup", str(wu), "--validate", "--json-out", path]
    cm.LAUNCHES = 0
    cr.HOP_LAUNCHES = 0
    before = routes()
    with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr), \
            clock_samples() as during:
        records = matmul_overlap_benchmark.main(argv)
    launches, hops, by_route = cm.LAUNCHES, cr.HOP_LAUNCHES, routes_since(before)
    torch.cuda.empty_cache()
    phase = f"overlap_modes[{tag}]"
    if len(records) != 1:
        fail(phase, f"expected one record, got {len(records)} (the runner "
                    "reports a failed size and returns no record for it)")
    with open(path) as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    rec, x = records[0], records[0].extras
    want, want_hops = overlap_counts(mode, RING_WORLD, timing)
    if impl != "cuda":
        want = 0
    ms = lambda v: None if v is None else v * 1e3  # noqa: E731
    summary = {"phase": phase, "mode": rec.mode, "world": rec.world,
               "avg_ms": ms(rec.avg_time_s), "compute_ms": ms(rec.compute_time_s),
               "comm_ms": ms(rec.comm_time_s), "overhead_ms": ms(x.get("overhead_time_s")),
               "per": "step" if step else "call",
               "comm_overhead_vs_compute_pct": x.get("comm_overhead_vs_compute_pct"),
               "baseline_ms": x.get("baseline_time_ms"),
               "overlap_speedup_x": x.get("overlap_speedup_x"),
               "tflops_per_card": rec.tflops_per_device,
               "peak_efficiency_pct": rec.peak_efficiency_pct,
               "cards": x.get("cards"), "ranks_per_card": x.get("ranks_per_card"),
               "validation": x.get("validation"),
               "validation_max_rel_err": x.get("validation_max_rel_err"),
               "timing": x.get("timing", "dispatch"), "chain": x.get("chain"),
               "k1_launches": launches, "expected_k1_launches": want,
               "hops": hops, "expected_hops": want_hops, "launches_by_route": by_route,
               "during": during}
    problems = []
    peak = rec.peak_efficiency_pct
    if peak is None or not 0 < peak <= 100:
        problems.append(f"peak_efficiency_pct {peak} outside (0, 100]")
    if rec.world != RING_WORLD or x.get("cards") != 1 or x.get("ranks_per_card") != RING_WORLD:
        problems.append(f"world {rec.world} on {x.get('cards')} cards, not {RING_WORLD} on 1")
    if step and x.get("validation") != "n/a (program outputs per-step scalars)":
        problems.append(f"validation {x.get('validation')!r}")
    if not step and x.get("validation") != "ok":
        problems.append("validation is not ok")
    if timing == "fused" and (x.get("timing"), x.get("chain")) != ("fused", "operand"):
        problems.append(f"fused was asked, yet timing {x.get('timing')}, chain {x.get('chain')}")
    for key, value in (("comm_time_s", rec.comm_time_s),
                       ("overhead_time_s", x.get("overhead_time_s"))):
        if value is not None and value < 0:
            problems.append(f"{key} {value} < 0")
    if step and (rec.comm_time_s is None
                 or (mode != "no_overlap") != ("overhead_time_s" in x)):
        problems.append(f"comm_time_s {rec.comm_time_s}, overhead_time_s "
                        f"{x.get('overhead_time_s')}")
    if not lines or not is_manifest(lines[0]):
        problems.append("the JSONL does not start with its manifest")
    if len(lines) != 2 or lines[1].get("mode") != mode:
        problems.append("the JSONL does not hold the record after the manifest")
    if launches != want:
        problems.append(f"{launches} K1 launches, not the {want} the mode makes")
    if hops != want_hops:
        problems.append(f"{hops} hops, not the {want_hops} the mode makes")
    if impl == "cuda" and by_route != {"gemm:wgmma": want}:
        problems.append(f"launches by route {by_route}: not all {want} on wgmma")
    if impl == "torch" and by_route:
        problems.append(f"the library run launched the port's kernels: {by_route}")
    summary["ok"] = not problems
    emit(summary)
    if problems:
        fail(phase, "; ".join(problems))
    return summary


# each collective-matmul ring beside the ring kernel of its contract
CM_KERNELS = {"collective_matmul": "ring_ag", "collective_matmul_bidir": "ring_ag_bidir",
              "collective_matmul_rs": "ring_rs", "collective_matmul_bidir_rs": "ring_rs_bidir"}
CM_TURN_RUNS, CM_TURN_WARMUP, CM_TURN_PASSES = 20, 5, 1


def collective_turns(card: str) -> dict:
    """Each collective-matmul ring (K1 products and hops) at bf16 SIZE² over
    RING_WORLD ranks on the card, in turns with the ring kernel of its
    contract (K2–K5) and `torch.matmul` of the gathered operands, on the
    same operands: CM_TURN_RUNS calls after CM_TURN_WARMUP, in
    CM_TURN_PASSES passes, every other in the mirrored order; the medians.
    The library ring's output is first held against the kernel's, within
    the modes' bf16 validation tolerance: the reduce-scatter rings round
    their bf16 accumulator twice a step (the product, then the sum, JAX's
    arithmetic), where K3 and K5 round once a step."""
    import torch

    from tpu_matmul_bench_torch.parallel import overlap as ovl
    from tpu_matmul_bench_torch.parallel.mesh import gather
    from tpu_matmul_bench_torch.parallel.modes import validation_tolerance

    tol = validation_tolerance(torch.bfloat16)

    mesh = card_mesh(RING_WORLD)
    result = {}
    for mode, label in CM_KERNELS.items():
        reduce_scatter, build, _, _ = rings()[label]
        library_ring = ovl.CollectiveMatmul(mesh, reduce_scatter=reduce_scatter,
                                            bidir="bidir" in mode, impl="cuda")
        kernel_ring = build(mesh)
        x, w = ring_operands(mesh, reduce_scatter, (SIZE, SIZE, SIZE), torch.bfloat16, seed=17)
        xg, wg = gather(x), gather(w)
        got, want = gather(library_ring(x, w)), gather(kernel_ring(x, w))
        torch.cuda.synchronize()
        rel = ((got.float() - want.float()).abs().max().item()
               / (want.float().abs().max().item() or 1.0))
        del got, want
        calls = {mode: lambda: library_ring(x, w), label: lambda: kernel_ring(x, w),
                 "library": lambda: torch.matmul(xg, wg)}
        runs: dict[str, list[float]] = {name: [] for name in calls}
        order = list(calls)
        for p in range(CM_TURN_PASSES):
            for name in order if p % 2 == 0 else order[::-1]:
                for _ in range(CM_TURN_WARMUP):
                    calls[name]()
                runs[name].append(events_ms(calls[name], CM_TURN_RUNS))
        del x, w, xg, wg, calls
        torch.cuda.empty_cache()
        ms = {name: statistics.median(v) for name, v in runs.items()}
        result[mode] = {"kernel": label, "ms": ms[mode], "kernel_ms": ms[label],
                        "library_ms": ms["library"], "passes_ms": runs,
                        "over_kernel": ms[mode] / ms[label],
                        "over_library": ms[mode] / ms["library"], "max_rel_err": rel}
    ok = all(v["max_rel_err"] <= tol for v in result.values())
    emit({"phase": "collective_turns", "ranks": RING_WORLD, "shape": [SIZE] * 3,
          "card": card, "runs": CM_TURN_RUNS, "warmup": CM_TURN_WARMUP,
          "tolerance": tol, "rings": result, "ok": ok})
    if not ok:
        fail("collective_turns", f"a collective-matmul ring differs from its kernel: {result}")
    return result


def overlap_modes_phase(out_dir: str) -> dict:
    """The seven library modes at bf16 SIZE² over RING_WORLD ranks on the
    card: under K1 (dispatch, and fused where the mode is fusable) and the
    library (dispatch); returns each mode's runs by label and prints the
    phase's table and its seconds."""
    from tpu_matmul_bench_torch.parallel.overlap import OVERLAP_MODES

    t0 = time.perf_counter()
    runs = {}
    for mode in (*STEP_MODES, *CM_MODES):
        # whether the mode takes --timing fused, as its ModeSetup says
        fusable = OVERLAP_MODES[mode](_race_config(0), card_mesh(1), 256).fusable
        legs = [("cuda", "dispatch"), *([("cuda", "fused")] if fusable else []),
                ("torch", "dispatch")]
        runs[mode] = {f"{impl},{timing}": drive_overlap_mode(mode, impl, timing, out_dir)
                      for impl, timing in legs}
    table = {mode: {"per": r["cuda,dispatch"]["per"],
                    "cuda_ms": r["cuda,dispatch"]["avg_ms"],
                    "cuda_fused_ms": r.get("cuda,fused", {}).get("avg_ms"),
                    "library_ms": r["torch,dispatch"]["avg_ms"],
                    "compute_ms": r["cuda,dispatch"]["compute_ms"],
                    "comm_ms": r["cuda,dispatch"]["comm_ms"],
                    "overhead_ms": r["cuda,dispatch"]["overhead_ms"],
                    "overlap_speedup_x": r["cuda,dispatch"]["overlap_speedup_x"],
                    "comm_overhead_vs_compute_pct":
                        r["cuda,dispatch"]["comm_overhead_vs_compute_pct"]}
             for mode, r in runs.items()}
    emit({"phase": "overlap_modes", "modes": table,
          "seconds": time.perf_counter() - t0, "ok": True})
    return runs


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
                  d: int = RING_WORLD, profile_dir: str | None = None,
                  comm_quant: str | None = None) -> dict:
    """One run of the scaling or distributed program through its entry
    point, its ranks on the card; returns the record's summary. Every K1
    launch must take the wgmma route, as many as the mode makes
    (`scaling_launches`); the library run launches none. Under
    `comm_quant` (a `--comm-quant` value) the record's `comm_quant` extra
    must be the port's `comm_quant_record_extra` for the run, and every
    call of the full program must have put its collective on that wire
    (`collectives.WIRE_CALLS`)."""
    from tpu_matmul_bench_torch.benchmarks import (
        matmul_distributed_benchmark,
        matmul_scaling_benchmark,
    )
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.parallel import collectives
    from tpu_matmul_bench_torch.utils.telemetry import is_manifest

    entry = (matmul_scaling_benchmark if program == "scaling"
             else matmul_distributed_benchmark).main
    tag = (f"{mode},{impl},{timing}" + ("" if d == RING_WORLD else f",d={d}")
           + (f",{comm_quant}" if comm_quant else ""))
    path = f"{out_dir}/{program}-{tag.replace(',', '-').replace(':', '')}.jsonl"
    argv = ["--mode", mode, "--sizes", str(SIZE), "--dtype", "bfloat16",
            "--num-devices", str(d), "--matmul-impl", impl, "--timing", timing,
            "--iterations", str(SCALING_ITERATIONS), "--warmup", str(SCALING_WARMUP),
            "--validate", "--json-out", path]
    if profile_dir:
        argv += ["--profile-dir", profile_dir]
    if comm_quant:
        argv += ["--comm-quant", comm_quant]
    # the baseline is measured in this run, not taken from an earlier one
    matmul_scaling_benchmark._BASELINE_CACHE.clear()
    cm.LAUNCHES = 0
    collectives.WIRE_CALLS.clear()
    before = routes()
    t0 = time.perf_counter()
    with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr), \
            clock_samples() as during:
        records = entry(argv)
    seconds = time.perf_counter() - t0
    launches, by_route = cm.LAUNCHES, routes_since(before)
    wire_calls = {f"{spec},{kind}": n for (spec, kind), n in collectives.WIRE_CALLS.items()}
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
               "launches_by_route": by_route, "during": during, "seconds": seconds}
    problems = []
    if comm_quant:
        problems += comm_quant_problems(program, mode, comm_quant, timing, rec, wire_calls)
        summary.update(comm_quant=x.get("comm_quant"), wire_calls=wire_calls)
    elif wire_calls:
        problems.append(f"no --comm-quant, yet a wire format ran: {wire_calls}")
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


def comm_quant_problems(program: str, mode: str, spec: str, timing: str, rec,
                        wire_calls: dict) -> list[str]:
    """What a --comm-quant run of the scaling or distributed program got
    wrong: its `comm_quant` extra against the port's own
    `comm_quant_record_extra` (payload_reduction_x 2.0 for bf16), its
    validation tolerance against `quantized_tolerance`, and its wire calls:
    one for each call of the full program (the validation's and the timed
    ones, `scaling_calls`), under the format that ran."""
    from tpu_matmul_bench_torch.parallel.collectives import (
        comm_quant_record_extra,
        parse_wire_format,
    )
    from tpu_matmul_bench_torch.parallel.modes import quantized_tolerance
    from tpu_matmul_bench_torch.utils.config import parse_config

    config = parse_config(["--sizes", str(SIZE), "--dtype", "bfloat16", "--comm-quant", spec],
                          "t", modes=[mode], comm_quant=True)
    want = comm_quant_record_extra(config, RING_WORLD, mode=mode, size=SIZE)
    got = rec.extras.get("comm_quant")
    problems = []
    if got != want:
        problems.append(f"extras comm_quant {got}, not {want}")
    if (got or {}).get("payload_reduction_x") != 2.0:
        problems.append(f"payload_reduction_x {(got or {}).get('payload_reduction_x')}, not 2.0")
    tol = quantized_tolerance(spec, RING_WORLD)
    if rec.extras.get("validation_tolerance") != tol:
        problems.append(f"validation_tolerance {rec.extras.get('validation_tolerance')}, "
                        f"not {tol}")
    fmt = parse_wire_format(spec)
    kind = "all_gather" if mode == "matrix_parallel" else "all_reduce"
    full_calls = 1 + (scaling_calls(mode, RING_WORLD, timing) - 1) // 2
    expect = {f"{'int8' if fmt.legacy else spec},{kind}": full_calls}
    if wire_calls != expect:
        problems.append(f"wire calls {wire_calls}, not {expect}")
    return problems


def efficiency_in_turns(runs: dict, card: str) -> dict:
    """ROADMAP C2: each efficiency mode at bf16 SIZE² over RING_WORLD ranks
    under K1, the leg its TFLOPS formula reads (EFFICIENCY_LEGS), timed in
    turns with the single-device baseline's product (`matmul_scaling_
    benchmark._single_device_tflops`: SIZE³ through K1 on the first rank's
    card) at the power limit's steady clocks, the same number of products
    in each leg; the efficiency by the record's own formula
    (`attach_scaling_efficiency`) from each pass's two legs, the median of
    the passes, beside the record's `scaling_efficiency_pct` from the
    `scaling` phase, with each leg's SM clock. Fails above
    EFFICIENCY_MAX_PCT."""
    import torch

    from tpu_matmul_bench_torch.models.workloads import MatmulWorkload
    from tpu_matmul_bench_torch.ops.matmul import make_matmul
    from tpu_matmul_bench_torch.parallel import modes
    from tpu_matmul_bench_torch.utils.config import parse_config
    from tpu_matmul_bench_torch.utils.metrics import calculate_tflops
    from tpu_matmul_bench_torch.utils.reporting import attach_scaling_efficiency
    from tpu_matmul_bench_torch.utils.timing import Timing

    t0 = time.perf_counter()
    builders = {**modes.SCALING_MODES, **modes.DISTRIBUTED_MODES}
    config = parse_config(["--sizes", str(SIZE), "--dtype", "bfloat16", "--matmul-impl",
                           "cuda"], "t", modes=list(EFFICIENCY_LEGS))
    mesh = card_mesh(RING_WORLD)
    kind = torch.cuda.get_device_name(0)
    a, b = MatmulWorkload(SIZE, config.dtype, seed=config.seed).operands(mesh.devices[0])
    mm = make_matmul("cuda", None, kind)
    result = {}
    for mode, leg in EFFICIENCY_LEGS.items():
        setup = builders[mode](config, mesh, SIZE)
        program = getattr(setup, leg)
        products = RING_WORLD * max(4 // RING_WORLD, 1)  # a call's products, ranks × local batch
        calls = {mode: (lambda: program(*setup.operands), EFFICIENCY_CALLS),
                 "single": (lambda: mm(a, b), EFFICIENCY_CALLS * products)}
        for fn, n in calls.values():
            for _ in range(EFFICIENCY_WARMUP):
                fn()
        passes, clocks_by_leg = [], {name: [] for name in calls}
        order = list(calls)
        for p in range(EFFICIENCY_PASSES):
            ms = {}
            for name in order if p % 2 == 0 else order[::-1]:
                fn, n = calls[name]
                with clock_samples() as during:
                    ms[name] = events_ms(fn, n)
                clocks_by_leg[name].append(during.get("sm_mhz_mean"))
            t_leg = Timing(total_s=ms[mode] * EFFICIENCY_CALLS / 1e3,
                           iterations=EFFICIENCY_CALLS)
            rec = setup.build_record(t_leg, t_leg, 0.0)
            attach_scaling_efficiency(rec, calculate_tflops(SIZE, ms["single"] / 1e3))
            passes.append({"leg_ms": ms[mode], "single_ms": ms["single"],
                           "scaling_efficiency_pct": rec.scaling_efficiency_pct})
        del setup, program, calls
        torch.cuda.empty_cache()
        in_turns = statistics.median(q["scaling_efficiency_pct"] for q in passes)
        result[mode] = {"leg": leg, "products_a_call": products,
                        "scaling_efficiency_in_turns_pct": in_turns,
                        "scaling_efficiency_pct": runs[mode]["cuda,dispatch"][
                            "scaling_efficiency_pct"],
                        "sm_mhz_mean": clocks_by_leg, "passes": passes}
    del a, b
    torch.cuda.empty_cache()
    over = {m: r["scaling_efficiency_in_turns_pct"] for m, r in result.items()
            if r["scaling_efficiency_in_turns_pct"] > EFFICIENCY_MAX_PCT}
    emit({"phase": "scaling_efficiency_in_turns", "card": card, "calls": EFFICIENCY_CALLS,
          "warmup": EFFICIENCY_WARMUP, "modes": result,
          "seconds": time.perf_counter() - t0, "ok": not over})
    if over:
        fail("scaling_efficiency_in_turns", f"above {EFFICIENCY_MAX_PCT}%: {over}")
    return result


def comm_quant_phase(scaling: dict, out_dir: str) -> dict:
    """The scaling and distributed programs under --comm-quant
    (COMM_QUANT_RUNS, cuda dispatch, --validate, and COMM_QUANT_FUSED under
    --timing fused), each checked by `drive_scaling` and
    `comm_quant_problems`; prints each run's comm ms beside the exact run's
    from the `scaling` phase of this call. Ranks that share the card move
    the payloads within its memory: the quantize and dequantize passes
    only add time there."""
    t0 = time.perf_counter()
    runs = {}
    for program, mode, spec in COMM_QUANT_RUNS:
        runs[f"{mode},{spec},dispatch"] = drive_scaling(program, mode, "cuda", "dispatch",
                                                        out_dir, comm_quant=spec)
    program, mode, spec = COMM_QUANT_FUSED
    runs[f"{mode},{spec},fused"] = drive_scaling(program, mode, "cuda", "fused", out_dir,
                                                 comm_quant=spec)
    table = {}
    for label, r in runs.items():
        mode, _, timing = label.split(",")
        exact = scaling[r["mode"]][f"cuda,{timing}"]
        table[label] = {"avg_ms": r["avg_ms"], "compute_ms": r["compute_ms"],
                        "comm_ms": r["comm_ms"], "exact_comm_ms": exact["comm_ms"],
                        "exact_avg_ms": exact["avg_ms"],
                        "validation_max_rel_err": r["validation_max_rel_err"],
                        "wire_bytes": r["comm_quant"].get("wire_bytes"),
                        "baseline_bytes": r["comm_quant"].get("baseline_bytes")}
    emit({"phase": "comm_quant", "runs": table, "wire": "the card's memory, not NVLink",
          "seconds": time.perf_counter() - t0, "ok": True})
    return runs


def wire_phase(card: str) -> dict:
    """The port's wire collectives called directly at bf16 over RING_WORLD
    ranks on the card, on Gaussian shards: `wire_psum` (the legacy tier
    for int8) and `wire_reduce_scatter` on a SIZE² shard a rank (as
    model_parallel's partials), `wire_all_gather` along axis 1 on a SIZE ×
    SIZE/RING_WORLD shard (as matrix_parallel's C shard), in each format
    of WIRE_FORMATS; each held against the exact collective on the same
    shards, the whole output's relative error (Frobenius norm) within the
    format's bound, and timed (CUDA events, the median of WIRE_RUNS calls)
    beside it. The legacy tier has no reduce_scatter half and must be
    refused. Prints the wire calls counted during each."""
    import torch

    from tpu_matmul_bench_torch.parallel import collectives as col
    from tpu_matmul_bench_torch.parallel.mesh import COLS, ROWS, sharded_normal

    t0 = time.perf_counter()
    mesh = card_mesh(RING_WORLD)
    (full,) = sharded_normal(23, (RING_WORLD * SIZE, SIZE), torch.bfloat16, mesh, ROWS,
                             count=1)
    (cols,) = sharded_normal(29, (SIZE, SIZE), torch.bfloat16, mesh, COLS, count=1)
    ops = {"psum": (col.psum_impl, col.psum_over(mesh), full, {}),
           "reduce_scatter": (col.reduce_scatter_impl,
                              col.psum_scatter_over(mesh, scatter_dimension=0), full, {}),
           "all_gather": (col.allgather_impl, col.all_gather_over(mesh, gather_axis=1),
                          cols, {"axis": 1})}

    def median_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(WIRE_RUNS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def rel(got: list, want: list) -> float:
        num = sum(float(torch.linalg.vector_norm(g.float() - w.float()) ** 2)
                  for g, w in zip(got, want))
        den = sum(float(torch.linalg.vector_norm(w.float()) ** 2) for w in want)
        return math.sqrt(num / den)

    result, problems = {}, []
    for op, (impl, exact, shards, kw) in ops.items():
        want = exact(shards)
        # every rank of a psum or gather holds the same result: rank 0's
        # is the output; a reduce_scatter's is every rank's chunk
        want = want if op == "reduce_scatter" else want[:1]
        row = {"exact_ms": median_ms(lambda: exact(shards))}
        for spec, bound in WIRE_FORMATS.items():
            fmt = col.parse_wire_format(spec)
            if op == "reduce_scatter" and fmt.legacy:
                try:
                    impl(spec)
                    problems.append(f"reduce_scatter took the legacy {spec}")
                except ValueError as e:
                    row[spec] = {"refused": str(e)}
                continue
            fn = impl(spec)
            col.WIRE_CALLS.clear()
            got = fn(mesh, shards, **kw)
            got = got if op == "reduce_scatter" else got[:1]
            err = rel(got, want)
            del got
            ms = median_ms(lambda: fn(mesh, shards, **kw))
            ticks = {f"{k[0]},{k[1]}": n for k, n in col.WIRE_CALLS.items()}
            row[spec] = {"ms": ms, "rel_err": err, "bound": bound, "wire_calls": ticks}
            if not err < bound:
                problems.append(f"{op} {spec}: relative error {err} >= {bound}")
            # the check's call, the warm call and the timed ones
            if sum(ticks.values()) != WIRE_RUNS + 2:
                problems.append(f"{op} {spec}: wire calls {ticks}")
            torch.cuda.empty_cache()
        result[op] = row
        del want
        torch.cuda.empty_cache()
    del full, cols
    torch.cuda.empty_cache()
    emit({"phase": "wire", "card": card, "ranks": RING_WORLD, "dtype": "bfloat16",
          "shapes": {"psum": [SIZE, SIZE], "reduce_scatter": [SIZE, SIZE],
                     "all_gather": [SIZE, SIZE // RING_WORLD]},
          "wire": "the card's memory, not NVLink", "ops": result,
          "seconds": time.perf_counter() - t0, "ok": not problems})
    if problems:
        fail("wire", "; ".join(problems))
    return result


def collectives_phase(card: str, out_dir: str) -> dict:
    """The collectives program through its entry point over RING_WORLD
    ranks on the card, each of its six ops at a SIZE² bf16 payload a rank
    with --validate, then `collectives selftest`: every op `validation:
    ok`, the selftest returns. Ranks that share the card copy within its
    memory, so algbw and busbw are the card's memory, not NVLink."""
    from tpu_matmul_bench_torch.benchmarks import collective_benchmark

    t0 = time.perf_counter()
    result, problems = {}, []
    for op in COLLECTIVE_OPS:
        path = f"{out_dir}/collectives-{op}.jsonl"
        argv = ["--mode", op, "--sizes", str(SIZE), "--dtype", "bfloat16",
                "--num-devices", str(RING_WORLD), "--iterations", str(SCALING_ITERATIONS),
                "--warmup", str(SCALING_WARMUP), "--validate", "--json-out", path]
        with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr):
            records = collective_benchmark.main(argv)
        if len(records) != 1:
            fail(f"collectives[{op}]", f"expected one record, got {len(records)}")
        rec = records[0]
        result[op] = {"ms": rec.avg_time_s * 1e3, "algbw_gbps": rec.algbw_gbps,
                      "busbw_gbps": rec.busbw_gbps, "bytes_per_device": rec.bytes_per_device,
                      "validation": rec.extras.get("validation"),
                      "cards": rec.extras.get("cards"),
                      "ranks_per_card": rec.extras.get("ranks_per_card")}
        if rec.extras.get("validation") != "ok" or rec.world != RING_WORLD:
            problems.append(f"{op}: validation {rec.extras.get('validation')}, "
                            f"world {rec.world}")
    t_selftest = time.perf_counter()
    try:
        with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr):
            collective_benchmark.main(["selftest"])
        selftest = 0
    except SystemExit as e:
        selftest = e.code
        problems.append(f"collectives selftest exited {e.code}")
    emit({"phase": "collectives", "card": card, "ranks": RING_WORLD,
          "payload": [SIZE, SIZE], "dtype": "bfloat16",
          "bandwidth": "copies within one card's memory, not NVLink", "ops": result,
          "selftest_exit": selftest, "selftest_seconds": time.perf_counter() - t_selftest,
          "seconds": time.perf_counter() - t0, "ok": not problems})
    if problems:
        fail("collectives", "; ".join(problems))
    return result


def drive_2d(program: str, impl: str, timing: str, out_dir: str,
             extra: tuple[str, ...] = (), comm_quant: str | None = None) -> dict:
    """One run of the hybrid or summa program through its entry point at
    bf16 SIZE² over RING_WORLD ranks on the card; returns the record's
    summary. Every K1 launch must take the wgmma route, K1_PER_CALL a call
    of either program (the validation's and the timed ones, `scaling_calls`);
    the library run launches none. Under `comm_quant` (hybrid on HYBRID_MESH)
    the record's `comm_quant` extra must be the port's per-link
    `comm_quant_record_extra`, and each full-program call must have put the
    dcn psum of each of its groups on the wire."""
    from tpu_matmul_bench_torch.benchmarks import (
        matmul_hybrid_benchmark,
        matmul_summa_benchmark,
    )
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.parallel import collectives

    entry = {"hybrid": matmul_hybrid_benchmark, "summa": matmul_summa_benchmark}[program].main
    tag = ",".join([program, impl, timing, *extra] + ([comm_quant] if comm_quant else []))
    path = f"{out_dir}/{re.sub(r'[^A-Za-z0-9]+', '-', tag)}.jsonl"
    argv = ["--sizes", str(SIZE), "--dtype", "bfloat16", "--num-devices", str(RING_WORLD),
            "--matmul-impl", impl, "--timing", timing, "--iterations", str(SCALING_ITERATIONS),
            "--warmup", str(SCALING_WARMUP), "--validate", "--json-out", path, *extra]
    if comm_quant:
        argv += ["--comm-quant", comm_quant]
    cm.LAUNCHES = 0
    collectives.WIRE_CALLS.clear()
    before = routes()
    t0 = time.perf_counter()
    with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr), \
            clock_samples() as during:
        records = entry(argv)
    seconds = time.perf_counter() - t0
    launches, by_route = cm.LAUNCHES, routes_since(before)
    wire_calls = {f"{spec},{kind}": n for (spec, kind), n in collectives.WIRE_CALLS.items()}
    phase = f"{program}[{tag}]"
    if len(records) != 1:
        fail(phase, f"expected one record, got {len(records)} (the runner reports a "
                    "failed size and returns no record for it)")
    rec, x = records[0], records[0].extras
    calls = scaling_calls(program, RING_WORLD, timing)
    want = K1_PER_CALL[program] * calls if impl == "cuda" else 0
    summary = {"phase": phase, "program": program, "mode": rec.mode, "world": rec.world,
               "k1_shape": "x".join(map(str, HYBRID_SHAPE if program == "hybrid"
                                        else SUMMA_SHAPE)),
               "avg_ms": rec.avg_time_s * 1e3, "compute_ms": rec.compute_time_s * 1e3,
               "comm_ms": rec.comm_time_s * 1e3, "tflops_total": rec.tflops_total,
               "tflops_per_device": rec.tflops_per_device,
               "peak_efficiency_pct": rec.peak_efficiency_pct,
               "extras": {k: v for k, v in x.items() if k != "comm_quant"},
               "k1_launches": launches, "expected_k1_launches": want,
               "launches_by_route": by_route, "wire_calls": wire_calls, "during": during,
               "seconds": seconds}
    problems = []
    if x.get("validation") != "ok":
        problems.append("validation is not ok")
    if rec.world != RING_WORLD or x.get("cards") != 1 or x.get("ranks_per_card") != RING_WORLD:
        problems.append(f"world {rec.world} on {x.get('cards')} cards, "
                        f"{x.get('ranks_per_card')} a card")
    if timing == "fused" and (x.get("timing"), x.get("chain")) != ("fused", "operand"):
        problems.append(f"fused was asked, yet timing {x.get('timing')}, chain "
                        f"{x.get('chain')}")
    if launches != want:
        problems.append(f"{launches} K1 launches, not the {want} the program makes")
    if impl == "cuda" and by_route != {"gemm:wgmma": want}:
        problems.append(f"launches by route {by_route}: not all {want} on wgmma")
    if impl == "torch" and by_route:
        problems.append(f"the library run launched the port's kernels: {by_route}")
    if comm_quant:
        from tpu_matmul_bench_torch.parallel.collectives import comm_quant_record_extra
        from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args

        config = config_from_args(build_parser("t", comm_quant=True, mesh=True).parse_args(
            ["--sizes", str(SIZE), "--comm-quant", comm_quant, "--mesh", HYBRID_MESH]))
        expect = comm_quant_record_extra(config, RING_WORLD, mode="hybrid", size=SIZE,
                                         dp=2, mesh_spec=HYBRID_MESH)
        summary["comm_quant"] = x.get("comm_quant")
        if x.get("comm_quant") != expect:
            problems.append(f"extras comm_quant {x.get('comm_quant')}, not {expect}")
        if expect.get("bottleneck_link") != "dcn":
            problems.append(f"bottleneck_link {expect.get('bottleneck_link')}, not dcn")
        # the dcn psum runs in each of the 2 groups along dcn, every full call
        full_calls = 1 + (calls - 1) // 2
        if wire_calls != {"fp8-block:128,all_reduce": 2 * full_calls}:
            problems.append(f"wire calls {wire_calls}, not {2 * full_calls} dcn psums")
    elif wire_calls:
        problems.append(f"no --comm-quant, yet a wire format ran: {wire_calls}")
    summary["ok"] = not problems
    emit(summary)
    if problems:
        fail(phase, "; ".join(problems))
    return summary


def runs_2d(program: str, out_dir: str, extra: tuple[str, ...] = ()) -> dict:
    """The program through K1 and the library, dispatch and fused."""
    return {f"{impl},{timing}": drive_2d(program, impl, timing, out_dir, extra)
            for impl in ("cuda", "torch") for timing in ("dispatch", "fused")}


def hybrid_phase(out_dir: str) -> dict:
    """hybrid at --dp 2 under K1 and the library, dispatch and fused, then on
    HYBRID_MESH with the dcn psum on HYBRID_WIRE; returns the runs."""
    t0 = time.perf_counter()
    runs = runs_2d("hybrid", out_dir, ("--dp", str(HYBRID_DP)))
    runs["cuda,dispatch,mesh"] = drive_2d("hybrid", "cuda", "dispatch", out_dir,
                                          ("--mesh", HYBRID_MESH), comm_quant=HYBRID_WIRE)
    emit({"phase": "hybrid", "card": card_line(),
          "ms": {label: r["avg_ms"] for label, r in runs.items()},
          "seconds": time.perf_counter() - t0, "ok": True})
    return runs


def summa_strides(card: str) -> dict:
    """SUMMA validate-only on the 1x4 and 4x1 grids and on HYBRID_MESH over
    RING_WORLD ranks on the card, through K1: each full program's corner
    `validation: ok`; on the two grids also one compute-leg call, whose
    products take the panels as views of the resident blocks (on the 4x1
    grid A panels are column views, their rows SIZE apart, their base moved
    by a panel a step), held rank by rank to the library's compute leg, all
    on wgmma."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.parallel.mesh import make_factorized_mesh
    from tpu_matmul_bench_torch.parallel.summa import make_summa_mesh, summa_mode, summa_programs
    from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args
    from tpu_matmul_bench_torch.utils.device import resolve_devices

    config = config_from_args(build_parser("t", mesh=True).parse_args(
        ["--sizes", str(SIZE), "--dtype", "bfloat16", "--matmul-impl", "cuda"]))
    with ranks_per_card(RING_WORLD):
        devices = resolve_devices("cuda", RING_WORLD)
    grids = {f"rows={rows}": make_summa_mesh(devices, rows) for rows in SUMMA_ROWS}
    grids[HYBRID_MESH] = make_factorized_mesh(devices, HYBRID_MESH)
    out, problems = {}, []
    for label, mesh in grids.items():
        setup = summa_mode(config, mesh, SIZE)
        entry = {"grid": "x".join(map(str, mesh.dims))}
        if label.startswith("rows="):
            before = routes()
            got = setup.compute(*setup.operands)
            entry["compute_routes"] = routes_since(before)
            want = summa_programs(mesh, "torch")[0](*setup.operands)
            entry["compute_max_rel_err"] = max(
                ((g.double() - w.double()).abs().max() / w.double().abs().max()).item()
                for g, w in zip(got, want))
            del got, want
            steps = math.lcm(*mesh.dims)
            if entry["compute_routes"] != {"gemm:wgmma": RING_WORLD * steps}:
                problems.append(f"{label}: compute routes {entry['compute_routes']}")
            if entry["compute_max_rel_err"] > TOLERANCE["bfloat16"]:
                problems.append(f"{label}: compute leg off the library's by "
                                f"{entry['compute_max_rel_err']}")
        before = cm.LAUNCHES
        entry.update(setup.validate())
        entry["validate_launches"] = cm.LAUNCHES - before
        if entry.get("validation") != "ok":
            problems.append(f"{label}: validation {entry.get('validation')}")
        out[label] = entry
        del setup
        torch.cuda.empty_cache()
    emit({"phase": "summa_strides", "card": card, "grids": out, "ok": not problems})
    if problems:
        fail("summa_strides", "; ".join(problems))
    return out


def summa_phase(out_dir: str) -> dict:
    """SUMMA on the default 2x2 grid under K1 and the library, dispatch and
    fused, then validate-only on the other grids (`summa_strides`)."""
    t0 = time.perf_counter()
    runs = runs_2d("summa", out_dir)
    strides = summa_strides(card_line())
    emit({"phase": "summa", "ms": {label: r["avg_ms"] for label, r in runs.items()},
          "seconds": time.perf_counter() - t0, "ok": True})
    runs["strides"] = strides
    return runs


def check_stream_pickup() -> dict:
    """K1's pickup kernel at the stream's panel product on the card: an A
    panel that is a column view of its window slab ([STREAM_SIZE, kp] of a
    [STREAM_SIZE, 2·kp] slab), B's [kp, STREAM_SIZE] rows, accumulating
    into an fp32 accin in place (out is accin), against its plain version;
    one launch, on wgmma."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops.matmul import random_operands

    n, kp = STREAM_SIZE, STREAM_SIZE // STREAM_PANELS
    (slab,) = random_operands(7, (n, 2 * kp), torch.bfloat16, device="cuda", count=1)
    (b,) = random_operands(8, (kp, n), torch.bfloat16, device="cuda", count=1)
    a = slab[:, kp:]
    (acc,) = random_operands(9, (n, n), torch.float32, device="cuda", count=1)
    want = cm.matmul_acc_plain(a, b, acc, out_dtype=torch.float32)
    before, launches = routes(), cm.ACC_LAUNCHES
    got = cm.cuda_matmul_acc(a, b, acc, out=acc, out_dtype=torch.float32)
    torch.cuda.synchronize()
    launched = routes_since(before)
    diff = (got.double() - want.double()).abs().max().item()
    rel = diff / (want.double().abs().max().item() or 1.0)
    result = {"phase": "kernel_vs_plain[stream_pickup]", "kernel": "matmul_acc",
              "shape": [n, kp, n], "lda": slab.stride(0), "in_place": got.data_ptr() ==
              acc.data_ptr(), "max_abs_err": diff, "max_rel_err": rel,
              "tolerance": TOLERANCE["float32"], "routes": launched,
              "launches": cm.ACC_LAUNCHES - launches}
    result["ok"] = (rel <= TOLERANCE["float32"] and launched == {"gemm:wgmma": 1}
                    and result["in_place"])
    emit(result)
    del slab, b, acc, want, got
    torch.cuda.empty_cache()
    if not result["ok"]:
        fail("kernel_vs_plain[stream_pickup]", str(result))
    return result


def drive_stream(impl: str, out_dir: str, size: int, panels: int, iterations: int,
                 budget_gib: float | None = None, mesh: str | None = None,
                 ranks: int = 1) -> dict:
    """One run of `parallel stream` through its entry point on the card;
    returns the record's summary. Under K1 each panel product is one pickup
    launch on wgmma (panels × ranks × calls: the validation's, the warm-up
    and the timed ones); the library launches none."""
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.parallel import cli as parallel_cli

    tag = f"{impl},{size},k{panels}" + (f",{mesh}" if mesh else "")
    path = f"{out_dir}/stream-{re.sub(r'[^A-Za-z0-9]+', '-', tag)}.jsonl"
    argv = ["stream", "--sizes", str(size), "--stream-k", str(panels), "--dtype", "bfloat16",
            "--num-devices", str(ranks), "--matmul-impl", impl, "--iterations",
            str(iterations), "--validate", "--json-out", path]
    if budget_gib is not None:
        argv += ["--mem-budget-gib", str(budget_gib)]
    if mesh:
        argv += ["--mesh", mesh]
    cm.ACC_LAUNCHES = 0
    before = routes()
    t0 = time.perf_counter()
    with ranks_per_card(ranks), contextlib.redirect_stdout(sys.stderr):
        records = parallel_cli.main(argv)
    seconds = time.perf_counter() - t0
    launches, by_route = cm.ACC_LAUNCHES, routes_since(before)
    phase = f"stream[{tag}]"
    if len(records) != 1:
        fail(phase, f"expected one record, got {len(records)}")
    rec, x = records[0], records[0].extras
    want = panels * ranks * (iterations + 2) if impl == "cuda" else 0
    summary = {"phase": phase, "avg_ms": rec.avg_time_s * 1e3, "tflops_total": rec.tflops_total,
               "stream_k": x.get("stream_k"), "validation": x.get("validation"),
               "validation_max_rel_err": x.get("validation_max_rel_err"),
               "world": rec.world, "acc_launches": launches, "expected_acc_launches": want,
               "launches_by_route": by_route, "seconds": seconds}
    problems = []
    if x.get("validation") != "ok":
        problems.append("validation is not ok")
    if launches != want or by_route != ({"gemm:wgmma": want} if want else {}):
        problems.append(f"{launches} pickup launches by route {by_route}, not {want} "
                        "on wgmma")
    if budget_gib is not None and not (x.get("stream_k") or {}).get("out_of_core"):
        problems.append(f"not out of core under {budget_gib} GiB: {x.get('stream_k')}")
    summary["ok"] = not problems
    emit(summary)
    if problems:
        fail(phase, "; ".join(problems))
    return summary


def stream_parts_ms(host, runs: int = 2) -> dict:
    """The stream's two halves apart, on one rank of the card: the H2D
    copies of every window alone (events on a copy stream), and every
    window's products alone on windows already on the card, through K1's
    pickup and through the library."""
    import torch

    from tpu_matmul_bench_torch.ops.stream_k import _consume, panel_product

    plan = host.plan
    n, width = host.b.shape[0], plan.window_k
    bufs = [(torch.empty((n, width), dtype=host.b.dtype, device="cuda"),
             torch.empty((width, n), dtype=host.b.dtype, device="cuda")) for _ in range(2)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    copies = []
    with torch.cuda.stream(stream):
        for _ in range(runs):
            start.record()
            for w in range(plan.num_windows):
                a_buf, b_buf = bufs[w % 2]
                a_buf.copy_(host.a[0, w], non_blocking=True)
                b_buf.copy_(host.b[w * width:(w + 1) * width], non_blocking=True)
            end.record()
            end.synchronize()
            copies.append(start.elapsed_time(end))
    torch.cuda.current_stream().wait_stream(stream)
    moved = host.a[0].numel() * host.a.element_size() + host.b.numel() * host.b.element_size()
    acc = torch.zeros((n, n), dtype=torch.float32, device="cuda")
    products = {}
    for impl in ("cuda", "torch"):
        product = panel_product(impl)

        def windows():
            for w in range(plan.num_windows):
                _consume(product, *bufs[w % 2], acc, plan)

        products[impl] = events_ms(windows, runs)
    del bufs, acc
    torch.cuda.empty_cache()
    copy_ms = min(copies)
    return {"copies_ms": copy_ms, "copied_bytes": moved,
            "h2d_gbps": moved / (copy_ms * 1e-3) / 1e9,
            "products_ms": products["cuda"], "library_products_ms": products["torch"]}


def stream_races(card: str) -> dict:
    """STREAM_RACE_CALLS stream calls at STREAM_RACE_SIZE over one rank, each
    held bitwise to a serial call (every copy and product on the current
    stream, the card synchronised after each), which is held to the plain
    product of the whole operands (fp32)."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops.stream_k import StreamPlan, stage_host, stream_matmul
    from tpu_matmul_bench_torch.parallel.stream_k import host_operands
    from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args

    config = config_from_args(build_parser("t").parse_args(["--dtype", "bfloat16"]))
    a, b = host_operands(config, STREAM_RACE_SIZE)
    plan = StreamPlan(size=STREAM_RACE_SIZE, panels=STREAM_RACE_PANELS, window=2, world=1)
    host = stage_host(a, b, plan, pin=True)
    mesh = card_mesh(1)
    serial = stream_matmul(host, mesh, "cuda", serial=True)[0]
    plain = cm.matmul_plain(a.cuda(), b.cuda(), out_dtype=torch.float32)
    rel = ((serial.double() - plain.double()).abs().max()
           / plain.double().abs().max()).item()
    mismatched = [i for i in range(STREAM_RACE_CALLS)
                  if not torch.equal(stream_matmul(host, mesh, "cuda")[0], serial)]
    result = {"phase": "races[stream]", "card": card, "size": STREAM_RACE_SIZE,
              "panels": STREAM_RACE_PANELS, "calls": STREAM_RACE_CALLS,
              "mismatched_calls": mismatched, "serial_vs_plain_max_rel_err": rel,
              "tolerance": TOLERANCE["float32"]}
    result["ok"] = not mismatched and rel <= TOLERANCE["float32"]
    emit(result)
    if not result["ok"]:
        fail("races[stream]", str(result))
    return result


def stream_phase(card: str, out_dir: str) -> dict:
    """`parallel stream` at STREAM_SIZE over one rank under STREAM_BUDGET_GIB
    (out of core), through K1's pickup and through the library, the host
    operands made once for both (the library run reuses the K1 run's); the
    copies and the products timed apart (`stream_parts_ms`); the race check
    (`stream_races`); then the stream over RING_WORLD ranks on HYBRID_MESH,
    validate-only, at STREAM_RACE_SIZE."""
    from tpu_matmul_bench_torch.parallel import stream_k

    t0 = time.perf_counter()
    made, staged = {}, []
    host_operands, stage_host = stream_k.host_operands, stream_k.stage_host

    def cached(config, size):
        key = (config.seed, size, config.dtype_name)
        if key not in made:
            made.clear()
            made[key] = host_operands(config, size)
        return made[key]

    def kept(*args, **kw):
        staged[:] = [stage_host(*args, **kw)]
        return staged[0]

    stream_k.host_operands, stream_k.stage_host = cached, kept
    try:
        runs = {impl: drive_stream(impl, out_dir, STREAM_SIZE, STREAM_PANELS,
                                   STREAM_ITERATIONS, budget_gib=STREAM_BUDGET_GIB)
                for impl in ("cuda", "torch")}
        made.clear()
        parts = stream_parts_ms(staged[0])
    finally:
        stream_k.host_operands, stream_k.stage_host = host_operands, stage_host
        made.clear()
        staged.clear()
    races = stream_races(card)
    runs["mesh"] = drive_stream("cuda", out_dir, STREAM_RACE_SIZE, STREAM_RACE_PANELS, 1,
                                mesh=STREAM_MESH, ranks=RING_WORLD)
    result = {"phase": "stream", "card": card, "size": STREAM_SIZE, "panels": STREAM_PANELS,
              "stream_ms": runs["cuda"]["avg_ms"], "library_stream_ms": runs["torch"]["avg_ms"],
              **parts, "races": races["mismatched_calls"],
              "seconds": time.perf_counter() - t0, "ok": True}
    emit(result)
    runs["parts"] = parts
    return runs


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
    efficiency_in_turns(runs, card_line())
    return runs


def launch_spread(trace: str, name_part: str) -> dict:
    """The device µs of each launch of the kernels whose name holds
    `name_part` in a trace: count, min, median, max."""
    from tpu_matmul_bench_torch.utils import profiling

    durs = sorted(float(e["dur"]) for e in profiling.device_events(profiling.load_events(trace))
                  if str(e.get("cat", "")).lower() == "kernel" and name_part in e["name"])
    if not durs:
        return {"count": 0}
    return {"count": len(durs), "min_us": durs[0], "median_us": statistics.median(durs),
            "max_us": durs[-1]}


def profile_phase(cap: int, out_dir: str) -> dict:
    """--profile-dir on the card: batch_parallel at bf16 SIZE², the fused
    ring at its cap and K4 at SIZE² (ROADMAP C3), each traced by
    torch.profiler; prints each trace's device time per kernel, the
    device's busy and idle share inside the timed windows, K6's device time
    a launch beside its event-timed ms, and the spread of K4's step
    launches' device time beside its calls' (`single_calls`). Fails when a
    trace holds no device kernel event; where the profiler records no CUDA
    activity at all, the program raises and the phase reports why."""
    from tpu_matmul_bench_torch.benchmarks import matmul_overlap_benchmark
    from tpu_matmul_bench_torch.utils import profiling

    result = {"phase": "profile"}
    scaling_dir, k6_dir = "build/profile/scaling", "build/profile/k6"
    k4_dir = "build/profile/k4"
    for d in (scaling_dir, k6_dir, k4_dir):
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
        argv = ["--mode", "cuda_ring_bidir_hbm", "--sizes", str(SIZE), "--dtype", "bfloat16",
                "--num-devices", str(RING_WORLD), "--matmul-impl", "cuda",
                "--iterations", str(OVERLAP_ITERATIONS), "--warmup", str(OVERLAP_WARMUP),
                "--profile-dir", k4_dir]
        with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr), \
                single_calls() as k4_calls:
            (k4_rec,) = matmul_overlap_benchmark.main(argv)
    except RuntimeError as e:
        if "recorded no CUDA activity" not in str(e):
            raise
        result.update(profiler_records_cuda=False, reason=str(e), ok=True)
        emit(result)
        return result
    summaries = {}
    for label, d in (("scaling", scaling_dir), ("k6", k6_dir), ("k4", k4_dir)):
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
        k6_event_ms=k6_rec.avg_time_s * 1e3, k6_baseline_event_ms=k6_rec.compute_time_s * 1e3,
        k4=summaries["k4"], k4_event_ms=k4_rec.avg_time_s * 1e3,
        k4_single_calls=spread(k4_calls.get(1)),
        k4_step_launches=launch_spread(summaries["k4"]["trace"], "rs_step_wgmma"))
    problems = [f"the {label} trace holds no device kernel event"
                for label, s in summaries.items() if not s["kernel_launches"]]
    if not k6["count"]:
        problems.append("the fused ring's kernel is not in its trace")
    if not result["k4_step_launches"]["count"]:
        problems.append("K4's step kernel is not in its trace")
    result["ok"] = not problems
    emit(result)
    if problems:
        fail("profile", "; ".join(problems))
    return result


def ring_entry(label: str, counts: dict, baseline_ms: float, card: str,
               kind: str, size: int = SIZE) -> tuple[dict, tuple]:
    """Times and bound of one ring at bf16 size², RING_WORLD ranks on the
    card: the ring, its plain version and torch.matmul of the gathered
    operands, with the main path's launches and its baseline leg. Every
    shard of the ring's output is first held against the plain version's,
    max|ring − plain| / max|plain| within the bf16 tolerance. The bound is
    that of the function the ring computes, Y = X·W over the world (X and W
    read once, Y written once: the hops and staged partials are the ring's
    own traffic, not the function's). Returns the entry, the ring and its
    operands (X, W)."""
    import torch

    from tpu_matmul_bench_torch.obs import attribution
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
    bound_ms, bound_by = attribution.bound(size, size, size, torch.bfloat16, kind)
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


def curve_phase(out_dir: str) -> dict:
    """`curve --mode batch_parallel --sizes SIZE --device-counts 1,2,4
    --matmul-impl cuda --validate` through its entry point: one record and
    one table row a count, each `validation: ok` with every K1 launch of its
    scaling run on wgmma, as many as the scaling phase's count for that
    rank count (the single-device baseline measured once, at the first
    multi-rank count, and cached for the next), no efficiency above
    EFFICIENCY_MAX_PCT."""
    from tpu_matmul_bench_torch.benchmarks import matmul_scaling_benchmark, scaling_curve
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm

    md, path = f"{out_dir}/curve.md", f"{out_dir}/curve.jsonl"
    argv = ["--mode", CURVE_MODE, "--sizes", str(SIZE), "--dtype", "bfloat16",
            "--device-counts", ",".join(map(str, CURVE_COUNTS)), "--matmul-impl", "cuda",
            "--iterations", str(SCALING_ITERATIONS), "--warmup", str(SCALING_WARMUP),
            "--validate", "--markdown-out", md, "--json-out", path]
    per_count: dict[int, int] = {}
    real = matmul_scaling_benchmark.run

    def counted(config, **kw):
        before = cm.LAUNCHES
        records = real(config, **kw)
        per_count[config.num_devices] = cm.LAUNCHES - before
        return records

    matmul_scaling_benchmark._BASELINE_CACHE.clear()
    cm.LAUNCHES = 0
    before = routes()
    t0 = time.perf_counter()
    matmul_scaling_benchmark.run = counted
    try:
        with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr):
            records = scaling_curve.main(argv)
    finally:
        matmul_scaling_benchmark.run = real
    seconds = time.perf_counter() - t0
    launches, by_route = cm.LAUNCHES, routes_since(before)
    with open(md) as fh:
        table = fh.read()
    rows = [line for line in table.splitlines() if re.match(r"\| \d+ \|", line)]
    baseline = 1 + SCALING_WARMUP + SCALING_ITERATIONS
    want = {}
    for n in CURVE_COUNTS:
        want[n] = scaling_launches(CURVE_MODE, n, "dispatch")
        if n > 1 and n != min(c for c in CURVE_COUNTS if c > 1):
            want[n] -= baseline  # the baseline came from the cache
    by_count = {r.world: {"avg_ms": r.avg_time_s * 1e3, "tflops_total": r.tflops_total,
                          "tflops_per_card": r.tflops_per_device,
                          "scaling_efficiency_pct": r.scaling_efficiency_pct,
                          "validation": r.extras.get("validation"),
                          "k1_launches": per_count.get(r.world),
                          "expected_k1_launches": want[r.world]} for r in records}
    problems = []
    if [r.world for r in records] != list(CURVE_COUNTS) or len(rows) != len(CURVE_COUNTS):
        problems.append(f"records for {[r.world for r in records]}, table rows {rows}")
    for n, row in by_count.items():
        if row["validation"] != "ok":
            problems.append(f"{n} ranks: validation {row['validation']}")
        if row["k1_launches"] != row["expected_k1_launches"]:
            problems.append(f"{n} ranks: {row['k1_launches']} K1 launches, not "
                            f"{row['expected_k1_launches']}")
        eff = row["scaling_efficiency_pct"]
        if (eff is None) != (n == 1) or (eff is not None and eff > EFFICIENCY_MAX_PCT):
            problems.append(f"{n} ranks: scaling_efficiency_pct {eff}")
    if by_route != {"gemm:wgmma": launches} or launches != sum(per_count.values()):
        problems.append(f"launches by route {by_route}, {launches} in all: not all on wgmma")
    summary = {"phase": "curve", "mode": CURVE_MODE, "counts": by_count, "table": table,
               "k1_launches": launches, "launches_by_route": by_route,
               "seconds": seconds, "ok": not problems}
    emit(summary)
    if problems:
        fail("curve", "; ".join(problems))
    return summary


def membw_phase(card: str, out_dir: str) -> dict:
    """membw's five ops at bf16 MEMBW_SIZES through its entry point: each
    array far above the card's L2 (read from the device), every reading at
    most the datasheet's rate (`pct_of_spec_hbm_bw` ≤ 100: more means the
    byte model or L2 residency is wrong), the triad's GB/s printed."""
    import torch

    from tpu_matmul_bench_torch.benchmarks import membw_benchmark
    from tpu_matmul_bench_torch.parallel.overlap import l2_bytes

    l2 = l2_bytes(torch.device("cuda", 0))
    argv = ["--sizes", *map(str, MEMBW_SIZES), "--dtype", "bfloat16",
            "--iterations", str(MEMBW_ITERATIONS), "--warmup", str(MEMBW_WARMUP),
            "--json-out", f"{out_dir}/membw.jsonl"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        records = membw_benchmark.main(argv)
    seconds = time.perf_counter() - t0
    gbps = {f"{r.mode},{r.size}": r.algbw_gbps for r in records}
    pct = {f"{r.mode},{r.size}": r.extras.get("pct_of_spec_hbm_bw") for r in records}
    problems = []
    if len(records) != len(membw_benchmark.STREAM_OPS) * len(MEMBW_SIZES):
        problems.append(f"{len(records)} records")
    small = [s for s in MEMBW_SIZES if s * s * 2 < 2 * l2]
    if small:
        problems.append(f"sizes {small}: an array is not twice the L2 ({l2} B)")
    high = {k: v for k, v in pct.items() if v is None or v > 100}
    if high:
        problems.append(f"readings above the datasheet (or none): {high}")
    summary = {"phase": "membw", "card": card, "l2_bytes": l2, "gbps": gbps,
               "pct_of_spec_hbm_bw": pct,
               "triad_gbps": {s: gbps[f"triad,{s}"] for s in MEMBW_SIZES if f"triad,{s}" in gbps},
               "seconds": seconds, "ok": not problems}
    emit(summary)
    if problems:
        fail("membw", "; ".join(problems))
    return summary


def doctor_phase() -> dict:
    """`python -m tpu_matmul_bench_torch doctor --json-out -` as a process
    of its own (its hard-exit path): exit code 0, its JSON line printed."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_matmul_bench_torch", "doctor", "--json-out", "-"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=300)
    seconds = time.perf_counter() - t0
    print(proc.stdout + proc.stderr, file=sys.stderr)
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    report = lines[-1] if lines else None
    ok = proc.returncode == 0 and bool(report) and report.get("healthy") is True
    emit({"phase": "doctor", "rc": proc.returncode, "report": report,
          "seconds": seconds, "ok": ok})
    if not ok:
        fail("doctor", f"rc {proc.returncode}, report {report}")
    return report


def _compare_run(argv: list[str], label: str, want: set, out_dir: str) -> tuple[dict, dict]:
    """One `compare` through its entry point, its ranks on the card, with
    the launches each in-process row made; fails unless every row of
    `want` is there and validates (the step modes give no verdict), and
    every in-process row launched as many K1 as `resolve_route` on the
    committed DB predicts from the products the row routed under `auto`:
    each product whose (shape, dtype) the DB or table sends to `cuda` is
    one launch (a product replayed in a CUDA graph is neither routed nor
    launched from the host)."""
    from tpu_matmul_bench_torch.benchmarks import compare_benchmarks
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops import cuda_ring_fused as crf

    routed: list[str] = []  # each `auto` product's predicted impl (auto_routes)

    def counters() -> dict:
        return {"k1": cm.LAUNCHES, "ag": cm.AG_LAUNCHES, "rs": cm.RS_LAUNCHES,
                "fused": crf.FUSED_RING_LAUNCHES, "routed": len(routed),
                "predicted_k1": routed.count("cuda")}

    by_row: dict[str, dict] = {}  # by the record's mode (the matmul rows: "single")
    k1_rows: list[tuple[str, int, int]] = []
    real = compare_benchmarks._run

    def counted(main, argv_):
        before = counters()
        records = real(main, argv_)
        delta = {k: v - before[k] for k, v in counters().items()}
        for rec in records:
            by_row[rec.mode] = delta
            k1_rows.append((f"{rec.mode},{rec.dtype}", delta["k1"], delta["predicted_k1"]))
        return records

    path = f"{out_dir}/compare-{label}.jsonl"
    cm.LAUNCHES = cm.AG_LAUNCHES = cm.RS_LAUNCHES = crf.FUSED_RING_LAUNCHES = 0
    t0 = time.perf_counter()
    compare_benchmarks._run = counted
    try:
        with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr), \
                auto_routes(routed):
            results = compare_benchmarks.main([*argv, "--dtype", "bfloat16", "--validate",
                                               "--iterations", str(COMPARE_ITERATIONS),
                                               "--warmup", str(COMPARE_WARMUP),
                                               "--json-out", path,
                                               "--markdown-out", f"{path}.md"])
    finally:
        compare_benchmarks._run = real
    seconds = time.perf_counter() - t0
    rows = {k: {"avg_ms": r.avg_time_s * 1e3, "tflops_total": r.tflops_total,
                "compute_ms": None if r.compute_time_s is None else r.compute_time_s * 1e3,
                "comm_ms": None if r.comm_time_s is None else r.comm_time_s * 1e3,
                "scaling_efficiency_pct": r.scaling_efficiency_pct,
                "validation": r.extras.get("validation"), "world": r.world,
                "launches": by_row.get(r.mode)} for k, r in results.items()}
    problems = []
    if set(results) != want:
        problems.append(f"rows {sorted(set(results))}, not {sorted(want)} (a missing row "
                        "failed, in-process or in its child)")
    for k, row in rows.items():
        verdict = row["validation"] or ""
        if verdict != "ok" and not (k in COMPARE_NO_VERDICT and verdict.startswith("n/a")):
            problems.append(f"{k}: validation {verdict!r}")
    off = [(k, n, p) for k, n, p in k1_rows if n != p]
    if off:
        problems.append(f"rows' K1 launches (row, launched, predicted) off the "
                        f"committed DB's routes: {off}")
    with open(f"{path}.md") as fh:
        table = fh.read()
    summary = {"phase": f"compare[{label}]", "rows": rows, "table": table,
               "k1_launched_predicted": k1_rows, "seconds": seconds}
    return summary, problems


def compare_phase(cap: int, out_dir: str) -> dict:
    """`compare` at bf16 SIZE² over RING_WORLD ranks: the whole table in
    process (every row but the fused ring, which its L2 cap skips; each
    HBM ring row's step launches above 0), then COMPARE_ISOLATED in child
    processes (`--isolate`), then COMPARE_AT_CAP at K6's cap (K6 and K2
    launched); returns the three summaries."""
    from tpu_matmul_bench_torch.benchmarks.compare_benchmarks import ROW_KEYS

    out = {}
    full, problems = _compare_run(["--size", str(SIZE)], "table",
                                  set(ROW_KEYS) - {"cuda_ring"}, out_dir)
    for mode, counter in COMPARE_RING_STEPS.items():
        launches = full["rows"].get(mode, {}).get("launches") or {}
        if launches.get(counter, 0) <= 0:
            problems.append(f"{mode}: no {counter} step launched: {launches}")
    out["table"] = full
    isolated, more = _compare_run(["--size", str(SIZE), "--isolate",
                                   "--only", ",".join(COMPARE_ISOLATED)], "isolate",
                                  set(COMPARE_ISOLATED), out_dir)
    problems += more
    out["isolate"] = isolated
    at_cap, more = _compare_run(["--size", str(cap), "--only", ",".join(COMPARE_AT_CAP)],
                                f"cap{cap}", set(COMPARE_AT_CAP), out_dir)
    problems += more
    launches = {k: (v.get("launches") or {}) for k, v in at_cap["rows"].items()}
    if launches.get("cuda_ring", {}).get("fused", 0) <= 0 or \
            launches.get("cuda_ring_hbm", {}).get("ag", 0) <= 0:
        problems.append(f"at the cap K6 or K2 did not launch: {launches}")
    out["cap"] = at_cap
    for summary in out.values():
        summary["ok"] = not problems
        emit(summary)
    if problems:
        fail("compare", "; ".join(problems))
    return out


def train_grad_error(extra: tuple[str, ...]) -> dict:
    """The synced gradient of one step of a TRAIN_RUNS cell (its
    `grad_comm` prefix's fp32 output) against the dense fp32 dW/denom of the
    same operands, ‖g − dW‖/‖dW‖: within the bf16 tolerance on the exact
    wire, within WIRE_FORMATS' bound on a wire. At bf16 SIZE the step's
    update (lr · dW, about 6e-7 of |w|) is below the weight's rounding, so
    the record's own validation holds an unchanged weight; the gradient is
    what shows the step is right."""
    import torch

    from tpu_matmul_bench_torch.parallel.collectives import link_format_spec
    from tpu_matmul_bench_torch.parallel.mesh import gather, make_factorized_mesh
    from tpu_matmul_bench_torch.parallel.modes import validation_tolerance
    from tpu_matmul_bench_torch.train.step import make_train_setup
    from tpu_matmul_bench_torch.utils.device import resolve_devices

    opts = dict(zip(extra[::2], extra[1::2]))
    with ranks_per_card(RING_WORLD):
        devices = resolve_devices("cuda", RING_WORLD)
    mesh = (make_factorized_mesh(devices, opts["--mesh"]) if "--mesh" in opts
            else card_mesh(RING_WORLD))
    setup = make_train_setup(mesh, opts["--mode"], SIZE, torch.bfloat16, batch=TRAIN_BATCH,
                             zero=opts["--zero"] == "1",
                             grad_quant=opts.get("--grad-quant"))
    x, w = setup.operands
    g = gather(setup.prefixes["grad_comm"](x, w))
    xg, wf = gather(x), gather(w).float()
    dw = torch.zeros_like(wf)
    with torch.no_grad():
        for b in range(xg.shape[0]):
            xf = xg[b].float()
            dw += xf.T @ (xf @ wf)
    dw /= setup.global_batch * SIZE * SIZE
    err = float(torch.linalg.norm(g - dw) / torch.linalg.norm(dw))
    fmt = link_format_spec(setup.grad_quant, setup.dp_axis)
    tol = WIRE_FORMATS[fmt] if fmt else validation_tolerance(torch.bfloat16)
    del setup, x, w, g, xg, wf, dw
    torch.cuda.empty_cache()
    return {"rel_err": err, "tolerance": tol, "wire": fmt}


def train_phase(card: str, out_dir: str) -> dict:
    """`train bench` at bf16 SIZE, batch TRAIN_BATCH, over RING_WORLD ranks
    in the TRAIN_RUNS (the cache freed between runs, each run's peak memory
    beside the estimate), then `train selftest` over 8 ranks on the card.
    Each record passes `validate_train_record`, its five phases sum to its
    wall time, it validates against the dense fp32 reference
    (`train_tolerance`: the dtype's for the exact wire), no K1 ran, and the
    cell's synced gradient holds to the dense one (`train_grad_error`)."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.train import cli
    from tpu_matmul_bench_torch.train.harness import validate_train_record

    runs, problems = {}, []
    t0 = time.perf_counter()
    for extra in TRAIN_RUNS:
        label = " ".join(extra)
        path = f"{out_dir}/train-{re.sub(r'[^A-Za-z0-9]+', '-', label)}.jsonl"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cm.LAUNCHES = 0
        t1 = time.perf_counter()
        with ranks_per_card(RING_WORLD), contextlib.redirect_stdout(sys.stderr):
            records = cli.main(["bench", "--sizes", str(SIZE), "--dtype", "bfloat16",
                                "--batch", str(TRAIN_BATCH), "--num-devices", str(RING_WORLD),
                                "--iterations", str(TRAIN_ITERATIONS),
                                "--warmup", str(TRAIN_WARMUP), "--validate",
                                "--json-out", path, *extra])
        rec = records[0]
        t = rec.extras["train"]
        dp, tp = t["dp"], t["tp"]
        # a rank's x shard and forward batch, its w shard and dW, and the
        # fp32 update's temporaries (step.make_train_setup's estimate)
        est = RING_WORLD * SIZE * SIZE * (2 * (2 * t["local_batch"] + 2 / tp) + 4 * 2 / tp)
        runs[label] = {"avg_ms": rec.avg_time_s * 1e3,
                       "phases_ms": {k.removesuffix("_s"): v * 1e3
                                     for k, v in t["phases"].items()},
                       "wall_ms": t["wall_s"] * 1e3, "phase_sum_ms": t["phase_sum_s"] * 1e3,
                       "compute_ms": rec.compute_time_s * 1e3, "comm_ms": rec.comm_time_s * 1e3,
                       "tflops_total": rec.tflops_total, "dp": dp, "tp": tp,
                       "update_drift": t["update_drift"], "wire": t.get("wire"),
                       "validation": rec.extras.get("validation"),
                       "validation_max_rel_err": rec.extras.get("validation_max_rel_err"),
                       "validation_tolerance": rec.extras.get("validation_tolerance"),
                       "estimated_gib": est / 2**30,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "k1_launches": cm.LAUNCHES, "seconds": time.perf_counter() - t1}
        for p in validate_train_record(rec):
            problems.append(f"{label}: {p}")
        if abs(t["phase_sum_s"] - t["wall_s"]) > 1e-6 * len(t["phases"]):
            problems.append(f"{label}: phases sum {t['phase_sum_s']} != wall {t['wall_s']}")
        if rec.extras.get("validation") != "ok":
            problems.append(f"{label}: validation {rec.extras.get('validation')} "
                            f"({rec.extras.get('validation_max_rel_err')})")
        if cm.LAUNCHES:
            problems.append(f"{label}: {cm.LAUNCHES} K1 launches in the train step")
        if ("--grad-quant" in extra) != bool(t["update_drift"]):
            problems.append(f"{label}: drift series {t['update_drift']}")
        del records, rec
        torch.cuda.empty_cache()
        grad = runs[label]["grad_vs_dense"] = train_grad_error(extra)
        if not grad["rel_err"] <= grad["tolerance"]:
            problems.append(f"{label}: the synced gradient is {grad['rel_err']} from the "
                            f"dense one (tolerance {grad['tolerance']})")
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    selftest = io.StringIO()
    try:
        with ranks_per_card(8), contextlib.redirect_stdout(selftest):
            cli.main(["selftest"])
        selftest_rc = 0
    except SystemExit as e:
        selftest_rc = e.code
    print(selftest.getvalue(), file=sys.stderr)
    if selftest_rc:
        problems.append(f"train selftest exited {selftest_rc}: "
                        f"{selftest.getvalue().strip().splitlines()[-3:]}")
    summary = {"phase": "train", "card": card, "size": SIZE, "batch": TRAIN_BATCH,
               "ranks": RING_WORLD, "runs": runs,
               "selftest": {"rc": selftest_rc,
                            "lines": selftest.getvalue().strip().splitlines()[-6:],
                            "seconds": time.perf_counter() - t1},
               "seconds": time.perf_counter() - t0, "ok": not problems}
    emit(summary)
    if problems:
        fail("train", "; ".join(problems))
    return summary


def trace_kernels(path: str) -> list[tuple[str, tuple | None, float]]:
    """(name, grid or None, device µs) of each kernel in a torch.profiler
    trace."""
    from tpu_matmul_bench_torch.utils import profiling

    out = []
    for e in profiling.device_events(profiling.load_events(path)):
        if str(e.get("cat", "")).lower() == "kernel":
            grid = (e.get("args") or {}).get("grid")
            out.append((e["name"], tuple(grid) if grid else None, float(e["dur"])))
    return out


@contextlib.contextmanager
def profiled_loads(paths: list[str], stem: str, pod: bool = False):
    """Each serve load window run inside the block (`serve/service.py
    _run_load`, or with `pod` `serve/pod.py _run_pod_load`: the producer and
    the workers, after the prewarm and before the record is made) traced by
    torch.profiler, the card's activity only, after a warm-up step that is
    traced and dropped (a kernel launched right after the profiler's start
    can be missed: one request's of 1953 was on an H100); each trace's path
    is appended to `paths`."""
    import torch

    from tpu_matmul_bench_torch.serve import pod as pod_module
    from tpu_matmul_bench_torch.serve import service

    module, name = (pod_module, "_run_pod_load") if pod else (service, "_run_load")
    real = getattr(module, name)

    def traced(*args, **kw):
        path = f"{stem}-{len(paths)}.json"
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.1)
            prof.step()
            out = real(*args, **kw)
            prof.step()
        paths.append(path)
        return out

    setattr(module, name, traced)
    try:
        yield paths
    finally:
        setattr(module, name, real)


def runs_k1(label: str, kind: str) -> bool:
    """Whether a serve bucket's requests run K1: its impl is `cuda`, or
    `auto` and `resolve_route` routes its problem to `cuda` on the committed
    DB."""
    from tpu_matmul_bench_torch.ops.impl_select import resolve_route

    dims, dtype, impl = label.split("/")
    if impl != "auto":
        return impl == "cuda"
    m, k, n = (int(v) for v in dims.split("x"))
    return resolve_route(m, n, k, kind, dtype)[0].impl == "cuda"


def serve_buckets(impl: str, dtype_name: str, mix: str) -> dict:
    """Each bucket of `mix` under `impl`, its executable built through the
    serve cache over its pooled operands (`serve/service.py _make_cache`, a
    CUDA graph of one product): its product once against the plain version
    (TOLERANCE: bf16 1e-2, int8 exact), its cold and warm ms, its replay's ms
    between CUDA events over SERVE_REPLAYS replays, and the device µs a
    replay of its kernels in a torch.profiler trace of SERVE_REPLAYS replays
    (K1's, with their (name, grid), and all of them)."""
    import torch

    from tpu_matmul_bench_torch.obs import attribution
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.serve import service
    from tpu_matmul_bench_torch.serve.cache import ExecKey
    from tpu_matmul_bench_torch.serve.queue import ShapeGrid

    kind = torch.cuda.get_device_name(0)
    config = service.ServeConfig(mix=mix, dtype_name=dtype_name, matmul_impl=impl,
                                 device="cuda")
    pool = service._OperandPool(config.seed, torch.device("cuda", 0))
    cache = service._make_cache(config, kind, pool)
    grid, rows = ShapeGrid(), {}
    os.makedirs("build/profile/serve", exist_ok=True)
    for e in config.mix_entries:
        key = ExecKey(*grid.bucket(e.m, e.k, e.n), dtype=dtype_name, impl=impl)
        entry = cache.get(key)
        a, b = pool.get(key)
        got = entry.compiled(a, b)
        want = cm.matmul_plain(a, b)
        torch.cuda.synchronize()
        diff = (got.double() - want.double()).abs().max().item()
        rel = diff / (want.double().abs().max().item() or 1.0)
        finite = bool(torch.isfinite(got.double()).all().item())
        del want
        replay_ms = events_ms(lambda: entry.compiled(a, b), SERVE_REPLAYS)
        path = f"build/profile/serve/replays-{key.label.replace('/', '-')}.json"
        want_k1 = SERVE_REPLAYS if runs_k1(key.label, kind) else 0
        # a warm-up step first, traced and dropped: a profiler started again
        # in a process that had traced before recorded 7 of the 20 replays
        # that followed its start at once. The profiler can still lose a
        # graph replay's kernel record (19 of 20 int8 K1 kernels seen once
        # on an H100): a trace short of the replays is taken again, up to
        # SERVE_TRACES times, and each trace's count is held exactly
        for attempt in range(1, SERVE_TRACES + 1):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA],
                    schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
                    on_trace_ready=lambda p, path=path: p.export_chrome_trace(path)) as prof:
                for _ in range(2):
                    for _ in range(SERVE_REPLAYS):
                        entry.compiled(a, b)
                    torch.cuda.synchronize()
                    prof.step()
            kernels = trace_kernels(path)
            k1 = [k for k in kernels if K1_KERNEL.search(k[0])]
            if len(k1) >= want_k1:
                break
        rows[f"{key.m}x{key.k}x{key.n}/{dtype_name}"] = {
            "impl": impl, "max_abs_err": diff, "max_rel_err": rel,
            "tolerance": TOLERANCE[dtype_name],
            "cold_compile_ms": entry.cold_compile_s * 1e3,
            "warm_dispatch_ms": entry.warm_dispatch_s * 1e3, "replay_ms": replay_ms,
            "k1_kernels": len(k1), "k1_kernel_ms": sum(k[2] for k in k1) / len(k1) / 1e3
            if k1 else None,
            "kernels_ms_a_replay": sum(k[2] for k in kernels) / SERVE_REPLAYS / 1e3,
            "k1_signatures": sorted({(k[0], k[1]) for k in k1}, key=str),
            "bound_ms": attribution.bound(key.m, key.n, key.k, getattr(torch, dtype_name),
                                          kind)[0],
            "cost": entry.cost, "traces": attempt,
            "ok": finite and tuple(got.shape) == (key.m, key.n)
            and rel <= TOLERANCE[dtype_name] and len(k1) == want_k1}
    del cache, pool
    torch.cuda.empty_cache()
    return rows


def serve_run(label: str, argv: list[str], out_dir: str, traced: bool = True,
              pod: bool = False) -> dict:
    """One `serve` run through `serve.cli.main` in process, with K1's launch
    count set to 0 just before and read just after; `traced`, it writes its
    ledger (`--json-out`) and its load windows are traced
    (`profiled_loads`, the pod's with `pod`). Returns its records (read back
    from the ledger when there is one), the ledger's lines, the traces, the
    launches, the requests the registry counted as failed, and its exit
    code."""
    from tpu_matmul_bench_torch.obs.registry import get_registry
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.serve import cli as serve_cli
    from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord

    def failures() -> float:
        return get_registry().snapshot()["counters"].get("serve_request_failures_total", 0)

    ledger, traces, rc = f"{out_dir}/serve-{label}.jsonl", [], 0
    os.makedirs("build/profile/serve", exist_ok=True)
    failed = failures()
    cm.LAUNCHES = 0
    before = routes()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr), \
            profiled_loads(traces, f"build/profile/serve/{label}", pod) if traced \
            else contextlib.nullcontext():
        try:
            records = serve_cli.main([*argv, "--json-out", ledger] if traced else argv)
        except SystemExit as e:
            rc, records = e.code, []
    seconds = time.perf_counter() - t0
    launches, by_route = cm.LAUNCHES, routes_since(before)
    lines = []
    if traced:
        with open(ledger) as fh:
            lines = [json.loads(line) for line in fh if line.strip()]
        records = [BenchmarkRecord.from_json(json.dumps(d)) for d in lines
                   if d.get("benchmark") == "serve"]
    return {"records": records, "lines": lines, "traces": traces, "launches": launches,
            "launches_by_route": by_route, "failed": failures() - failed, "rc": rc,
            "seconds": seconds, "ledger": ledger, "traced": traced}


def serve_summary(label: str, run: dict, kind: str, signatures: dict,
                  k1_a_request: int | None = 1, prewarmed: bool = True) -> tuple[dict, list]:
    """A serve run's headlines by record (latency percentiles, QPS, each
    bucket's count, cold and warm ms) and its window's K1 kernels and device
    busy share, with the contract's problems: a record that fails
    `validate_serve_record`, a failed request (registry, batch lines, span
    records), a cold request (when the run prewarms), and K1 kernels in a
    window other than `k1_a_request` a request of its K1 buckets (one; a
    pod's group ranks; None: read, not counted), by bucket where the trace
    gives kernels' grids (`signatures`: each bucket's (name, grid) from its
    replays) and in all."""
    from tpu_matmul_bench_torch.serve.service import validate_serve_record

    problems = [f"{label}: {p}" for rec in run["records"] for p in validate_serve_record(rec)]
    batch_failed = sum(d.get("failed", 0) for d in run["lines"]
                       if d.get("record_type") == "serve_batch")
    span_failed = sum(1 for d in run["lines"]
                      if d.get("record_type") == "serve_span" and d.get("state") == "failed")
    if run["failed"] or batch_failed or span_failed:
        problems.append(f"{label}: failed requests (registry {run['failed']}, batch lines "
                        f"{batch_failed}, span records {span_failed})")
    if not run["records"] or run["traced"] and len(run["traces"]) != len(run["records"]):
        problems.append(f"{label}: {len(run['traces'])} traced windows for "
                        f"{len(run['records'])} records")
    windows = []
    for i, rec in enumerate(run["records"]):
        s = rec.extras["serve"]
        if s["cold_requests"] and prewarmed:
            problems.append(f"{label}: {s['cold_requests']} cold requests in a prewarmed window")
        window = {
            "scheduler": s["scheduler"], "requests": s["requests"], "shed": s["shed"],
            "achieved_qps": s["achieved_qps"], "offered_qps": s.get("offered_qps"),
            "p50_ms": s["p50_ms"], "p95_ms": s["p95_ms"], "p99_ms": s["p99_ms"],
            "max_ms": s["max_ms"], "service_p50_ms": s["service_p50_ms"],
            "wait_p99_ms": s["wait_p99_ms"], "wall_s": s["wall_s"],
            "goodput_qps": s["goodput_qps"], "cold_requests": s["cold_requests"],
            "buckets": {b: {"count": r["count"], "p50_ms": r["p50_ms"], "p99_ms": r["p99_ms"],
                            "impl_source": r.get("impl_source")}
                        for b, r in s["buckets"].items()},
            "by_entry": s["cache"]["by_entry"], "explore": s.get("explore"),
            "ab": rec.extras.get("ab"), "cost_analysis": rec.extras.get("cost_analysis"),
            "pod": s.get("pod"), "artifacts": s["cache"].get("artifacts"),
            "preload": s["cache"]["preload"]}
        windows.append(window)
        if not run["traced"]:
            continue
        kernels = trace_kernels(run["traces"][i])
        k1 = [k for k in kernels if K1_KERNEL.search(k[0])]
        by_bucket = {}
        for bucket, row in s["buckets"].items():
            if not runs_k1(bucket, kind):
                continue
            sig = {tuple(x) for x in signatures.get(bucket.rsplit("/", 1)[0], [])}
            counted = sum(1 for k in k1 if (k[0], k[1]) in sig) \
                if sig and all(g is not None for _, g in sig) else None
            by_bucket[bucket] = {"requests": row["count"], "k1_kernels": counted}
            if counted is not None and counted != row["count"]:
                problems.append(f"{label}: bucket {bucket} ran {counted} K1 kernels for "
                                f"{row['count']} requests")
        want = (k1_a_request or 0) * sum(row["count"] for bucket, row in s["buckets"].items()
                                         if runs_k1(bucket, kind))
        if k1_a_request is not None and len(k1) != want:
            problems.append(f"{label}: {len(k1)} K1 kernels in the window, {want} for the "
                            f"requests of K1 buckets ({k1_a_request} a request)")
        # fewer K1 kernels than requests, nowhere more: records the profiler
        # lost, or requests that ran no kernel (serve_traced runs such a
        # window again; a program at fault stays short)
        counts = [(b["k1_kernels"], b["requests"]) for b in by_bucket.values()
                  if b["k1_kernels"] is not None]
        if k1_a_request is not None:
            counts.append((len(k1), want))
        window.update(k1_kernels=len(k1), k1_by_bucket=by_bucket,
                      k1_short=any(got < n for got, n in counts)
                      and all(got <= n for got, n in counts),
                      device_busy_share=sum(k[2] for k in kernels) / (s["wall_s"] * 1e6))
    return {"seconds": run["seconds"], "rc": run["rc"], "launches": run["launches"],
            "launches_by_route": run["launches_by_route"], "windows": windows}, problems


def serve_traced(label: str, argv: list[str], out_dir: str, kind: str, signatures: dict,
                 traced: bool = True, pod: bool = False, **summary_kw
                 ) -> tuple[dict, dict, list]:
    """`serve_run` then `serve_summary`. The profiler can lose a graph
    replay's kernel record (9 of 12268 K1 records in one pod window on an
    H100): a traced window whose only problems are K1 counts short of its
    requests, never above them, is run and traced again, up to
    SERVE_TRACES times, and each run's counts are held exactly. Returns
    (run, summary, problems) of the last run; the summary's `runs` says how
    many were made."""
    for attempt in range(1, SERVE_TRACES + 1):
        run = serve_run(label, argv, out_dir, traced=traced, pod=pod)
        summary, found = serve_summary(label, run, kind, signatures, **summary_kw)
        shortfall = all("K1 kernels" in p for p in found) and any(
            w.get("k1_short") for w in summary["windows"])
        if not (found and shortfall and traced):
            break
    summary["runs"] = attempt
    return run, summary, found


def ab_run(label: str, argv: list[str]) -> tuple[dict, list]:
    """One `serve ab` run through `serve.cli.main` in process, bare: no
    ledger and no profiler, whose host stalls moved the verdict (ROADMAP
    C4). The verdict is read where `serve/service.py _ab_verdict` returns it
    (`ab --mesh` reaches it too). Exit 1 with a regressed verdict is a
    finding, recorded on the phase's line; any other nonzero exit, a missing
    verdict, or an exit that disagrees with the verdict is a problem."""
    from tpu_matmul_bench_torch.serve import cli as serve_cli
    from tpu_matmul_bench_torch.serve import service

    verdicts, real = [], service._ab_verdict

    def captured(*args, **kw):
        verdicts.append(real(*args, **kw))
        return verdicts[-1]

    service._ab_verdict = captured
    rc, t0 = 0, time.perf_counter()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            serve_cli.main(argv)
    except SystemExit as e:
        rc = e.code
    finally:
        service._ab_verdict = real
    verdict = verdicts[-1] if verdicts else None
    problems = []
    if verdict is None:
        problems.append(f"{label}: no verdict (exit {rc})")
    elif rc not in (0, 1) or (rc == 1) != bool(verdict["regressed"]):
        problems.append(f"{label}: exit {rc} with verdict regressed={verdict['regressed']}")
    return {"rc": rc, "verdict": verdict, "seconds": time.perf_counter() - t0,
            "finding": "regressed" if rc == 1 and verdict and verdict["regressed"] else None,
            }, problems


def serve_phase(card: str, out_dir: str) -> dict:
    """The serving path on the card (the `serve` phase), through
    `serve.cli.main` in process: each bucket's executable alone first
    (`serve_buckets`: bf16 under `cuda` and `torch`, int8 under `auto`);
    then `bench` at SERVE_QPS open loop under `cuda` and under `torch` (the
    same request stream), closed loop at SERVE_CONCURRENCY under `cuda`,
    `ab` under `cuda` bare (`ab_run`: its verdict recorded, a regression a
    finding), `bench --explore SERVE_EXPLORE` under `auto` (the
    committed DB routes these bf16 problems to cuBLAS, so an explored
    request runs K1, the runner-up), and int8 under `auto`; every run
    prewarmed, its load windows traced (`serve_summary` has the checks).
    The instrumentation's cost beside them: both open loops again with no
    ledger and no profiler, and the closed loop with its ledger alone and
    with neither.
    Then `selftest`, `trace selftest`, `tune online selftest` and `explain
    --slowest 3` on the `cuda` bench's ledger, each trace reconciled.
    Fails on any problem; returns the `kernels` line's serve block."""
    import torch

    from tpu_matmul_bench_torch.ops.impl_select import resolve_route
    from tpu_matmul_bench_torch.serve import cli as serve_cli
    from tpu_matmul_bench_torch.tune import cli as tune_cli

    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    problems = []
    buckets = {"cuda": serve_buckets("cuda", "bfloat16", SERVE_MIX),
               "torch": serve_buckets("torch", "bfloat16", SERVE_MIX),
               "int8_auto": serve_buckets("auto", "int8", SERVE_INT8_MIX)}
    problems += [f"buckets[{impl}] {b}: product or kernels off (rel {r['max_rel_err']}, "
                 f"{r['k1_kernels']} K1 kernels in {SERVE_REPLAYS} replays)"
                 for impl, rows in buckets.items() for b, r in rows.items() if not r["ok"]]
    signatures = {b: r["k1_signatures"] for rows in buckets.values() for b, r in rows.items()
                  if r["k1_signatures"]}
    load = ["--mix", SERVE_MIX, "--dtype", "bfloat16", "--seed", "0", "--prewarm",
            "--duration", str(SERVE_DURATION)]
    open_loop = ["--qps", str(SERVE_QPS)]
    argvs = {
        "bench_cuda": ["bench", *load, *open_loop, "--matmul-impl", "cuda"],
        "bench_torch": ["bench", *load, *open_loop, "--matmul-impl", "torch"],
        "closed_cuda": ["bench", *load, "--concurrency", str(SERVE_CONCURRENCY),
                        "--matmul-impl", "cuda"],
        "explore_auto": ["bench", *load, *open_loop, "--matmul-impl", "auto",
                         "--explore", str(SERVE_EXPLORE)],
        "int8_auto": ["bench", "--mix", SERVE_INT8_MIX, "--dtype", "int8", "--seed", "0",
                      "--prewarm", "--duration", str(SERVE_DURATION),
                      "--qps", str(SERVE_INT8_QPS), "--matmul-impl", "auto"],
    }
    # the instrumentation's cost: the open loops with no ledger (so no
    # fsynced batch and span lines) and no profiler, and the closed loop
    # with its ledger alone and with neither
    bare = {"bench_cuda_bare": argvs["bench_cuda"], "bench_torch_bare": argvs["bench_torch"],
            "closed_cuda_ledger": argvs["closed_cuda"], "closed_cuda_bare": argvs["closed_cuda"]}
    runs, summaries = {}, {}
    for label, argv in {**argvs, **bare}.items():
        if label == "closed_cuda_ledger":
            argv = [*argv, "--json-out", f"{out_dir}/serve-{label}.jsonl"]
        runs[label], summaries[label], found = serve_traced(
            label, argv, out_dir, kind, signatures, traced=label not in bare)
        problems += found
        if runs[label]["rc"]:
            problems.append(f"{label}: exit {runs[label]['rc']}")
    ab, found = ab_run("ab_cuda", ["ab", *load, *open_loop, "--matmul-impl", "cuda"])
    problems += found
    def window(label: str) -> dict:
        return summaries[label]["windows"][0]

    cuda, lib = window("bench_cuda"), window("bench_torch")
    if runs["bench_cuda"]["launches"] <= 0:
        problems.append("the cuda bench launched no K1 (prewarm's first calls and captures)")
    ratios = {f"{p}{label}": window(f"bench_cuda{label}")[p] / window(f"bench_torch{label}")[p]
              for label in ("", "_bare")
              for p in ("p50_ms", "p95_ms", "p99_ms", "max_ms", "service_p50_ms")}
    # the same request stream under both impls
    streams = [[(d["rid"], d["bucket"]) for d in runs[label]["lines"]
                if d.get("record_type") == "serve_span"] for label in ("bench_cuda", "bench_torch")]
    if sorted(streams[0]) != sorted(streams[1]):
        problems.append("the cuda and torch benches did not serve the same request stream")
    explore = summaries["explore_auto"]["windows"][0]
    ex = explore["explore"] or {}
    explored_warm = sum(r["count"] for b, r in explore["buckets"].items() if b.endswith("/cuda"))
    if not ex or ex["explored"] > SERVE_EXPLORE * ex["seen"]:
        problems.append(f"explorer over its budget: {ex}")
    if explore["k1_kernels"] != explored_warm or ex.get("explored") != explored_warm:
        problems.append(f"explore: {explore['k1_kernels']} K1 kernels, {explored_warm} explored "
                        f"warm requests, {ex.get('explored')} explored")
    int8 = summaries["int8_auto"]["windows"][0]
    routed = {}
    for bucket, row in int8["buckets"].items():
        m, k, n = (int(v) for v in bucket.split("/")[0].split("x"))
        choice = resolve_route(m, n, k, kind, "int8")[0]
        routed[bucket] = {"impl": choice.impl, "source": choice.source,
                          "impl_source": row["impl_source"]}
        if row["impl_source"] != choice.source:
            problems.append(f"int8 {bucket}: impl_source {row['impl_source']}, "
                            f"resolve_route says {choice.source}")
    if set(int8["cost_analysis"] or {}) != {b for b, r in routed.items() if r["impl"] == "cuda"}:
        problems.append(f"int8: cost_analysis for {sorted(int8['cost_analysis'] or {})}, "
                        f"routed to cuda {routed}")
    # the CI hooks, and `explain` on the cuda bench's ledger
    explained = io.StringIO()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            serve_cli.main(["selftest"])
            serve_cli.main(["trace", "selftest"])
            tune_cli.main(["online", "selftest"])
        with contextlib.redirect_stdout(explained):
            serve_cli.main(["explain", "--ledger", runs["bench_cuda"]["ledger"],
                            "--slowest", "3"])
    except SystemExit as e:
        problems.append(f"a selftest or explain exited {e.code}")
    reconciled = [line for line in explained.getvalue().splitlines()
                  if "reconciliation:" in line]
    print(explained.getvalue(), file=sys.stderr)
    if len(reconciled) != 3 or not all(line.endswith("ok") for line in reconciled):
        problems.append(f"explain --slowest 3: {reconciled}")
    result = {"phase": "serve", "card": card, "mix": SERVE_MIX, "qps": SERVE_QPS,
              "duration_s": SERVE_DURATION, "buckets": buckets, "runs": summaries,
              "cuda_over_torch": ratios, "int8_routes": routed,
              "explained": reconciled, "ab_cuda": ab, "seconds": time.perf_counter() - t0,
              "ok": not problems, "problems": problems}
    emit(result)
    if problems:
        fail("serve", "; ".join(problems[:10]))
    return {"launches": runs["bench_cuda"]["launches"],
            "launches_by_route": runs["bench_cuda"]["launches_by_route"],
            "k1_kernels": cuda["k1_kernels"], "requests": cuda["requests"],
            "p50_ms": cuda["p50_ms"], "p99_ms": cuda["p99_ms"],
            "torch_p50_ms": lib["p50_ms"], "torch_p99_ms": lib["p99_ms"],
            "bare_p50_ms": window("bench_cuda_bare")["p50_ms"],
            "bare_p99_ms": window("bench_cuda_bare")["p99_ms"],
            "torch_bare_p50_ms": window("bench_torch_bare")["p50_ms"],
            "torch_bare_p99_ms": window("bench_torch_bare")["p99_ms"],
            "closed_loop_qps": {label: window(label)["achieved_qps"]
                                for label in ("closed_cuda", "closed_cuda_ledger",
                                              "closed_cuda_bare")},
            "buckets": {b: {k: r[k] for k in ("warm_dispatch_ms", "replay_ms", "k1_kernel_ms",
                                              "bound_ms", "max_abs_err")}
                        for b, r in buckets["cuda"].items()},
            "ab_cuda": {"rc": ab["rc"], "finding": ab["finding"],
                        "verdict": ab["verdict"]}}


def pod_config(mesh_spec: str, quant: str | None = None):
    """A pod ServeConfig of the slice 16 cells: SERVE_MIX, bf16, seed 0,
    under `cuda`, in POD_GROUPS groups."""
    from tpu_matmul_bench_torch.serve import service

    return service.ServeConfig(mix=SERVE_MIX, dtype_name="bfloat16", matmul_impl="cuda",
                               device="cuda", mesh=mesh_spec, replica_groups=POD_GROUPS,
                               comm_quant=quant, prewarm=True)


def pod_buckets(mesh_spec: str, quant: str | None, tolerance: float) -> dict:
    """Each group executable of a pod cell built as the pod arm builds it
    (`serve/pod.py _group_caches`: one CUDA graph of the group's program, K1
    on every rank and the gathers, replayed on the group's stream), one
    replay held rank by rank to the plain product of the pooled operands
    (`cuda_matmul.matmul_plain`) at `tolerance`; its K1 launches counted
    while it is built (the eager first call's and the capture's,
    POD_K1_A_REQUEST each, on wgmma: a replay runs every node the capture
    recorded); the device µs of its K1 kernels and of all its kernels in a
    torch.profiler trace of SERVE_REPLAYS replays, and a replay's host ms
    with its wait."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.serve import pod, service
    from tpu_matmul_bench_torch.serve.placement import group_meshes
    from tpu_matmul_bench_torch.serve.queue import ShapeGrid

    config = pod_config(mesh_spec, quant)
    devices, info = pod._pod_devices(config)
    pairs = group_meshes(devices, mesh_spec, POD_GROUPS)
    base = service._OperandPool(config.seed, devices[0])
    gpools, caches = pod._group_caches(config, info, [m for _, m in pairs], base, None)
    rows = {}
    for gi, (group, mesh) in enumerate(pairs):
        for key in pod._group_keys(config, ShapeGrid(), group, mesh, config.tenant_specs):
            a, b = gpools[gi].get(key)
            before = routes()
            entry = caches[gi].get(key)
            built = routes_since(before)
            out = entry.compiled(a, b)
            entry.compiled.wait()
            want = cm.matmul_plain(*base.get(key)).double()
            scale = want.abs().max().item() or 1.0
            errs = [(o.double() - want).abs().max().item() for o in out]
            finite = all(bool(torch.isfinite(o.double()).all().item()) for o in out)
            del want
            path = (f"build/profile/serve/pod-{mesh_spec.replace(':', '').replace(',', '-')}"
                    f"-g{gi}-{key.label.replace('/', '-')}.json")
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA],
                    schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
                    on_trace_ready=lambda p, path=path: p.export_chrome_trace(path)) as prof:
                for _ in range(2):
                    for _ in range(SERVE_REPLAYS):
                        entry.compiled(a, b)
                    torch.cuda.synchronize()
                    prof.step()
            kernels = trace_kernels(path)
            k1 = [k for k in kernels if K1_KERNEL.search(k[0])]
            t0 = time.perf_counter()
            for _ in range(SERVE_REPLAYS):
                entry.compiled(a, b)
                entry.compiled.wait()
            host_ms = (time.perf_counter() - t0) * 1e3 / SERVE_REPLAYS
            rel = max(errs) / scale
            rows[f"g{gi}:{key.label}"] = {
                "placement": group.placement, "ranks": len(out),
                "rank_product": [key.m // (mesh.dims[0] if len(mesh.dims) == 2 else 1), key.k,
                                 key.n // mesh.dims[-1]],
                "max_abs_err": max(errs), "max_rel_err": rel, "tolerance": tolerance,
                "k1_launches_built": built,
                "k1_kernels_traced": len(k1),
                "k1_kernel_ms": sum(k[2] for k in k1) / len(k1) / 1e3 if k1 else None,
                "kernels_ms_a_replay": sum(k[2] for k in kernels) / SERVE_REPLAYS / 1e3,
                "replay_wait_ms": host_ms, "cold_compile_ms": entry.cold_compile_s * 1e3,
                "cost": entry.cost,
                "ok": finite and rel <= tolerance and all(tuple(o.shape) == (key.m, key.n)
                                                          for o in out)
                and built == {"gemm:wgmma": 2 * POD_K1_A_REQUEST} and bool(k1)}
    del caches, gpools, base
    torch.cuda.empty_cache()
    return rows


def pod_rank_products(card: str) -> dict:
    """K1 and cuBLAS at each per-rank product of the pod cells
    (POD_RANK_SHAPES), CUDA events over 20 calls each in turns (K1,
    library, library, K1), beside the bound."""
    import torch

    from tpu_matmul_bench_torch.obs import attribution
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops.matmul import random_operands

    name = torch.cuda.get_device_name(0)
    rows = {}
    for m, k, n in POD_RANK_SHAPES:
        (a,) = random_operands(0, (m, k), torch.bfloat16, device="cuda", count=1)
        (b,) = random_operands(1, (k, n), torch.bfloat16, device="cuda", count=1)
        c = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        turns = [events_ms(lambda: cm.cuda_matmul(a, b, out=c), 20),
                 events_ms(lambda: torch.matmul(a, b, out=c), 20),
                 events_ms(lambda: torch.matmul(a, b, out=c), 20),
                 events_ms(lambda: cm.cuda_matmul(a, b, out=c), 20)]
        bound_ms, bound_by = attribution.bound(m, n, k, torch.bfloat16, name)
        rows[f"{m}x{k}x{n}"] = {"ms": (turns[0] + turns[3]) / 2,
                                "library_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
                                "bound_ms": bound_ms, "bound_by": bound_by, "card": card}
        del a, b, c
    torch.cuda.empty_cache()
    return rows


def pod_warm_start(out_dir: str) -> tuple[dict, list]:
    """The two-process warm start from the kernel-library store: run 1 in
    this checkout (its library already built) exports into a store under
    `out_dir`; run 2 in a copy of the package and this script whose build
    directory starts empty, with an `nvcc` first on PATH that records its
    call and fails. Each run is `chip_smoke.py --pod-warm-start` (a pod
    bench at POD_MESH with `--artifacts`, then every group executable's
    output bytes digested). Run 2 must start nvcc zero times, take every
    preload from the store, serve no cold request, serve its buckets from
    `artifact`, and give bitwise run 1's outputs."""
    import shutil

    repo = os.path.dirname(os.path.abspath(__file__))
    store = os.path.join(out_dir, "pod-store")
    copy = tempfile.mkdtemp(prefix="pod-warm-")
    shutil.copytree(os.path.join(repo, "tpu_matmul_bench_torch"),
                    os.path.join(copy, "tpu_matmul_bench_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.abspath(__file__), copy)
    fakebin, marker = os.path.join(copy, "fakebin"), os.path.join(copy, "nvcc-called")
    os.makedirs(fakebin)
    with open(os.path.join(fakebin, "nvcc"), "w") as fh:
        fh.write(f"#!/bin/sh\necho \"$@\" >> {marker}\nexit 1\n")
    os.chmod(os.path.join(fakebin, "nvcc"), 0o755)
    env = {**os.environ, "TMB_RANKS_PER_CARD": str(POD_RANKS)}
    runs, problems = {}, []
    try:
        for label, cwd, extra in (("run1", repo, {}),
                                  ("run2", copy, {"PATH": f"{fakebin}:{os.environ['PATH']}"})):
            out = os.path.join(out_dir, f"pod-warm-{label}.json")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "chip_smoke.py", "--pod-warm-start", store, out],
                                  cwd=cwd, env={**env, **extra}, capture_output=True, text=True,
                                  timeout=600)
            print(proc.stderr[-4000:], file=sys.stderr)
            if proc.returncode != 0:
                problems.append(f"{label}: exit {proc.returncode}: {proc.stderr[-400:]}")
                return {"runs": runs}, problems
            with open(out) as fh:
                runs[label] = json.load(fh)
            runs[label]["seconds"] = time.perf_counter() - t0
        run1, run2 = runs["run1"], runs["run2"]
        count = run1["preload"]["count"]
        if not count or run1["preload"]["compiled"] != count \
                or run1["artifacts"]["exports"] != count:
            problems.append(f"run1 did not build and export every executable: "
                            f"{run1['preload']}, {run1['artifacts']}")
        if run2["nvcc_runs"] or os.path.exists(marker):
            problems.append(f"run2 started nvcc {run2['nvcc_runs']} times")
        if run2["preload"]["deserialized"] != count or run2["preload"]["compiled"] \
                or run2["artifacts"]["hits"] != count:
            problems.append(f"run2 did not import every executable: {run2['preload']}, "
                            f"{run2['artifacts']}")
        if run2["cold_requests"] or not run2["requests"] or run2["failed"]:
            problems.append(f"run2: {run2['cold_requests']} cold, {run2['failed']} failed of "
                            f"{run2['requests']} requests")
        if set(run2["impl_sources"].values()) != {"artifact"}:
            problems.append(f"run2 impl_source {run2['impl_sources']}")
        if not run1["digests"] or run1["digests"] != run2["digests"]:
            problems.append("run2's outputs are not run 1's bitwise")
    finally:
        shutil.rmtree(copy, ignore_errors=True)
    return {"runs": runs, "store": store}, problems


def pod_warm_start_child(store: str, out_path: str) -> None:
    """One process of the warm start (`--pod-warm-start STORE OUT`): a pod
    bench at POD_MESH under `cuda` with `--artifacts STORE` (prewarmed: each
    executable imported from the store, or built and exported), then each
    group executable built again over the store and replayed once, its
    output bytes digested; writes the counts, sources and digests to OUT."""
    import hashlib

    import torch

    from tpu_matmul_bench_torch.obs.registry import get_registry
    from tpu_matmul_bench_torch.ops import _build
    from tpu_matmul_bench_torch.serve import cli as serve_cli
    from tpu_matmul_bench_torch.serve import pod, service
    from tpu_matmul_bench_torch.serve.placement import group_meshes
    from tpu_matmul_bench_torch.serve.queue import ShapeGrid
    from tpu_matmul_bench_torch.tune.artifacts import ArtifactStore

    with contextlib.redirect_stdout(sys.stderr):
        (rec,) = serve_cli.main(["bench", "--mesh", POD_MESH, "--replica-groups",
                                 str(POD_GROUPS), "--mix", SERVE_MIX, "--dtype", "bfloat16",
                                 "--seed", "0", "--prewarm", "--qps", "200", "--duration", "1",
                                 "--matmul-impl", "cuda", "--artifacts", store])
    s = rec.extras["serve"]
    config = dataclasses.replace(pod_config(POD_MESH), artifacts=store)
    devices, info = pod._pod_devices(config)
    pairs = group_meshes(devices, POD_MESH, POD_GROUPS)
    gpools, caches = pod._group_caches(
        config, info, [m for _, m in pairs], service._OperandPool(config.seed, devices[0]),
        pod._LockedStore(ArtifactStore.load(store)))
    digests = {}
    for gi, (group, mesh) in enumerate(pairs):
        keys = pod._group_keys(config, ShapeGrid(), group, mesh, config.tenant_specs)
        caches[gi].warm_start(keys)
        for key in keys:
            entry = caches[gi].get(key)
            out = entry.compiled(*gpools[gi].get(key))
            entry.compiled.wait()
            h = hashlib.sha256()
            for t in out:
                h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
            digests[f"g{gi}:{key.label}"] = h.hexdigest()
    result = {
        "nvcc_runs": _build.NVCC_RUNS, "requests": s["requests"],
        "cold_requests": s["cold_requests"], "preload": s["cache"]["preload"],
        "artifacts": s["cache"]["artifacts"],
        "failed": get_registry().snapshot()["counters"].get("serve_request_failures_total", 0),
        "sources": {label: row["source"] for label, row in s["cache"]["by_entry"].items()},
        "impl_sources": {b: row.get("impl_source") for b, row in s["buckets"].items()},
        "build_dir": sorted(os.listdir(_build.BUILD_DIR)), "digests": digests}
    with open(out_path, "w") as fh:
        json.dump(result, fh)


def pod_phase(card: str, out_dir: str) -> dict:
    """Pod serving on the card (the `pod` phase), POD_RANKS ranks sharing it
    (TMB_RANKS_PER_CARD): `serve pod selftest`; each group executable of
    both pod cells against its plain version (`pod_buckets`: exact at
    TOLERANCE, the quantized cell within WIRE_FORMATS' fp8 bound); K1 and
    cuBLAS at the six per-rank products (`pod_rank_products`); then through
    `serve.cli.main`, SERVE_MIX at seed 0, prewarmed: `pod_cuda` (traced:
    POD_K1_A_REQUEST K1 kernels a request), `pod_torch`, `pod_closed_cuda`
    (SERVE_CONCURRENCY clients), `pod_quant_cuda` (POD_QUANT_MESH, the dcn
    gathers on an fp8-block:32 wire: its wire calls counted); `pod_cold_cuda`
    unprewarmed, so drain threads capture misses while the other group
    replays (no failed request); the two-process warm start
    (`pod_warm_start`); and `pod_ab_cuda` bare (`ab_run`). Fails on any
    problem; returns the `kernels` line's pod block."""
    import torch

    from tpu_matmul_bench_torch.parallel import collectives
    from tpu_matmul_bench_torch.serve import cli as serve_cli

    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    problems = []
    with ranks_per_card(POD_RANKS):
        try:
            with contextlib.redirect_stdout(sys.stderr):
                serve_cli.main(["pod", "selftest"])
            selftest = 0
        except SystemExit as e:
            selftest = e.code
        if selftest:
            problems.append(f"serve pod selftest exited {selftest}")
        wire_before = dict(collectives.WIRE_CALLS)
        buckets = {POD_MESH: pod_buckets(POD_MESH, None, TOLERANCE["bfloat16"]),
                   POD_QUANT_MESH: pod_buckets(POD_QUANT_MESH, POD_QUANT,
                                               WIRE_FORMATS["fp8"])}
        problems += [f"buckets[{mesh_spec}] {label}: product or kernels off (rel "
                     f"{r['max_rel_err']}, K1 launches while built {r['k1_launches_built']}, "
                     f"{r['k1_kernels_traced']} traced in {SERVE_REPLAYS} replays)"
                     for mesh_spec, rows in buckets.items()
                     for label, r in rows.items() if not r["ok"]]
        ranks = pod_rank_products(card)
        load = ["--mix", SERVE_MIX, "--dtype", "bfloat16", "--seed", "0",
                "--duration", str(SERVE_DURATION)]
        pod_flags = ["--mesh", POD_MESH, "--replica-groups", str(POD_GROUPS)]
        open_loop = ["--qps", str(SERVE_QPS)]
        argvs = {
            "pod_cuda": ["bench", *pod_flags, *load, *open_loop, "--prewarm",
                         "--matmul-impl", "cuda"],
            "pod_torch": ["bench", *pod_flags, *load, *open_loop, "--prewarm",
                          "--matmul-impl", "torch"],
            "pod_closed_cuda": ["bench", *pod_flags, *load, "--prewarm",
                                "--concurrency", str(SERVE_CONCURRENCY), "--matmul-impl", "cuda"],
            "pod_quant_cuda": ["bench", "--mesh", POD_QUANT_MESH, "--replica-groups",
                               str(POD_GROUPS), "--comm-quant", POD_QUANT, *load, *open_loop,
                               "--prewarm", "--matmul-impl", "cuda"],
            "pod_cold_cuda": ["bench", *pod_flags, "--mix", SERVE_MIX, "--dtype", "bfloat16",
                              "--seed", "0", "--duration", "2", *open_loop,
                              "--matmul-impl", "cuda"],
        }
        runs, summaries = {}, {}
        for label, argv in argvs.items():
            traced = label != "pod_cold_cuda"
            if label == "pod_quant_cuda":
                wire_run = dict(collectives.WIRE_CALLS)
            # the quantized window's trace holds ~15 wire kernels a K1 kernel,
            # and lost 4 of 7496 K1 records in one call: it is read, not counted
            runs[label], summaries[label], found = serve_traced(
                label, argv, out_dir, kind, {}, traced=traced, pod=True,
                k1_a_request=None if label == "pod_quant_cuda" else POD_K1_A_REQUEST,
                prewarmed=traced)
            problems += found
            if runs[label]["rc"]:
                problems.append(f"{label}: exit {runs[label]['rc']}")
        wire_calls = {f"{f}:{c}": n - wire_run.get((f, c), 0)
                      for (f, c), n in collectives.WIRE_CALLS.items()
                      if n - wire_run.get((f, c), 0)}
        if not wire_calls.get("fp8-block:32:all_gather"):
            problems.append(f"pod_quant_cuda put no dcn gather on the wire: {wire_calls}")
        cold = summaries["pod_cold_cuda"]["windows"][0]
        if not cold["requests"] or not any(r["cold_compile_ms"] for r in
                                           cold["by_entry"].values()):
            problems.append(f"pod_cold_cuda: {cold['requests']} requests, no capture in the "
                            "window")
        warm, found = pod_warm_start(out_dir)
        problems += found
        ab, found = ab_run("pod_ab_cuda", ["ab", *pod_flags, *load, *open_loop, "--prewarm",
                                           "--matmul-impl", "cuda"])
        problems += found

    def window(label: str) -> dict:
        return summaries[label]["windows"][0]

    result = {"phase": "pod", "card": card, "ranks": POD_RANKS, "mix": SERVE_MIX,
              "qps": SERVE_QPS, "duration_s": SERVE_DURATION, "selftest_rc": selftest,
              "buckets": buckets, "rank_products": ranks, "runs": summaries,
              "wire_calls": wire_calls, "wire_calls_before": {
                  f"{f}:{c}": n for (f, c), n in wire_before.items()},
              "warm_start": warm, "pod_ab_cuda": ab, "seconds": time.perf_counter() - t0,
              "ok": not problems, "problems": problems}
    emit(result)
    if problems:
        fail("pod", "; ".join(problems[:10]))
    cuda = window("pod_cuda")
    return {"launches": runs["pod_cuda"]["launches"],
            "launches_by_route": runs["pod_cuda"]["launches_by_route"],
            "k1_kernels": cuda["k1_kernels"], "requests": cuda["requests"],
            "k1_a_request": POD_K1_A_REQUEST,
            "p50_ms": cuda["p50_ms"], "p99_ms": cuda["p99_ms"],
            "achieved_qps": cuda["achieved_qps"], "busy_share": cuda["device_busy_share"],
            "groups": cuda["pod"]["groups"],
            "torch_p50_ms": window("pod_torch")["p50_ms"],
            "torch_p99_ms": window("pod_torch")["p99_ms"],
            "closed_loop_qps": window("pod_closed_cuda")["achieved_qps"],
            "quant_p99_ms": window("pod_quant_cuda")["p99_ms"],
            "max_rel_err": {mesh_spec: max(r["max_rel_err"] for r in rows.values())
                            for mesh_spec, rows in buckets.items()},
            "rank_products": ranks,
            "ab_cuda": {"rc": ab["rc"], "finding": ab["finding"], "verdict": ab["verdict"]}}


# the campaign runner on the card (the `campaign` phase, slice 17):
# CAMPAIGN_SPEC's four jobs as children of `campaign run`, killed after the
# first job is done and resumed; the gate against itself and against a
# baseline with CAMPAIGN_DOCTORED_JOB's TFLOPS raised CAMPAIGN_DOCTOR times;
# then `tune fill` of a one-job spec (FILL_SIZE, FILL_TILES) into a DB of
# its own, and `auto` at its problem through that DB
CAMPAIGN_SPEC = "specs/torch/card.toml"
CAMPAIGN_DOCTORED_JOB, CAMPAIGN_DOCTOR = "matmul_cuda", 1.5
CAMPAIGN_TIMEOUT_S = 900
FILL_SIZE, FILL_TILES = 8192, ("128,256,64", "128,128,64")
# the chaos matrix (the `faults` phase): `faults selftest` and the smoke
# subset (the first ledger, tune and obs cell), whose children never touch
# the card, run beside the campaign phase; the serve cell, verbatim, in a
# spec of its own (`serve selftest` on the card), beside the campaign's
# resume, whose jobs' numbers are recorded, not compared. The whole matrix
# took 308.5 s on an NVIDIA H100 80GB HBM3 at 700 W, over the phase's
# 240-s share of the script's time: a campaign or ledger cell is 3-4
# children of about 7 s
CHAOS_SPEC, FAULTS_TIMEOUT_S = "specs/chaos.toml", 600


def compute_apps() -> list[int]:
    """Pids that hold the card, as `nvidia-smi --query-compute-apps=pid
    --format=csv,noheader` lists them (host pids when the card's processes
    live in another pid namespace)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return [int(line) for line in out.stdout.split() if line.strip().isdigit()]


def campaign_children(campaign_dir: str) -> list[int]:
    """Live job children of a campaign: the port's processes whose argv
    names the campaign directory (each job's --json-out lies in it), the
    campaign's own process left out."""
    pids = []
    for entry in glob.glob("/proc/[0-9]*/cmdline"):
        try:
            with open(entry, "rb") as fh:
                argv = fh.read().split(b"\0")
        except OSError:
            continue
        # the campaign's own process and the `obs status` tail of its
        # snapshots (the `obs` phase) are not job children
        if (b"tpu_matmul_bench_torch" in argv and b"campaign" not in argv
                and b"obs" not in argv
                and any(campaign_dir.encode() in a for a in argv)):
            pids.append(int(entry.split("/")[2]))
    return pids


def alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def start_port(argv: list[str], log: str, env: dict | None = None) -> subprocess.Popen:
    """`python -m tpu_matmul_bench_torch ARGV` as a child in a session of
    its own, its output to `log` (`env`: its environment, else this
    process's)."""
    with open(log, "w") as fh:
        return subprocess.Popen([sys.executable, "-m", "tpu_matmul_bench_torch", *argv],
                                stdout=fh, stderr=subprocess.STDOUT, start_new_session=True,
                                env=env)


def finish_port(proc: subprocess.Popen, log: str, timeout: float) -> tuple[int, str]:
    """Wait for a `start_port` child (killed with its group past `timeout`
    seconds, rc 124) and kill whatever its group left; (rc, its output)."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        rc = 124
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()
    with open(log) as fh:
        return rc, fh.read()


def run_port(argv: list[str], timeout: float, log: str) -> tuple[int, str]:
    return finish_port(start_port(argv, log), log, timeout)


def in_process(main, argv: list[str]) -> tuple[int, str]:
    """A program's `main(argv)` in this process, its report captured (this
    process's standard output holds JSON lines only): (exit code, report)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        try:
            rc = main(argv) or 0
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
    return (rc if isinstance(rc, int) else 0), buf.getvalue()


def campaign_cli(argv: list[str]) -> tuple[int, str]:
    """`campaign ARGV` in this process (its parent never touches the card)."""
    from tpu_matmul_bench_torch.campaign import cli

    return in_process(cli.main, argv)


def kill_after_first_done(campaign_dir: str, card_name: str, tail: dict) -> dict:
    """`campaign run CAMPAIGN_SPEC` as a process of its own; once the
    journal holds the first `done` and the next job's child has reached
    the card (its log names the card), SIGKILL the campaign's process
    group; then every job child still alive (the supervisor starts each in
    a session of its own, so the group kill does not reach it: ROADMAP C5)
    by its own session. Returns what was killed and what held the card.
    Once the campaign's snapshot file exists, `start_obs_tail` starts its
    tail into `tail`."""
    journal = os.path.join(campaign_dir, "journal.jsonl")
    log_path = os.path.join(os.path.dirname(campaign_dir), "campaign_run.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_matmul_bench_torch", "campaign", "run",
             CAMPAIGN_SPEC, "--dir", campaign_dir],
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    result = {"campaign_pid": proc.pid}
    try:
        deadline = time.monotonic() + CAMPAIGN_TIMEOUT_S
        while '"status": "done"' not in (open(journal).read() if os.path.exists(journal)
                                         else ""):
            if not tail:
                start_obs_tail(campaign_dir, tail)
            if proc.poll() is not None or time.monotonic() > deadline:
                fail("campaign", f"the campaign ended (rc {proc.returncode}) or timed out "
                                 "before its first job was done")
            time.sleep(0.05)
        running = [json.loads(line) for line in open(journal) if '"running"' in line]
        in_flight = running[-1]["job_id"]
        result["first_done_s"] = time.monotonic() - (deadline - CAMPAIGN_TIMEOUT_S)
        result["in_flight_job"] = in_flight
        child_log = os.path.join(campaign_dir, "jobs", f"{in_flight}.log")
        wait_until = time.monotonic() + 120
        while time.monotonic() < wait_until and proc.poll() is None:
            if os.path.exists(child_log) and card_name in open(child_log).read():
                break
            time.sleep(0.05)
        result["in_flight_on_card"] = (os.path.exists(child_log)
                                       and card_name in open(child_log).read())
        children = campaign_children(campaign_dir)
        result["children_before_kill"] = children
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
        time.sleep(1.0)
        # a child spawned between the scan and the kill counts too
        children = sorted(set(children) | set(campaign_children(campaign_dir)))
        orphans = [pid for pid in children if alive(pid)]
        apps = compute_apps()
        result.update(orphans_after_group_kill=orphans,
                      orphans_on_card=[pid for pid in orphans if pid in apps])
        for pid in orphans:
            try:
                os.killpg(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)
    gone_by = time.monotonic() + 60
    killed = [proc.pid, *children]
    while any(alive(pid) for pid in killed) and time.monotonic() < gone_by:
        time.sleep(0.1)
    apps = compute_apps()
    result.update(killed_alive=[pid for pid in killed if alive(pid)],
                  compute_apps_before_resume=apps, own_pid=os.getpid(),
                  own_pid_listed=os.getpid() in apps,
                  killed_on_card=[pid for pid in killed if pid in apps])
    return result


def ledger_lines(path: str) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def campaign_phase(card: str, k1_fused_tflops: float, out_dir: str, beside: dict,
                   tail: dict) -> dict:
    """The campaign runner on the card: kill after the first done and
    resume, every job done once with its ledger, K1's and K1b's kernels in
    the jobs' traces, `status`, the gate against itself (exit 0) and
    against a doctored baseline (exit 1), each twice with the same output,
    and `tune fill` into a DB of its own with `auto` through it (source db,
    counted by tune_route_total, K1 launched). The cuda job's TFLOPS is
    printed beside this process's fused K1 run (`k1_fused_tflops`), the
    resumed job's beside its pre-kill attempt when one landed. The chaos
    matrix's serve cell starts beside the resume (`beside`), the tail of the
    campaign's snapshots beside the run (`tail`, `start_obs_tail`)."""
    import torch

    from tpu_matmul_bench_torch.benchmarks import matmul_benchmark
    from tpu_matmul_bench_torch.campaign import spec as cspec
    from tpu_matmul_bench_torch.campaign import state as cstate
    from tpu_matmul_bench_torch.obs.registry import get_registry
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.tune import db as tdb

    t0 = time.perf_counter()
    root = os.path.join(out_dir, "campaign")
    d = os.path.join(root, "card")
    os.makedirs(root, exist_ok=True)
    from tpu_matmul_bench_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    result = {"phase": "campaign", "card": card, "spec": CAMPAIGN_SPEC}
    problems = []
    # the kernels were built before this phase: no child may run nvcc
    libraries = sorted(glob.glob(str(_build.BUILD_DIR / "*.so")))
    kill = kill_after_first_done(d, name, tail)
    result["kill"] = kill
    if kill["killed_alive"] or kill["killed_on_card"]:
        problems.append(f"processes of the killed run remain: alive {kill['killed_alive']}, "
                        f"on the card {kill['killed_on_card']}")
    in_flight = kill["in_flight_job"]
    pre_ledger = os.path.join(d, "jobs", f"{in_flight}.jsonl")
    pre_kill = ([r for r in ledger_lines(pre_ledger) if "benchmark" in r]
                if os.path.exists(pre_ledger) else [])
    beside["serve"] = start_serve_cell(out_dir)
    t_resume = time.perf_counter()
    rc, out = run_port(["campaign", "resume", d], CAMPAIGN_TIMEOUT_S,
                       os.path.join(root, "resume.log"))
    result["resume_s"] = time.perf_counter() - t_resume
    result["resume_tail"] = out.strip().splitlines()[-2:]
    if rc != 0:
        problems.append(f"campaign resume exited {rc}: {out[-2000:]}")
    spec = cspec.load_spec(CAMPAIGN_SPEC)
    events = cstate.load_events(d)
    done = [ev.fingerprint for ev in events if ev.status == cstate.DONE]
    jobs = {}
    for job in spec.jobs:
        ledger = os.path.join(d, "jobs", f"{job.job_id}.jsonl")
        lines = ledger_lines(ledger) if os.path.exists(ledger) else []
        recs = [r for r in lines if "benchmark" in r]
        manifests = sum(r.get("record_type") == "manifest" for r in lines)
        # a child's start-up: from its journaled launch to its ledger's
        # manifest (python, torch, the card's context and the device probe)
        launched = [ev.ts for ev in events if ev.job_id == job.job_id
                    and ev.status == cstate.RUNNING and not ev.detail]
        made = [r["created_unix"] for r in lines if r.get("record_type") == "manifest"]
        jobs[job.job_id] = {"done": done.count(job.fingerprint), "records": len(recs),
                            "manifests": manifests,
                            "startup_s": made[0] - launched[-1] if made and launched
                            else None,
                            "tflops": max((r.get("tflops_per_device") or 0.0) for r in recs)
                            if recs else None}
        if done.count(job.fingerprint) != 1 or not recs or manifests != 1:
            problems.append(f"job {job.job_id}: done {done.count(job.fingerprint)} times, "
                            f"{len(recs)} records, {manifests} manifests")
    result["jobs"] = jobs
    result["libraries_unchanged"] = sorted(glob.glob(str(_build.BUILD_DIR / "*.so"))) \
        == libraries
    if not result["libraries_unchanged"]:
        problems.append("a campaign child built a kernel library (nvcc ran)")
    # the kernels in the jobs' traces
    traces = {}
    for job_id, want in (("matmul_cuda", "K1"), ("tune_ksplit", "K1b")):
        paths = glob.glob(os.path.join(d, "prof", job_id, "*.json"))
        kernels = [k for p in paths for k in trace_kernels(p)]
        gemm = [g for n, g, _ in kernels if "wgmma_gemm" in n]
        entry = {"traces": len(paths), "kernels": len(kernels), "wgmma_gemm": len(gemm),
                 "reduce_partials": sum("reduce_partials" in n for n, _, _ in kernels),
                 "split_grids": sum(1 for g in gemm if g and len(g) == 3 and g[2] == 2),
                 "device_us": sum(dur for _, _, dur in kernels)}
        traces[job_id] = entry
        if want == "K1" and not entry["wgmma_gemm"]:
            problems.append("the cuda job's trace holds no K1 kernel")
        if want == "K1b" and not (entry["split_grids"] and entry["reduce_partials"]):
            problems.append(f"the split-K job's trace lacks K1b (S=2 GEMM grids "
                            f"{entry['split_grids']}, reduce_partials "
                            f"{entry['reduce_partials']})")
    result["traces"] = traces
    rc, out = campaign_cli(["status", d])
    result["status_rc"] = rc
    if rc != 0:
        problems.append(f"campaign status exited {rc}")
    # the gate: against itself, then against a doctored copy of the baseline
    baseline = os.path.join(root, "baseline.json")
    gates = [campaign_cli(["gate", d, "--baseline", d, "--write-baseline", baseline])]
    gates.append(campaign_cli(["gate", d, "--baseline", d]))
    with open(baseline) as fh:
        snap = json.load(fh)
    fp = next(fp for fp, row in sorted(snap["jobs"].items())
              if row["job_id"] == CAMPAIGN_DOCTORED_JOB)
    snap["jobs"][fp]["tflops_per_device"] *= CAMPAIGN_DOCTOR
    doctored = os.path.join(root, "doctored.json")
    with open(doctored, "w") as fh:
        json.dump(snap, fh)
    gates += [campaign_cli(["gate", d, "--baseline", doctored]) for _ in range(2)]
    result["gate"] = {"self_rc": [gates[0][0], gates[1][0]],
                      "doctored_rc": [gates[2][0], gates[3][0]],
                      "self_summary": gates[1][1].strip().splitlines()[-1],
                      "doctored_summary": gates[3][1].strip().splitlines()[-1]}
    if [gates[0][0], gates[1][0], gates[2][0], gates[3][0]] != [0, 0, 1, 1]:
        problems.append(f"gate exit codes {[g[0] for g in gates]}, want [0, 0, 1, 1]")
    if gates[2][1] != gates[3][1] or gates[0][1].splitlines()[1:] != gates[1][1].splitlines():
        problems.append("a gate's output differs between two runs on the same inputs")
    cuda_tflops = jobs["matmul_cuda"]["tflops"]
    result["numbers"] = {
        "cuda_job_tflops": cuda_tflops, "in_process_fused_tflops": k1_fused_tflops,
        "cuda_job_over_in_process": (cuda_tflops / k1_fused_tflops
                                     if cuda_tflops and k1_fused_tflops else None),
        "torch_job_tflops": jobs["matmul_torch"]["tflops"],
        "resumed_job": in_flight,
        "resumed_pre_kill_records": len(pre_kill),
        "resumed_tflops": jobs[in_flight]["tflops"],
        "resumed_over_pre_kill": (jobs[in_flight]["tflops"] / pre_kill[0]["tflops_per_device"]
                                  if pre_kill else None),
    }
    # `tune fill` into a DB of its own, then `auto` through it
    fill_spec = os.path.join(root, "fill.toml")
    with open(fill_spec, "w") as fh:
        fh.write('[campaign]\nname = "card_fill"\n\n[defaults]\ntimeout_s = 600.0\n'
                 'retries = 1\nbackoff_s = 5.0\n\n[[job]]\nid = "bf16_8k"\n'
                 'program = "tune"\n'
                 f'flags = ["--sizes", "{FILL_SIZE}", "--dtype", "bfloat16", '
                 '"--iterations", "10", "--warmup", "3", "--num-devices", "1", '
                 '"--timing", "fused", "--confirm-top", "2", "--candidates", '
                 + ", ".join(f'"{t}"' for t in FILL_TILES) + "]\n")
    committed = open(tdb.TuningDB.load().path, "rb").read()
    fill_db = os.path.join(root, "fill_db.jsonl")
    from tpu_matmul_bench_torch.tune import cli as tune_cli

    rc, out = in_process(tune_cli.main, ["fill", "--spec", fill_spec, "--dir",
                                         os.path.join(root, "fill"), "--db", fill_db,
                                         "--device-kind", name])
    fill = {"rc": rc, "promoted": [line for line in out.splitlines()
                                   if line.startswith(("promoted", "skipped"))]}
    if rc != 0 or not os.path.exists(fill_db):
        problems.append(f"tune fill exited {rc}: {out[-2000:]}")
    else:
        filled = tdb.TuningDB.load(fill_db)
        cell = filled.lookup(FILL_SIZE, FILL_SIZE, FILL_SIZE, "bfloat16", name)
        fill["cell"] = None if cell is None else {"impl": cell.impl, "blocks": cell.blocks,
                                                  "tflops": cell.tflops}
        if cell is None:
            problems.append("tune fill promoted no cell for its problem")
        else:
            key = 'tune_route_total{source="db"}'
            before = get_registry().snapshot()["counters"].get(key, 0.0)
            tdb.install_default_db(filled)
            cm.LAUNCHES = 0
            try:
                with contextlib.redirect_stdout(sys.stderr):
                    (rec,) = matmul_benchmark.main(
                        ["--sizes", str(FILL_SIZE), "--dtype", "bfloat16", "--num-devices",
                         "1", "--matmul-impl", "auto", "--iterations", "5", "--warmup", "2",
                         "--validate"])
                launches = cm.LAUNCHES
            finally:
                tdb.install_default_db(None)
            counted = get_registry().snapshot()["counters"].get(key, 0.0) - before
            fill.update(auto_source=rec.extras.get("impl_source"),
                        auto_impl=rec.extras.get("matmul_impl_resolved"),
                        auto_validation=rec.extras.get("validation"),
                        auto_k1_launches=launches, route_db_counted=counted,
                        auto_ms=rec.avg_time_s * 1e3)
            if (rec.extras.get("impl_source"), rec.extras.get("validation")) != ("db", "ok") \
                    or counted < 1 or (cell.impl == "cuda" and launches < 1):
                problems.append(f"auto through the filled DB: {fill}")
    if open(tdb.TuningDB.load().path, "rb").read() != committed:
        problems.append("tune fill wrote to the committed DB")
    result["fill"] = fill
    result["seconds"] = time.perf_counter() - t0
    result["ok"] = not problems
    emit(result)
    if problems:
        fail("campaign", "; ".join(problems))
    return result


def serve_cell_spec(path: str) -> None:
    """A chaos spec at `path` holding CHAOS_SPEC's seed and its serve cell,
    the cell's text copied verbatim."""
    import tomllib

    with open(CHAOS_SPEC) as fh:
        text = fh.read()
    seed = tomllib.loads(text)["chaos"]["seed"]
    (cell,) = [block for block in text.split("[[chaos.cell]]")[1:]
               if 'subsystem = "serve"' in block]
    with open(path, "w") as fh:
        fh.write(f"[chaos]\nseed = {seed}\n\n[[chaos.cell]]{cell}")


def start_faults_beside(out_dir: str) -> dict:
    """`faults selftest` and `faults audit --smoke` started as processes
    of their own, to run beside the campaign phase: their children never
    touch the card. Returns {label: (process, log, seconds at start)}."""
    runs = {}
    for label, argv in (("selftest", ["faults", "selftest"]),
                        ("smoke", ["faults", "audit", "--smoke", "--spec", CHAOS_SPEC,
                                   "--dir", os.path.join(out_dir, "fault_audit_smoke")])):
        log = os.path.join(out_dir, f"faults_{label}.log")
        runs[label] = (start_port(argv, log), log, time.time())
    return runs


def start_serve_cell(out_dir: str) -> tuple:
    """`faults audit` of the chaos matrix's serve cell alone (`serve
    selftest` on the card killed at its second batch), started as a
    process of its own."""
    serve_spec = os.path.join(out_dir, "chaos_serve.toml")
    serve_cell_spec(serve_spec)
    log = os.path.join(out_dir, "faults_serve.log")
    argv = ["faults", "audit", "--spec", serve_spec, "--dir",
            os.path.join(out_dir, "fault_audit_serve")]
    return start_port(argv, log), log, time.time()


def stop_faults_beside(runs: dict) -> None:
    for proc, _log, _t in runs.values():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def faults_phase(card: str, out_dir: str, beside: dict) -> dict:
    """The fault certifier: `faults selftest`, `faults audit --smoke` and
    `faults audit` of the chaos matrix's serve cell (started beside the
    campaign phase, `start_faults_beside` and `start_serve_cell`) must
    exit 0 with every verdict PASS; each cell's wall and recovery seconds,
    each run's time."""
    t0 = time.perf_counter()
    result = {"phase": "faults", "card": card, "cells": {}}
    problems = []
    # a run's seconds: from its start to its log's last write
    runs = {label: finish_port(proc, log, FAULTS_TIMEOUT_S) + (os.path.getmtime(log) - t,)
            for label, (proc, log, t) in beside.items()}
    result["waited_s"] = time.perf_counter() - t0
    for label, (rc, out, seconds) in runs.items():
        result[f"{label}_rc"], result[f"{label}_s"] = rc, seconds
        if rc != 0:
            problems.append(f"faults {label} exited {rc}: {out[-2000:]}")
    for label, want in (("smoke", 3), ("serve", 1)):
        ledger = os.path.join(out_dir, f"fault_audit_{label}", "fault_audit.jsonl")
        verdicts = ledger_lines(ledger) if os.path.exists(ledger) else []
        result["cells"].update(
            {v["cell"]: {"status": v["status"], "subsystem": v["subsystem"],
                         "wall_s": v.get("wall_s"), "recovery_s": v.get("recovery_s"),
                         "attempts": v.get("attempts"), "escalation": v.get("escalation"),
                         "problems": v.get("problems")[:2]}
             for v in verdicts})
        if len(verdicts) != want or any(v["status"] != "PASS" for v in verdicts):
            problems.append(f"faults audit {label}: {len(verdicts)} of {want} verdicts, "
                            f"{[v['cell'] for v in verdicts if v['status'] != 'PASS']} failed")
    if not any(c["subsystem"] == "serve" for c in result["cells"].values()):
        problems.append("the serve cell gave no verdict")
    result["seconds"] = time.perf_counter() - t0
    result["ok"] = not problems
    emit(result)
    if problems:
        fail("faults", "; ".join(problems))
    return result


# the perf observatory (the `obs` phase, slice 18): the tail of the
# campaign's snapshots stops after OBS_TAIL_IDLE_S without a new one (the
# gap between the kill and the resume's first snapshot is a child's
# start-up), or once it has printed the file's final line after the
# campaign ended; the committed history store is round 1 of the card
OBS_TAIL_IDLE_S, OBS_TAIL_INTERVAL_S = 60.0, 0.2
# the `obs selftest` bucket (serve/queue.py's first grid point over its
# 96x96x96 mix), float32 under `cuda`; its executable's replays timed
# against the plain product and the library's
OBS_BUCKET = (128, 128, 128)
OBS_REPLAYS = 200


def start_obs_tail(campaign_dir: str, tail: dict) -> None:
    """Once `campaign_dir/obs` holds the campaign's snapshot file, start
    `obs status --follow --json` on it as a process of its own, into
    `tail` (its process, log and start time)."""
    from tpu_matmul_bench_torch.obs import export

    obs_dir = os.path.join(campaign_dir, "obs")
    if export.find_snapshot_file(obs_dir) is None:
        return
    log = os.path.join(os.path.dirname(campaign_dir), "obs_tail.log")
    tail.update(proc=start_port(["obs", "status", obs_dir, "--follow", "--json",
                                 "--interval", str(OBS_TAIL_INTERVAL_S),
                                 "--timeout", str(OBS_TAIL_IDLE_S)], log),
                log=log, obs_dir=obs_dir, started=time.time())


def stop_obs_tail(tail: dict) -> None:
    if tail.get("proc") is not None:
        try:
            os.killpg(tail["proc"].pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        tail["proc"].wait()


def tail_result(tail: dict) -> tuple[dict, list]:
    """Read the tail once the campaign has ended: wait until the last
    snapshot it printed is the file's final line (or it stopped), then
    stop it. The distinct (run, seq) pairs it printed, and its problems."""
    from tpu_matmul_bench_torch.obs import export

    if not tail:
        return {}, ["the campaign's snapshot file never appeared: no tail ran"]

    def printed() -> list[dict]:
        out = []
        with open(tail["log"]) as fh:
            for line in fh:
                with contextlib.suppress(ValueError):
                    out.append(json.loads(line))
        return out

    final = export.read_snapshots(export.find_snapshot_file(tail["obs_dir"]))[-1]
    deadline = time.monotonic() + OBS_TAIL_IDLE_S + 10
    while tail["proc"].poll() is None and time.monotonic() < deadline:
        seen = printed()
        if seen and seen[-1] == final:
            break
        time.sleep(OBS_TAIL_INTERVAL_S)
    exited_rc = tail["proc"].poll()
    stop_obs_tail(tail)
    seen = [d for d in printed() if d.get("record_type") == "obs_snapshot"]
    pairs = sorted({(d["run_id"], d["seq"]) for d in seen})
    result = {"printed": len(seen), "distinct_seqs": len(pairs),
              "runs": len({run for run, _ in pairs}),
              "exited_on_its_own": exited_rc is not None, "exit_rc": exited_rc,
              "final_seq": final.get("seq"),
              "last_printed_is_final": bool(seen) and seen[-1] == final}
    problems = []
    if not pairs:
        problems.append("the tail saw no snapshot while the campaign's jobs ran")
    if not result["last_printed_is_final"]:
        problems.append("the last snapshot the tail printed is not the file's final line")
    return result, problems


def obs_selftest_on_card(work: str) -> tuple[dict, list]:
    """`obs selftest --device cuda` in process, with K1's launches set to
    0 just before and read just after (its bucket's first call and its
    capture: graph replays launch without counting) and every executable
    it captures recorded: the OBS_BUCKET executable's output, the product
    its last replay wrote, held to the plain version on the same operands
    (TOLERANCE, as `check_kernel`); then its replay's ms between CUDA
    events beside the plain product's, the library's and the bound."""
    import torch

    from tpu_matmul_bench_torch.obs import attribution
    from tpu_matmul_bench_torch.obs import cli as obs_cli
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.serve import cache as serve_cache

    captured = []
    real_capture = serve_cache.capture

    def recording_capture(fn, a, b, **kw):
        executable = real_capture(fn, a, b, **kw)
        captured.append(executable)
        return executable

    serve_cache.capture = recording_capture
    cm.LAUNCHES = 0
    before = routes()
    t0 = time.perf_counter()
    try:
        rc, out = in_process(obs_cli.main, ["selftest", "--device", "cuda", "--dir", work])
    finally:
        serve_cache.capture = real_capture
    seconds = time.perf_counter() - t0
    launches, by_route = cm.LAUNCHES, routes_since(before)
    problems = [] if rc == 0 else [f"obs selftest --device cuda exited {rc}: {out[-2000:]}"]
    ledger = os.path.join(work, "serve.jsonl")
    recs = [r for r in ledger_lines(ledger) if r.get("benchmark") == "serve"] \
        if os.path.exists(ledger) else []
    books = (recs[0].get("extras") or {}).get("cost_analysis") or {} if recs else {}
    m, k, n = OBS_BUCKET
    label = f"{m}x{k}x{n}/float32/cuda"
    bucket = [e for e in captured if tuple(e._a.shape) == (m, k) and tuple(e._b.shape) == (k, n)]
    result = {"rc": rc, "seconds": seconds, "k1_launches": launches,
              "launches_by_route": by_route, "bucket": label,
              "executables": len(captured), "books": books.get(label),
              "verdict": out.strip().splitlines()[-1] if out.strip() else ""}
    if not bucket:
        problems.append(f"the selftest captured no executable at {label}")
    else:
        e = bucket[-1]
        route, tile, splits = cm.launch_plan(e._a, e._b)
        got, want = e.out, cm.matmul_plain(e._a, e._b)
        torch.cuda.synchronize()
        diff = (got.double() - want.double()).abs().max().item()
        rel = diff / (want.double().abs().max().item() or 1.0)
        result.update(route=route, tile=list(tile), splits=splits, max_abs_err=diff,
                      max_rel_err=rel, tolerance=TOLERANCE["float32"],
                      finite=bool(torch.isfinite(got).all().item()),
                      replay_ms=events_ms(lambda: e(e._a, e._b), OBS_REPLAYS),
                      plain_ms=events_ms(lambda: cm.matmul_plain(e._a, e._b), OBS_REPLAYS),
                      library_ms=events_ms(lambda: torch.matmul(e._a, e._b), OBS_REPLAYS))
        result["bound_ms"], result["bound_by"] = attribution.bound(
            m, n, k, torch.float32, torch.cuda.get_device_name(0))
        if not (result["finite"] and rel <= TOLERANCE["float32"]):
            problems.append(f"K1's output at {label}: max rel err {rel} > "
                            f"{TOLERANCE['float32']}")
    if launches < 1:
        problems.append("the selftest launched K1 no time")
    if not books.get(label):
        problems.append(f"the selftest's ledger carries no cost books for {label}")
    return result, problems


def obs_http(work: str) -> tuple[dict, list]:
    """The exporter's HTTP surface on the registry the selftest recorded
    into: one snapshot written, then `/metrics`'s line count, `/healthz`'s
    and `/readyz`'s status over loopback."""
    import urllib.error
    import urllib.request

    from tpu_matmul_bench_torch.obs.export import SnapshotExporter

    exporter = SnapshotExporter(os.path.join(work, "obs_http"))
    exporter.write_once()
    port = exporter.start_http(0)
    got = {}
    try:
        for path in ("/metrics", "/healthz", "/readyz"):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                            timeout=10) as resp:
                    got[path] = (resp.status, resp.read().decode())
            except urllib.error.HTTPError as e:
                got[path] = (e.code, e.read().decode())
    finally:
        exporter.stop_http()
    metrics = got["/metrics"][1].splitlines()
    result = {"metrics_status": got["/metrics"][0], "metrics_lines": len(metrics),
              "serve_lines": sum(line.startswith("serve_") for line in metrics),
              "healthz_status": got["/healthz"][0], "readyz_status": got["/readyz"][0],
              "readyz": got["/readyz"][1].strip()}
    problems = [] if (result["metrics_status"], result["healthz_status"],
                      result["readyz_status"]) == (200, 200, 200) and result["serve_lines"] \
        else [f"the exporter's HTTP surface: {result}"]
    return result, problems


def obs_history(campaign_dir: str, work: str) -> tuple[dict, list]:
    """The committed store copied; the campaign's job ledgers ingested into
    the copy (`obs ingest`, its next round); `obs history selftest` on the
    committed store, `obs detect` and `obs report` on the copy; the
    residual of the cuda job's point."""
    import shutil

    from tpu_matmul_bench_torch.obs import cli as obs_cli
    from tpu_matmul_bench_torch.obs import history as hist

    copy = os.path.join(work, "history.jsonl")
    shutil.copyfile(hist.default_path(), copy)
    committed_round = hist.HistoryStore.load().max_seq()
    ledgers = sorted(glob.glob(os.path.join(campaign_dir, "jobs", "*.jsonl")))
    runs = {"ingest": in_process(obs_cli.main, ["ingest", *ledgers, "--store", copy]),
            "history_selftest": in_process(obs_cli.main, ["history", "selftest"]),
            "detect": in_process(obs_cli.main, ["detect", "--store", copy]),
            "report": in_process(obs_cli.main, ["report", "--store", copy, "--out",
                                                os.path.join(work, "report.md")])}
    store = hist.HistoryStore.load(copy)
    findings: dict[str, int] = {}
    for line in runs["detect"][1].splitlines():
        match = re.match(r"\[\s*\w+\s*\] (HIST-\d+) ", line)
        if match:
            findings[match.group(1)] = findings.get(match.group(1), 0) + 1
    cuda_ledger = os.path.join(campaign_dir, "jobs", f"{CAMPAIGN_DOCTORED_JOB}.jsonl")
    cuda_points = [p for p in hist.points_from_source(cuda_ledger)
                   if p["metric"] == "tflops_per_device"]
    result = {"rc": {name: rc for name, (rc, _) in runs.items()},
              "ingest": runs["ingest"][1].strip().splitlines()[-1:],
              "committed_round": committed_round, "copy_round": store.max_seq(),
              "points": len(store), "series": len(store.series()),
              "hist_findings": findings,
              "detect_summary": runs["detect"][1].strip().splitlines()[-1:],
              "cuda_job_point": {k: cuda_points[0].get(k) for k in (
                  "value", "status", "residual_pct", "predicted", "measured", "backend")}
              if cuda_points else None}
    problems = []
    for name, (rc, out) in runs.items():
        # detect follows the gate's rule: a regression (exit 1) is a measurement
        if rc not in ((0, 1) if name == "detect" else (0,)):
            problems.append(f"obs {name} exited {rc}: {out[-2000:]}")
    if store.max_seq() != committed_round + 1:
        problems.append(f"the copy reads round {store.max_seq()} after the ingest, "
                        f"want {committed_round + 1}")
    if not cuda_points or cuda_points[0].get("residual_pct") is None:
        problems.append("the cuda job's point carries no residual")
    return result, problems


def obs_gate(campaign_dir: str, store: str) -> tuple[dict, list]:
    """`campaign gate CAMPAIGN --history STORE`: each job's baseline (the
    store's last-known-good of its series, from an earlier round), its
    value in this campaign and the verdict. A job that gates as `new` has
    no earlier point: the committed round is not its baseline."""
    from tpu_matmul_bench_torch.campaign import gate as gate_mod

    rc, out = campaign_cli(["gate", campaign_dir, "--history", store])
    report = gate_mod.run_gate(gate_mod.load_summary(campaign_dir),
                               gate_mod.history_baseline(campaign_dir, store))
    rows = [{"job": r.job_id, "metric": r.metric, "baseline": r.baseline,
             "current": r.current, "delta_pct": r.delta_pct, "verdict": r.verdict}
            for r in report.rows]
    result = {"rc": rc, "rows": rows, "summary": out.strip().splitlines()[-1:]}
    problems = []
    if rc not in (0, 1) or report.exit_code != rc:
        problems.append(f"campaign gate --history exited {rc}: {out[-2000:]}")
    new = sorted({r["job"] for r in rows if r["verdict"] == "new"})
    if new:
        problems.append(f"jobs without a round-1 baseline: {new}")
    return result, problems


def obs_phase(card: str, out_dir: str, tail: dict, keep_ledgers: str | None) -> dict:
    """The perf observatory on the card: the campaign's live tail, `obs
    selftest --device cuda` with K1 held to its plain version, the
    exporter's HTTP surface, the history store's rounds, and the history
    gate. With `keep_ledgers`, the campaign's job ledgers and the
    selftest's serve ledger are copied there, unedited, as `.ndjson`."""
    import shutil

    t0 = time.perf_counter()
    campaign_dir = os.path.join(out_dir, "campaign", "card")
    work = os.path.join(out_dir, "obs")
    os.makedirs(work, exist_ok=True)
    result = {"phase": "obs", "card": card}
    problems = []
    laps = {}
    for name, step in (("selftest", lambda: obs_selftest_on_card(os.path.join(work, "selftest"))),
                       ("http", lambda: obs_http(work)),
                       ("history", lambda: obs_history(campaign_dir, work)),
                       ("gate", lambda: obs_gate(campaign_dir,
                                                 os.path.join(work, "history.jsonl"))),
                       ("tail", lambda: tail_result(tail))):
        t1 = time.perf_counter()
        result[name], found = step()
        problems += found
        laps[name] = time.perf_counter() - t1
    result["laps"] = laps
    if keep_ledgers:
        # named .ndjson, as the card's committed ledgers are
        # (`obs/history.py SOURCES_GLOB`)
        os.makedirs(keep_ledgers, exist_ok=True)
        kept = {os.path.join(work, "selftest", "serve.jsonl"): "obs_selftest.ndjson"}
        for path in sorted(glob.glob(os.path.join(campaign_dir, "jobs", "*.jsonl"))):
            kept[path] = os.path.basename(path).removesuffix(".jsonl") + ".ndjson"
        for path, name in kept.items():
            shutil.copyfile(path, os.path.join(keep_ledgers, name))
        result["kept"] = sorted(kept.values())
    result["seconds"] = time.perf_counter() - t0
    result["ok"] = not problems
    emit(result)
    if problems:
        fail("obs", "; ".join(problems))
    return result


# the `lint` phase (slice 19): the lint on the card in process, seeded
# PURE-001 and DONATE-001, the live-bytes walk against the allocator, the
# shared memory a block may opt into, `parallel hier selftest` and the
# campaign's lint gate. LINT_WALK_BAND is the walk's peak over the
# allocator's in the same call, stated in PERF.md before the first run
LINT_RANKS = 8
LINT_WALK_BAND = (0.90, 1.00)
LINT_IMPLS = [("cuda", "bfloat16"), ("cuda", "float32"), ("cuda", "int8"),
              ("cuda_ksplit", "bfloat16"), ("cuda_ksplit", "float32")]
LINT_GATE_TIMEOUT_S = 300


def lint_gate_children(out_dir: str) -> dict:
    """`campaign run CAMPAIGN_SPEC --lint --dry-run` and a copy of the spec
    with an unknown key in one [[job]] table under `--lint --no-hlo` (no
    dry run, and no card visible: were the gate to pass, its jobs could
    not reach the card), each a process of its own: {label: (process,
    log, campaign dir)}."""
    import shutil

    work = os.path.join(out_dir, "lint_gate")
    os.makedirs(work, exist_ok=True)
    bad = os.path.join(work, "card_bad.toml")
    shutil.copyfile(CAMPAIGN_SPEC, bad)
    with open(bad) as fh:
        text = fh.read()
    with open(bad, "w") as fh:  # the first [[job]] table gains a typo'd key
        fh.write(text.replace("[[job]]\n", "[[job]]\ntimout_s = 60\n", 1))
    runs = {}
    # two intra-op threads each: the lint in this process shares the cores
    quiet = {**os.environ, "OMP_NUM_THREADS": "2"}
    for label, argv, env in (
            ("ok", ["campaign", "run", CAMPAIGN_SPEC, "--lint", "--dry-run", "--dir",
                    os.path.join(work, "ok")], quiet),
            ("bad", ["campaign", "run", bad, "--lint", "--no-hlo", "--dir",
                     os.path.join(work, "bad")], {**quiet, "CUDA_VISIBLE_DEVICES": ""})):
        log = os.path.join(work, f"{label}.log")
        runs[label] = (start_port(argv, log, env=env), log, os.path.join(work, label))
    return runs


def lint_gate_result(runs: dict) -> tuple[dict, list]:
    out, problems = {}, []
    for label, (proc, log, campaign_dir) in runs.items():
        rc, text = finish_port(proc, log, LINT_GATE_TIMEOUT_S)
        jobs = os.path.join(campaign_dir, "jobs")
        started = os.path.isdir(jobs) and bool(os.listdir(jobs))
        out[label] = {"rc": rc, "jobs_started": started,
                      "gate_failed": "lint gate failed" in text,
                      "lint": [ln for ln in text.splitlines() if ln.startswith("lint: ")]}
        if started:
            problems.append(f"gate[{label}]: a job started ({jobs})")
    if out["ok"]["rc"] != 0 or out["ok"]["gate_failed"]:
        problems.append(f"gate[ok] exit {out['ok']['rc']}: {out['ok']['lint']}")
    if out["bad"]["rc"] == 0 or not out["bad"]["gate_failed"]:
        problems.append(f"gate[bad] exit {out['bad']['rc']}, the seeded key did not "
                        "stop it")
    return out, problems


def lint_walk_vs_allocator() -> tuple[dict, list]:
    """Each mode's full program at each audit world: the live-bytes walk's
    peak beside the allocator's peak over its baseline in the same call."""
    import torch

    from tpu_matmul_bench_torch.analysis import auditor
    from tpu_matmul_bench_torch.analysis.memory_model import MEM_WORLDS, estimate_peak_bytes
    from tpu_matmul_bench_torch.parallel.mesh import make_mesh

    devices = auditor.audit_devices("cuda")
    config = auditor._audit_config("bfloat16", auditor.AUDIT_IMPL, devices[0])
    rows, problems = {}, []
    for world in MEM_WORLDS:
        mesh = make_mesh(devices[:world])
        for mode, builder in sorted(auditor._all_modes().items()):
            setup = builder(config, mesh, auditor.AUDIT_SIZE)
            fn = setup.full if setup.full is not None else setup.compute
            fn(*setup.operands)  # first call: anything made lazily
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            walk = estimate_peak_bytes(fn, *setup.operands)
            torch.cuda.synchronize()
            alloc = torch.cuda.max_memory_allocated() - base
            ratio = walk / alloc if alloc else 0.0
            rows[f"{mode}@d{world}"] = {"walk_bytes": walk, "allocator_bytes": alloc,
                                        "ratio": ratio}
            if not LINT_WALK_BAND[0] <= ratio <= LINT_WALK_BAND[1]:
                problems.append(f"walk {mode}@d{world}: {walk} B over the allocator's "
                                f"{alloc} B = {ratio:.4f}, outside {LINT_WALK_BAND}")
            del setup, fn
    return rows, problems


def lint_seeded() -> tuple[dict, list]:
    """The card path can fire: a mode's compute with an added `.item()`
    (PURE-001, the recorder's and the sync debug mode's both) and a fused
    chain that clones its operands (DONATE-001)."""
    import torch

    from tpu_matmul_bench_torch.analysis import auditor
    from tpu_matmul_bench_torch.parallel.mesh import make_mesh
    from tpu_matmul_bench_torch.utils import timing

    devices = auditor.audit_devices("cuda")
    config = auditor._audit_config("bfloat16", auditor.AUDIT_IMPL, devices[0])
    setup = auditor._all_modes()["batch_parallel"](config, make_mesh(devices[:4]),
                                                   auditor.AUDIT_SIZE)

    def compute_with_item(x, y):
        out = setup.compute(x, y)
        out[0].float().sum().item()
        return out

    rec = auditor.run_recorded(compute_with_item, *setup.operands, card=True)
    pure = auditor._purity_findings(rec, "seeded:batch_parallel/compute+item")
    real = timing._chain

    def cloning_chain(ops, src):
        real([timing._clone(op) for op in ops], src)

    timing._chain = cloning_chain
    try:
        donate = auditor.audit_donation(devices)
    finally:
        timing._chain = real
    torch.cuda.synchronize()
    out = {"pure": [f.rule for f in pure], "host_syncs": rec.host_syncs,
           "sync_debug_raised": any(h.startswith("sync debug mode") for h in rec.host_syncs),
           "donate": [(f.rule, f.where) for f in donate]}
    problems = []
    if out["pure"] != ["PURE-001"] or "item" not in rec.host_syncs \
            or not out["sync_debug_raised"]:
        problems.append(f"seeded .item() did not fire PURE-001 both ways: {out}")
    if not any(rule == "DONATE-001" and "chains operand 0" in where
               for rule, where in out["donate"]):
        problems.append(f"seeded cloning chain did not fire DONATE-001: {out['donate']}")
    return out, problems


# cycles of the busy kernel of `capture_lock_check`: about a second at an
# H100's SM clock
CAPTURE_BUSY_CYCLES = 2_000_000_000


class _TimedLock:
    """A lock that sums the seconds it was held."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.held_s = 0.0

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self._lock.acquire()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.held_s += time.perf_counter() - self._t0
        self._lock.release()


def capture_lock_check() -> tuple[dict, list]:
    """`serve/cache.py capture` of a K1 product under a capture lock, as a
    pod's drain thread captures a miss, while a kernel of about a second
    (`torch.cuda._sleep`) runs on a stream of the other priority pool (so
    neither the side stream nor the capture stream is that stream): the
    capture must return while that kernel still runs, hold the lock for
    under a tenth of the busy kernel's time, call `torch.cuda.synchronize`
    never with the lock held, and its graph's replay must equal an eager
    K1 call. One capture runs first, untimed: a process's first capture
    may load a kernel module lazily (CUDA's lazy loading), which
    synchronises the context once, whatever the lock."""
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.serve import cache

    problems = []
    from tpu_matmul_bench_torch.ops.matmul import random_operands

    (a,) = random_operands(1, (1024, 1024), torch.bfloat16, device="cuda", count=1)
    (b,) = random_operands(2, (1024, 1024), torch.bfloat16, device="cuda", count=1)
    want = cm.cuda_matmul(a, b)
    product = lambda x, y, out: cm.cuda_matmul(x, y, out=out)  # noqa: E731
    cache.capture(product, a, b, lock=threading.Lock())
    lock, synced = _TimedLock(), []
    real_sync = torch.cuda.synchronize

    def spy(*args, **kw):
        synced.append(lock.locked())
        return real_sync(*args, **kw)

    busy = torch.cuda.Stream(priority=-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.cuda.stream(busy):
        torch.cuda._sleep(CAPTURE_BUSY_CYCLES)
    busy_done = torch.cuda.Event()
    busy_done.record(busy)
    torch.cuda.synchronize = spy
    try:
        exe = cache.capture(product, a, b, lock=lock)
    finally:
        torch.cuda.synchronize = real_sync
    capture_s = time.perf_counter() - t0
    still_busy = not busy_done.query()
    busy_done.synchronize()
    busy_s = time.perf_counter() - t0
    exe(a, b)
    exe.wait()
    same = bool(torch.equal(exe.out, want))
    result = {"capture_s": capture_s, "lock_held_s": lock.held_s, "busy_s": busy_s,
              "returned_while_busy": still_busy, "syncs_under_lock": sum(synced),
              "replay_equals_eager": same}
    if not still_busy or lock.held_s > busy_s / 10 or any(synced) or not same:
        problems.append(f"capture under the lock waited for the card or differs: {result}")
    return result, problems


def lint_last_groups() -> tuple[dict, list]:
    """The slice-20 groups on the card (see the module docstring): the
    `sched` and `fingerprint` programs with K1's and K1b's launches counted
    from 0 and held to the recorded products, the card's fingerprints
    against the golden, its schedules against the CPU's, the seeded
    SCHED-001, and the source certifiers' selftests as children (started
    first, read last). Call it with the lint's ranks on the card."""
    from tpu_matmul_bench_torch.analysis import auditor
    from tpu_matmul_bench_torch.analysis import fingerprint as fp
    from tpu_matmul_bench_torch.analysis import schedule as sc
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm

    problems = []
    children = {fam: subprocess.Popen(
        [sys.executable, "-m", "tpu_matmul_bench_torch", "lint", fam, "selftest"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for fam in ("conc", "schema")}
    card = auditor.audit_devices("cuda")
    for name in cm.ROUTES:
        cm.LAUNCHES_BY_ROUTE[name] = 0
    cm.LAUNCHES = cm.REDUCE_LAUNCHES = 0
    sc.PRIMITIVES_RUN.clear()
    t0 = time.perf_counter()
    runs = sc.run_inventory(card)
    sched = sc.audit_sched(card, runs=runs)
    t1 = time.perf_counter()
    fingerprints = fp.current_fingerprints(card)
    t2 = time.perf_counter()
    launches = {"k1": cm.LAUNCHES, "k1b": cm.REDUCE_LAUNCHES,
                "k1_by_route": dict(cm.LAUNCHES_BY_ROUTE)}
    recorded = sc.PRIMITIVES_RUN
    ksplits = recorded["cuda_matmul_ksplit"]
    expected = {"k1": recorded["cuda_matmul"] + ksplits,
                "k1b": ksplits if cm.effective_ksplit(fp.IMPL_SIZE, 2) > 1 else 0}
    if [launches["k1"], launches["k1b"]] != [expected["k1"], expected["k1b"]]:
        problems.append(f"sched+fingerprint launched K1 {launches['k1']} and K1b "
                        f"{launches['k1b']} times, the recorded products say {expected}")
    if not expected["k1"] or not expected["k1b"]:
        problems.append(f"sched+fingerprint recorded no K1 or no K1b product: {expected}")
    golden = fp.load_golden() or {}
    matched = sorted(k for k, v in fingerprints.items() if golden.get(k) == v)
    moved = sorted(set(golden) ^ set(fingerprints) | set(fingerprints) - set(matched))
    if moved or not matched:
        problems.append(f"fingerprints off the golden on the card: {moved}")
    cpu_runs = sc.run_inventory(auditor.audit_devices("cpu"))
    same = sorted(k for k in runs if sc.canonical(runs[k].log.entries)
                  == sc.canonical(cpu_runs[k].log.entries))
    if len(same) != len(runs) or set(runs) != set(cpu_runs):
        problems.append(f"schedules differing from the CPU's: {sorted(set(runs) - set(same))}")
    if sched:
        problems.append(f"sched findings on the card: {[f.to_record() for f in sched]}")
    seeded = sorted({f.rule for f in sc.seeded_serialized_overlap(card)})
    if seeded != ["SCHED-001"]:
        problems.append(f"seeded serialized overlap fired {seeded}, not SCHED-001")
    selftests = {}
    for fam, proc in children.items():
        try:
            text, _ = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            text, _ = proc.communicate()
        selftests[fam] = {"rc": proc.returncode, "last": text.strip().splitlines()[-1:]}
        if proc.returncode != 0:
            problems.append(f"lint {fam} selftest exit {proc.returncode}: {text[-800:]}")
    capture_lock, found = capture_lock_check()
    problems += found
    return {"sched_s": t1 - t0, "fingerprint_s": t2 - t1, "launches": launches,
            "expected_launches": expected, "programs": len(runs),
            "fingerprints_matched": len(matched), "golden_keys": len(golden),
            "fingerprints_moved": moved, "schedules_equal_cpu": len(same),
            "sched_findings": len(sched), "seeded_sched": seeded,
            "selftests": selftests, "capture_lock": capture_lock}, problems


def lint_phase(card: str, out_dir: str, gate: dict) -> dict:
    """The contract auditor on the card (slice 19): `lint --fail-on error
    --json-out` in process, exit 0, its findings by group, rule and
    severity, each group's seconds and K1's and K1b's launches by route
    (counted from 0 just before it); the `impls` products of K1 and K1b
    against their plain versions; seeded PURE-001 and DONATE-001; the walk
    against the allocator; SMEM_PER_BLOCK against the card's opt-in limit;
    `parallel hier selftest` on the card; the campaign's lint gate (`gate`,
    the two processes `lint_gate_children` started beside the campaign);
    and the slice-20 groups (`lint_last_groups`)."""
    import torch

    from tpu_matmul_bench_torch.analysis import auditor
    from tpu_matmul_bench_torch.analysis import cli as lint_cli
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.parallel import cli as parallel_cli

    t0 = time.perf_counter()
    result = {"phase": "lint", "card": card}
    problems = []
    ledger = os.path.join(out_dir, "lint.jsonl")
    with ranks_per_card(LINT_RANKS):
        for name in cm.ROUTES:
            cm.LAUNCHES_BY_ROUTE[name] = 0
        cm.LAUNCHES = cm.REDUCE_LAUNCHES = cm.ACC_LAUNCHES = 0
        t1 = time.perf_counter()
        rc, report_text = in_process(lint_cli.main, ["--device", "cuda", "--fail-on", "error",
                                                     "--json-out", ledger])
        result["lint_s"] = time.perf_counter() - t1
        k1b = cm.REDUCE_LAUNCHES
        by_route = dict(cm.LAUNCHES_BY_ROUTE)
        result["launches"] = {"k1_by_route": by_route, "k1": sum(by_route.values()) - k1b,
                              "k1b": k1b, "pickups": cm.ACC_LAUNCHES}
        result["rc"] = rc
        recs = [json.loads(line) for line in open(ledger)] if os.path.exists(ledger) else []
        manifest = recs[0] if recs else {}
        result["groups"] = manifest.get("lint", {}).get("groups")
        result["summary"] = recs[-1] if recs else None
        result["peak_memory"] = manifest.get("lint", {}).get("peak_memory")
        if rc != 0:
            problems.append(f"lint exit {rc}: {report_text[-1500:]}")
        groups = result["groups"] or {}
        if list(groups) != list(auditor.audit_groups()):
            problems.append(f"lint groups {list(groups)} != {list(auditor.audit_groups())}")
        found = {g: v["findings"] for g, v in groups.items() if v["findings"]}
        if found:
            problems.append(f"lint findings by group: {found}")
        if result["launches"]["k1"] < 1 or k1b < 1:
            problems.append(f"lint launched K1 {result['launches']['k1']} and K1b {k1b} times")
        # K1 and K1b at the impls group's operands against their plain versions
        impls = {}
        plain = {"cuda": cm.matmul_plain,
                 "cuda_ksplit": lambda a, b: cm.matmul_ksplit_plain(a, b, splits=2)}
        for impl, dtype_name in LINT_IMPLS:
            res = compare(dtype_name, (auditor.AUDIT_SIZE,) * 3,
                          lambda x, y, f=auditor._impl_fn(impl): f(x, y), plain[impl])
            impls[f"{impl}/{dtype_name}"] = res
            if not res["ok"]:
                problems.append(f"impls {impl}/{dtype_name}: {res}")
        result["impls"] = impls
        t1 = time.perf_counter()
        result["seeded"], found = lint_seeded()
        problems += found
        result["walk"], found = lint_walk_vs_allocator()
        problems += found
        result["seeded_walk_s"] = time.perf_counter() - t1
        optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
        result["smem"] = {"SMEM_PER_BLOCK": cm.SMEM_PER_BLOCK, "optin": optin}
        if cm.SMEM_PER_BLOCK > optin:
            problems.append(f"SMEM_PER_BLOCK {cm.SMEM_PER_BLOCK} > the card's opt-in {optin}")
        t1 = time.perf_counter()
        before = routes()
        acc = cm.ACC_LAUNCHES
        rc, text = in_process(parallel_cli.main, ["hier", "selftest", "--device", "cuda"])
        result["hier_selftest"] = {"rc": rc, "s": time.perf_counter() - t1,
                                   "pickups": cm.ACC_LAUNCHES - acc,
                                   "routes": routes_since(before),
                                   "lines": [ln for ln in text.splitlines()
                                             if ln.startswith(("hier", "mem gate", "stream"))]}
        if rc != 0 or "hier selftest: OK" not in text:
            problems.append(f"parallel hier selftest exit {rc}: {text[-1000:]}")
        t1 = time.perf_counter()
        result["last_groups"], found = lint_last_groups()
        result["last_groups_s"] = time.perf_counter() - t1
        problems += found
    t1 = time.perf_counter()
    result["gate"], found = lint_gate_result(gate)
    result["gate_wait_s"] = time.perf_counter() - t1
    problems += found
    result["seconds"] = time.perf_counter() - t0
    result["ok"] = not problems
    emit(result)
    if problems:
        fail("lint", "; ".join(problems))
    return result


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


def main(keep_ledgers: str | None = None) -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    try:
        from tpu_matmul_bench_torch.obs import attribution
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
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable: {e}",
              file=sys.stderr)
        sys.exit(2)

    # each stretch's seconds, printed on the `seconds` line
    laps, mark = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = now - mark[0]
        mark[0] = now

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
    lap("build")

    # 3. each kernel against its plain version, on the card, in true fp32
    apply_matmul_precision("highest")
    cases = [(d, s) for d in TOLERANCE for s in SHAPES]
    cases.append(("bfloat16", (SIZE, SIZE, SIZE)))
    # K1's two other shapes in the scaling modes (matrix and model parallel)
    cases += [("bfloat16", mkn) for mkn in dict.fromkeys(SCALING_SHAPES.values())
              if mkn != (SIZE, SIZE, SIZE)]
    # and its four in the collective-matmul rings, and hybrid's and SUMMA's
    cases += [("bfloat16", mkn) for mkn in CM_SHAPES]
    cases += [("bfloat16", HYBRID_SHAPE), ("bfloat16", SUMMA_SHAPE)]
    # and each rank's product in the pod cells
    cases += [("bfloat16", mkn) for mkn in POD_RANK_SHAPES]
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
    stream_pickup = check_stream_pickup()
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
    check_overlap_races()
    lap("kernel_vs_plain")

    # 4. the paths through their entry points; launch counts are set to 0
    # just before each run and read just after
    with tempfile.TemporaryDirectory() as out_dir:
        dispatch, launches = drive("cuda", "dispatch", out_dir)
        fused, launches_fused = drive("cuda", "fused", out_dir)
        library, _ = drive("torch", "dispatch", out_dir)
        library_fused, _ = drive("torch", "fused", out_dir)
        c1 = c1_check([dispatch, fused, library, library_fused], out_dir)
        lap("main_path")
        headline = headline_phase(fused["tflops"], out_dir)
        lap("headline")
        tiles_mnk, _, _, _ = tune(f"tune[{SIZE}]", ["--sizes", str(SIZE)], out_dir)
        tiles_nmk, _, _, _ = tune(f"tune[{SIZE},nmk]", ["--sizes", str(SIZE),
                                                        "--grid-order", "nmk"], out_dir)
        _, gemm_sq, reduce_sq, books_sq = tune(
            f"tune[ksplit,{SIZE}]", ["--sizes", str(SIZE), "--ksplit", "2"],
            out_dir, ksplit=2)
        _, gemm_tall, reduce_tall, books_tall = tune(
            "tune[ksplit,{}x{}x{},nmk]".format(*TALL),
            ["--mkn", *map(str, TALL), "--grid-order", "nmk", "--ksplit", "2"],
            out_dir, ksplit=2)
        lap("tune")
        tune_db = tune_db_phase(tune_ledger(f"tune[{SIZE}]", out_dir), out_dir)
        lap("tune_db")
        # each HBM ring's overlap run, then its tile sweep (the `tune_ring`
        # phase) at the same point of the clock's fall
        overlaps, tuned_rings = {}, {}
        for label, mode in TUNE_RINGS.items():
            overlaps[label] = drive_overlap(mode, out_dir)
            tuned_rings[label] = tune_ring(label, overlaps[label][0]["avg_ms"], out_dir)
        overlaps["ring_fused"] = drive_overlap("cuda_ring", out_dir, size=cap)
        k2_at_cap, _ = drive_overlap("cuda_ring_hbm", out_dir, size=cap)
        lap("overlap_tune_ring")
        scaling = scaling_phase(out_dir)
        comm_quant_phase(scaling, out_dir)
        lap("scaling_comm_quant")
        wire_phase(card)
        collectives_phase(card, out_dir)
        lap("wire_collectives")
        hybrid = hybrid_phase(out_dir)
        summa = summa_phase(out_dir)
        stream = stream_phase(card, out_dir)
        lap("hybrid_summa_stream")
        overlap_modes = overlap_modes_phase(out_dir)
        cm_turns = collective_turns(card)
        lap("overlap_modes_turns")
        profile = profile_phase(cap, out_dir)
        lap("profile")
        # the curve, membw, doctor, compare and train programs
        t0 = time.perf_counter()
        curve = curve_phase(out_dir)
        membw_phase(card, out_dir)
        doctor_phase()
        compared = compare_phase(cap, out_dir)
        train_phase(card, out_dir)
        emit({"phase": "programs", "seconds": time.perf_counter() - t0, "ok": True})
        lap("programs")
        serve = serve_phase(card, out_dir)
        lap("serve")
        pod = pod_phase(card, out_dir)
        lap("pod")
        # the campaign runner and the fault certifier (slice 17): their
        # jobs and cells are child processes that own the card in turn
        torch.cuda.empty_cache()
        beside, tail = start_faults_beside(out_dir), {}
        # the lint phase's campaign gate (slice 19): two CPU processes that
        # never touch the card, beside the campaign as the faults smoke is
        gate = lint_gate_children(out_dir)
        try:
            campaign = campaign_phase(card, fused["tflops"], out_dir, beside, tail)
            lap("campaign")
            faults = faults_phase(card, out_dir, beside)
            lap("faults")
            # the perf observatory (slice 18): the tail started beside the
            # campaign, the selftest on the card, the history and its gate
            obs = obs_phase(card, out_dir, tail, keep_ledgers)
            lap("obs")
            # the contract auditor (slice 19)
            torch.cuda.empty_cache()
            lint = lint_phase(card, out_dir, gate)
            lap("lint")
        finally:
            stop_faults_beside(beside)
            stop_faults_beside(gate)
            stop_obs_tail(tail)

    # 5. the plain version's time at the headline shape
    a, b = random_operands(0, (SIZE, SIZE), torch.bfloat16, device="cuda")
    plain_ms = events_ms(lambda: matmul_plain(a, b), runs=3)
    del a, b
    torch.cuda.empty_cache()

    # every bound from the kernels' cost books (obs/attribution.py): the
    # product's operations at the card's peak, or its bytes (A and B read
    # once, C written once) at its memory rate
    name = torch.cuda.get_device_name(0)
    try:
        bound_ms, bound_by = attribution.bound(SIZE, SIZE, SIZE, torch.bfloat16, name)
    except ValueError as e:
        fail("bound", str(e))

    # 6. the split-K at both tune shapes: S=2, default tile, dispatch
    square = ksplit_entry((SIZE, SIZE, SIZE), ksplit_errors[(SIZE, SIZE, SIZE)],
                          gemm_sq, reduce_sq, name)
    tall = ksplit_entry(TALL, ksplit_errors[TALL], gemm_tall, reduce_tall, name)
    square["cost_analysis"] = books_sq
    tall["cost_analysis"] = books_tall

    # 7. the rings at bf16 16384^2 over RING_WORLD ranks on the card, the
    # fused ring at its cap, beside K2 on the same operands
    fused_summary, fused_counts = overlaps.pop("ring_fused")
    entries = {label: ring_entry(label, counts, summary["baseline_ms"], card, name)[0]
               for label, (summary, counts) in overlaps.items()}
    entries["ring_fused"], (fused_ring, x, w) = ring_entry(
        "ring_fused", fused_counts, fused_summary["baseline_ms"], card, name, size=cap)
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
    # each ring kernel beside the collective-matmul ring of its contract
    for mode, turns in cm_turns.items():
        entries[turns["kernel"]].update(
            turns_vs_collective_matmul={"mode": mode, "kernel_ms": turns["kernel_ms"],
                                        "collective_matmul_ms": turns["ms"],
                                        "library_ms": turns["library_ms"]})
    for label, tiles in tuned_rings.items():
        entries[label]["tune_ring"] = tiles
    # each ring's row of the compare table (K6's at its cap): its ms, its
    # baseline (the library product, compute_ms) and its step launches
    for label, mode in TUNE_RINGS.items():
        entries[label]["compare"] = compared["table"]["rows"][mode]
    entries["ring_fused"]["compare"] = compared["cap"]["rows"]["cuda_ring"]
    for label in AG_STEPS:
        turns = ring_turns(label, card)
        entries[label].update(
            turns_ms=turns["forward_ms"], turns_hop_ms=turns["hop_ms"],
            turns_library_ms=turns["library_ms"],
            forward_over_library=turns["forward_over_library"],
            hop_over_library=turns["hop_over_library"],
            step=ag_step_ms(label), step_max_abs_err=ag_errors[label])
    lap("tail")
    emit({"phase": "seconds", "laps": laps, "total": sum(laps.values()), "card": card})
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
        "bound_ms": bound_ms, "bound_by": bound_by,
        "cost_analysis": dispatch["cost_analysis"],
        "library_ms": library["avg_ms"], "library_fused_ms": library_fused["avg_ms"],
        "c1": c1, "card": card, "headline": headline,
        "tiles_ms": {t: {"mnk": tiles_mnk[t], "nmk": tiles_nmk[t]}
                     for t in tiles_mnk},
        # each parallel mode's products over RING_WORLD ranks (dispatch)
        "scaling": {mode: {"shape": r["cuda,dispatch"]["k1_shape"],
                           "launches": r["cuda,dispatch"]["k1_launches"],
                           "mode_ms": r["cuda,dispatch"]["avg_ms"],
                           "library_mode_ms": r["torch,dispatch"]["avg_ms"]}
                    for mode, r in scaling.items()},
        # the overlap program's library modes over RING_WORLD ranks
        # (dispatch; a step's ms for the step modes, a call's for the rings)
        "overlap_modes": {mode: {"launches": r["cuda,dispatch"]["k1_launches"],
                                 "per": r["cuda,dispatch"]["per"],
                                 "mode_ms": r["cuda,dispatch"]["avg_ms"],
                                 "library_mode_ms": r["torch,dispatch"]["avg_ms"]}
                          for mode, r in overlap_modes.items()},
        # the 2-D modes over RING_WORLD ranks (a call's ms; launches of the
        # dispatch run), and the out-of-core stream's panel products on the
        # pickup kernel (cuda_matmul_acc, tmb_matmul_acc) over one rank
        "hybrid": {"shape": "x".join(map(str, HYBRID_SHAPE)),
                   "launches": hybrid["cuda,dispatch"]["k1_launches"],
                   "launches_a_call": K1_PER_CALL["hybrid"],
                   "mode_ms": hybrid["cuda,dispatch"]["avg_ms"],
                   "fused_ms": hybrid["cuda,fused"]["avg_ms"],
                   "library_mode_ms": hybrid["torch,dispatch"]["avg_ms"],
                   "library_fused_ms": hybrid["torch,fused"]["avg_ms"],
                   "mesh_wire_ms": hybrid["cuda,dispatch,mesh"]["avg_ms"]},
        "summa": {"shape": "x".join(map(str, SUMMA_SHAPE)),
                  "launches": summa["cuda,dispatch"]["k1_launches"],
                  "launches_a_call": K1_PER_CALL["summa"],
                  "mode_ms": summa["cuda,dispatch"]["avg_ms"],
                  "fused_ms": summa["cuda,fused"]["avg_ms"],
                  "library_mode_ms": summa["torch,dispatch"]["avg_ms"],
                  "library_fused_ms": summa["torch,fused"]["avg_ms"]},
        # the scaling curve's rows (batch_parallel over 1, 2, 4 ranks)
        "curve": curve["counts"],
        # the serving path: bf16 SERVE_MIX at SERVE_QPS open loop under
        # `cuda`, each request a replay of its bucket's captured K1 (the
        # launches are the prewarm's first calls and captures; the window's
        # K1 kernels equal its requests), beside the same stream under
        # `torch`; each bucket's warm dispatch beside K1's kernel ms
        "serve": serve,
        # pod serving (the `pod` phase): SERVE_MIX over POD_RANKS ranks on the
        # card in POD_GROUPS groups of POD_MESH under `cuda`, each request a
        # replay of its group's captured program (POD_K1_A_REQUEST K1 kernels,
        # one a rank); the launches are the prewarm's first calls and
        # captures; K1 and cuBLAS at the per-rank products
        "pod": pod,
        # `auto` through a measured `cuda` DB cell at bf16 SIZE³ (tune_db)
        "tune_db": {k: tune_db[k] for k in ("launches", "launches_by_route", "cell",
                                            "max_abs_err", "auto_ms", "cuda_ms",
                                            "lookup_us", "int8_auto")},
        # the campaign phase: K1 in the cuda job's child (its trace's
        # kernels), that job's TFLOPS beside this process's fused run, and
        # `auto` through the filled DB in this process (launches counted)
        "campaign": {"trace": campaign["traces"]["matmul_cuda"],
                     **{k: campaign["numbers"][k] for k in (
                         "cuda_job_tflops", "in_process_fused_tflops",
                         "cuda_job_over_in_process", "resumed_over_pre_kill")},
                     "fill_auto_launches": campaign["fill"].get("auto_k1_launches"),
                     "fill_cell": campaign["fill"].get("cell"),
                     "faults_s": faults["seconds"]},
        # the obs phase: `obs selftest --device cuda`'s bucket executable, a
        # CUDA graph of K1 (launches counted while it was built), its
        # output against the plain version, its cost books; the cuda job's
        # history point and its gate against round 1
        "obs": {"selftest": {k: obs["selftest"].get(k) for k in (
                    "bucket", "k1_launches", "launches_by_route", "route", "tile",
                    "max_abs_err", "books", "replay_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by")},
                "cuda_job_point": obs["history"]["cuda_job_point"],
                "gate": [r for r in obs["gate"]["rows"] if r["job"] == CAMPAIGN_DOCTORED_JOB]},
        # the lint phase: its in-process lint's K1 launches by route (counted
        # from 0 just before it), and K1 at the impls group's operands
        "lint": {"launches": lint["launches"]["k1"],
                 "launches_by_route": lint["launches"]["k1_by_route"],
                 # sched's and fingerprint's programs alone (slice 20)
                 "sched_fingerprint_launches": lint["last_groups"]["launches"],
                 "seconds": lint["lint_s"],
                 "impls": {k: v for k, v in lint["impls"].items() if k.startswith("cuda/")},
                 "hier_selftest_pickups": lint["hier_selftest"]["pickups"]},
        "stream": {"kernel": "cuda_matmul_acc (tmb_matmul_acc)",
                   "shape": [STREAM_SIZE, STREAM_SIZE // STREAM_PANELS, STREAM_SIZE],
                   "launches": stream["cuda"]["acc_launches"],
                   "max_abs_err": stream_pickup["max_abs_err"],
                   "stream_ms": stream["cuda"]["avg_ms"],
                   "library_stream_ms": stream["torch"]["avg_ms"],
                   "products_bound_ms": attribution.bound(
                       STREAM_SIZE, STREAM_SIZE, STREAM_SIZE, torch.bfloat16, name)[0],
                   **stream["parts"]},
    }, {
        "name": "matmul_ksplit", "route": "cuda",
        "source": "tpu_matmul_bench_torch/csrc/matmul.cu",
        "replaces": "tpu_matmul_bench/ops/pallas_matmul.py:352",
        "replaces_function": "pallas_matmul_ksplit",
        "dtype": "bfloat16", "card": card,
        **square, "shapes": [square, tall],
        # the campaign phase's split-K job (tall shape, S = 2) in its child
        "campaign": {"trace": campaign["traces"]["tune_ksplit"],
                     "job_tflops": campaign["jobs"]["tune_ksplit"]["tflops"]},
        # the obs phase ingests and gates that job's ledger; it runs nothing
        "obs": {"gate": [r for r in obs["gate"]["rows"] if r["job"] == "tune_ksplit"]},
        # the lint phase's impls group: K1b (S = 2) at 256³, bf16 and fp32
        "lint": {"launches": lint["launches"]["k1b"],
                 "impls": {k: v for k, v in lint["impls"].items()
                           if k.startswith("cuda_ksplit/")}},
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
    if sys.argv[1:2] == ["--pod-warm-start"]:
        pod_warm_start_child(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--keep-ledgers"] and len(sys.argv) == 3:
        main(keep_ledgers=os.path.abspath(sys.argv[2]))
    else:
        main()
