"""The out-of-core K-streaming runner: gate, stage, stream, validate, time.

Port of `tpu_matmul_bench/parallel/stream_k.py`; `ops/stream_k.py` owns the
mechanics. The order of work is the certificate the program promises:

1. **Gate before allocating.** `analysis/memory_model.check_stream_budget`
   (MEM-003) must pass for the plan before any host or device allocation:
   the windows of the ranks on one device fit `--mem-budget-gib` (default:
   the device's own memory). `nonstreaming_over_budget` records which
   in-core modes the same budget rejects at this shape.
2. **Stage.** The seeded host operands (JAX's numpy generator, so the bits
   are JAX's for a seed) laid out once, pinned when the ranks are on a
   card, before anything is timed.
3. **Stream, validate, time.** `--validate` corner-checks the accumulator
   against a float64 host reference; one warm-up call, then the timed calls,
   each synchronised, on the wall clock, as JAX times them.

Run: python -m tpu_matmul_bench_torch parallel stream --sizes 32768 \
        --stream-k 16 --mem-budget-gib 5.5 --matmul-impl cuda
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_matmul_bench_torch.analysis.memory_model import (
    check_stream_budget,
    default_budget_gib,
    nonstreaming_over_budget,
    stream_window_bytes,
)
from tpu_matmul_bench_torch.ops.stream_k import StreamPlan, acc_dtype, stage_host, stream_matmul
from tpu_matmul_bench_torch.parallel.mesh import Mesh, global_block, mesh_device_kind
from tpu_matmul_bench_torch.parallel.modes import VALIDATION_CORNER, corner_validation
from tpu_matmul_bench_torch.utils.config import BenchConfig
from tpu_matmul_bench_torch.utils.metrics import calculate_tflops, is_integer_dtype
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord, report

#: panel count when --stream-k is omitted
DEFAULT_PANELS = 8
#: windows of panels staged at a time (double-buffered)
WINDOW = 2


def host_operands(config: BenchConfig, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded host operands from JAX's numpy generator (`parallel/
    stream_k.py:55-68`), as CPU tensors: the same draws in the same order,
    so the bits are JAX's for a seed (bf16 rounds fp32 to nearest even, as
    ml_dtypes does). Made on the host end to end: they may not fit the
    card."""
    rng = np.random.default_rng(config.seed)
    dt = config.dtype
    if is_integer_dtype(dt):
        a = rng.integers(-4, 4, (size, size), dtype=np.int8)
        b = rng.integers(-4, 4, (size, size), dtype=np.int8)
        return torch.from_numpy(a), torch.from_numpy(b)
    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((size, size), dtype=np.float32))
        out.append(x if dt == torch.float32 else x.to(dt))
        del x
    return out[0], out[1]


def _expected_corner_host(a: torch.Tensor, b: torch.Tensor,
                          corner: int = VALIDATION_CORNER) -> torch.Tensor:
    """The float64 host reference of C[:corner, :corner] (a full-K product
    of A's first rows and B's first columns; exact for int8)."""
    c = min(corner, a.shape[0], b.shape[1])
    return a[:c].double() @ b[:, :c].double()


def stream_gate(config: BenchConfig, size: int, mesh: Mesh) -> tuple[StreamPlan, dict]:
    """The MEM-003 gate for one shape: the validated plan and the
    certificate's extras, or SystemExit(1) with the finding printed, before
    anything is allocated."""
    world = mesh.size
    panels = config.stream_k or DEFAULT_PANELS
    budget = (config.mem_budget_gib if config.mem_budget_gib is not None
              else default_budget_gib(mesh.devices[0]))
    per_card = mesh.ranks_per_card
    plan = StreamPlan(size=size, panels=panels, window=WINDOW, world=world)
    findings = check_stream_budget(size, config.dtype, world, panels, window=plan.window,
                                   budget_gib=budget, ranks_per_card=per_card)
    if findings:
        for f in findings:
            report(f"\nMEM GATE [{f.severity}] {f.rule} {f.where}: {f.message}")
        raise SystemExit(1)
    resident = stream_window_bytes(size, config.dtype, world, panels, window=plan.window)
    full_gib = (2 * size * size * config.dtype.itemsize
                + size * size * acc_dtype(config.dtype).itemsize) / 2**30
    over = nonstreaming_over_budget(config, world, size, budget, ranks_per_card=per_card)
    return plan, {
        "panels": plan.panels,
        "window": plan.window,
        "resident_gib": round(resident / 2**30, 4),  # a rank's
        "budget_gib": budget,
        "ranks_per_card": per_card,
        "full_problem_gib": round(full_gib, 4),
        # the contrast certificate: in-core modes the same budget rejects
        "nonstreaming_over_budget": over,
        "out_of_core": bool(over),
    }


def _sync(mesh: Mesh) -> None:
    for card in mesh.cards:
        if card.type == "cuda":
            torch.cuda.synchronize(card)


def stream_benchmark(config: BenchConfig, mesh: Mesh, size: int) -> BenchmarkRecord:
    """Gate, stage, stream, validate and time one out-of-core matmul."""
    world = mesh.size
    plan, cert = stream_gate(config, size, mesh)

    a, b = host_operands(config, size)
    expected = _expected_corner_host(a, b) if config.validate else None
    host = stage_host(a, b, plan, pin=mesh.devices[0].type == "cuda")
    del a, b

    def call():
        return stream_matmul(host, mesh, config.matmul_impl, config.blocks)

    verdict = {}
    if config.validate:
        c = call()
        corner = VALIDATION_CORNER
        verdict = corner_validation(global_block(c, corner, corner), expected, config.dtype)
        del c
    # one warm-up call builds the kernels and touches every path; more
    # would stream the whole operands again for nothing
    call()
    _sync(mesh)
    t0 = time.perf_counter()
    for _ in range(config.iterations):
        call()
        _sync(mesh)
    avg = (time.perf_counter() - t0) / config.iterations

    tflops_total = calculate_tflops(size, avg)
    cards = mesh.card_count
    rec = BenchmarkRecord(
        benchmark="stream", mode="stream_k", size=size, dtype=config.dtype_name,
        world=world, iterations=config.iterations, warmup=1, avg_time_s=avg,
        tflops_per_device=tflops_total / cards, tflops_total=tflops_total,
        device_kind=mesh_device_kind(mesh),
        extras={"stream_k": cert, "cards": cards, "ranks_per_card": mesh.ranks_per_card})
    if config.mesh:
        rec.extras["mesh"] = config.mesh
    rec.extras.update(verdict)
    return rec
