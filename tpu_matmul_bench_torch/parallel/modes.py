"""Mode machinery: `ModeSetup`, `run_mode_benchmark`, the memory estimate,
and result validation for `--validate`.

Port of `tpu_matmul_bench/parallel/modes.py:57-160, 197-298, 633-713`: a
mode builds two programs over the world of ranks (`parallel/mesh.py`), a
compute leg (for the overlap modes, the serialized baseline) and a full
program (the ring), which `run_mode_benchmark` times interleaved; and the
corner check that compares a result's top-left corner with a recomputed
reference. The scaling modes of that file come with the scaling slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from tpu_matmul_bench_torch.utils.config import BenchConfig
from tpu_matmul_bench_torch.utils.metrics import (
    as_dtype,
    bytes_per_element,
    is_integer_dtype,
    matmul_out_dtype,
)
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord
from tpu_matmul_bench_torch.utils.timing import (
    Timing,
    choose_timer,
    effective_warmup,
    latency_percentiles_ms,
    sample_extras,
    time_variants,
)


@dataclasses.dataclass
class ModeSetup:
    """Programs + operands + record semantics for one mode at one size."""

    mode: str
    operands: tuple[Any, ...]
    compute: Callable[..., Any]
    full: Callable[..., Any] | None  # None → no communication leg
    # (t_compute, t_full, comm_s) -> record; captures the mode's TFLOPS math
    build_record: Callable[[Timing, Timing | None, float], BenchmarkRecord]
    # estimated GiB per rank of operands, buffers and outputs (pre-flight
    # memory guard; the guard sums the ranks that share a device)
    memory_gib_per_device: float
    # --validate: corner-check the mode's result against a recomputed
    # reference (None → not applicable)
    validate: Callable[[], dict] | None = None
    # whether --timing fused may capture this setup's programs in one CUDA
    # graph (utils/timing.fuse_iterations). The ring kernels opt out: their
    # per-rank streams and events are not captured, so they demote to the
    # dispatch protocol
    fusable: bool = True

# --validate corner size (the reference's 10×10 spot check, widened)
VALIDATION_CORNER = 128


def validation_tolerance(dtype: Any) -> float:
    """Integer matmuls are exact; half dtypes get rounding headroom; fp32
    keeps the reference's 1e-3, or 2e-2 while TF32 is allowed (products
    rounded to a 10-bit mantissa), the headroom the JAX package gives fp32
    on the TPU for its bf16 passes."""
    d = as_dtype(dtype)
    if is_integer_dtype(d):
        return 0.0
    if d.itemsize >= 4:
        return 2e-2 if torch.backends.cuda.matmul.allow_tf32 else 1e-3
    return 3e-2


def expected_corner(a: torch.Tensor, b: torch.Tensor,
                    corner: int = VALIDATION_CORNER) -> torch.Tensor:
    """Reference for C[:corner, :corner]: full-K product of A's first rows
    and B's first columns in float64, on the operands' device. float64 is
    exact for the int8 operands (the card has no integer matmul) and is
    unaffected by the TF32 switch."""
    c = min(corner, a.shape[0], b.shape[1])
    return a[:c].double() @ b[:, :c].double()


def corner_validation(got: torch.Tensor, expected: torch.Tensor, dtype: Any,
                      tol: float | None = None) -> dict:
    """Compare a result corner with the reference: max |got - expected|
    relative to max |expected|, against the dtype's tolerance."""
    g = got.detach().double().cpu()
    e = expected.detach().double().cpu()
    denom = float(e.abs().max()) or 1.0
    err = float((g - e).abs().max()) / denom
    if tol is None:
        tol = validation_tolerance(dtype)
    return {
        "validation": "ok" if err <= tol else "FAILED",
        "validation_max_rel_err": round(err, 8),
        "validation_tolerance": tol,
    }


def make_corner_validate(program, operands, expected_fn, dtype,
                         index: int | None = None) -> Callable[[], dict]:
    """A ModeSetup.validate closure: run `program` over `operands`, take
    `[index]` of the result when the output is stacked, and corner-compare
    the global result against `expected_fn()`. A sharded result (a list of
    per-rank shards, `parallel/mesh.Sharded`) is read from the shards that
    hold the corner."""
    from tpu_matmul_bench_torch.parallel.mesh import Sharded, global_block

    def validate() -> dict:
        out = program(*operands)
        if index is not None:
            out = out[index]
        c = VALIDATION_CORNER
        got = (global_block(out, c, c) if isinstance(out, Sharded)
               else out[:c, :c])
        return corner_validation(got, expected_fn(), dtype)

    return validate


def _record_base(config: BenchConfig, benchmark: str, mode: str, size: int,
                 world: int, timing: Timing, **kw) -> BenchmarkRecord:
    return BenchmarkRecord(
        benchmark=benchmark, mode=mode, size=size, dtype=config.dtype_name,
        world=world, iterations=timing.iterations, warmup=config.warmup, **kw)


def _gib(size: int, dtype: Any, count: float) -> float:
    return count * size * size * bytes_per_element(dtype) / (1024**3)


def estimate_memory_gib(mode: str, config: BenchConfig, world: int,
                        size: int) -> float:
    """Per-rank footprint of a mode's operands, buffers and outputs, in
    GiB: the single source for ModeSetup.memory_gib_per_device and the
    pre-flight guard (pure: it never touches the allocator). The rows of
    the JAX package's `estimate_memory_gib` for the modes the port runs;
    ranks that share a device add up (the guard multiplies)."""
    d = world
    out_dtype = matmul_out_dtype(config.dtype)  # int8 products are int32

    def gib(in_count: float, out_count: float) -> float:
        return _gib(size, config.dtype, in_count) + _gib(size, out_dtype, out_count)

    if mode in ("cuda_ring_hbm", "cuda_ring_bidir_hbm"):
        # sharded operands (2/d) + the 2-slot receive buffer (2/d, operand
        # dtype) + full-size C + one temp (the baseline's gathered X)
        return gib(4.0 / d, 2)
    if mode in ("cuda_ring_rs_hbm", "cuda_ring_bidir_rs_hbm"):
        # sharded operands (2/d) + the baseline's full partial product and
        # scatter temp (out dtype) + the 4 slots (4/d, out dtype: 2 receive
        # + 2 staging, all partial sums)
        return gib(2.0 / d, 2 + 4.0 / d)
    if mode in ("collective_matmul", "collective_matmul_bidir",
                "collective_matmul_rs", "collective_matmul_bidir_rs",
                "cuda_ring") and d > 1:
        # sharded operands (2/d) + full-size combined C + one temp
        return gib(2.0 / d, 2)
    # world-1 fallback: full A, B, C per rank
    return gib(2, 1)


def _pre_validate(setup: ModeSetup, config: BenchConfig) -> dict:
    """--validate verdict, computed before the timed run so a wrong kernel
    fails fast."""
    if not config.validate:
        return {}
    if setup.validate is None:
        return {"validation": "n/a (program outputs per-step scalars)"}
    return setup.validate()


def run_mode_benchmark(setup: ModeSetup, config: BenchConfig) -> BenchmarkRecord:
    """Time a mode's programs and build its record.

    The --timing protocol threads through every program; a non-fusable
    setup (the ring kernels) demotes to the dispatch protocol, and the
    record's `timing` extra reports what actually ran.
    """
    protocol = config.timing if setup.fusable else "dispatch"
    verdict = _pre_validate(setup, config)

    def _tag(rec: BenchmarkRecord) -> BenchmarkRecord:
        if config.timing != "dispatch":
            rec.extras["timing"] = protocol  # what ran, not what was asked
        rec.warmup = effective_warmup(protocol, config.iterations, config.warmup)
        return rec

    if setup.full is None:
        t_compute = choose_timer(protocol)(
            setup.compute, setup.operands,
            iterations=config.iterations, warmup=config.warmup)
        rec = _tag(setup.build_record(t_compute, None, 0.0))
        timed = setup.compute
        reliable = t_compute.reliable
    else:
        t_compute, t_full, comm_s = time_variants(
            setup.compute, setup.full, setup.operands,
            iterations=config.iterations, warmup=config.warmup,
            protocol=protocol)
        rec = _tag(setup.build_record(t_compute, t_full, comm_s))
        # sampled on the full program: the distribution of the quantity
        # the headline avg_time_s reports
        timed = setup.full
        reliable = t_compute.reliable and t_full.reliable
    if not reliable:
        rec.extras["timing_reliable"] = False
    if config.percentiles:
        rec.extras["latency_ms"] = latency_percentiles_ms(
            timed, setup.operands, config)
    if config.samples:
        rec.extras["samples"] = sample_extras(timed, setup.operands, config)
    rec.extras.update(verdict)
    return rec
