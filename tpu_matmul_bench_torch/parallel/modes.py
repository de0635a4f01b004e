"""The scaling modes and their machinery: `ModeSetup`, `run_mode_benchmark`,
the memory estimate, and result validation for `--validate`.

Port of `tpu_matmul_bench/parallel/modes.py`: a mode builds two programs
over the world of ranks (`parallel/mesh.py`), a compute leg (for the
overlap modes, the serialized baseline) and a full program (compute, then
the collective; for the overlap modes, the ring), which
`run_mode_benchmark` times interleaved, with a third program for the step
modes of `parallel/overlap.py` (the full one without its collective); and
the corner check that compares
a result's top-left corner with a float64 reference. The five parallel
modes (`independent`, `batch_parallel`, `matrix_parallel`, `data_parallel`,
`model_parallel`) take every product from `ops/matmul.py matmul_2d`, so
`--matmul-impl cuda` runs each on the hand-written GEMM (K1). Their
collectives come from `parallel/collectives.py psum_impl` and
`allgather_impl`: the exact `psum_over` and `all_gather_over`, or under
`--comm-quant` a quantized wire format, whose runs validate against
`quantized_tolerance` and whose records carry `extras["comm_quant"]`.

TFLOPS: `tflops_total` keeps the JAX formula of each mode. The ranks that
share a card run their products one after another, so that formula gives
the total over the cards; `tflops_per_device` is `tflops_total / cards`
(extras `cards`, `ranks_per_card`), so `peak_efficiency_pct` keeps its
0–100 meaning. With one rank per card both reduce to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from tpu_matmul_bench_torch.ops.matmul import Matmul, matmul_2d
from tpu_matmul_bench_torch.parallel.collectives import (
    allgather_impl,
    check_wire_payload,
    comm_quant_record_extra,
    is_per_link_spec,
    parse_link_formats,
    parse_wire_format,
    psum_impl,
)
from tpu_matmul_bench_torch.parallel.mesh import (
    COLS,
    REPLICATED,
    ROWS,
    Mesh,
    Sharded,
    global_block,
    home_device,
    mesh_device_kind,
    sharded_normal,
    stacked_item,
    world_size,
)
from tpu_matmul_bench_torch.parallel.quantized import uses_quantized_comm
from tpu_matmul_bench_torch.utils.config import BenchConfig
from tpu_matmul_bench_torch.utils.metrics import (
    as_dtype,
    bytes_per_element,
    calculate_tflops,
    is_integer_dtype,
    matmul_acc_dtype,
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
    time_variants_n,
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
    # third program: the full program's streams, events and buffers with
    # its collective left out. When present, comm = full − nocomm (the
    # collective alone) and overhead = nocomm − compute (the machinery's
    # own cost, reported apart as extras.overhead_time_s)
    nocomm: Callable[..., Any] | None = None
    # steps one program call runs (the step programs); per-step figures
    # divide by it
    steps_per_program: int = 1
    # whether --timing fused may capture this setup's programs in one CUDA
    # graph (utils/timing.fuse_iterations), side streams included through
    # the fork and join events of `ops/cuda_ring.py _Schedule`. The ring
    # kernels (K2–K6) opt out, as the JAX package's Pallas rings do, so
    # they demote to the dispatch protocol
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


def expected_corner_sum(a: torch.Tensor, b: torch.Tensor,
                        corner: int = VALIDATION_CORNER) -> torch.Tensor:
    """Reference corner for Σ_i A[i]·B[i] over a stacked leading dim (the
    all_reduce-of-products modes), in float64 on the operands' device."""
    c = min(corner, a.shape[1], b.shape[2])
    return torch.einsum("bik,bkj->ij", a[:, :c].double(), b[:, :, :c].double())


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


def quantized_tolerance(comm_quant: str | None, world: int) -> float | None:
    """The corner-validation tolerance a quantized-wire run must meet, or
    None for exact collectives (JAX `modes.py:163-195`).

    The wire ring's worst case grows ~(per-step rounding)·world, so the
    tolerance scales with the reduction width: int8 rounds to 1/254 of the
    block max (2·world/254), float8_e4m3fn's 3-bit mantissa to at most 1/16
    of each value (2·world/16, a sanity rail; the seeded accuracy bounds
    live in the tests). A per-link spec takes the loosest per-step rounding
    among its named formats.
    """
    if is_per_link_spec(comm_quant):
        fmts = [f for f in parse_link_formats(comm_quant).values()
                if f is not None]
        if not fmts:
            return None
        per_step = max(2 / 254 if f.qtype == "int8" else 2 / 16
                       for f in fmts)
        return max(validation_tolerance(torch.bfloat16), world * per_step)
    fmt = parse_wire_format(comm_quant)
    if fmt is None:
        return None
    per_step = 2 / 254 if fmt.qtype == "int8" else 2 / 16
    return max(validation_tolerance(torch.bfloat16), world * per_step)


def make_corner_validate(program, operands, expected_fn, dtype,
                         index: int | None = None,
                         comm_quant: str | None = None,
                         world: int = 1) -> Callable[[], dict]:
    """A ModeSetup.validate closure: run `program` over `operands`, take
    `[index]` of the result when the output is stacked, and corner-compare
    the global result against `expected_fn()`, within
    `quantized_tolerance(comm_quant, world)` when a float run's collective
    is quantized. A sharded result (a list of per-rank shards,
    `parallel/mesh.Sharded`) is read from the shards that hold the
    corner."""
    def validate() -> dict:
        out = program(*operands)
        if index is not None:
            out = stacked_item(out, index) if isinstance(out, Sharded) else out[index]
        c = VALIDATION_CORNER
        got = (global_block(out, c, c) if isinstance(out, Sharded)
               else out[:c, :c])
        tol = quantized_tolerance(comm_quant, world)
        if tol is not None and not is_integer_dtype(dtype):
            # integer inputs bypass the quantized wire (the exact psum)
            # and keep their exact tolerance
            return corner_validation(got, expected_fn(), dtype, tol=tol)
        return corner_validation(got, expected_fn(), dtype)

    return validate


def _stacked_mm(mm: Matmul) -> Matmul:
    """Per-rank batched matmul: `mm` on each matrix of the rank's (small)
    leading dim, so `--matmul-impl cuda` stays on K1 for the stacked modes,
    as the JAX package's `_stacked_mm` keeps Pallas. One matrix needs no
    stacking copy."""
    def bmm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.shape[0] == 1:
            return mm(x[0], y[0]).unsqueeze(0)
        return torch.stack([mm(x[i], y[i]) for i in range(x.shape[0])])

    return bmm


def _per_rank(fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], spec: tuple,
              collective: Callable[[list[torch.Tensor]], list[torch.Tensor]] | None = None
              ) -> Callable[[Sharded, Sharded], Sharded]:
    """A program that runs `fn` on each rank's shards, then `collective`
    over the ranks' results when one is given; its output has `spec`
    (JAX's `out_specs`)."""
    def program(x: Sharded, y: Sharded) -> Sharded:
        outs = [fn(xr, yr) for xr, yr in zip(x, y)]
        return Sharded(outs if collective is None else collective(outs), spec)

    return program


def _stacked_corner_sum(a: Sharded, b: Sharded, indices: range) -> torch.Tensor:
    """`expected_corner_sum` over global[indices] of two stacked operands,
    reading only the corner's rows of A and columns of B."""
    c = VALIDATION_CORNER
    device = home_device(a)
    return expected_corner_sum(
        torch.stack([stacked_item(a, i)[:c].to(device) for i in indices]),
        torch.stack([stacked_item(b, i)[:, :c].to(device) for i in indices]))


def _record_base(config: BenchConfig, benchmark: str, mode: str, size: int,
                 world: int, timing: Timing, **kw) -> BenchmarkRecord:
    return BenchmarkRecord(
        benchmark=benchmark, mode=mode, size=size, dtype=config.dtype_name,
        world=world, iterations=timing.iterations, warmup=config.warmup, **kw)


def _gib(size: int, dtype: Any, count: float) -> float:
    return count * size * size * bytes_per_element(dtype) / (1024**3)


def estimate_memory_gib(mode: str, config: BenchConfig, world: int,
                        size: int, batch: int = 4, dp: int | None = None) -> float:
    """Per-rank footprint of a mode's operands, buffers and outputs, in
    GiB: the single source for ModeSetup.memory_gib_per_device and the
    pre-flight guard (pure: it never touches the allocator). The rows of
    the JAX package's `estimate_memory_gib` for the modes the port runs,
    counting the port's own buffers (a psum's result and its fp32 or int32
    accumulator, `collectives._sum_on`; the accumulator is counted for
    every rank, though ranks on one card share one); ranks that share a
    device add up (the guard multiplies)."""
    d = world
    out_dtype = matmul_out_dtype(config.dtype)  # int8 products are int32

    def gib(in_count: float, out_count: float, acc_count: float = 0.0) -> float:
        return (_gib(size, config.dtype, in_count) + _gib(size, out_dtype, out_count)
                + _gib(size, matmul_acc_dtype(out_dtype), acc_count))

    if mode == "hybrid":
        # X's shard (lb) + W's column shard (1/tp); the products (lb/tp),
        # the gathered columns (lb), the batch sum and the psum's result
        # (2) + its accumulator
        tp = d // (dp or 1)
        lb = max(batch // (dp or 1), 1)
        return gib(lb + 1.0 / tp, lb / tp + lb + 2, 1)
    if mode == "summa":
        # A and B blocks (2/d) + a step's masked contributions and its
        # broadcast panels (two pairs, each panel at most 1/d) + the C
        # block and a step's product (2/d) + the broadcast's accumulator
        return gib(6.0 / d, 2.0 / d, 1.0 / d)
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
    if mode == "batch_parallel":
        # stacked A, B (2·lb) + products and the psum's result (2·lb) + its
        # accumulator (lb)
        lb = max(batch // d, 1)
        return gib(2 * lb, 2 * lb, lb)
    if mode == "data_parallel":
        # A, B + C and the psum's result + its accumulator
        return gib(2, 2, 1)
    if mode == "matrix_parallel" and d > 1:
        # replicated A + B's column shard; C's shard + the gathered C
        return gib(1 + 1.0 / d, 1 + 1.0 / d)
    if mode == "model_parallel":
        # A, B shards (2/d) + the full-shape partial and the psum's result
        # + its accumulator
        return gib(2.0 / d, 2, 1)
    if mode in ("no_overlap", "overlap", "pipeline"):
        # nbuf A/B pairs + the products + the psum's result + its
        # accumulator. no_overlap holds one product; overlap and pipeline
        # the filled ring of k = nbuf (an operand, never written) and the
        # k + 1 slots the program's products go to (`parallel/overlap.py
        # StepProgram`), where JAX's row (nbuf + 2 outputs) counts one ring
        # updated in place
        nbuf = {"no_overlap": 1, "overlap": 2, "pipeline": 3}[mode]
        return gib(2 * nbuf, 2 if nbuf == 1 else 2 * nbuf + 2, 1)
    # independent and the world-1 fallback: full A, B, C per rank
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

    def _tag(rec: BenchmarkRecord, *timings: Timing) -> BenchmarkRecord:
        if config.timing != "dispatch":
            rec.extras["timing"] = protocol  # what ran, not what was asked
        if protocol == "fused":
            # "operand" only when every timed program chained its operands
            chains = {t.chain for t in timings}
            rec.extras["chain"] = "operand" if chains == {"operand"} else "none"
        rec.warmup = effective_warmup(protocol, config.iterations, config.warmup)
        return rec

    if setup.full is None:
        t_compute = choose_timer(protocol)(
            setup.compute, setup.operands,
            iterations=config.iterations, warmup=config.warmup)
        rec = _tag(setup.build_record(t_compute, None, 0.0), t_compute)
        timed = setup.compute
        reliable = t_compute.reliable
    else:
        t_nocomm = None
        if setup.nocomm is not None:
            # the three-variant split: comm is the collective alone (full −
            # nocomm, the same program with the collective left out), and
            # the machinery's own cost is reported apart
            t_compute, t_nocomm, t_full = time_variants_n(
                (setup.compute, setup.nocomm, setup.full), setup.operands,
                iterations=config.iterations, warmup=config.warmup,
                protocol=protocol)
            comm_s = max(t_full.avg_s - t_nocomm.avg_s, 0.0)
        else:
            t_compute, t_full, comm_s = time_variants(
                setup.compute, setup.full, setup.operands,
                iterations=config.iterations, warmup=config.warmup,
                protocol=protocol)
        timings = [t for t in (t_compute, t_nocomm, t_full) if t is not None]
        rec = _tag(setup.build_record(t_compute, t_full, comm_s), *timings)
        if t_nocomm is not None:
            overhead_s = max(t_nocomm.avg_s - t_compute.avg_s, 0.0)
            rec.extras["overhead_time_s"] = round(overhead_s / setup.steps_per_program, 9)
        # sampled on the full program: the distribution of the quantity
        # the headline avg_time_s reports
        timed = setup.full
        reliable = all(t.reliable for t in timings)
    if not reliable:
        rec.extras["timing_reliable"] = False
    if config.percentiles:
        rec.extras["latency_ms"] = latency_percentiles_ms(
            timed, setup.operands, config)
    if config.samples:
        rec.extras["samples"] = sample_extras(timed, setup.operands, config)
    rec.extras.update(verdict)
    return rec


# ---------------------------------------------------------------------------
# The five parallel modes (the JAX package's P2-P6)
# ---------------------------------------------------------------------------

def _mode_record(config: BenchConfig, benchmark: str, mode: str, size: int,
                 mesh: Mesh, timing: Timing, tflops_total: float,
                 extras: dict | None = None, **kw) -> BenchmarkRecord:
    """A parallel mode's record: `tflops_total` by the mode's JAX formula,
    `tflops_per_device` that total over the cards the ranks occupy (the
    JAX per-device figure × world / cards), the card's name, and the
    extras `cards` and `ranks_per_card`."""
    cards = mesh.card_count
    return _record_base(
        config, benchmark, mode, size, world_size(mesh), timing,
        tflops_per_device=tflops_total / cards, tflops_total=tflops_total,
        device_kind=mesh_device_kind(mesh),
        extras={**(extras or {}), "cards": cards,
                "ranks_per_card": mesh.ranks_per_card}, **kw)


def _mm(config: BenchConfig, mesh: Mesh) -> Matmul:
    return matmul_2d(config.matmul_impl, config.blocks, mesh_device_kind(mesh))


def independent(config: BenchConfig, mesh: Mesh, size: int,
                benchmark: str = "scaling") -> ModeSetup:
    """≙ JAX `independent` (`modes.py:304`; reference
    `matmul_scaling_benchmark.py:69-104`). Every rank multiplies its own
    distinct matrices; no collective. Total = one product's TFLOPS · world
    (the sum over ranks)."""
    d = world_size(mesh)
    a, b = sharded_normal(config.seed, (d, size, size), config.dtype, mesh, ROWS)
    compute = _per_rank(_stacked_mm(_mm(config, mesh)), ROWS)

    def build(t_compute: Timing, t_full: Timing | None, comm_s: float) -> BenchmarkRecord:
        return _mode_record(
            config, benchmark, "independent", size, mesh, t_compute,
            calculate_tflops(size, t_compute.avg_s) * d,
            avg_time_s=t_compute.avg_s, compute_time_s=t_compute.avg_s,
            comm_time_s=0.0)

    return ModeSetup("independent", (a, b), compute, None, build,
                     memory_gib_per_device=estimate_memory_gib(
                         "independent", config, d, size),
                     validate=make_corner_validate(
                         compute, (a, b),
                         lambda: expected_corner(stacked_item(a, 0), stacked_item(b, 0)),
                         config.dtype, index=0))


def batch_parallel(config: BenchConfig, mesh: Mesh, size: int, batch: int = 4,
                   benchmark: str = "scaling") -> ModeSetup:
    """≙ JAX `batch_parallel` (`modes.py:346`; reference
    `matmul_scaling_benchmark.py:106-165`). The global batch (default 4)
    is split across the ranks; each call multiplies the rank's local batch,
    then all_reduce(SUM)s the products (the gradient sync). Total = local
    batch ops over compute+comm time · world. The local batch is floored at
    1, so the global batch grows to world · local where world > batch (the
    record's note says so)."""
    d = world_size(mesh)
    local_batch = max(batch // d, 1)
    g = local_batch * d
    a, b = sharded_normal(config.seed, (g, size, size), config.dtype, mesh, ROWS)
    bmm = _stacked_mm(_mm(config, mesh))
    compute = _per_rank(bmm, ROWS)
    check_wire_payload(config.comm_quant, "all_reduce", (local_batch, size, size), d,
                       config.dtype)
    full = _per_rank(bmm, ROWS, functools.partial(
        psum_impl(config.comm_quant, varying_out=True), mesh))

    def build(t_compute: Timing, t_full: Timing | None, comm_s: float) -> BenchmarkRecord:
        total_s = t_full.avg_s if t_full else t_compute.avg_s
        extras = {"global_batch": g, "local_batch": local_batch}
        if uses_quantized_comm(config):
            extras["comm_quant"] = comm_quant_record_extra(
                config, d, mode="batch_parallel", size=size, batch=batch)
        if g != batch:
            extras["note"] = f"global batch grown from {batch} to {g} to cover {d} devices"
        return _mode_record(
            config, benchmark, "batch_parallel", size, mesh, t_full or t_compute,
            calculate_tflops(size, total_s, num_ops=local_batch) * d, extras,
            avg_time_s=total_s, compute_time_s=t_compute.avg_s, comm_time_s=comm_s)

    # the psum sums each slot across ranks: global row 0 of the full output
    # is Σ_j A[j·lb]·B[j·lb], the stride-lb subset, not the whole batch
    return ModeSetup("batch_parallel", (a, b), compute, full, build,
                     memory_gib_per_device=estimate_memory_gib(
                         "batch_parallel", config, d, size, batch=batch),
                     validate=make_corner_validate(
                         full, (a, b),
                         lambda: _stacked_corner_sum(a, b, range(0, g, local_batch)),
                         config.dtype, index=0, comm_quant=config.comm_quant,
                         world=d))


def matrix_parallel(config: BenchConfig, mesh: Mesh, size: int,
                    benchmark: str = "scaling") -> ModeSetup:
    """≙ JAX `matrix_parallel` (`modes.py:414`; reference
    `matmul_scaling_benchmark.py:167-238`). A replicated, B cut by columns;
    each rank's product, then an all_gather of the C shards. World 1 falls
    back to `independent`. Total = the full product's FLOPs over
    compute+comm time."""
    d = world_size(mesh)
    if d == 1:
        setup = independent(config, mesh, size, benchmark)
        if uses_quantized_comm(config):
            # the fallback's records still carry the (flagged) comm_quant
            # key, as every quantizable mode's do
            inner = setup.build_record

            def build_flagged(t_c: Timing, t_f: Timing | None, comm_s: float
                              ) -> BenchmarkRecord:
                rec = inner(t_c, t_f, comm_s)
                rec.extras["comm_quant"] = comm_quant_record_extra(
                    config, 1, mode="matrix_parallel", size=size)
                return rec

            return dataclasses.replace(setup, mode="matrix_parallel",
                                       build_record=build_flagged)
        return dataclasses.replace(setup, mode="matrix_parallel")
    (a,) = sharded_normal(config.seed, (size, size), config.dtype, mesh, REPLICATED,
                          count=1)
    (b,) = sharded_normal(config.seed + 1, (size, size), config.dtype, mesh, COLS,
                          count=1)
    mm = _mm(config, mesh)
    compute = _per_rank(mm, COLS)
    # under --comm-quant the C-shard gather carries quantized payloads
    ag = allgather_impl(config.comm_quant)
    check_wire_payload(config.comm_quant, "all_gather", (size, size // d), d,
                       config.dtype)
    full = _per_rank(mm, REPLICATED, lambda outs: ag(mesh, outs, axis=1))

    def build(t_compute: Timing, t_full: Timing | None, comm_s: float) -> BenchmarkRecord:
        total_s = t_full.avg_s if t_full else t_compute.avg_s
        extras = {"portion_per_device": f"1/{d} of B's columns"}
        if uses_quantized_comm(config):
            extras["comm_quant"] = comm_quant_record_extra(
                config, d, mode="matrix_parallel", size=size)
        return _mode_record(
            config, benchmark, "matrix_parallel", size, mesh, t_full or t_compute,
            calculate_tflops(size, total_s), extras,
            avg_time_s=total_s, compute_time_s=t_compute.avg_s, comm_time_s=comm_s)

    c = VALIDATION_CORNER
    return ModeSetup("matrix_parallel", (a, b), compute, full, build,
                     memory_gib_per_device=estimate_memory_gib(
                         "matrix_parallel", config, d, size),
                     validate=make_corner_validate(
                         full, (a, b),
                         lambda: expected_corner(global_block(a, c, size),
                                                 global_block(b, size, c)),
                         config.dtype, comm_quant=config.comm_quant, world=d))


def data_parallel(config: BenchConfig, mesh: Mesh, size: int,
                  benchmark: str = "distributed") -> ModeSetup:
    """≙ JAX `data_parallel` (`modes.py:495`; reference
    `backup/matmul_distributed_benchmark.py:66-110`). Every rank computes
    a full distinct product, then all_reduce(SUM)s it. TFLOPS come from
    the compute leg alone (total = one product's TFLOPS · world), with the
    communication reported apart."""
    d = world_size(mesh)
    a, b = sharded_normal(config.seed, (d, size, size), config.dtype, mesh, ROWS)
    bmm = _stacked_mm(_mm(config, mesh))
    compute = _per_rank(bmm, ROWS)
    check_wire_payload(config.comm_quant, "all_reduce", (1, size, size), d, config.dtype)
    full = _per_rank(bmm, ROWS, functools.partial(
        psum_impl(config.comm_quant, varying_out=True), mesh))

    def build(t_compute: Timing, t_full: Timing | None, comm_s: float) -> BenchmarkRecord:
        total_s = t_full.avg_s if t_full else t_compute.avg_s
        extras = {}
        if uses_quantized_comm(config):
            extras["comm_quant"] = comm_quant_record_extra(
                config, d, mode="data_parallel", size=size)
        return _mode_record(
            config, benchmark, "data_parallel", size, mesh, t_full or t_compute,
            calculate_tflops(size, t_compute.avg_s) * d, extras,
            avg_time_s=total_s, compute_time_s=t_compute.avg_s, comm_time_s=comm_s)

    return ModeSetup("data_parallel", (a, b), compute, full, build,
                     memory_gib_per_device=estimate_memory_gib(
                         "data_parallel", config, d, size),
                     validate=make_corner_validate(
                         full, (a, b), lambda: _stacked_corner_sum(a, b, range(d)),
                         config.dtype, index=0, comm_quant=config.comm_quant,
                         world=d))


def model_parallel(config: BenchConfig, mesh: Mesh, size: int,
                   benchmark: str = "distributed") -> ModeSetup:
    """≙ JAX `model_parallel` (`modes.py:550`; reference
    `backup/matmul_distributed_benchmark.py:112-174`). The inner dimension
    is split: A cut by columns, B by rows; each rank computes a full-shape
    partial product, and the partials are summed (psum, the correct
    combine where the reference all_gathers them). Total = the full
    product's FLOPs over compute+comm time."""
    d = world_size(mesh)
    (a,) = sharded_normal(config.seed, (size, size), config.dtype, mesh, COLS, count=1)
    (b,) = sharded_normal(config.seed + 1, (size, size), config.dtype, mesh, ROWS,
                          count=1)
    mm = _mm(config, mesh)
    # each rank's partial is a full-shape product: the global compute
    # output is the partials side by side (JAX's out_specs P(None, "x"))
    compute = _per_rank(mm, COLS)
    check_wire_payload(config.comm_quant, "all_reduce", (size, size), d, config.dtype)
    full = _per_rank(mm, REPLICATED, functools.partial(psum_impl(config.comm_quant), mesh))

    def build(t_compute: Timing, t_full: Timing | None, comm_s: float) -> BenchmarkRecord:
        total_s = t_full.avg_s if t_full else t_compute.avg_s
        extras = {"combine": "psum (reference used all_gather on partial sums)"}
        if uses_quantized_comm(config):
            extras["comm_quant"] = comm_quant_record_extra(
                config, d, mode="model_parallel", size=size)
        return _mode_record(
            config, benchmark, "model_parallel", size, mesh, t_full or t_compute,
            calculate_tflops(size, total_s), extras,
            avg_time_s=total_s, compute_time_s=t_compute.avg_s, comm_time_s=comm_s)

    c = VALIDATION_CORNER
    return ModeSetup("model_parallel", (a, b), compute, full, build,
                     memory_gib_per_device=estimate_memory_gib(
                         "model_parallel", config, d, size),
                     validate=make_corner_validate(
                         full, (a, b),
                         lambda: expected_corner(global_block(a, c, size),
                                                 global_block(b, size, c)),
                         config.dtype, comm_quant=config.comm_quant, world=d))


SCALING_MODES: dict[str, Callable[..., ModeSetup]] = {
    "independent": independent,
    "batch_parallel": batch_parallel,
    "matrix_parallel": matrix_parallel,
}

DISTRIBUTED_MODES: dict[str, Callable[..., ModeSetup]] = {
    "independent": independent,
    "data_parallel": data_parallel,
    "model_parallel": model_parallel,
}
