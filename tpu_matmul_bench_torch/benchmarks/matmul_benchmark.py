"""Basic matmul benchmark (reference `matmul_benchmark.py`).

Port of `tpu_matmul_bench/benchmarks/matmul_benchmark.py`: C = A·B timed
over the size sweep (or one rectangular --mkn problem) with TFLOPS and
peak-efficiency reporting, on the card unless --device cpu is given.
A record of the hand-written kernel carries its cost books
(`extras["cost_analysis"]`, `obs/attribution.py`); a record of the library
product carries none.

With more than one rank (`--num-devices`, `TMB_RANKS_PER_CARD`, or ranks
as processes under torchrun or `python -m tpu_matmul_bench_torch.multihost`)
every rank runs its own product, with no collective in the timed loop, as
JAX's `_bench_all_devices` does (≙ every rank calling the reference's
`benchmark_matmul` at once): `world` is the rank count, `tflops_total` the
rank count times one product's TFLOPS, and `tflops_per_device` that total
over the cards the ranks occupy (extras `cards`, `ranks_per_card`), the
port's per-card count of the parallel modes.

Run: python -m tpu_matmul_bench_torch matmul [--sizes ...]
"""

from __future__ import annotations

from typing import Sequence

import torch

from tpu_matmul_bench_torch.benchmarks.runner import run_sizes
from tpu_matmul_bench_torch.models.workloads import MatmulWorkload, RectMatmulWorkload
from tpu_matmul_bench_torch.obs import attribution
from tpu_matmul_bench_torch.ops.cuda_matmul import launch_plan
from tpu_matmul_bench_torch.ops.impl_select import auto_extras, select_impl
from tpu_matmul_bench_torch.ops.matmul import make_matmul
from tpu_matmul_bench_torch.parallel.mesh import (
    ROWS,
    Mesh,
    make_mesh,
    sharded_normal,
    stacked_item,
)
from tpu_matmul_bench_torch.parallel.modes import (
    VALIDATION_CORNER,
    _per_rank,
    _stacked_mm,
    corner_validation,
    expected_corner,
)
from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.config import BenchConfig
from tpu_matmul_bench_torch.utils.device import (
    cluster_exit_barrier,
    collect_device_info,
    device_banner,
    maybe_init_process_group,
    precision_extras,
    resolve_devices,
)
from tpu_matmul_bench_torch.utils.metrics import calculate_tflops
from tpu_matmul_bench_torch.utils.profiling import maybe_trace
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord, header, report
from tpu_matmul_bench_torch.utils.timing import (
    Timing,
    choose_timer,
    effective_warmup,
    latency_percentiles_ms,
    protocol_extras,
    sample_extras,
    time_fused,
    time_jitted,
)


def _time(config: BenchConfig, fn, operands) -> Timing:
    """Dispatch or fused timing per --timing; --repeats N re-runs the whole
    timed loop and keeps the fastest. Repeats after the first warm up once:
    the kernel is built by then."""
    best = choose_timer(config.timing)(
        fn, operands, iterations=config.iterations, warmup=config.warmup)
    for _ in range(max(config.repeats, 1) - 1):
        if config.timing == "fused":
            t = time_fused(fn, operands, iterations=config.iterations)
        else:
            t = time_jitted(fn, operands, iterations=config.iterations,
                            warmup=1)
        if t.avg_s < best.avg_s:
            best = t
    return best


def _extras(config: BenchConfig, t: Timing, mm, a, b, m: int, n: int,
            k: int, device_kind: str, cost_operands=None) -> dict:
    """Record extras shared by the square, rectangular and all-rank runs;
    the kernel's cost books only where the kernel ran (`_cost_extras`, of
    one launch on `cost_operands`, default (a, b))."""
    extras = protocol_extras(config.timing, t)
    if config.repeats > 1:
        extras["repeats"] = config.repeats  # best-of-N provenance
    extras.update(auto_extras(config.matmul_impl, m, n, k, device_kind,
                              config.dtype))
    extras.update(_cost_extras(config, *(cost_operands or (a, b)), device_kind))
    extras.update(precision_extras())
    if config.percentiles:
        extras["latency_ms"] = latency_percentiles_ms(mm, (a, b), config)
    if config.samples:
        extras["samples"] = sample_extras(mm, (a, b), config)
    return extras


def _cost_extras(config: BenchConfig, a, b, device_kind: str) -> dict:
    """`extras["cost_analysis"]` (`matmul_benchmark.py:105-121` of the JAX
    package): the hand-written kernel's own books for the launch it makes
    on these operands (`cuda_matmul.launch_plan`, `obs/attribution.py`),
    beside the hand model. Only where the kernel runs, `--matmul-impl cuda`
    or an `auto` that resolves to it: the library product (cuBLAS) keeps no
    books the port can read, so its records carry no block, as the JAX
    package records none where `cost_analysis` is missing."""
    (m, k), n = a.shape, b.shape[1]
    impl, blocks = config.matmul_impl, config.blocks
    if impl == "auto":  # as matmul_2d: an explicit tile wins, else the cell's
        choice = select_impl(m, n, k, device_kind, a.dtype)
        impl, blocks = choice.impl, blocks if blocks is not None else choice.blocks
    if impl != "cuda":
        return {}
    route, tile, splits = launch_plan(a, b, blocks)
    return {"cost_analysis": attribution.attribution_block(
        route, m, n, k, tile, splits, a.dtype)}


def _validate(config: BenchConfig, mm, a, b, corner: int) -> dict:
    """--validate, before timing so a wrong kernel fails fast."""
    if not config.validate:
        return {}
    got = mm(a, b)[:corner, :corner]
    return corner_validation(got, expected_corner(a, b, corner=corner),
                             config.dtype)


def _bench_single(config: BenchConfig, size: int, device_kind: str,
                  device: torch.device) -> BenchmarkRecord:
    wl = MatmulWorkload(size, config.dtype, seed=config.seed)
    a, b = wl.operands(device)
    mm = make_matmul(config.matmul_impl, config.blocks, device_kind)
    verdict = _validate(config, mm, a, b, VALIDATION_CORNER)
    t = _time(config, mm, (a, b))
    extras = _extras(config, t, mm, a, b, size, size, size, device_kind)
    extras.update(verdict)
    tflops = calculate_tflops(size, t.avg_s)
    return BenchmarkRecord(
        benchmark="matmul",
        mode="single",
        size=size,
        dtype=config.dtype_name,
        world=1,
        iterations=t.iterations,
        warmup=effective_warmup(config.timing, config.iterations, config.warmup),
        avg_time_s=t.avg_s,
        tflops_per_device=tflops,
        tflops_total=tflops,
        device_kind=device_kind,
        extras=extras,
    )


def _bench_all_ranks(config: BenchConfig, size: int, device_kind: str,
                     mesh: Mesh) -> BenchmarkRecord:
    """One independent product a rank (JAX `_bench_all_devices`,
    `matmul_benchmark.py:164-212`): A and B stacked [d, size, size] and cut
    by rows, so each rank multiplies its own pair through `make_matmul`
    (K1 once a rank a call under `--matmul-impl cuda`); no collective in
    the timed loop. --validate checks rank 0's corner against float64."""
    d = mesh.size
    a, b = sharded_normal(config.seed, (d, size, size), config.dtype, mesh, ROWS)
    mm = _per_rank(_stacked_mm(make_matmul(config.matmul_impl, config.blocks,
                                           device_kind)), ROWS)
    verdict: dict = {}
    if config.validate:  # before timing: a wrong kernel fails fast
        got = stacked_item(mm(a, b), 0)[:VALIDATION_CORNER, :VALIDATION_CORNER]
        verdict = corner_validation(
            got, expected_corner(stacked_item(a, 0), stacked_item(b, 0)),
            config.dtype)
    t = _time(config, mm, (a, b))
    # one launch's books: this process's first rank's operands
    mine = next(i for i, r in enumerate(mesh.ranks) if r.local)
    a0, b0 = a[mine][0], b[mine][0]
    extras = _extras(config, t, mm, a, b, size, size, size, device_kind,
                     cost_operands=(a0, b0))
    extras.update(verdict)
    extras.update(cards=mesh.card_count, ranks_per_card=mesh.ranks_per_card)
    total = calculate_tflops(size, t.avg_s) * d  # each rank did one product a call
    return BenchmarkRecord(
        benchmark="matmul",
        mode="single",
        size=size,
        dtype=config.dtype_name,
        world=d,
        iterations=t.iterations,
        warmup=effective_warmup(config.timing, config.iterations, config.warmup),
        avg_time_s=t.avg_s,
        tflops_per_device=total / mesh.card_count,
        tflops_total=total,
        device_kind=device_kind,
        extras=extras,
    )


def _bench_rect(config: BenchConfig, mkn: tuple[int, int, int],
                device_kind: str, device: torch.device) -> BenchmarkRecord:
    """--mkn M K N: one rectangular matmul."""
    m, k, n = mkn
    wl = RectMatmulWorkload(m, k, n, config.dtype, seed=config.seed)
    a, b = wl.operands(device)
    mm = make_matmul(config.matmul_impl, config.blocks, device_kind)
    verdict = _validate(config, mm, a, b, min(VALIDATION_CORNER, m, n))
    t = _time(config, mm, (a, b))
    extras = {"shape": f"{m}x{k}x{n}",
              **_extras(config, t, mm, a, b, m, n, k, device_kind)}
    extras.update(verdict)
    tflops = calculate_tflops(max(mkn), t.avg_s, flops=wl.flops)
    return BenchmarkRecord(
        benchmark="matmul", mode="single", size=max(mkn),
        dtype=config.dtype_name, world=1, iterations=t.iterations,
        warmup=effective_warmup(config.timing, config.iterations, config.warmup),
        avg_time_s=t.avg_s, tflops_per_device=tflops, tflops_total=tflops,
        device_kind=device_kind, flops_per_op=wl.flops, extras=extras,
    )


def run(config: BenchConfig, mkn: tuple[int, int, int] | None = None
        ) -> list[BenchmarkRecord]:
    maybe_init_process_group()
    devices = resolve_devices(config.device, config.num_devices)
    info = collect_device_info(devices)
    report(device_banner(info))
    report(
        header(
            "Matrix Multiplication Benchmark (PyTorch/CUDA)",
            {
                "Number of devices": len(devices),
                "Data type": config.dtype_name,
                "Platform": info.platform,
                "Iterations per test": config.iterations,
                "Warmup iterations": config.warmup,
                "Matmul implementation": config.matmul_impl,
            },
        )
    )
    device, kind = devices[0], info.device_kind
    traced = maybe_trace(config.profile_dir, cuda=info.platform == "cuda")
    if mkn is not None:
        if len(devices) > 1:
            raise SystemExit("--mkn is single-device (use --num-devices 1); "
                             "the sharded modes are square-sweep programs")
        m, k, n = mkn
        wl = RectMatmulWorkload(m, k, n, config.dtype)
        # one "size" through the shared runner: the same memory guard, OOM
        # backstop, JSON sink and report as the sweep
        with telemetry.session(config.trace_out), traced:
            records = run_sizes(
                config,
                lambda _s: _bench_rect(config, mkn, kind, device),
                sizes=[max(mkn)],
                memory_gib=lambda _s: wl.memory_gib,
                memory_limit_gib=info.memory_gib,
                preamble=lambda _s: (
                    f"\nBenchmarking {m}x{k}x{n} matrix multiplication:\n"
                    f"  - Total memory for A, B, C: {wl.memory_gib:.2f} GiB"
                ),
            )
    else:
        mesh = make_mesh(devices)

        def bench_one(size: int) -> BenchmarkRecord:
            if len(devices) == 1:
                return _bench_single(config, size, kind, device)
            return _bench_all_ranks(config, size, kind, mesh)

        with telemetry.session(config.trace_out), traced:
            records = run_sizes(
                config,
                bench_one,
                # the ranks that share a card share its memory
                memory_gib=lambda s: (MatmulWorkload(s, config.dtype).memory_gib
                                      * info.ranks_per_card),
                memory_limit_gib=info.memory_gib,
            )
    cluster_exit_barrier()
    report("\n" + "=" * 60, "Benchmark completed!", "=" * 60)
    return records


def main(argv: Sequence[str] | None = None) -> list[BenchmarkRecord]:
    from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args

    parser = build_parser(__doc__ or "matmul benchmark", extra_dtypes=("int8",),
                          profile=True)
    parser.add_argument(
        "--mkn", type=int, nargs=3, metavar=("M", "K", "N"), default=None,
        help="Benchmark one rectangular C[M,N] = A[M,K]·B[K,N] instead of "
             "the square --sizes sweep",
    )
    args = parser.parse_args(argv)
    config = config_from_args(args)
    return run(config, mkn=tuple(args.mkn) if args.mkn else None)


if __name__ == "__main__":
    main()
