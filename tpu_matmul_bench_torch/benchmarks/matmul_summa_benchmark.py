"""SUMMA 2-D-grid benchmark: the scalable distributed matmul.

Port of `tpu_matmul_bench/benchmarks/matmul_summa_benchmark.py`: A, B and C
all block-sharded over an (r × c) grid of ranks, k walked in lcm(r, c)
panels whose owners broadcast along their grid axis while each rank
accumulates; per-rank memory O(1/p) in every matrix, no output collective.
`--rows` picks the grid (default: the most-square factorization);
`--mesh dcn:R,ici:C` supersedes it, rows on dcn and columns on ici. A size
that does not split into whole blocks and panels is reported and skipped.
Compute/comm split timing as in the scaling modes.

Run: TMB_RANKS_PER_CARD=4 python -m tpu_matmul_bench_torch summa \
        --num-devices 4 --sizes 16384 --matmul-impl cuda
"""

from __future__ import annotations

from typing import Sequence

from tpu_matmul_bench_torch.benchmarks.runner import run_sizes
from tpu_matmul_bench_torch.parallel.collectives import verify_collectives
from tpu_matmul_bench_torch.parallel.mesh import make_factorized_mesh, make_mesh
from tpu_matmul_bench_torch.parallel.modes import estimate_memory_gib, run_mode_benchmark
from tpu_matmul_bench_torch.parallel.summa import make_summa_mesh, summa_mode
from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.config import BenchConfig, build_parser, config_from_args
from tpu_matmul_bench_torch.utils.device import (
    cluster_exit_barrier,
    collect_device_info,
    device_banner,
    maybe_init_process_group,
    resolve_devices,
)
from tpu_matmul_bench_torch.utils.profiling import maybe_trace
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord, header, report


def run(config: BenchConfig, rows: int | None = None) -> list[BenchmarkRecord]:
    maybe_init_process_group()
    devices = resolve_devices(config.device, config.num_devices)
    info = collect_device_info(devices)
    if config.mesh:
        # the factorized mesh: grid rows ride the outer (dcn) axis, columns
        # the inner (ici) axis; --mesh supersedes --rows
        mesh = make_factorized_mesh(devices, config.mesh)
        if len(mesh.axis_names) != 2:
            report(f"\nERROR: summa needs a two-axis --mesh, got {config.mesh!r}")
            raise SystemExit(1)
    else:
        mesh = make_summa_mesh(devices, rows)
    i_ax, j_ax = mesh.axis_names
    r, c = mesh.shape[i_ax], mesh.shape[j_ax]
    report(device_banner(info))
    report(header(
        "SUMMA 2-D Grid Benchmark (PyTorch/CUDA)",
        {
            "Grid": f"{r} ({i_ax}) x {c} ({j_ax})",
            "Data type": config.dtype_name,
            "Iterations per test": config.iterations,
            "Warmup iterations": config.warmup,
        },
    ))

    if len(devices) > 1:
        report("\nVerifying collectives:")
        if not verify_collectives(make_mesh(devices)):
            report("\nERROR: collective verification failed — aborting")
            raise SystemExit(1)

    def bench_one(size: int) -> BenchmarkRecord:
        return run_mode_benchmark(summa_mode(config, mesh, size), config)

    with telemetry.session(config.trace_out), \
            maybe_trace(config.profile_dir, cuda=info.platform == "cuda"):
        records = run_sizes(
            config, bench_one,
            memory_gib=lambda s: (estimate_memory_gib("summa", config, len(devices), s)
                                  * info.ranks_per_card),
            memory_limit_gib=info.memory_gib,
        )
    cluster_exit_barrier()
    report("\n" + "=" * 70, "Benchmark completed!", "=" * 70)
    return records


def main(argv: Sequence[str] | None = None) -> list[BenchmarkRecord]:
    parser = build_parser(__doc__ or "SUMMA benchmark", extra_dtypes=("int8",),
                          fused_timing=True, best_of=False, comm_quant=True, mesh=True,
                          profile=True)
    parser.add_argument(
        "--rows", type=int, default=None,
        help="grid rows r (columns = devices/r; default: most-square "
             "factorization)")
    args = parser.parse_args(argv)
    return run(config_from_args(args), args.rows)


if __name__ == "__main__":
    main()
