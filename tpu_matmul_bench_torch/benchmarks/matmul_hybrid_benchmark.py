"""Hybrid 2-D mesh benchmark: dp×tp composed sharding in one program.

Port of `tpu_matmul_bench/benchmarks/matmul_hybrid_benchmark.py`. `--dp`
picks the data-parallel axis length and tensor parallelism gets the rest
of the ranks; `--mesh dcn:R,ici:C` supersedes it, dp on dcn and tp on ici.
The collective gate runs on the flat world, and sizes that do not fit the
device are skipped before anything is allocated. Compute/comm split timing
as in the scaling modes (`parallel/modes.py run_mode_benchmark`).

Run: TMB_RANKS_PER_CARD=4 python -m tpu_matmul_bench_torch hybrid --dp 2 \
        --num-devices 4 --sizes 16384 --matmul-impl cuda
"""

from __future__ import annotations

from typing import Sequence

from tpu_matmul_bench_torch.benchmarks.runner import run_sizes
from tpu_matmul_bench_torch.parallel.collectives import verify_collectives
from tpu_matmul_bench_torch.parallel.hybrid import hybrid_mode, make_hybrid_mesh
from tpu_matmul_bench_torch.parallel.mesh import make_factorized_mesh, make_mesh
from tpu_matmul_bench_torch.parallel.modes import estimate_memory_gib, run_mode_benchmark
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


def run(config: BenchConfig, dp: int, batch: int) -> list[BenchmarkRecord]:
    maybe_init_process_group()
    devices = resolve_devices(config.device, config.num_devices)
    info = collect_device_info(devices)
    if config.mesh:
        # the factorized mesh: dp rides the outer (dcn) axis, tp the inner
        # (ici) axis; --mesh supersedes --dp
        mesh = make_factorized_mesh(devices, config.mesh)
        if len(mesh.axis_names) != 2:
            report(f"\nERROR: hybrid needs a two-axis --mesh, got {config.mesh!r}")
            raise SystemExit(1)
    else:
        mesh = make_hybrid_mesh(devices, dp)
    dp_ax, tp_ax = mesh.axis_names
    dp = mesh.shape[dp_ax]
    report(device_banner(info))
    report(header(
        "Hybrid 2-D Mesh Benchmark (dp x tp, PyTorch/CUDA)",
        {
            "Mesh": f"dp={dp} x tp={mesh.shape[tp_ax]} ({dp_ax} x {tp_ax})",
            "Global batch": batch,
            "Data type": config.dtype_name,
            "Iterations per test": config.iterations,
            "Warmup iterations": config.warmup,
        },
    ))

    # collective gate on the flat world (the axes compose below)
    if len(devices) > 1:
        report("\nVerifying collectives:")
        if not verify_collectives(make_mesh(devices)):
            report("\nERROR: collective verification failed — aborting")
            raise SystemExit(1)

    def bench_one(size: int) -> BenchmarkRecord:
        return run_mode_benchmark(hybrid_mode(config, mesh, size, batch=batch), config)

    with telemetry.session(config.trace_out), \
            maybe_trace(config.profile_dir, cuda=info.platform == "cuda"):
        records = run_sizes(
            config, bench_one,
            # pure estimator; the ranks that share a device share its memory
            memory_gib=lambda s: (estimate_memory_gib(
                "hybrid", config, len(devices), s, batch=batch, dp=dp)
                * info.ranks_per_card),
            memory_limit_gib=info.memory_gib,
        )
    cluster_exit_barrier()
    report("\n" + "=" * 70, "Benchmark completed!", "=" * 70)
    return records


def main(argv: Sequence[str] | None = None) -> list[BenchmarkRecord]:
    parser = build_parser(__doc__ or "hybrid benchmark", extra_dtypes=("int8",),
                          fused_timing=True, best_of=False, comm_quant=True, mesh=True,
                          profile=True)
    parser.add_argument("--dp", type=int, default=2,
                        help="data-parallel axis length (tp = devices/dp)")
    parser.add_argument("--batch", type=int, default=4,
                        help="global batch (≙ the scaling benchmark's 4)")
    args = parser.parse_args(argv)
    return run(config_from_args(args), args.dp, args.batch)


if __name__ == "__main__":
    main()
