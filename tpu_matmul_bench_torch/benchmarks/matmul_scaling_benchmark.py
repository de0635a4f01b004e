"""Scaling benchmark (reference `matmul_scaling_benchmark.py`).

Port of `tpu_matmul_bench/benchmarks/matmul_scaling_benchmark.py`: the
modes {independent, batch_parallel, matrix_parallel} over a world of
--num-devices ranks (`parallel/mesh.py`; `TMB_RANKS_PER_CARD` ranks may
share a card), with the startup collective gate, per-mode TFLOPS, and a
scaling efficiency against a measured single-device baseline. `run` is the
runner the distributed and overlap programs share: resolve the ranks, build
the world, run the gate when there is more than one rank, then each size of
the sweep through the mode's `ModeSetup` and `run_mode_benchmark`, inside a
`torch.profiler` trace under --profile-dir. Under torchrun or the
`multihost` launcher each process joins the group first and holds its
share of the world's ranks, and every process waits at an exit barrier.

Run: TMB_RANKS_PER_CARD=4 python -m tpu_matmul_bench_torch scaling \
        --mode batch_parallel --num-devices 4 --matmul-impl cuda ...
"""

from __future__ import annotations

import sys
from typing import Callable, Sequence

import torch

from tpu_matmul_bench_torch.benchmarks.runner import run_sizes
from tpu_matmul_bench_torch.parallel.collectives import verify_collectives
from tpu_matmul_bench_torch.parallel.mesh import make_mesh
from tpu_matmul_bench_torch.parallel.modes import (
    SCALING_MODES,
    ModeSetup,
    estimate_memory_gib,
    run_mode_benchmark,
)
from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.config import BenchConfig, parse_config
from tpu_matmul_bench_torch.utils.device import (
    cluster_exit_barrier,
    collect_device_info,
    device_banner,
    maybe_init_process_group,
    resolve_devices,
)
from tpu_matmul_bench_torch.utils.profiling import maybe_trace
from tpu_matmul_bench_torch.utils.reporting import (
    BenchmarkRecord,
    attach_scaling_efficiency,
    header,
    report,
)

# the modes whose efficiency is measured against one device: matrix and
# model parallel split one product across the ranks (reference README.md:46)
EFFICIENCY_MODES = ("independent", "batch_parallel", "data_parallel")


def run(
    config: BenchConfig,
    *,
    modes_table: dict[str, Callable[..., ModeSetup]] = SCALING_MODES,
    benchmark_name: str = "scaling",
    title: str = "Matrix Multiplication Scaling Benchmark (PyTorch/CUDA)",
) -> list[BenchmarkRecord]:
    maybe_init_process_group()
    devices = resolve_devices(config.device, config.num_devices)
    info = collect_device_info(devices)
    mesh = make_mesh(devices)
    report(device_banner(info))
    report(
        header(
            title,
            {
                "Mode": config.mode,
                "Number of devices": len(devices),
                "Data type": config.dtype_name,
                "Iterations per test": config.iterations,
                "Warmup iterations": config.warmup,
            },
        )
    )

    # startup collective gate ≙ reference matmul_scaling_benchmark.py:388-394
    if len(devices) > 1:
        report("\nVerifying collectives:")
        if not verify_collectives(mesh):
            report("\nERROR: collective verification failed — aborting benchmark")
            sys.exit(1)

    builder = modes_table[config.mode]
    d = len(devices)

    def bench_one(size: int) -> BenchmarkRecord:
        rec = run_mode_benchmark(builder(config, mesh, size, benchmark=benchmark_name),
                                 config)
        # efficiency against a measured single-device product on this
        # process's own card (the reference's in-run formula compares ranks
        # with each other; JAX `:90-100` measures each process's local chip)
        if d > 1 and rec.mode in EFFICIENCY_MODES:
            attach_scaling_efficiency(
                rec, _single_device_tflops(config, mesh.first_local,
                                           info.device_kind, size))
        return rec

    with telemetry.session(config.trace_out), \
            maybe_trace(config.profile_dir, cuda=info.platform == "cuda"):
        records = run_sizes(
            config,
            bench_one,
            # the ranks that share a device share its memory
            memory_gib=lambda s: (estimate_memory_gib(config.mode, config, d, s)
                                  * info.ranks_per_card),
            memory_limit_gib=info.memory_gib,
        )
    cluster_exit_barrier()
    report("\n" + "=" * 70, "Benchmark completed!", "=" * 70)
    return records


def _single_device_tflops(config: BenchConfig, device: torch.device,
                          device_kind: str, size: int) -> float:
    """The one-device product's TFLOPS, the efficiency's denominator, under
    the run's --matmul-impl, tile and --timing (cached per process)."""
    key = (size, config.dtype_name, config.matmul_impl, config.blocks,
           config.timing, str(device))
    if key not in _BASELINE_CACHE:
        from tpu_matmul_bench_torch.benchmarks.matmul_benchmark import _bench_single

        _BASELINE_CACHE[key] = _bench_single(config, size, device_kind,
                                             device).tflops_per_device
    return _BASELINE_CACHE[key]


_BASELINE_CACHE: dict = {}


def main(argv: Sequence[str] | None = None) -> list[BenchmarkRecord]:
    config = parse_config(
        argv,
        description=__doc__ or "scaling benchmark",
        modes=list(SCALING_MODES),
        default_mode="independent",  # ≙ reference :360-362
        extra_dtypes=("int8",),
        fused_timing=True,
        comm_quant=True,
    )
    return run(config)


if __name__ == "__main__":
    main()
