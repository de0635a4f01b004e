"""The mode-program runner shared by the scaling and overlap benchmarks.

Port of `tpu_matmul_bench/benchmarks/matmul_scaling_benchmark.py:42-142`,
`run` only: resolve the ranks (`utils/device.py resolve_devices`), build the
world (`parallel/mesh.py`), run the startup collective gate
(`verify_collectives`) when there is more than one rank, then each size of
the sweep through the mode's `ModeSetup` and `run_mode_benchmark`. The
scaling modes and this program's `main` come with their slice (ROADMAP A6).
"""

from __future__ import annotations

import sys
from typing import Callable

from tpu_matmul_bench_torch.benchmarks.runner import run_sizes
from tpu_matmul_bench_torch.parallel.collectives import verify_collectives
from tpu_matmul_bench_torch.parallel.mesh import make_mesh
from tpu_matmul_bench_torch.parallel.modes import (
    ModeSetup,
    estimate_memory_gib,
    run_mode_benchmark,
)
from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.config import BenchConfig
from tpu_matmul_bench_torch.utils.device import (
    collect_device_info,
    device_banner,
    resolve_devices,
)
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord, header, report


def run(
    config: BenchConfig,
    *,
    modes_table: dict[str, Callable[..., ModeSetup]],
    benchmark_name: str,
    title: str,
) -> list[BenchmarkRecord]:
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
        return run_mode_benchmark(builder(config, mesh, size, benchmark=benchmark_name),
                                  config)

    with telemetry.session(config.trace_out):
        records = run_sizes(
            config,
            bench_one,
            # the ranks that share a device share its memory
            memory_gib=lambda s: (estimate_memory_gib(config.mode, config, d, s)
                                  * info.ranks_per_card),
            memory_limit_gib=info.memory_gib,
        )
    report("\n" + "=" * 70, "Benchmark completed!", "=" * 70)
    return records
