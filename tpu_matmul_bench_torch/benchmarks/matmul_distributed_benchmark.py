"""Distributed benchmark (reference `backup/matmul_distributed_benchmark.py`).

Port of `tpu_matmul_bench/benchmarks/matmul_distributed_benchmark.py`:
the modes {independent, data_parallel, model_parallel}, the older variants
of the scaling suite (a full product on every rank, then an all_reduce;
and the inner-dimension split). It shares the scaling program's runner;
only the mode table and the default differ (reference default
data_parallel, `backup/matmul_distributed_benchmark.py:283-285`).

Run: TMB_RANKS_PER_CARD=4 python -m tpu_matmul_bench_torch distributed \
        --mode model_parallel --num-devices 4 --matmul-impl cuda ...
"""

from __future__ import annotations

from typing import Sequence

from tpu_matmul_bench_torch.benchmarks.matmul_scaling_benchmark import run
from tpu_matmul_bench_torch.parallel.modes import DISTRIBUTED_MODES
from tpu_matmul_bench_torch.utils.config import parse_config
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord


def main(argv: Sequence[str] | None = None) -> list[BenchmarkRecord]:
    config = parse_config(
        argv,
        description=__doc__ or "distributed benchmark",
        modes=list(DISTRIBUTED_MODES),
        default_mode="data_parallel",
        extra_dtypes=("int8",),
        fused_timing=True,
    )
    return run(
        config,
        modes_table=DISTRIBUTED_MODES,
        benchmark_name="distributed",
        title="Distributed Matrix Multiplication Benchmark (PyTorch/CUDA)",
    )


if __name__ == "__main__":
    main()
