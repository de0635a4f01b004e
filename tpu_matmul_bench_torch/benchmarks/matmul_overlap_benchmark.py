"""Overlap benchmark: the ring matmuls against their serialized baselines.

Port of `tpu_matmul_bench/benchmarks/matmul_overlap_benchmark.py`. The
ported modes are `cuda_ring_hbm` (the all-gather ring, K2) and
`cuda_ring_rs_hbm` (the reduce-scatter ring, K3), over a world of
--num-devices ranks (`parallel/mesh.py`; `TMB_RANKS_PER_CARD` ranks may
share a card). `--mode` accepts the JAX suite's twelve names with
`pallas_` → `cuda_`; a name not ported yet exits with an error that names
it and the ROADMAP item that brings it. The default is `cuda_ring_hbm`
until the JAX default, `overlap`, is ported (ROADMAP A7).

Run: TMB_RANKS_PER_CARD=4 python -m tpu_matmul_bench_torch overlap \
        --mode cuda_ring_hbm --num-devices 4 --matmul-impl cuda ...
"""

from __future__ import annotations

from typing import Sequence

from tpu_matmul_bench_torch.benchmarks.matmul_scaling_benchmark import run
from tpu_matmul_bench_torch.parallel.overlap import OVERLAP_MODE_NAMES, OVERLAP_MODES
from tpu_matmul_bench_torch.utils.config import parse_config
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord


def main(argv: Sequence[str] | None = None) -> list[BenchmarkRecord]:
    config = parse_config(
        argv,
        description=__doc__ or "overlap benchmark",
        modes=list(OVERLAP_MODE_NAMES),
        default_mode="cuda_ring_hbm",
        extra_dtypes=("int8",),
        fused_timing=True,
    )
    brings = OVERLAP_MODE_NAMES[config.mode]
    if brings is not None:
        raise SystemExit(f"overlap: mode {config.mode!r} is not ported yet; "
                         f"{brings} brings it. Ported: {', '.join(OVERLAP_MODES)}")
    return run(
        config,
        modes_table=OVERLAP_MODES,
        benchmark_name="overlap",
        title="Compute/Communication Overlap Benchmark (PyTorch/CUDA)",
    )


if __name__ == "__main__":
    main()
