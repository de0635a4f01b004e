"""Overlap benchmark: compute/communication overlap over a world of ranks.

Port of `tpu_matmul_bench/benchmarks/matmul_overlap_benchmark.py`, all
twelve modes of `parallel/overlap.py` with `pallas_` → `cuda_`: the
reference's stream-overlap programs `no_overlap`, `overlap` (the default,
as in JAX and the reference) and `pipeline`; the collective-matmul rings
`collective_matmul`, `collective_matmul_bidir`, `collective_matmul_rs` and
`collective_matmul_bidir_rs`; and the ring kernels `cuda_ring_hbm` (K2),
`cuda_ring_rs_hbm` (K3), `cuda_ring_bidir_hbm` (K4),
`cuda_ring_bidir_rs_hbm` (K5) and `cuda_ring` (K6, capped at the card's
L2), over --num-devices ranks (`parallel/mesh.py`; `TMB_RANKS_PER_CARD`
ranks may share a card).

Run: TMB_RANKS_PER_CARD=4 python -m tpu_matmul_bench_torch overlap \
        --mode overlap --num-devices 4 --matmul-impl cuda ...
"""

from __future__ import annotations

from typing import Sequence

from tpu_matmul_bench_torch.benchmarks.matmul_scaling_benchmark import run
from tpu_matmul_bench_torch.parallel.overlap import OVERLAP_MODES
from tpu_matmul_bench_torch.utils.config import parse_config
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord


def main(argv: Sequence[str] | None = None) -> list[BenchmarkRecord]:
    config = parse_config(
        argv,
        description=__doc__ or "overlap benchmark",
        modes=list(OVERLAP_MODES),
        default_mode="overlap",
        extra_dtypes=("int8",),
        fused_timing=True,
    )
    return run(
        config,
        modes_table=OVERLAP_MODES,
        benchmark_name="overlap",
        title="Compute/Communication Overlap Benchmark (PyTorch/CUDA)",
    )


if __name__ == "__main__":
    main()
