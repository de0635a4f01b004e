"""Compute primitives: the matmul routes (`ops/matmul.py`), the hand-written
kernels' wrappers (`ops/cuda_matmul.py`, `ops/cuda_ring.py`,
`ops/cuda_ring_fused.py`) and their build (`ops/_build.py`).

Importing the package loads no module of it: `ops/_build.py` is imported
by processes that must not import torch (`tpu_matmul_bench_torch/bench.py`).
"""


def ring_matmul_builders() -> dict:
    """The HBM ring matmuls by mode name → (builder, operand-sharding
    kind), the port's `tpu_matmul_bench/ops/__init__.py:12-34`: "ag" rings
    take x P("x", None) and w P(None, "x"), "rs" rings the transposed
    contract. Imported lazily, as the JAX package imports its Pallas
    modules."""
    from tpu_matmul_bench_torch.ops.cuda_ring import (
        ring_allgather_matmul_bidir_hbm,
        ring_allgather_matmul_hbm,
        ring_reduce_scatter_matmul_bidir_hbm,
        ring_reduce_scatter_matmul_hbm,
    )

    return {
        "cuda_ring_hbm": (ring_allgather_matmul_hbm, "ag"),
        "cuda_ring_bidir_hbm": (ring_allgather_matmul_bidir_hbm, "ag"),
        "cuda_ring_rs_hbm": (ring_reduce_scatter_matmul_hbm, "rs"),
        "cuda_ring_bidir_rs_hbm": (ring_reduce_scatter_matmul_bidir_hbm, "rs"),
    }
