"""Overlap suite: the collective-matmul baselines and the ring modes.

Port of `tpu_matmul_bench/parallel/overlap.py:260-352, 451-495, 650-705,
764-803` for the two HBM ring modes: `cuda_ring_hbm` (K2, the all-gather
ring) and `cuda_ring_rs_hbm` (K3, the reduce-scatter ring), each timed
against its serialized baseline over the world of ranks
(`parallel/mesh.py`). The JAX package's mode names keep their form, with
`pallas_` → `cuda_`. The other modes of the JAX suite are not ported yet
(`OVERLAP_MODE_NAMES` says which queue item brings each).
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_matmul_bench_torch.ops.matmul import matmul_2d
from tpu_matmul_bench_torch.parallel.collectives import all_gather_over, psum_scatter_over
from tpu_matmul_bench_torch.parallel.mesh import (
    COLS,
    ROWS,
    Mesh,
    Sharded,
    global_block,
    mesh_device_kind,
    sharded_normal,
    world_size,
)
from tpu_matmul_bench_torch.parallel.modes import (
    ModeSetup,
    _record_base,
    estimate_memory_gib,
    expected_corner,
    make_corner_validate,
)
from tpu_matmul_bench_torch.utils.config import BenchConfig
from tpu_matmul_bench_torch.utils.metrics import bytes_per_element, calculate_tflops
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord
from tpu_matmul_bench_torch.utils.timing import Timing


def collective_matmul_program(mesh: Mesh, overlap: bool = True,
                              impl: str = "torch",
                              blocks: tuple[int, int, int] | None = None):
    """Y = X·W with X row-sharded [m/D, k] and W column-sharded [k, n/D]:
    logically Y_local = all_gather(X) @ W_local. Only the baseline
    (overlap=False) is ported: gather, then one product per rank."""
    if overlap:
        raise NotImplementedError(
            "collective_matmul's overlapped form is not ported yet (ROADMAP A7)")
    mm = matmul_2d(impl, blocks, mesh_device_kind(mesh))
    gather_x = all_gather_over(mesh, gather_axis=0)

    def program(x: Sharded, w: Sharded) -> Sharded:
        x_full = gather_x(x)
        return Sharded([mm(xf, wr) for xf, wr in zip(x_full, w)], COLS)

    return program


def collective_matmul_rs_program(mesh: Mesh, overlap: bool = True,
                                 impl: str = "torch",
                                 blocks: tuple[int, int, int] | None = None):
    """Y = X·W with the contraction dim sharded: X [m, k/D] column-sharded,
    W [k/D, n] row-sharded, Y [m/D, n] row-sharded. Only the baseline
    (overlap=False) is ported: each rank's whole partial product, then
    psum_scatter."""
    if overlap:
        raise NotImplementedError(
            "collective_matmul_rs's overlapped form is not ported yet (ROADMAP A7)")
    mm = matmul_2d(impl, blocks, mesh_device_kind(mesh))
    scatter = psum_scatter_over(mesh, scatter_dimension=0)

    def program(x: Sharded, w: Sharded) -> Sharded:
        return Sharded(scatter([mm(xr, wr) for xr, wr in zip(x, w)]), ROWS)

    return program


def _vs_baseline_mode(config: BenchConfig, mesh: Mesh, size: int,
                      mode_name: str, baseline_program, overlapped_program,
                      baseline_label: str, extra_fields: dict, benchmark: str,
                      x_spec: tuple = ROWS, w_spec: tuple = COLS,
                      fusable: bool = True) -> ModeSetup:
    """Shared builder for the collective-matmul forms: a serialized
    baseline leg timed against the overlapped program, with the speedup in
    extras. `tflops_per_device` is the total over the cards the ranks
    occupy, so on one card it is that card's throughput and
    `peak_efficiency_pct` keeps its 0–100 meaning."""
    d = world_size(mesh)
    cards = len(mesh.cards)
    (x,) = sharded_normal(config.seed, (size, size), config.dtype, mesh,
                          x_spec, count=1)
    (w,) = sharded_normal(config.seed + 1, (size, size), config.dtype, mesh,
                          w_spec, count=1)

    def build(t_compute: Timing, t_full: Timing | None, comm_s: float) -> BenchmarkRecord:
        # here 'compute' = the serialized baseline, 'full' = overlapped
        t_base = t_compute
        t_ovl = t_full if t_full else t_compute
        actual = calculate_tflops(size, t_ovl.avg_s)
        speedup = t_base.avg_s / t_ovl.avg_s if t_ovl.avg_s > 0 else 1.0
        return _record_base(
            config, benchmark, mode_name, size, d, t_ovl,
            avg_time_s=t_ovl.avg_s, tflops_per_device=actual / cards,
            tflops_total=actual, compute_time_s=t_base.avg_s, comm_time_s=None,
            device_kind=mesh_device_kind(mesh),
            extras={
                "baseline": baseline_label,
                "baseline_time_ms": round(t_base.avg_s * 1e3, 3),
                "overlap_speedup_x": round(speedup, 3),
                **extra_fields,
                "cards": cards,
                "ranks_per_card": mesh.ranks_per_card,
            })

    def expected() -> torch.Tensor:
        c = 128
        return expected_corner(global_block(x, c, size), global_block(w, size, c))

    return ModeSetup(mode_name, (x, w), baseline_program, overlapped_program,
                     build,
                     memory_gib_per_device=estimate_memory_gib(
                         mode_name, config, d, size),
                     validate=make_corner_validate(
                         overlapped_program, (x, w), expected, config.dtype),
                     fusable=fusable)


def _explicit_blocks(config: BenchConfig) -> dict:
    """Only the explicitly-set --block-m/n/k flags, as kernel kwargs (the
    ring builders fill the rest from the default tile)."""
    return {f"block_{dim}": v for dim, v in
            zip("mnk", (config.block_m, config.block_n, config.block_k))
            if v is not None}


def _hbm_ring_kwargs(config: BenchConfig) -> dict:
    """Kernel kwargs the HBM ring builders share: explicit block overrides
    + the --wres tri-state."""
    return {**_explicit_blocks(config), "wres": config.wres_override}


def _wres_extras(config: BenchConfig, mesh: Mesh, size: int) -> dict:
    """Record extras for a ring mode's W-resident provenance: the flag, the
    engagement and the reason, for a size² W cut into world-size shards
    (`--wres on` raised when the ring was built)."""
    from tpu_matmul_bench_torch.ops.cuda_ring import resolve_wres

    d = world_size(mesh)
    engaged, reason = resolve_wres(config.wres_override, d,
                                   size * (size // d) * bytes_per_element(config.dtype))
    return {"wres": config.wres, "wres_engaged": engaged, "wres_reason": reason}


def cuda_ring_hbm_mode(config: BenchConfig, mesh: Mesh, size: int,
                       benchmark: str = "overlap") -> ModeSetup:
    """The all-gather ring (`ops/cuda_ring.py`, K2) against the
    gather-then-matmul baseline. `--block-m/n/k` set the products' tile."""
    from tpu_matmul_bench_torch.ops.cuda_ring import ring_allgather_matmul_hbm

    fn = ring_allgather_matmul_hbm(mesh, **_hbm_ring_kwargs(config))
    return _vs_baseline_mode(
        config, mesh, size, "cuda_ring_hbm",
        collective_matmul_program(mesh, overlap=False, impl=config.matmul_impl,
                                  blocks=config.blocks),
        fn,
        "all_gather-then-matmul",
        {"kernel": "CUDA HBM ring all-gather matmul (K1 products, "
                   "copy-engine hops between rank streams)",
         **_wres_extras(config, mesh, size)}, benchmark,
        fusable=False,
    )


def cuda_ring_rs_hbm_mode(config: BenchConfig, mesh: Mesh, size: int,
                          benchmark: str = "overlap") -> ModeSetup:
    """The reduce-scatter ring (`ops/cuda_ring.py`, K3) against the
    matmul-then-psum_scatter baseline."""
    from tpu_matmul_bench_torch.ops.cuda_ring import ring_reduce_scatter_matmul_hbm

    fn = ring_reduce_scatter_matmul_hbm(mesh, **_hbm_ring_kwargs(config))
    return _vs_baseline_mode(
        config, mesh, size, "cuda_ring_rs_hbm",
        collective_matmul_rs_program(mesh, overlap=False,
                                     impl=config.matmul_impl,
                                     blocks=config.blocks),
        fn,
        "matmul-then-psum_scatter",
        {"kernel": "CUDA HBM ring reduce-scatter matmul (pickup-GEMM "
                   "products, copy-engine hops between rank streams)",
         **_wres_extras(config, mesh, size)}, benchmark,
        x_spec=COLS, w_spec=ROWS,
        fusable=False,
    )


OVERLAP_MODES: dict[str, Callable[..., ModeSetup]] = {
    "cuda_ring_hbm": cuda_ring_hbm_mode,
    "cuda_ring_rs_hbm": cuda_ring_rs_hbm_mode,
}

# The JAX suite's twelve modes, `pallas_` → `cuda_`: ported ones map to
# None, the rest to the ROADMAP item that brings them.
OVERLAP_MODE_NAMES: dict[str, str | None] = {
    "no_overlap": "ROADMAP A7 (the stream-overlap programs)",
    "overlap": "ROADMAP A7 (the stream-overlap programs)",
    "pipeline": "ROADMAP A7 (the stream-overlap programs)",
    "collective_matmul": "ROADMAP A7 (the collective-matmul rings)",
    "collective_matmul_bidir": "ROADMAP A7 (the collective-matmul rings)",
    "collective_matmul_rs": "ROADMAP A7 (the collective-matmul rings)",
    "collective_matmul_bidir_rs": "ROADMAP A7 (the collective-matmul rings)",
    "cuda_ring": "ROADMAP B6 (the shared-memory-resident ring, K6)",
    "cuda_ring_hbm": None,
    "cuda_ring_bidir_hbm": "ROADMAP B4 (the bidirectional ring, K4)",
    "cuda_ring_rs_hbm": None,
    "cuda_ring_bidir_rs_hbm": "ROADMAP B5 (the bidirectional reduce-scatter ring, K5)",
}
