"""Overlap suite: the collective-matmul baselines and the ring modes.

Port of `tpu_matmul_bench/parallel/overlap.py:260-352, 451-495, 584-803`
for the five ring modes: `cuda_ring_hbm` (K2, the all-gather ring),
`cuda_ring_rs_hbm` (K3, the reduce-scatter ring), their bidirectional
forms `cuda_ring_bidir_hbm` (K4) and `cuda_ring_bidir_rs_hbm` (K5), and
`cuda_ring` (K6, the fused ring with its operands resident in L2, capped by
`cuda_ring_max_size`), each timed against its serialized baseline over the
world of ranks (`parallel/mesh.py`). The JAX package's mode names keep
their form, with `pallas_` → `cuda_`. The other modes of the JAX suite are
not ported yet (`OVERLAP_MODE_NAMES` says which queue item brings each).
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
from tpu_matmul_bench_torch.utils.metrics import (
    bytes_per_element,
    calculate_tflops,
    matmul_out_dtype,
)
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
        {"kernel": "CUDA HBM ring all-gather matmul (persistent-GEMM "
                   "products that store each chunk they load into the reader's "
                   "receive slot; K1 products and copy-engine hops between rank "
                   "streams across cards, or where a step "
                   "cannot forward)",
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
        {"kernel": "CUDA HBM ring reduce-scatter matmul (persistent pickup-GEMM "
                   "products stored into the reader's receive slot; copy-engine "
                   "hops between rank streams only across cards)",
         **_wres_extras(config, mesh, size)}, benchmark,
        x_spec=COLS, w_spec=ROWS,
        fusable=False,
    )


def cuda_ring_bidir_hbm_mode(config: BenchConfig, mesh: Mesh, size: int,
                             benchmark: str = "overlap") -> ModeSetup:
    """The bidirectional all-gather ring (`ops/cuda_ring.py`, K4):
    counter-rotating half chunks, two half-chunk products a step, against
    the gather-then-matmul baseline."""
    from tpu_matmul_bench_torch.ops.cuda_ring import ring_allgather_matmul_bidir_hbm

    fn = ring_allgather_matmul_bidir_hbm(mesh, **_hbm_ring_kwargs(config))
    return _vs_baseline_mode(
        config, mesh, size, "cuda_ring_bidir_hbm",
        collective_matmul_program(mesh, overlap=False, impl=config.matmul_impl,
                                  blocks=config.blocks),
        fn,
        "all_gather-then-matmul",
        {"kernel": "CUDA bidirectional HBM ring all-gather matmul (two "
                   "persistent-GEMM half-chunk products a step, each storing its "
                   "half into the reader's receive slot of its direction; "
                   "counter-rotating copy-engine hops across cards, or where a step "
                   "cannot forward)",
         **_wres_extras(config, mesh, size)}, benchmark,
        fusable=False,
    )


def cuda_ring_bidir_rs_hbm_mode(config: BenchConfig, mesh: Mesh, size: int,
                                benchmark: str = "overlap") -> ModeSetup:
    """The bidirectional reduce-scatter ring (`ops/cuda_ring.py`, K5):
    counter-rotating half accumulators, against the matmul-then-psum_scatter
    baseline."""
    from tpu_matmul_bench_torch.ops.cuda_ring import ring_reduce_scatter_matmul_bidir_hbm

    fn = ring_reduce_scatter_matmul_bidir_hbm(mesh, **_hbm_ring_kwargs(config))
    return _vs_baseline_mode(
        config, mesh, size, "cuda_ring_bidir_rs_hbm",
        collective_matmul_rs_program(mesh, overlap=False,
                                     impl=config.matmul_impl,
                                     blocks=config.blocks),
        fn,
        "matmul-then-psum_scatter",
        {"kernel": "CUDA bidirectional HBM ring reduce-scatter matmul (two "
                   "persistent pickup-GEMM half products a step, each stored "
                   "into the reader's receive slot of its direction; "
                   "counter-rotating copy-engine hops only across cards)",
         **_wres_extras(config, mesh, size)}, benchmark,
        x_spec=COLS, w_spec=ROWS,
        fusable=False,
    )


def cuda_ring_max_size(world: int, dtype, budget: int, ranks_per_card: int = 1) -> int:
    """Largest size whose fused-ring footprint fits `budget` bytes on one
    card: per rank the X shard, its 2 slots and the W shard (operand dtype)
    and the Y block (output dtype, int32 for int8), (3·mshard·k + k·nshard)
    · item + m·nshard · out_item (`pallas_ring.py:147-148`), that is
    size²/world · (4·item + out_item), summed over the `ranks_per_card` ranks
    that share the card. Rounded down to a multiple of 128·world, at least
    one. The form of `pallas_ring_max_size` (`overlap.py:597-606`), whose
    budget is the VMEM one and whose device holds one rank."""
    item = bytes_per_element(dtype)
    out_item = bytes_per_element(matmul_out_dtype(dtype))
    s = int((budget * world / (ranks_per_card * (4 * item + out_item))) ** 0.5)
    step = 128 * world  # keep shards lane-aligned and divisible by world
    return max((s // step) * step, step)


def l2_bytes(device: torch.device) -> int:
    """The card's L2, as it reports it: where the fused ring's operands stay
    between steps."""
    return torch.cuda.get_device_properties(device).L2_cache_size


def cuda_ring_mode(config: BenchConfig, mesh: Mesh, size: int,
                   benchmark: str = "overlap") -> ModeSetup:
    """The fused ring (`ops/cuda_ring_fused.py`, K6): the whole ring, every
    rank on the card, in one cooperative launch, against the
    gather-then-matmul baseline. On the card the size is capped by
    `cuda_ring_max_size` at the card's L2 (the CPU has no such cap, as the
    JAX package's interpreter has no VMEM cap)."""
    from tpu_matmul_bench_torch.ops.cuda_ring_fused import ring_allgather_matmul

    d = world_size(mesh)
    card = mesh.devices[0]
    if card.type == "cuda":
        limit = cuda_ring_max_size(d, config.dtype, l2_bytes(card), mesh.ranks_per_card)
        if size > limit:
            raise ValueError(
                f"cuda_ring at size {size} exceeds the L2-residency budget (max "
                f"size for {d} ranks, {mesh.ranks_per_card} per card/"
                f"{config.dtype_name}: {limit}); use --sizes {limit} or the "
                "HBM-blocked cuda_ring_hbm")
    return _vs_baseline_mode(
        config, mesh, size, "cuda_ring",
        collective_matmul_program(mesh, overlap=False, impl=config.matmul_impl,
                                  blocks=config.blocks),
        ring_allgather_matmul(mesh),
        "all_gather-then-matmul",
        {"kernel": "CUDA fused ring all-gather matmul (one cooperative launch, "
                   "wgmma tiles and TMA-store hops for TMA-describable bf16/f16, "
                   "a grid barrier a step)",
         # as the JAX package's pallas_ring: the HBM ring is the headline
         "superseded_by": "cuda_ring_hbm"}, benchmark,
        fusable=False,
    )


OVERLAP_MODES: dict[str, Callable[..., ModeSetup]] = {
    "cuda_ring": cuda_ring_mode,
    "cuda_ring_hbm": cuda_ring_hbm_mode,
    "cuda_ring_bidir_hbm": cuda_ring_bidir_hbm_mode,
    "cuda_ring_rs_hbm": cuda_ring_rs_hbm_mode,
    "cuda_ring_bidir_rs_hbm": cuda_ring_bidir_rs_hbm_mode,
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
    "cuda_ring": None,
    "cuda_ring_hbm": None,
    "cuda_ring_bidir_hbm": None,
    "cuda_ring_rs_hbm": None,
    "cuda_ring_bidir_rs_hbm": None,
}
