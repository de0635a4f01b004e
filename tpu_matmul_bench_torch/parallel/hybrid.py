"""Hybrid 2-D mesh mode: data parallelism × tensor parallelism in one program.

Port of `tpu_matmul_bench/parallel/hybrid.py`. The ranks form a ('dp', 'tp')
mesh, or a factorized ('dcn', 'ici') one: axis roles come from position,
the outer axis data parallelism and the inner tensor parallelism, so
`--mesh dcn:R,ici:C` puts the gradient-sync psum on dcn and the column
gather on ici. X [batch, n, n] is cut P('dp') and W [n, n] P(None, 'tp');
each rank multiplies its local batch of [n, n]·[n, n/tp] products through
`ops/matmul.py matmul_2d`, so `--matmul-impl cuda` runs each on K1 with W's
column shard as B. The full program gathers the output columns over 'tp',
sums the local batch, psums over 'dp' and downcasts once.
"""

from __future__ import annotations

import torch

from tpu_matmul_bench_torch.ops.matmul import Matmul, matmul_2d
from tpu_matmul_bench_torch.parallel.collectives import (
    allgather_impl,
    check_wire_payload,
    comm_quant_record_extra,
    over_axis,
    psum_impl,
)
from tpu_matmul_bench_torch.parallel.mesh import (
    Mesh,
    Sharded,
    first_local_shard,
    global_block,
    make_mesh,
    mesh_device_kind,
    mesh_spec_of,
    sharded_normal,
    stacked_item,
)
from tpu_matmul_bench_torch.parallel.modes import (
    VALIDATION_CORNER,
    ModeSetup,
    _mode_record,
    estimate_memory_gib,
    expected_corner,
    make_corner_validate,
)
from tpu_matmul_bench_torch.parallel.quantized import uses_quantized_comm
from tpu_matmul_bench_torch.utils.config import BenchConfig
from tpu_matmul_bench_torch.utils.metrics import calculate_tflops
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord
from tpu_matmul_bench_torch.utils.timing import Timing


def make_hybrid_mesh(devices, dp: int) -> Mesh:
    """(dp, tp) mesh over the ranks' devices; tp = len(devices) // dp."""
    n = len(devices)
    if dp <= 0 or n % dp:
        raise ValueError(f"--dp {dp} must divide the {n}-device world")
    return make_mesh(devices, ("dp", "tp"), (dp, n // dp))


def _local_products(mm: Matmul, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[lb, n, n/tp]: each matrix of the rank's local batch times its W
    shard (one matrix needs no stacking copy)."""
    if x.shape[0] == 1:
        return mm(x[0], w).unsqueeze(0)
    return torch.stack([mm(x[i], w) for i in range(x.shape[0])])


def hybrid_programs(mesh: Mesh, impl: str = "torch",
                    blocks: tuple[int, int, int] | None = None,
                    comm_quant: str | None = None):
    """(compute, full) programs for the composed dp×tp step (JAX
    `hybrid.py:55-101`). Under `comm_quant` both collectives go on the
    wire of their axis's format: the gather keeps its dequantized values in
    fp32 (`fuse_f32`) through the batch sum and the psum, so the step
    downcasts once, at its end."""
    dp_ax, tp_ax = mesh.axis_names
    mm = matmul_2d(impl, blocks, mesh_device_kind(mesh))
    ag = allgather_impl(comm_quant, fuse_f32=True)
    psum = psum_impl(comm_quant, varying_out=True)

    def compute(x: Sharded, w: Sharded) -> Sharded:
        return Sharded([_local_products(mm, xr, wr) for xr, wr in zip(x, w)],
                       (dp_ax, None, tp_ax), mesh.shape)

    def full(x: Sharded, w: Sharded) -> Sharded:
        y = [_local_products(mm, xr, wr) for xr, wr in zip(x, w)]
        out_dt = y[0].dtype  # the exact program's output dtype
        # tp leg: every tp rank assembles the full output columns
        y = over_axis(mesh, tp_ax, y, lambda sub, g: ag(sub, g, axis=2))
        # dp leg: the gradient-sync-style psum of the local batch's sum
        g = over_axis(mesh, dp_ax, [yr.sum(dim=0, dtype=yr.dtype) for yr in y], psum)
        del y
        # one downcast (a no-op for exact and integer programs); out spec
        # P(('dp', 'tp')): every rank's identical [n, n] side by side on dim 0
        return Sharded([gr.to(out_dt) for gr in g], ((dp_ax, tp_ax),), mesh.shape)

    return compute, full


def hybrid_mode(config: BenchConfig, mesh: Mesh, size: int, batch: int = 4,
                benchmark: str = "hybrid") -> ModeSetup:
    """≙ JAX `hybrid_mode` (`hybrid.py:104-164`). The local batch is floored
    at 1, so the global batch grows to dp where dp > batch (the record's
    note says so). Total = the global batch's products over the full
    program's time."""
    dp_ax, tp_ax = mesh.axis_names
    dp, tp = mesh.shape[dp_ax], mesh.shape[tp_ax]
    mesh_spec = mesh_spec_of(mesh)
    world = dp * tp
    local_batch = max(batch // dp, 1)
    g = local_batch * dp

    (x,) = sharded_normal(config.seed, (g, size, size), config.dtype, mesh,
                          (dp_ax,), count=1)
    (w,) = sharded_normal(config.seed + 1, (size, size), config.dtype, mesh,
                          (None, tp_ax), count=1)
    check_wire_payload(config.comm_quant, "all_gather", (local_batch, size, size // tp),
                       tp, config.dtype, axis_name=tp_ax)
    check_wire_payload(config.comm_quant, "all_reduce", (size, size), dp, config.dtype,
                       axis_name=dp_ax)
    compute, full = hybrid_programs(mesh, config.matmul_impl, config.blocks,
                                    comm_quant=config.comm_quant)

    def build(t_compute: Timing, t_full: Timing | None, comm_s: float) -> BenchmarkRecord:
        total_s = t_full.avg_s if t_full else t_compute.avg_s
        extras = {"dp": dp, "tp": tp, "global_batch": g, "local_batch": local_batch}
        if mesh_spec is not None:
            extras["mesh"] = mesh_spec
        if uses_quantized_comm(config):
            extras["comm_quant"] = comm_quant_record_extra(
                config, world, mode="hybrid", size=size, batch=batch, dp=dp,
                mesh_spec=mesh_spec)
        if g != batch:
            extras["note"] = f"global batch grown from {batch} to {g} to cover dp={dp}"
        # g full-size products a step, split over the whole mesh
        return _mode_record(
            config, benchmark, "hybrid", size, mesh, t_full or t_compute,
            calculate_tflops(size, total_s, num_ops=g), extras,
            avg_time_s=total_s, compute_time_s=t_compute.avg_s, comm_time_s=comm_s)

    def expected() -> torch.Tensor:
        # full = the psum over dp of each local batch's sum, and W is shared
        # across the batch: Σ_i x_i·W = (Σ_i x_i)·W
        c = VALIDATION_CORNER
        rows = sum(stacked_item(x, i)[:c].double() for i in range(g))
        return expected_corner(rows, global_block(w, size, c))

    return ModeSetup("hybrid", (x, w), compute, full, build,
                     memory_gib_per_device=estimate_memory_gib(
                         "hybrid", config, world, size, batch=batch, dp=dp),
                     # the first logical [size, size] block of the out
                     # spec P(('dp', 'tp')) is rank 0's copy of the output;
                     # every rank holds the same, and this process reads its own
                     validate=make_corner_validate(
                         lambda xx, ww: first_local_shard(full(xx, ww)), (x, w),
                         expected, config.dtype,
                         comm_quant=config.comm_quant,
                         # dp psum hops + one gather rounding drive the error
                         world=dp + 1))
