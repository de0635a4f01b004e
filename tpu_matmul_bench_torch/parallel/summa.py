"""SUMMA: the scalable 2-D-grid distributed matmul.

Port of `tpu_matmul_bench/parallel/summa.py`. The ranks form an (r × c)
grid, axes ('i', 'j'), or a factorized ('dcn', 'ici') one (rows on the
outer axis). A [m, k], B [k, n] and C [m, n] are all block-sharded
P('i', 'j'). The k dimension is walked in s = lcm(r, c) panels, so panel
t's A columns live in one grid column (t // (s/c)) and its B rows in one
grid row (t // (s/r)). Each step:

1. the owning column broadcasts its A panel [m/r, k/s] along 'j', and the
   owning row its B panel [k/s, n/c] along 'i', each as JAX's masked psum
   taken literally (the owner contributes its panel, every other rank
   zeros, through `psum_impl(fuse_f32=True)`), so a wire format's bits
   and the comms model's bytes are JAX's;
2. acc += a_panel · b_panel through `ops/matmul.py matmul_2d`, so
   `--matmul-impl cuda` runs each product on K1, its operands views of
   the resident blocks (an A panel is a column view whose rows keep the
   block's stride).

After s steps acc is the rank's C block: no output collective. The compute
leg runs the same walk without the broadcasts (each rank multiplies its
own panels).
"""

from __future__ import annotations

import math

import torch

from tpu_matmul_bench_torch.ops.matmul import matmul_2d
from tpu_matmul_bench_torch.parallel.collectives import (
    check_wire_payload,
    comm_quant_record_extra,
    over_axis,
    psum_impl,
)
from tpu_matmul_bench_torch.parallel.mesh import (
    Mesh,
    Sharded,
    global_block,
    make_mesh,
    mesh_device_kind,
    mesh_spec_of,
    sharded_normal,
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
from tpu_matmul_bench_torch.utils.metrics import calculate_tflops, matmul_out_dtype
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord
from tpu_matmul_bench_torch.utils.timing import Timing


def summa_grid(n_devices: int, rows: int | None = None) -> tuple[int, int]:
    """(r, c) grid: `rows` when given, else the most-square factorization
    (largest divisor ≤ √n as rows: 8 → 2×4, 16 → 4×4, 1 → 1×1)."""
    if rows is not None:
        if rows <= 0 or n_devices % rows:
            raise ValueError(
                f"--rows {rows} must divide the {n_devices}-device world")
        return rows, n_devices // rows
    r = max(d for d in range(1, int(math.isqrt(n_devices)) + 1)
            if n_devices % d == 0)
    return r, n_devices // r


def make_summa_mesh(devices, rows: int | None = None) -> Mesh:
    r, c = summa_grid(len(devices), rows)
    return make_mesh(devices, ("i", "j"), (r, c))


def summa_size_ok(n_devices: int, size: int, rows: int | None = None) -> bool:
    """Whether `size` splits into whole blocks and whole k-panels on the
    grid `summa_grid(n_devices, rows)`."""
    r, c = summa_grid(n_devices, rows)
    s = math.lcm(r, c)
    return size % (r * s) == 0 and size % (c * s) == 0


def summa_min_size(n_devices: int, floor: int = 1, rows: int | None = None) -> int:
    """The smallest compatible size ≥ `floor` for the grid."""
    r, c = summa_grid(n_devices, rows)
    s = math.lcm(r, c)
    base = math.lcm(r * s, c * s)
    return base * -(-floor // base)  # ceil(floor / base) · base


def step_panels(mesh: Mesh, a: Sharded, b: Sharded, t: int, psum=None
                ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Each rank's (A panel, B panel) of step t: views of its own blocks,
    or with `psum` (a `psum_impl`) the owners' panels broadcast along the
    grid's columns and rows by JAX's masked psum (`summa.py:305-312`)."""
    i_ax, j_ax = mesh.axis_names
    r, c = mesh.shape[i_ax], mesh.shape[j_ax]
    s = math.lcm(r, c)
    kb_a = a[0].shape[1] // (s // c)  # panel width inside an A block
    kb_b = b[0].shape[0] // (s // r)  # panel height inside a B block
    ta, tb = (t % (s // c)) * kb_a, (t % (s // r)) * kb_b
    a_pan = [ar[:, ta:ta + kb_a] for ar in a]
    b_pan = [br[tb:tb + kb_b] for br in b]
    if psum is None:
        return a_pan, b_pan
    col_owner, row_owner = t // (s // c), t // (s // r)
    coords = [mesh.coords(k) for k in range(mesh.size)]
    a_pan = over_axis(mesh, j_ax, [p if co[j_ax] == col_owner else torch.zeros_like(p)
                                   for p, co in zip(a_pan, coords)], psum)
    b_pan = over_axis(mesh, i_ax, [p if co[i_ax] == row_owner else torch.zeros_like(p)
                                   for p, co in zip(b_pan, coords)], psum)
    return a_pan, b_pan


def summa_programs(mesh: Mesh, impl: str = "torch",
                   blocks: tuple[int, int, int] | None = None,
                   comm_quant: str | None = None):
    """(compute, full) programs for the SUMMA walk on `mesh` (JAX
    `summa.py:271-324`). Grid roles come from position: the outer axis is
    the rows, the inner the columns, so on a factorized mesh the B-panel
    broadcast (over the rows) rides dcn and the A-panel broadcast ici.
    Under `comm_quant` the broadcasts keep their dequantized panels in
    fp32 into the product (`fuse_f32`), and each step's add into the
    accumulator, in the product's output dtype as in JAX, is the downcast."""
    i_ax, j_ax = mesh.axis_names
    s = math.lcm(mesh.shape[i_ax], mesh.shape[j_ax])
    mm = matmul_2d(impl, blocks, mesh_device_kind(mesh))
    psum = psum_impl(comm_quant, fuse_f32=True)

    def walk(a: Sharded, b: Sharded, with_comm: bool) -> Sharded:
        out_dtype = matmul_out_dtype(a[0].dtype)
        acc = [torch.zeros((ar.shape[0], br.shape[1]), dtype=out_dtype, device=ar.device)
               for ar, br in zip(a, b)]
        for t in range(s):
            a_pan, b_pan = step_panels(mesh, a, b, t, psum if with_comm else None)
            for acc_r, ap, bp in zip(acc, a_pan, b_pan):
                if ap.dtype != bp.dtype:
                    # a per-link wire dequantizes one broadcast to fp32 and
                    # leaves the other exact: the product promotes, as
                    # jnp.matmul does
                    wide = torch.promote_types(ap.dtype, bp.dtype)
                    ap, bp = ap.to(wide), bp.to(wide)
                acc_r.add_(mm(ap, bp).to(out_dtype))
            del a_pan, b_pan
        return Sharded(acc, (i_ax, j_ax), mesh.shape)

    return (lambda a, b: walk(a, b, False)), (lambda a, b: walk(a, b, True))


def summa_mode(config: BenchConfig, mesh: Mesh, size: int,
               benchmark: str = "summa") -> ModeSetup:
    """≙ JAX `summa_mode` (`summa.py:327-383`). Total = the product's FLOPs
    over the full program's time."""
    i_ax, j_ax = mesh.axis_names
    r, c = mesh.shape[i_ax], mesh.shape[j_ax]
    mesh_spec = mesh_spec_of(mesh)
    world = r * c
    s = math.lcm(r, c)
    if size % (r * s) or size % (c * s):
        # every block must split into whole panels (k/s) and whole block
        # rows and columns
        raise ValueError(
            f"size {size} must be divisible by r·lcm(r,c)={r * s} and "
            f"c·lcm(r,c)={c * s} for the ({r}x{c}) SUMMA grid")

    (a,) = sharded_normal(config.seed, (size, size), config.dtype, mesh,
                          (i_ax, j_ax), count=1)
    (b,) = sharded_normal(config.seed + 1, (size, size), config.dtype, mesh,
                          (i_ax, j_ax), count=1)
    check_wire_payload(config.comm_quant, "all_reduce", (size // r, size // s), c,
                       config.dtype, axis_name=j_ax)
    check_wire_payload(config.comm_quant, "all_reduce", (size // s, size // c), r,
                       config.dtype, axis_name=i_ax)
    compute, full = summa_programs(mesh, config.matmul_impl, config.blocks,
                                   comm_quant=config.comm_quant)

    def build(t_compute: Timing, t_full: Timing | None, comm_s: float) -> BenchmarkRecord:
        total_s = t_full.avg_s if t_full else t_compute.avg_s
        extras = {"grid": f"{r}x{c}", "k_panels": s,
                  "algorithm": "SUMMA (2-D grid, masked-psum broadcasts)"}
        if mesh_spec is not None:
            extras["mesh"] = mesh_spec
        if uses_quantized_comm(config):
            extras["comm_quant"] = comm_quant_record_extra(
                config, world, mode="summa", size=size, rows=r, mesh_spec=mesh_spec)
        return _mode_record(
            config, benchmark, "summa", size, mesh, t_full or t_compute,
            calculate_tflops(size, total_s), extras,
            avg_time_s=total_s, compute_time_s=t_compute.avg_s, comm_time_s=comm_s)

    corner = VALIDATION_CORNER
    return ModeSetup(
        "summa", (a, b), compute, full, build,
        memory_gib_per_device=estimate_memory_gib("summa", config, world, size),
        validate=make_corner_validate(
            full, (a, b),
            lambda: expected_corner(global_block(a, corner, size),
                                    global_block(b, size, corner)),
            config.dtype, comm_quant=config.comm_quant,
            # each C element crosses two quantized broadcasts a panel; the
            # tolerance scales with the broader of the two axes
            world=max(r, c) + 1))
