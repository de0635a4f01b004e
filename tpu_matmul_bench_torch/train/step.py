"""One optimizer step as per-rank programs over the world of ranks.

Port of `tpu_matmul_bench/train/step.py`. The workload is minimal on
purpose: the linear model Y[b] = X[b]·W with the quadratic loss L =
‖Y‖²/(2·denom), so the backward is one autograd pass through the local
forward and the gradient dW = Σ_b X[b]ᵀ·(Y[b]/denom) can be checked in
closed form. A step's dataflow:

    forward (local)  →  backward by torch.autograd (local)  →  gradient
    sync over the data axis  →  weight update (fp32)  →  [ZeRO] all_gather
    of the updated shards

Two train modes over the port's meshes (`parallel/mesh.py`):

- ``dp``     — a one-axis mesh (the flat 'x' or a one-axis --mesh): X cut
  over the batch, W replicated;
- ``hybrid`` — a two-axis mesh (``--mesh dcn:R,ici:C``): X cut over the
  outer (data) axis, W's columns over the inner (tensor) axis, the roles
  by position as in `parallel/hybrid.py`, so the gradient sync rides dcn.

The forward and backward make no collective: autograd differentiates the
LOCAL forward (with JAX's analytic cotangent Y/denom, as `jax.vjp` is fed
it), and the batch reduction is the explicit gradient collective. So the
full step's collectives are the gradient sync and, under ZeRO, the weight
all_gather: what `analysis/comms_model.py train_axis_collectives` lists.
The products are the library's (`torch.matmul`): the hand-written kernel
has no backward, as JAX's `pallas_matmul` has no VJP.

`--grad-quant` routes only the gradient collectives through the wire
formats (`reduce_scatter_impl` / `psum_impl` with `fuse_f32`, per link via
`link_format_spec`); the ZeRO all_gather of updated parameters is exact.
The update runs in fp32 and downcasts once, to the weight dtype.

Per-phase timing uses cumulative-prefix programs: prefix k runs phases
1..k and returns what crosses the k-th boundary, so phase k's time is t(k)
− t(k−1) and the split sums to the full step's time by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from tpu_matmul_bench_torch.ops.matmul import matmul_2d
from tpu_matmul_bench_torch.parallel.collectives import (
    allgather_impl,
    link_format_spec,
    over_axis,
    psum_impl,
    reduce_scatter_impl,
)
from tpu_matmul_bench_torch.parallel.mesh import (
    Mesh,
    Sharded,
    gather,
    mesh_device_kind,
    mesh_spec_of,
    shard_from_numpy,
    sharded_normal,
)
from tpu_matmul_bench_torch.utils.metrics import is_integer_dtype, matrix_memory_gib

TRAIN_MODES = ("dp", "hybrid")

#: the step's phase boundaries, in dataflow order: prefix program k runs
#: phases 1..k (see the module docstring)
PHASES = ("fwd", "bwd", "grad_comm", "update", "allgather")

DEFAULT_BATCH = 8
DEFAULT_STEPS = 4
DEFAULT_LR = 0.01


def train_axes(mesh: Mesh, mode: str) -> tuple[str, str | None]:
    """(data_axis, tensor_axis | None) of a train mode on a mesh: roles by
    position (outer = data), the `parallel/hybrid.py` convention."""
    names = mesh.axis_names
    if mode == "dp":
        if len(names) != 1:
            raise ValueError(
                f"train mode 'dp' takes a one-axis mesh, got axes {names}")
        return names[0], None
    if mode == "hybrid":
        if len(names) != 2:
            raise ValueError(
                "train mode 'hybrid' needs a two-axis mesh "
                f"(--mesh dcn:R,ici:C), got axes {names}")
        return names[0], names[1]
    raise ValueError(
        f"unknown train mode {mode!r} (expected one of {TRAIN_MODES})")


def zero_shard_rows(size: int, r: int) -> list[tuple[int, int]]:
    """The ZeRO ownership map: rank i of the r-wide data axis updates
    weight rows [start, stop). The r intervals are pairwise disjoint and
    tile [0, size) exactly."""
    if size % r:
        raise ValueError(f"size {size} must divide the {r}-wide data axis")
    chunk = size // r
    return [(i * chunk, (i + 1) * chunk) for i in range(r)]


def train_tolerance(dtype: Any, grad_quant: str | None, dp_axis: str,
                    world: int) -> float:
    """Validation tolerance of one train step: the dtype's, loosened to the
    quantized ring's bound when the data axis's gradient sync runs a wire
    format (conservative: the wire's error enters the weights scaled by
    the learning rate)."""
    from tpu_matmul_bench_torch.parallel.modes import (
        quantized_tolerance,
        validation_tolerance,
    )

    base = validation_tolerance(dtype)
    qt = quantized_tolerance(link_format_spec(grad_quant, dp_axis), world)
    return max(base, qt) if qt is not None else base


@dataclasses.dataclass(frozen=True)
class TrainStepSetup:
    """Everything the harness needs for one (mode, mesh, size) train cell."""

    mode: str
    size: int
    zero: bool
    grad_quant: str | None
    lr: float
    world: int
    dp: int                     # data-axis width R (the ZeRO shard count)
    tp: int                     # tensor-axis width C (1 for mode dp)
    dp_axis: str
    tp_axis: str | None
    mesh_spec: str | None       # canonical --mesh spec, None on other meshes
    global_batch: int
    local_batch: int
    operands: tuple[Sharded, Sharded]           # (x, w0)
    prefixes: dict[str, Callable]               # phase → prefix program
    step: Callable                              # full step: (x, w) → w_new
    reference: Callable                         # dense fp32 one-step reference
    memory_gib_per_device: float


def train_step_programs(mesh: Mesh, mode: str, size: int, *,
                        batch: int = DEFAULT_BATCH, zero: bool = False,
                        grad_quant: str | None = None, lr: float = DEFAULT_LR,
                        impl: str = "torch",
                        blocks: tuple[int, int, int] | None = None,
                        ) -> dict[str, Callable]:
    """The five cumulative-prefix programs of one train step, keyed by
    `PHASES`, each `(x, w) → Sharded`. ``prefixes["allgather"]`` is the full
    step; its output has the weight's spec, so it iterates:
    ``w = prefixes["allgather"](x, w)``."""
    dp_ax, tp_ax = train_axes(mesh, mode)
    r = mesh.shape[dp_ax]
    c = mesh.shape[tp_ax] if tp_ax else 1
    n = size
    zero_shard_rows(n, r)  # raises unless the data axis tiles the rows
    if tp_ax and n % c:
        raise ValueError(f"size {n} must divide the {c}-wide tensor axis")
    lb = max(batch // r, 1)
    denom = float(lb * r * n * n)
    mm = matmul_2d(impl, blocks, mesh_device_kind(mesh))
    # the gradient collectives ride the wire format; fuse_f32 keeps the
    # dequantized gradient in fp32 through the update, so the step makes
    # exactly one downcast (in `updated`)
    rs = reduce_scatter_impl(grad_quant, fuse_f32=True)
    ar = psum_impl(grad_quant, varying_out=True, fuse_f32=True)
    ag = allgather_impl(None)  # updated parameters travel exact
    chunk = n // r

    def fwd_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        # x: [lb, n, n] batch shard, w: [n, n/c] column shard
        return torch.stack([mm(x[i], w) for i in range(x.shape[0])])

    def grads_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        # the backward through the LOCAL forward, with the quadratic
        # loss's analytic cotangent dL/dY = Y/denom: autograd never meets a
        # collective, and the batch reduction stays the explicit gradient
        # collective below
        wv = w.detach().requires_grad_(True)
        with torch.enable_grad():
            y = fwd_local(x, wv)
        (dw,) = torch.autograd.grad(y, wv, grad_outputs=y.detach() / denom)
        return dw  # [n, n/c]: this rank's local-batch contribution

    def grad_sync(dws: list[torch.Tensor]) -> list[torch.Tensor]:
        g = over_axis(mesh, dp_ax, dws, rs if zero else ar)
        return [t.float() for t in g]  # a no-op on the fused wire

    def updated(ws: Sharded, g32: list[torch.Tensor]) -> list[torch.Tensor]:
        out = []
        for rank, (w, g) in enumerate(zip(ws, g32)):
            if zero:
                # the ZeRO ownership invariant: rank i updates exactly the
                # row chunk its reduce_scatter delivered (zero_shard_rows)
                my = mesh.coords(rank)[dp_ax]
                w = w[my * chunk:(my + 1) * chunk]
            out.append((w.float() - lr * g).to(w.dtype))  # the single downcast
        return out

    def grads(x: Sharded, w: Sharded) -> list[torch.Tensor]:
        return [grads_local(xr, wr) for xr, wr in zip(x, w)]

    def sharded(shards: list[torch.Tensor], spec: tuple) -> Sharded:
        return Sharded(shards, spec, mesh.shape)

    synced = (dp_ax, tp_ax) if zero else (None, tp_ax)

    def p_fwd(x: Sharded, w: Sharded) -> Sharded:
        return sharded([fwd_local(xr, wr) for xr, wr in zip(x, w)], (dp_ax, None, tp_ax))

    def p_bwd(x: Sharded, w: Sharded) -> Sharded:
        return sharded(grads(x, w), (dp_ax, tp_ax))

    def p_grad(x: Sharded, w: Sharded) -> Sharded:
        return sharded(grad_sync(grads(x, w)), synced)

    def p_update(x: Sharded, w: Sharded) -> Sharded:
        return sharded(updated(w, grad_sync(grads(x, w))), synced)

    def p_step(x: Sharded, w: Sharded) -> Sharded:
        new = updated(w, grad_sync(grads(x, w)))
        if zero:
            # the full weight from the owned shards: updated PARAMETERS
            # travel exact, only gradients ride the wire format
            new = over_axis(mesh, dp_ax, new, lambda sub, g: ag(sub, g, axis=0))
        return sharded(new, (None, tp_ax))

    bodies = {"fwd": p_fwd, "bwd": p_bwd, "grad_comm": p_grad,
              "update": p_update, "allgather": p_step}
    return {phase: bodies[phase] for phase in PHASES}


def train_operands_from_numpy(x: np.ndarray, w0: np.ndarray, mesh: Mesh,
                              mode: str) -> tuple[Sharded, Sharded]:
    """The JAX package's train operands `(x, w0)`, as numpy arrays, as the
    port's sharded operands, cut by JAX's specs: x P(dp), w P(None, tp)."""
    dp_ax, tp_ax = train_axes(mesh, mode)
    return (shard_from_numpy(x, (dp_ax,), mesh),
            shard_from_numpy(w0, (None, tp_ax), mesh))


def make_train_setup(mesh: Mesh, mode: str, size: int, dtype: torch.dtype, *,
                     batch: int = DEFAULT_BATCH, zero: bool = False,
                     grad_quant: str | None = None, lr: float = DEFAULT_LR,
                     impl: str = "torch",
                     blocks: tuple[int, int, int] | None = None,
                     seed: int = 0) -> TrainStepSetup:
    """Operands, programs and the dense reference of one train cell."""
    if is_integer_dtype(dtype):
        raise ValueError("the train step is a float workload (gradients); "
                         f"got dtype {str(dtype).removeprefix('torch.')}")
    dp_ax, tp_ax = train_axes(mesh, mode)
    r = mesh.shape[dp_ax]
    c = mesh.shape[tp_ax] if tp_ax else 1
    lb = max(batch // r, 1)
    g = lb * r
    denom = float(g * size * size)

    (x,) = sharded_normal(seed, (g, size, size), dtype, mesh, (dp_ax,), count=1)
    (w,) = sharded_normal(seed + 1, (size, size), dtype, mesh, (None, tp_ax), count=1)
    prefixes = train_step_programs(
        mesh, mode, size, batch=g, zero=zero, grad_quant=grad_quant, lr=lr,
        impl=impl, blocks=blocks)

    @torch.no_grad()
    def reference(xx: Sharded, ww: Sharded) -> torch.Tensor:
        # the dense fp32 step on the global arrays: no mesh, no wire; dW
        # summed a batch item at a time, to hold one item's fp32 copies
        xg, wg = gather(xx), gather(ww)
        wf = wg.float()
        dw = torch.zeros_like(wf)
        for b in range(xg.shape[0]):
            xf = xg[b].float()
            dw += xf.T @ (xf @ wf)
        return (wf - lr * (dw / denom)).to(wg.dtype)

    # a rank's x shard (lb) and forward batch (lb), its w shard and dW
    # (1/c each), and the fp32 update's temporaries (2/c)
    mem = matrix_memory_gib(size, dtype, count=2 * lb) + \
        matrix_memory_gib(size, dtype, count=2.0 / c) + \
        matrix_memory_gib(size, torch.float32, count=2.0 / c)
    return TrainStepSetup(
        mode=mode, size=size, zero=zero, grad_quant=grad_quant, lr=lr,
        world=r * c, dp=r, tp=c, dp_axis=dp_ax, tp_axis=tp_ax,
        mesh_spec=mesh_spec_of(mesh), global_batch=g, local_batch=lb,
        operands=(x, w), prefixes=prefixes, step=prefixes["allgather"],
        reference=reference, memory_gib_per_device=mem)
