"""Analytic comms model: the collectives each parallel mode must make, and
their bytes on a quantized wire.

Port of `tpu_matmul_bench/analysis/comms_model.py` `:55-685`: the flat
world's model, the hierarchical one of the factorized meshes, and the
train step's gradient collectives (`train_axis_collectives`). It is
derived from the mode definitions, not from a trace.
Payload bytes are each rank's operand bytes of the collective for a square
[size, size] problem in `dtype`:

- independent: no collective.
- batch_parallel: one all_reduce of the rank's [lb, n, n] products.
- data_parallel: one all_reduce of [1, n, n].
- matrix_parallel: one all_gather of the rank's [n, n/d] output columns
  (none at d = 1, where the mode falls back to independent).
- model_parallel: one all_reduce of the full [n, n] partial product.
- hybrid: one all_gather of [lb, n, n/tp] over 'tp', one all_reduce of
  [n, n] over 'dp'.
- summa: a step's two masked-psum broadcasts, the A panel [n/r, n/s] over
  the columns and the B panel [n/s, n/c] over the rows, for each of the
  s = lcm(r, c) steps.

**Hierarchical term.** On a factorized `--mesh dcn:R,ici:C` each
collective runs over one named axis, and the axis name is its link class
(`mode_axis_collectives`, `hier_expected_collectives`).
`hier_wire_bytes_summary` prices each link apart and names the slowest
(`LINK_WIRE_SECONDS`, a ranking factor, not a measurement).

**Wire-format term.** Under `--comm-quant` every float collective is
rewritten on the wire: an all_reduce becomes the quantized ring (D−1 hops
of the 1-byte payload chunk and of its fp32 scales, then one all_gather of
each), an all_gather carries the 1-byte payload and its scales.
`wire_collectives` lists that inventory and `wire_bytes_summary` prices
it, payload and scale bytes apart: the ≥2× reduction against bf16 is a
payload property, and the scales add 4/B bytes per payload byte at block
size B (4/cols for the per-row formats).

The module imports numpy only. A dtype is a name ("bfloat16"), a numpy
dtype or a torch dtype; the wire grammar comes from
`parallel/collectives.py` when a function needs it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

# ring wire traffic per payload byte, by collective kind
RING_WIRE_FACTOR = {
    "all_reduce": lambda d: 2.0 * (d - 1) / d,
    "all_gather": lambda d: float(d - 1),
    "reduce_scatter": lambda d: (d - 1) / d,
    "ppermute": lambda d: 1.0,
    "all_to_all": lambda d: (d - 1) / d,
}

# the dtypes numpy does not name on its own: (itemsize, integer)
_NAMED = {"bfloat16": (2, False), "float8_e4m3fn": (1, False)}


@dataclasses.dataclass(frozen=True)
class ExpectedCollective:
    kind: str
    payload_bytes: int


def _dtype_info(dtype: Any) -> tuple[int, bool]:
    """(itemsize, is integer) of a dtype name, numpy dtype or torch dtype."""
    name = str(dtype).removeprefix("torch.")
    if name in _NAMED:
        return _NAMED[name]
    try:
        dt = np.dtype(name)
    except TypeError:  # a numpy scalar type, whose str is not its name
        dt = np.dtype(dtype)
    return dt.itemsize, bool(np.issubdtype(dt, np.integer))


def matmul_out_itemsize(dtype: Any) -> int:
    """Output itemsize of the suite's matmul for an operand dtype: integer
    operands accumulate to int32; float operands keep their dtype."""
    itemsize, integer = _dtype_info(dtype)
    return 4 if integer else itemsize


def mode_collective_shapes(
        mode: str, world: int, size: int, batch: int = 4,
        dp: int | None = None, rows: int | None = None,
) -> list[tuple[str, int, tuple[int, ...]]]:
    """The float collectives of one mode's full program as
    ``(kind, axis_size, per_rank_operand_shape)`` triples: the base of the
    exact inventory (`expected_collectives`) and of the wire term
    (`wire_collectives`, `wire_bytes_summary`). summa's scan body counts
    once; its traffic a run multiplies by `mode_steps`."""
    n = size
    if mode == "independent":
        return []
    if mode == "batch_parallel":
        lb = max(batch // world, 1)
        return [("all_reduce", world, (lb, n, n))]
    if mode == "data_parallel":
        return [("all_reduce", world, (1, n, n))]
    if mode == "matrix_parallel":
        if world == 1:
            return []  # the mode falls back to independent
        return [("all_gather", world, (n, n // world))]
    if mode == "model_parallel":
        return [("all_reduce", world, (n, n))]
    if mode == "hybrid":
        if not dp or world % dp:
            raise ValueError(f"hybrid mode needs dp dividing world={world}")
        tp = world // dp
        lb = max(batch // dp, 1)
        return [("all_gather", tp, (lb, n, n // tp)),
                ("all_reduce", dp, (n, n))]
    if mode == "summa":
        r = rows or max(d for d in range(1, int(math.isqrt(world)) + 1)
                        if world % d == 0)
        c = world // r
        s = math.lcm(r, c)
        return [("all_reduce", c, (n // r, n // s)),   # A panel over 'j'
                ("all_reduce", r, (n // s, n // c))]   # B panel over 'i'
    raise ValueError(f"no comms model for mode {mode!r}")


def mode_steps(mode: str, world: int, rows: int | None = None) -> int:
    """Collective-making steps of one program run (1, except summa's
    k-panel scan)."""
    if mode != "summa":
        return 1
    r = rows or max(d for d in range(1, int(math.isqrt(world)) + 1)
                    if world % d == 0)
    return math.lcm(r, world // r)


def expected_collectives(mode: str, world: int, size: int, dtype: Any,
                         batch: int = 4, dp: int | None = None,
                         rows: int | None = None) -> list[ExpectedCollective]:
    """The collective inventory of one mode's full program with exact
    collectives."""
    item = matmul_out_itemsize(dtype)
    return [
        ExpectedCollective(kind, int(np.prod(shape)) * item)
        for kind, _, shape in mode_collective_shapes(
            mode, world, size, batch=batch, dp=dp, rows=rows)
    ]


_SCALE_ITEMSIZE = 4  # scales are always fp32
_WIRE_ITEMSIZE = 1   # int8 and float8_e4m3fn payloads are both 1 byte


def _one_wire_entries(kind: str, axis: int, shape: tuple[int, ...], fmt,
                      where: str = "") -> list[tuple[str, int, int, str]]:
    """One quantized collective's wire inventory as ``(kind, axis_size,
    payload_bytes, role)`` entries, role ∈ {payload, scale}, as
    `wire_psum`, `wire_reduce_scatter` and `wire_all_gather` move them: an
    all_reduce is the (D−1)-hop ring and a final all_gather, each hop a
    payload chunk and its scales; a reduce_scatter the ring alone; an
    all_gather the whole shard and its scales. An axis of size 1 moves
    nothing."""
    if axis == 1:
        return []
    n_rows = int(np.prod(shape[:-1]))
    cols = int(shape[-1])
    nb = fmt.scale_blocks(cols)
    out: list[tuple[str, int, int, str]] = []
    if kind in ("all_reduce", "reduce_scatter"):
        if n_rows % axis:
            raise ValueError(
                f"{where}: flattened rows {n_rows} must divide the "
                f"{axis}-device axis for the quantized ring")
        chunk = n_rows // axis
        for _ in range(axis - 1):  # the ring, a hop at a time
            out.append(("ppermute", axis, chunk * cols * _WIRE_ITEMSIZE, "payload"))
            out.append(("ppermute", axis, chunk * nb * _SCALE_ITEMSIZE, "scale"))
        if kind == "all_reduce":
            out.append(("all_gather", axis, chunk * cols * _WIRE_ITEMSIZE, "payload"))
            out.append(("all_gather", axis, chunk * nb * _SCALE_ITEMSIZE, "scale"))
    elif kind == "all_gather":
        out.append(("all_gather", axis, n_rows * cols * _WIRE_ITEMSIZE, "payload"))
        out.append(("all_gather", axis, n_rows * nb * _SCALE_ITEMSIZE, "scale"))
    else:
        raise ValueError(f"no wire model for collective kind {kind!r}")
    return out


def _wire_entries(mode: str, world: int, size: int, dtype: Any, comm_quant,
                  batch: int = 4, dp: int | None = None,
                  rows: int | None = None) -> list[tuple[str, int, int, str]]:
    """The quantized full program's collectives as ``(kind, axis_size,
    payload_bytes, role)``; integer operands keep the exact collective."""
    from tpu_matmul_bench_torch.parallel.collectives import parse_wire_format

    fmt = parse_wire_format(comm_quant)
    base = mode_collective_shapes(mode, world, size, batch=batch, dp=dp, rows=rows)
    if fmt is None or _dtype_info(dtype)[1]:
        item = matmul_out_itemsize(dtype)
        return [(kind, axis, int(np.prod(shape)) * item, "payload")
                for kind, axis, shape in base]
    out: list[tuple[str, int, int, str]] = []
    for kind, axis, shape in base:
        out.extend(_one_wire_entries(kind, axis, shape, fmt, where=mode))
    return out


def wire_collectives(mode: str, world: int, size: int, dtype: Any, comm_quant,
                     batch: int = 4, dp: int | None = None,
                     rows: int | None = None) -> list[ExpectedCollective]:
    """The collective inventory of the full program under `--comm-quant`
    (the quantized analogue of `expected_collectives`)."""
    return [ExpectedCollective(kind, payload)
            for kind, _, payload, _ in _wire_entries(
                mode, world, size, dtype, comm_quant, batch=batch, dp=dp,
                rows=rows)]


def wire_bytes_summary(mode: str, world: int, size: int, dtype: Any, comm_quant,
                       batch: int = 4, dp: int | None = None,
                       rows: int | None = None) -> dict:
    """Static wire-byte prices of one (mode, world, size, format) cell.

    Every total is ring-wire bytes a program run (payload bytes ×
    RING_WIRE_FACTOR[kind], × the scan steps for summa).
    `payload_reduction_x` is baseline ÷ quantized payload (2.0 for bf16 on
    any 1-byte wire, 4.0 for fp32); `wire_reduction_x` also charges the
    fp32 scales (2/(1 + 4/B) for bf16 at block size B).
    """
    from tpu_matmul_bench_torch.parallel.collectives import parse_wire_format

    fmt = parse_wire_format(comm_quant)
    steps = mode_steps(mode, world, rows=rows)
    item = matmul_out_itemsize(dtype)
    baseline = steps * sum(
        int(np.prod(shape)) * item * RING_WIRE_FACTOR[kind](axis)
        for kind, axis, shape in mode_collective_shapes(
            mode, world, size, batch=batch, dp=dp, rows=rows))
    totals = {"payload": 0.0, "scale": 0.0}
    for kind, axis, payload, role in _wire_entries(
            mode, world, size, dtype, comm_quant, batch=batch, dp=dp,
            rows=rows):
        totals[role] += steps * payload * RING_WIRE_FACTOR[kind](axis)
    payload_b, scale_b = totals["payload"], totals["scale"]
    out = {
        "wire_format": comm_quant,
        "block": fmt.block if fmt else None,
        "baseline_bytes": int(round(baseline)),
        "wire_payload_bytes": int(round(payload_b)),
        "wire_scale_bytes": int(round(scale_b)),
        "wire_bytes": int(round(payload_b + scale_b)),
    }
    if payload_b:
        out["payload_reduction_x"] = round(baseline / payload_b, 4)
        out["wire_reduction_x"] = round(baseline / (payload_b + scale_b), 4)
    return out


# ---------------------------------------------------------------------------
# Hierarchical (DCN×ICI) pricing (JAX `:285-518`): a factorized mesh's axis
# names are its link classes, so the axis a collective runs over is the wire
# it travels on. Relative wire-seconds per byte by link class: ICI is the
# unit and DCN a round planning factor of 8, not a measured constant; a
# two-axis program is priced slowest-link-dominates.
# ---------------------------------------------------------------------------

LINK_WIRE_SECONDS = {"ici": 1.0, "dcn": 8.0}


def mode_axis_collectives(
        mode: str, mesh_spec: str, size: int, batch: int = 4,
) -> list[tuple[str, str, int, tuple[int, ...]]]:
    """The float collectives of one mode's full program on a factorized
    mesh as ``(kind, axis_name, axis_size, per_rank_operand_shape)``.

    On a one-axis factorization the flat model applies with the axis's
    name attached. On a two-axis ``dcn:R,ici:C`` mesh hybrid puts data
    parallelism on the outer (dcn) axis and tensor parallelism on the
    inner (ici); SUMMA puts grid rows on dcn and columns on ici, so its
    A-panel broadcast (over the columns) rides ici and its B-panel
    broadcast (over the rows) dcn.
    """
    from tpu_matmul_bench_torch.parallel.mesh import parse_mesh_spec

    axes = parse_mesh_spec(mesh_spec)
    n = size
    if len(axes) == 1:
        name, d = axes[0]
        return [(kind, name, axis, shape)
                for kind, axis, shape in mode_collective_shapes(
                    mode, d, size, batch=batch)]
    (dp_ax, d0), (tp_ax, d1) = axes
    if mode == "hybrid":
        lb = max(batch // d0, 1)
        return [("all_gather", tp_ax, d1, (lb, n, n // d1)),
                ("all_reduce", dp_ax, d0, (n, n))]
    if mode == "summa":
        r, c = d0, d1
        s = math.lcm(r, c)
        return [("all_reduce", tp_ax, c, (n // r, n // s)),  # A panel over 'j'
                ("all_reduce", dp_ax, r, (n // s, n // c))]  # B panel over 'i'
    raise ValueError(
        f"no two-level comms model for mode {mode!r} (hybrid and summa map "
        "onto a dcn×ici factorization; the 1-D modes take a one-axis mesh)")


def hier_mode_steps(mode: str, mesh_spec: str) -> int:
    """`mode_steps` on a factorized mesh: summa's step count is the lcm of
    the grid sides, which on a two-axis mesh are the axis sizes."""
    from tpu_matmul_bench_torch.parallel.mesh import parse_mesh_spec

    axes = parse_mesh_spec(mesh_spec)
    if mode != "summa":
        return 1
    if len(axes) == 1:
        return mode_steps(mode, axes[0][1])
    return math.lcm(axes[0][1], axes[1][1])


def hier_expected_collectives(
        mode: str, mesh_spec: str, size: int, dtype: Any, comm_quant=None,
        batch: int = 4) -> list[tuple[str, str, int]]:
    """The per-axis collective inventory of the full program's one step on
    a factorized mesh as ``(kind, axis_name, payload_bytes)``. `comm_quant`
    may be uniform or per-link; each axis's collectives go on the wire of
    the format its link class resolves to (`link_format_spec`, the door the
    modes route through)."""
    from tpu_matmul_bench_torch.parallel.collectives import (
        link_format_spec,
        parse_wire_format,
    )

    item = matmul_out_itemsize(dtype)
    integer = _dtype_info(dtype)[1]
    out: list[tuple[str, str, int]] = []
    for kind, name, axis, shape in mode_axis_collectives(
            mode, mesh_spec, size, batch=batch):
        fmt = None if integer else parse_wire_format(
            link_format_spec(comm_quant, name))
        if fmt is None:
            # an exact collective runs even over a size-1 axis; only the
            # wire tier returns its input there
            out.append((kind, name, int(np.prod(shape)) * item))
        else:
            for k, _, payload, _ in _one_wire_entries(
                    kind, axis, shape, fmt, where=f"{mode}/{name}"):
                out.append((k, name, payload))
    return out


def _price_links(per_link: dict[str, dict]) -> tuple[str | None, float]:
    """Round each link's byte sums, add its reductions and relative
    wire-seconds (`LINK_WIRE_SECONDS`), in place; returns the slowest link
    and its wire-seconds (slowest-link-dominates)."""
    bottleneck, bottleneck_secs = None, -1.0
    for link, bucket in per_link.items():
        payload_b = bucket["wire_payload_bytes"]
        scale_b = bucket["wire_scale_bytes"]
        baseline = bucket["baseline_bytes"]
        for key in ("baseline_bytes", "wire_payload_bytes", "wire_scale_bytes"):
            bucket[key] = int(round(bucket[key]))
        bucket["wire_bytes"] = int(round(payload_b + scale_b))
        if payload_b:
            bucket["payload_reduction_x"] = round(baseline / payload_b, 4)
            bucket["wire_reduction_x"] = round(baseline / (payload_b + scale_b), 4)
        secs = (payload_b + scale_b) * LINK_WIRE_SECONDS[link]
        bucket["wire_seconds_rel"] = round(secs, 1)
        if secs > bottleneck_secs:
            bottleneck, bottleneck_secs = link, secs
    return bottleneck, bottleneck_secs


def hier_wire_bytes_summary(mode: str, mesh_spec: str, size: int, dtype: Any,
                            comm_quant, batch: int = 4) -> dict:
    """Static per-link-class wire-byte prices of one (mode, mesh, size,
    format) cell: `wire_bytes_summary` split by link class, plus the
    slowest-link-dominates attribution. Each link present gets its own
    {baseline, payload, scale, total, reduction} block; `bottleneck_link`
    is the link with the largest bytes × `LINK_WIRE_SECONDS` product and
    `comm_seconds_rel` that product, a ranking, not a latency."""
    from tpu_matmul_bench_torch.parallel.collectives import (
        link_format_spec,
        parse_wire_format,
    )
    from tpu_matmul_bench_torch.parallel.mesh import axis_link_class, canonical_mesh_spec

    steps = hier_mode_steps(mode, mesh_spec)
    item = matmul_out_itemsize(dtype)
    integer = _dtype_info(dtype)[1]
    per_link: dict[str, dict] = {}

    def link_bucket(link: str, fmt_spec) -> dict:
        return per_link.setdefault(link, {
            "wire_format": fmt_spec, "baseline_bytes": 0.0,
            "wire_payload_bytes": 0.0, "wire_scale_bytes": 0.0,
        })

    for kind, name, axis, shape in mode_axis_collectives(
            mode, mesh_spec, size, batch=batch):
        link = axis_link_class(name)
        sub = link_format_spec(comm_quant, name)
        fmt = None if integer else parse_wire_format(sub)
        bucket = link_bucket(link, sub if not integer else None)
        base = int(np.prod(shape)) * item * RING_WIRE_FACTOR[kind](axis)
        bucket["baseline_bytes"] += steps * base
        if fmt is None:
            bucket["wire_payload_bytes"] += steps * base
        else:
            for k, _, payload, role in _one_wire_entries(
                    kind, axis, shape, fmt, where=f"{mode}/{name}"):
                key = ("wire_payload_bytes" if role == "payload"
                       else "wire_scale_bytes")
                bucket[key] += steps * payload * RING_WIRE_FACTOR[k](axis)

    bottleneck, bottleneck_secs = _price_links(per_link)
    return {
        "wire_format": comm_quant,
        "mesh": canonical_mesh_spec(mesh_spec),
        "per_link": per_link,
        "baseline_bytes": sum(b["baseline_bytes"] for b in per_link.values()),
        "wire_bytes": sum(b["wire_bytes"] for b in per_link.values()),
        "bottleneck_link": bottleneck,
        "comm_seconds_rel": round(bottleneck_secs, 1),
    }


# ---------------------------------------------------------------------------
# The train step's gradient collectives (JAX `:522-685`): one optimizer
# step's closed-form inventory, by mode × mesh × --zero. The step's forward
# and backward are collective-free (`train/step.py` differentiates the LOCAL
# forward), so the full step's collectives are the gradient sync and, under
# ZeRO, the all_gather of the updated shards:
#
# - zero=0 (replicated update): one all_reduce of dW [n, n/C] over the data
#   axis;
# - zero=1 (ZeRO): one reduce_scatter of dW [n, n/C] over the data axis,
#   the update of the owned [n/R, n/C] rows, then one all_gather of them.
#
# `--grad-quant` puts only the gradient collectives (role "grad") on the
# wire; the weight all_gather (role "weight") carries updated parameters
# and stays exact.
# ---------------------------------------------------------------------------

TRAIN_MODES = ("dp", "hybrid")


def train_axis_collectives(
        mode: str, mesh_spec: str | None, world: int, size: int,
        batch: int = 8, zero: bool = False,
) -> list[tuple[str, str, int, tuple[int, ...], str]]:
    """The float collectives of one train step's full program as ``(kind,
    axis_name, axis_size, per_rank_operand_shape, role)``, role ∈ {"grad",
    "weight"}: the train counterpart of `mode_axis_collectives`.
    ``mesh_spec=None`` is the flat 'x' mesh over `world` ranks."""
    from tpu_matmul_bench_torch.parallel.mesh import parse_mesh_spec

    n = size
    if mesh_spec is None:
        axes: tuple[tuple[str, int], ...] = (("x", world),)
    else:
        axes = parse_mesh_spec(mesh_spec)
    if mode == "dp":
        if len(axes) != 1:
            raise ValueError(
                f"train mode 'dp' takes a one-axis mesh, got {mesh_spec!r}")
        (dp_ax, r), wcols = axes[0], n
    elif mode == "hybrid":
        if len(axes) != 2:
            raise ValueError(
                f"train mode 'hybrid' needs a two-axis mesh (--mesh "
                f"dcn:R,ici:C), got {mesh_spec!r}")
        (dp_ax, r), (_, c) = axes
        if n % c:
            raise ValueError(f"size {n} must divide the {c}-wide tensor axis")
        wcols = n // c
    else:
        raise ValueError(
            f"no train comms model for mode {mode!r} (expected one of "
            f"{TRAIN_MODES})")
    if n % r:
        raise ValueError(f"size {n} must divide the {r}-wide data axis "
                         "(ZeRO shards weight rows over it)")
    if not zero:
        return [("all_reduce", dp_ax, r, (n, wcols), "grad")]
    return [("reduce_scatter", dp_ax, r, (n, wcols), "grad"),
            ("all_gather", dp_ax, r, (n // r, wcols), "weight")]


def train_expected_collectives(
        mode: str, mesh_spec: str | None, world: int, size: int, dtype: Any,
        grad_quant=None, batch: int = 8, zero: bool = False,
) -> list[tuple[str, str, int]]:
    """The per-axis collective inventory of the full train step as ``(kind,
    axis_name, payload_bytes)``. Only role "grad" entries go on the wire
    under `grad_quant`, resolved per link class through `link_format_spec`,
    the door the step routes through."""
    from tpu_matmul_bench_torch.parallel.collectives import (
        link_format_spec,
        parse_wire_format,
    )

    item, integer = _dtype_info(dtype)
    out: list[tuple[str, str, int]] = []
    for kind, name, axis, shape, role in train_axis_collectives(
            mode, mesh_spec, world, size, batch=batch, zero=zero):
        fmt = None
        if role == "grad" and not integer:
            fmt = parse_wire_format(link_format_spec(grad_quant, name))
        if fmt is None:
            # an exact collective runs even over a size-1 axis; only the
            # wire tier returns its input there
            out.append((kind, name, int(np.prod(shape)) * item))
        else:
            for k, _, payload, _ in _one_wire_entries(
                    kind, axis, shape, fmt, where=f"train/{mode}/{name}"):
                out.append((k, name, payload))
    return out


def train_wire_bytes_summary(
        mode: str, mesh_spec: str | None, world: int, size: int, dtype: Any,
        grad_quant, batch: int = 8, zero: bool = False) -> dict:
    """Static per-link-class wire-byte prices of one train-step cell:
    `hier_wire_bytes_summary` over the gradient-collective model, the exact
    weight all_gather priced at its full payload on its link."""
    from tpu_matmul_bench_torch.parallel.collectives import (
        link_format_spec,
        parse_wire_format,
    )
    from tpu_matmul_bench_torch.parallel.mesh import axis_link_class, canonical_mesh_spec

    item, integer = _dtype_info(dtype)
    per_link: dict[str, dict] = {}

    def link_bucket(link: str, fmt_spec) -> dict:
        return per_link.setdefault(link, {
            "wire_format": fmt_spec, "baseline_bytes": 0.0,
            "wire_payload_bytes": 0.0, "wire_scale_bytes": 0.0,
        })

    for kind, name, axis, shape, role in train_axis_collectives(
            mode, mesh_spec, world, size, batch=batch, zero=zero):
        link = axis_link_class(name)
        sub = link_format_spec(grad_quant, name) if role == "grad" else None
        fmt = None if integer else parse_wire_format(sub)
        bucket = link_bucket(link, sub if not integer else None)
        base = int(np.prod(shape)) * item * RING_WIRE_FACTOR[kind](axis)
        bucket["baseline_bytes"] += base
        if fmt is None:
            bucket["wire_payload_bytes"] += base
        else:
            for k, _, payload, rl in _one_wire_entries(
                    kind, axis, shape, fmt, where=f"train/{mode}/{name}"):
                key = "wire_payload_bytes" if rl == "payload" else "wire_scale_bytes"
                bucket[key] += payload * RING_WIRE_FACTOR[k](axis)

    bottleneck, bottleneck_secs = _price_links(per_link)
    return {
        "wire_format": grad_quant,
        "mesh": canonical_mesh_spec(mesh_spec) if mesh_spec else None,
        "zero": int(zero),
        "per_link": per_link,
        "baseline_bytes": sum(b["baseline_bytes"] for b in per_link.values()),
        "wire_bytes": sum(b["wire_bytes"] for b in per_link.values()),
        "bottleneck_link": bottleneck,
        "comm_seconds_rel": round(bottleneck_secs, 1),
    }
