"""Analytic comms model: the collectives each parallel mode must make, and
their bytes on a quantized wire.

Port of the flat-world half of `tpu_matmul_bench/analysis/comms_model.py`
(`:55-297`). It is derived from the mode definitions, not from a trace.
Payload bytes are each rank's operand bytes of the collective for a square
[size, size] problem in `dtype`:

- independent: no collective.
- batch_parallel: one all_reduce of the rank's [lb, n, n] products.
- data_parallel: one all_reduce of [1, n, n].
- matrix_parallel: one all_gather of the rank's [n, n/d] output columns
  (none at d = 1, where the mode falls back to independent).
- model_parallel: one all_reduce of the full [n, n] partial product.
- hybrid and summa: their 2-D meshes' collectives (the modes themselves
  wait for ROADMAP A9).

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
