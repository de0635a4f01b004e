"""The legacy per-row int8 wire tier: the A/B control behind the block wire
formats of `parallel/collectives.py`.

Port of `tpu_matmul_bench/parallel/quantized.py` over the world of ranks
(`parallel/mesh.py`). The flag values ``int8`` and ``int8-tensor`` select
it. Structure of its all_reduce (`quantized_psum`):

1. **Reduce-scatter phase** (D−1 hops, `collectives.quantized_ring`): the
   accumulator of row chunk c starts on rank c+1 and hops right, adding
   each rank's chunk as it passes; every hop re-quantizes the partial sum
   to int8 + one fp32 scale per row before it moves.
2. **All-gather phase**: each rank owns one fully reduced chunk, quantizes
   it once, and the int8 chunks and their scales are gathered.

Quantization is symmetric per row (scale = max|row| / 127), accumulation is
fp32, and the result is downcast to the operand dtype at every collective
(unlike the fused block formats). Integer operands take the exact
collective; one rank is inert. Across processes the tier runs the wire's
ring and gather as they are, one crossing a hop and one for the gather.
"""

from __future__ import annotations

import torch

from tpu_matmul_bench_torch.parallel.collectives import (
    Shards,
    WireFormat,
    _wire_quantize,
    wire_all_gather,
    wire_psum,
)
from tpu_matmul_bench_torch.parallel.mesh import Mesh
from tpu_matmul_bench_torch.utils.metrics import is_integer_dtype

# the tier's format: per-row int8 (one scale a row), which is the block
# wire's math at one block a row, so the tier runs the wire's ring and
# gather and counts its calls under "int8"
_LEGACY = WireFormat(spec="int8", qtype="int8", block=None, legacy=True)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of a [rows, cols] tensor: (q[int8],
    scale[fp32, rows × 1]); `collectives._wire_dequantize` inverts it."""
    return _wire_quantize(x, _LEGACY)


def quantized_psum(mesh: Mesh, shards: Shards) -> list[torch.Tensor]:
    """all_reduce(SUM) of the shards with int8 wire traffic (JAX `:58`).
    Each shard is a rank's full tensor, its flattened leading dim divisible
    by the world; the output keeps the input dtype. Integer shards take the
    exact `psum_over`."""
    return wire_psum(mesh, shards, _LEGACY)


def quantized_all_gather(mesh: Mesh, shards: Shards, axis: int = 0) -> list[torch.Tensor]:
    """all_gather with int8 wire traffic (JAX `:103`): each rank quantizes
    its shard once (per-row int8) and the payloads and scales are gathered,
    one rounding's error; along axis 1 each rank's scale column applies to
    its own block of gathered columns. An N-D shard gathers along its last
    axis. Integer shards gather exactly; the output keeps the input
    dtype."""
    return wire_all_gather(mesh, shards, _LEGACY, axis=axis)


def uses_quantized_comm(config) -> bool:
    """Whether a BenchConfig selects a quantized-wire collective (the one
    normalization of --comm-quant's None/"none" defaults)."""
    return bool(config.comm_quant and config.comm_quant != "none")


def comm_quant_extra(config, world: int, *, dp: int | None = None,
                     tp: int | None = None) -> str:
    """The `comm_quant` format label of a record (JAX `:200`): where the
    quantized collectives are exact no-ops the label says so, or a
    "quantized" record would read as a quantized-wire measurement. Inert:
    integer operands at any world (the collectives take the exact integer
    path), world 1, and on a hybrid mesh (dp, tp) the axis of size 1."""
    q = config.comm_quant
    if is_integer_dtype(config.dtype):
        return f"{q} (inert: integer operands take the exact collective)"
    if world <= 1:
        return f"{q} (inert at world=1)"
    if dp is not None and tp is not None:
        if dp == 1:
            return f"{q} (psum inert at dp=1)"
        if tp == 1:
            return f"{q} (gather inert at tp=1)"
    return q
