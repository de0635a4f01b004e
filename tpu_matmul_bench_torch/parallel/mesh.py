"""The world of ranks: the port's counterpart of a 1-D JAX device mesh.

Port of `tpu_matmul_bench/parallel/mesh.py:129-208` for the flat 'x' axis.
The JAX package runs a sharded program under `shard_map` over a `Mesh` of
devices, and its tests force 8 virtual CPU devices
(`XLA_FLAGS=--xla_force_host_platform_device_count=8`). The port keeps the
ranks in one process instead: a rank is a (rank index, device) pair, and a
sharded operand is a list of D per-rank tensors with its spec: `ROWS`
(P("x", None); on a 3-D stacked operand, P("x"): dim 0 cut), `COLS`
(P(None, "x")) or `REPLICATED` (P(): every rank holds the whole array).

Placement: `TMB_RANKS_PER_CARD=R` (default 1), read only here, lets R ranks
share each card (or the CPU), the counterpart of the forced host device
count; rank r goes to card r // R. On one H100 with R = 4 the four ranks
share the card: their ring copies go from device memory to device memory,
not over NVLink.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Sequence

import torch

AXIS = "x"
ROWS = (AXIS, None)  # P("x", None): dim 0 cut into D blocks
COLS = (None, AXIS)  # P(None, "x"): dim 1 cut into D blocks
REPLICATED = ()  # P(): every rank holds the whole array
RANKS_PER_CARD_ENV = "TMB_RANKS_PER_CARD"


def ranks_per_card() -> int:
    """`TMB_RANKS_PER_CARD`, the ranks each card (or the CPU) may hold."""
    raw = os.environ.get(RANKS_PER_CARD_ENV, "1")
    try:
        value = int(raw)
    except ValueError:
        value = 0
    if value < 1:
        raise ValueError(f"{RANKS_PER_CARD_ENV}={raw!r}: expected a positive integer")
    return value


@dataclasses.dataclass(frozen=True)
class Rank:
    index: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """D ranks on the 1-D axis 'x'."""

    ranks: tuple[Rank, ...]
    axis: str = AXIS

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.ranks)}

    @property
    def devices(self) -> list[torch.device]:
        """Each rank's device, in rank order."""
        return [r.device for r in self.ranks]

    @property
    def cards(self) -> list[torch.device]:
        """The distinct devices the ranks occupy, in order of first use."""
        return list(dict.fromkeys(self.devices))

    @property
    def ranks_per_card(self) -> int:
        """The most ranks any one device holds."""
        devs = self.devices
        return max(devs.count(d) for d in self.cards)


class Sharded(list):
    """A sharded operand: D per-rank tensors in rank order, and its spec."""

    def __init__(self, shards: Sequence[torch.Tensor], spec: tuple):
        super().__init__(shards)
        self.spec = tuple(spec)

    @property
    def dim(self) -> int | None:
        """The dimension cut across the ranks; None when replicated."""
        return _cut_dim(self.spec)


def _cut_dim(spec: tuple) -> int | None:
    return spec.index(AXIS) if AXIS in spec else None


def make_mesh(devices: Sequence[torch.device]) -> Mesh:
    """A mesh with one rank per entry of `devices` (entries repeat where
    ranks share a card; `utils/device.py resolve_devices` makes the list)."""
    if not devices:
        raise ValueError("a mesh needs at least one rank")
    kinds = {torch.device(d).type for d in devices}
    if len(kinds) > 1:
        raise ValueError(f"ranks on both the CPU and the card: {sorted(kinds)}")
    return Mesh(tuple(Rank(i, torch.device(d)) for i, d in enumerate(devices)))


def place_ranks(cards: Sequence[torch.device],
                num_ranks: int | None) -> list[torch.device]:
    """The device of each rank: rank r on cards[r // R], R =
    `ranks_per_card()`. `num_ranks` None takes every place there is; more
    than there are raises a ValueError that names the count available."""
    per_card = ranks_per_card()
    available = len(cards) * per_card
    d = available if num_ranks is None else num_ranks
    if d < 1 or d > available:
        raise ValueError(
            f"--num-devices {d}: {available} available ({len(cards)} "
            f"device(s) x {per_card} rank(s) each; set {RANKS_PER_CARD_ENV} "
            "to place more ranks on each device)")
    return [cards[r // per_card] for r in range(d)]


def world_size(mesh: Mesh, axis: str = AXIS) -> int:
    return mesh.shape[axis]


def _blocks(n: int, d: int, what: str) -> int:
    if n % d:
        raise ValueError(f"{what} {n} does not split into {d} equal shards")
    return n // d


def shard_from_numpy(global_array: Any, spec: tuple, mesh: Mesh) -> Sharded:
    """The shards JAX's `NamedSharding(mesh, P(*spec))` would give each
    device, as tensors on each rank's device with the array's bits (ml_dtypes
    bfloat16 included)."""
    from tpu_matmul_bench_torch.ops.matmul import operands_from_numpy

    (t,) = operands_from_numpy(global_array, device="cpu")
    return shard_tensor(t, spec, mesh)


def shard_tensor(global_tensor: torch.Tensor, spec: tuple, mesh: Mesh) -> Sharded:
    """`global_tensor` cut by `spec`: one contiguous copy per rank, on the
    rank's device (the whole tensor for each rank when replicated)."""
    d = world_size(mesh)
    dim = _cut_dim(spec)
    if dim is None:
        return Sharded([global_tensor.to(r.device, copy=True).contiguous()
                        for r in mesh.ranks], spec)
    size = _blocks(global_tensor.shape[dim], d,
                   f"dimension {dim} of {tuple(global_tensor.shape)}")
    return Sharded([global_tensor.narrow(dim, r.index * size, size)
                    .to(r.device, copy=True).contiguous() for r in mesh.ranks],
                   spec)


def gather(sharded: Sharded, device: torch.device | str | None = None) -> torch.Tensor:
    """The global tensor, put back together on `device` (default: the
    first rank's); a replicated operand's first copy."""
    device = sharded[0].device if device is None else device
    if sharded.dim is None:
        return sharded[0].to(device)
    return torch.cat([s.to(device) for s in sharded], dim=sharded.dim)


def global_block(sharded: Sharded, rows: int, cols: int) -> torch.Tensor:
    """global[:rows, :cols] on the first rank's device, read from the shards
    that hold it, without putting the rest together."""
    device = sharded[0].device
    dim = sharded.dim
    if dim is None:
        return sharded[0][:rows, :cols]
    want = (rows, cols)[dim]
    parts, offset = [], 0
    for s in sharded:
        if offset >= want:
            break
        take = min(s.shape[dim], want - offset)
        part = s[:rows, :take] if dim == 1 else s[:take, :cols]
        parts.append(part.to(device))
        offset += take
    return torch.cat(parts, dim=dim)


def stacked_item(sharded: Sharded, index: int) -> torch.Tensor:
    """global[index] of a stacked operand cut along dim 0 (`ROWS` on a 3-D
    tensor): a view of the one shard that holds it, on its rank's device."""
    if sharded.dim != 0:
        raise ValueError(f"a stacked item needs dim 0 cut, got spec {sharded.spec}")
    per = sharded[0].shape[0]
    return sharded[index // per][index % per]


def sharded_normal(seed: int, shape: tuple[int, ...], dtype: torch.dtype,
                   mesh: Mesh, spec: tuple, *, count: int = 2) -> tuple[Sharded, ...]:
    """`count` random global arrays from the port's own generator
    (`ops/matmul.py random_operands`: standard normal, small uniform ints
    for int8), each made on the first rank's device and cut by `spec`. The
    JAX package's bits are not reproduced, as `random_operands` does not
    reproduce them either."""
    from tpu_matmul_bench_torch.ops.matmul import random_operands

    return tuple(shard_tensor(g, spec, mesh) for g in random_operands(
        seed, tuple(shape), dtype, device=mesh.devices[0], count=count))


def ring_perm(n: int) -> list[tuple[int, int]]:
    """Unidirectional ring permutation (rank d sends to d+1 mod n)."""
    return [(i, (i + 1) % n) for i in range(n)]


def ring_perm_rev(n: int) -> list[tuple[int, int]]:
    """Reverse-direction ring permutation (rank d sends to d−1 mod n): the
    counter-rotating half of a bidirectional ring."""
    return [(i, (i - 1) % n) for i in range(n)]


def mesh_device_kind(mesh: Mesh) -> str:
    """The ranks' device kind: the card's name, or 'cpu'."""
    first = mesh.devices[0]
    return torch.cuda.get_device_name(first) if first.type == "cuda" else "cpu"
