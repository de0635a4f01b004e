"""The world of ranks: the port's counterpart of a JAX device mesh.

Port of `tpu_matmul_bench/parallel/mesh.py`. The JAX package runs a sharded
program under `shard_map` over a `Mesh` of devices, and its tests force 8
virtual CPU devices (`XLA_FLAGS=--xla_force_host_platform_device_count=8`).
The port keeps the ranks in one process instead: a rank is a (rank index,
device) pair, and a mesh lays the ranks out row-major over its named axes,
as `np.reshape` lays out JAX's devices: the flat world 'x', the hybrid
mode's ('dp', 'tp'), SUMMA's ('i', 'j'), or a factorized `--mesh
dcn:R,ici:C` ('dcn', 'ici'). A collective over one axis runs over each
`axis_groups` group, the ranks that share every other coordinate, as a
1-D sub-mesh (`sub_mesh`) whose `.axis` is that axis's name.

A sharded operand is a list of per-rank tensors in rank order with its
spec, JAX's `PartitionSpec` as a tuple: each entry None (the dimension is
whole), an axis name (cut into that axis's size) or a tuple of names (cut
into their product, the first name slowest). `ROWS` (P("x", None); on a
3-D stacked operand, dim 0 cut), `COLS` (P(None, "x")) and `REPLICATED`
(P()) are the flat world's. Entries past the spec's end are None.

Placement: `TMB_RANKS_PER_CARD=R` (default 1), read only here, lets R ranks
share each card (or the CPU), the counterpart of the forced host device
count; rank r goes to card r // R. On one H100 with R = 4 the four ranks
share the card: their ring copies go from device memory to device memory,
not over NVLink, and the link classes 'dcn' and 'ici' of a factorized mesh
are labels there.

Processes: in a process group (`parallel/group.py`) a world mesh holds
every rank of the world, each with its process and its card's identity
(host and UUID, exchanged once at the rendezvous), and a rank of another
process lies on the meta device: its shard is a placeholder of the right
shape and dtype, so the per-rank code runs unchanged and computes nothing
for it. `cards` are the local devices; `card_count` and `ranks_per_card`
count physical cards across the world. Operands are made whole on every
process with the one-process world's bits and cut to the local shards
(`shard_tensor`); `gather`, `global_block` and `stacked_item` fetch what
other processes hold through the group (≙ JAX `process_allgather`).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Sequence

import numpy as np
import torch

from tpu_matmul_bench_torch.parallel import group

AXIS = "x"
# mesh-axis link classes, slowest first (JAX `parallel/mesh.py:44`): 'dcn'
# the network between hosts, 'ici' the interconnect within a slice. A
# factorized mesh's axis names are its link classes; every other axis name
# (the flat 'x', hybrid's 'dp'/'tp', SUMMA's 'i'/'j') is on 'ici'
LINK_CLASSES = ("dcn", "ici")
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
    device: torch.device  # meta: the rank of another process
    process: int = 0
    card: str | None = None  # physical identity across processes; None: the device

    @property
    def local(self) -> bool:
        return self.device.type != "meta"

    @property
    def card_key(self) -> str:
        return self.card if self.card is not None else str(self.device)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks laid out row-major over named axes (default: the 1-D 'x')."""

    ranks: tuple[Rank, ...]
    axis_names: tuple[str, ...] = (AXIS,)
    dims: tuple[int, ...] = ()  # each axis's size; () is the 1-D (len(ranks),)

    def __post_init__(self) -> None:
        dims = tuple(self.dims) or (len(self.ranks),)
        object.__setattr__(self, "dims", dims)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(dims) != len(self.axis_names) or math.prod(dims) != len(self.ranks):
            raise ValueError(f"mesh shape {dims} over axes {self.axis_names} does "
                             f"not cover {len(self.ranks)} ranks")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axis names repeat: {self.axis_names}")

    @property
    def axis(self) -> str:
        """The one axis of a 1-D mesh: the axis a collective runs over."""
        if len(self.axis_names) != 1:
            raise ValueError(f"a mesh over {self.axis_names} has no single axis; "
                             "take one axis's sub-mesh (sub_mesh)")
        return self.axis_names[0]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def devices(self) -> list[torch.device]:
        """Each rank's device, in rank order."""
        return [r.device for r in self.ranks]

    @property
    def cards(self) -> list[torch.device]:
        """The distinct devices this process's ranks occupy, in order of
        first use (the other processes' ranks have none here)."""
        return list(dict.fromkeys(r.device for r in self.ranks if r.local))

    @property
    def card_count(self) -> int:
        """The physical cards the ranks occupy across every process."""
        return len({r.card_key for r in self.ranks})

    @property
    def ranks_per_card(self) -> int:
        """The most ranks any one physical card holds."""
        keys = [r.card_key for r in self.ranks]
        return max(keys.count(k) for k in set(keys))

    @property
    def processes(self) -> list[int]:
        """The processes that hold the ranks, in order."""
        return sorted({r.process for r in self.ranks})

    @property
    def spans_processes(self) -> bool:
        return len(self.processes) > 1

    @property
    def shared_card(self) -> bool:
        """Every rank on one card and in one process: the rings store into
        and forward to each other's memory only then."""
        return not self.spans_processes and self.card_count == 1

    @property
    def first_local(self) -> torch.device:
        """The device of this process's first rank (of the mesh's first
        rank where it holds none)."""
        return next((r.device for r in self.ranks if r.local), self.ranks[0].device)

    def coords(self, index: int) -> dict[str, int]:
        """Rank `index`'s coordinate on each axis (row-major placement)."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(index, self.dims))))

    def axis_groups(self, axis: str) -> list[tuple[int, ...]]:
        """The rank indices of each group along `axis`: the ranks that share
        every other coordinate, in order of their `axis` coordinate; groups
        in row-major order of the other coordinates."""
        k = self.axis_names.index(axis)
        grid = np.arange(self.size).reshape(self.dims)
        lines = np.moveaxis(grid, k, -1).reshape(-1, self.dims[k])
        return [tuple(int(i) for i in line) for line in lines]

    def sub_mesh(self, axis: str, index: int) -> Mesh:
        """The 1-D mesh along `axis` of the group that holds rank `index`,
        its ranks renumbered from 0 in `axis` order."""
        group = next(g for g in self.axis_groups(axis) if index in g)
        return Mesh(tuple(dataclasses.replace(self.ranks[r], index=i)
                          for i, r in enumerate(group)), (axis,))


def _spec_axes(entry: Any) -> tuple[str, ...]:
    """The axis names one spec entry cuts its dimension by."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Sharded(list):
    """A sharded operand: per-rank tensors in rank order, its spec, and the
    mesh shape the spec's axes refer to (`grid`, axis name -> size; default
    the flat world of these shards)."""

    def __init__(self, shards: Sequence[torch.Tensor], spec: tuple,
                 grid: dict[str, int] | None = None):
        super().__init__(shards)
        self.spec = tuple(spec)
        self.grid = dict(grid) if grid is not None else {AXIS: len(self)}
        named = [a for e in self.spec for a in _spec_axes(e)]
        if len(set(named)) != len(named) or not set(named) <= set(self.grid):
            raise ValueError(f"spec {self.spec} does not fit the mesh {self.grid}")

    def like(self, shards: Sequence[torch.Tensor]) -> Sharded:
        """Other shards with this operand's spec and mesh shape."""
        return Sharded(shards, self.spec, self.grid)

    @property
    def cuts(self) -> list[tuple[int, int]]:
        """(dimension, blocks) of each cut dimension."""
        return [(dim, math.prod(self.grid[a] for a in _spec_axes(e)))
                for dim, e in enumerate(self.spec) if _spec_axes(e)]

    def blocks(self, index: int) -> tuple[int, ...]:
        """Rank `index`'s block along each cut dimension (`cuts` order)."""
        names, dims = list(self.grid), list(self.grid.values())
        coords = dict(zip(names, np.unravel_index(index, dims)))
        out = []
        for e in self.spec:
            axes = _spec_axes(e)
            if axes:
                out.append(int(np.ravel_multi_index([coords[a] for a in axes],
                                                     [self.grid[a] for a in axes])))
        return tuple(out)

    def holders(self) -> dict[tuple[int, ...], int]:
        """The first rank that holds each block, by its blocks tuple."""
        first: dict[tuple[int, ...], int] = {}
        for r in range(len(self)):
            first.setdefault(self.blocks(r), r)
        return first

    def origin_shards(self) -> list[torch.Tensor]:
        """Every copy of the block that holds the global [0, ..., 0]."""
        return [s for r, s in enumerate(self) if not any(self.blocks(r))]


def make_mesh(devices: Sequence[torch.device], axis_names: tuple[str, ...] = (AXIS,),
              shape: tuple[int, ...] | None = None) -> Mesh:
    """A mesh with one rank per entry of `devices` (entries repeat where
    ranks share a card; `utils/device.py resolve_devices` makes the list),
    laid out row-major over `axis_names` by `shape` (default: the 1-D world
    'x', JAX's `make_mesh`)."""
    if not devices:
        raise ValueError("a mesh needs at least one rank")
    devices = [torch.device(d) for d in devices]
    kinds = {d.type for d in devices} - {"meta"}
    if len(kinds) > 1:
        raise ValueError(f"ranks on both the CPU and the card: {sorted(kinds)}")
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (len(devices),)
    if math.prod(shape) != len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {len(devices)} devices")
    mesh = Mesh(_world_ranks(devices), tuple(axis_names), tuple(shape))
    if mesh.spans_processes:
        for axis in mesh.axis_names:
            for line in mesh.axis_groups(axis):
                group.ensure_group([mesh.ranks[r].process for r in line])
    return mesh


def _world_ranks(devices: list[torch.device]) -> tuple[Rank, ...]:
    """The ranks of `devices`. Without meta entries every rank is this
    process's. With them the list is a world of the process group
    (`utils/device.py resolve_devices`): process p holds the p-th of
    equal blocks of consecutive ranks, and only this process's block is
    real here."""
    me = group.process_index()
    if not any(d.type == "meta" for d in devices):
        cards = {d: group.card_id(d) for d in devices} if group.active() else {}
        return tuple(Rank(i, d, me, cards.get(d)) for i, d in enumerate(devices))
    nprocs = group.process_count()
    if len(devices) % nprocs:
        raise ValueError(f"{len(devices)} ranks do not split over {nprocs} processes")
    per = len(devices) // nprocs
    cards = group.process_cards()
    ranks = []
    for i, d in enumerate(devices):
        p = i // per
        if (p == me) == (d.type == "meta"):
            raise ValueError(f"rank {i} belongs to process {p} but is "
                             f"{'remote' if d.type == 'meta' else 'local'} "
                             f"to process {me}")
        ranks.append(Rank(i, d, p, cards[p]))
    return tuple(ranks)


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


def world_size(mesh: Mesh, axis: str | None = None) -> int:
    """The ranks of the mesh, or the size of one of its axes."""
    return mesh.size if axis is None else mesh.shape[axis]


def parse_mesh_spec(spec: str) -> tuple[tuple[str, int], ...]:
    """Parse a --mesh factorization, e.g. ``dcn:2,ici:4`` → (("dcn", 2),
    ("ici", 4)) (JAX `parallel/mesh.py:47-81`, its grammar and messages).

    Grammar: comma-separated ``<class>:<size>`` with class ∈ {dcn, ici},
    each class at most once, sizes positive. When both classes appear,
    ``dcn`` must come first: the outer (slowest-link) dimension.
    """
    if not spec or not spec.strip():
        raise ValueError("--mesh spec is empty (expected e.g. dcn:2,ici:4)")
    axes: list[tuple[str, int]] = []
    for part in spec.split(","):
        cls, sep, arg = part.strip().partition(":")
        if not sep or cls not in LINK_CLASSES:
            raise ValueError(
                f"--mesh {spec!r}: bad axis {part.strip()!r} (expected "
                f"<class>:<size> with class in {LINK_CLASSES})")
        try:
            size = int(arg)
        except ValueError:
            size = 0
        if size <= 0:
            raise ValueError(
                f"--mesh {spec!r}: axis size {arg!r} must be a positive int")
        if any(cls == c for c, _ in axes):
            raise ValueError(f"--mesh {spec!r}: axis class {cls!r} repeats")
        axes.append((cls, size))
    if len(axes) > 2:
        raise ValueError(f"--mesh {spec!r}: at most two axes (dcn, ici)")
    if len(axes) == 2 and axes[0][0] != "dcn":
        raise ValueError(
            f"--mesh {spec!r}: dcn (the outer, slower link) must come first")
    return tuple(axes)


def canonical_mesh_spec(spec: str) -> str:
    """The normalized --mesh string (``dcn:2 , ici:4`` → ``dcn:2,ici:4``)."""
    return ",".join(f"{cls}:{size}" for cls, size in parse_mesh_spec(spec))


def make_factorized_mesh(devices: Sequence[torch.device], spec: str) -> Mesh:
    """The two-level (or one-level) mesh a --mesh spec names, over the
    ranks' devices: its axis names are the link classes."""
    axes = parse_mesh_spec(spec)
    shape = tuple(size for _, size in axes)
    if math.prod(shape) != len(devices):
        raise ValueError(
            f"--mesh {spec!r} covers {math.prod(shape)} devices but "
            f"{len(devices)} are available")
    return make_mesh(devices, tuple(cls for cls, _ in axes), shape)


def mesh_spec_of(mesh: Mesh) -> str | None:
    """The canonical --mesh spec a mesh was built from, or None for the
    flat and named meshes (axis names that are not link classes)."""
    if not all(name in LINK_CLASSES for name in mesh.axis_names):
        return None
    return ",".join(f"{name}:{mesh.shape[name]}" for name in mesh.axis_names)


def axis_link_class(axis_name: str) -> str:
    """The link class a mesh axis's collectives travel on (JAX
    `parallel/mesh.py:116-121`): only an axis named 'dcn' crosses the
    network between hosts; every other name, the flat 'x' included, stays
    on 'ici'."""
    return "dcn" if axis_name == "dcn" else "ici"


def mesh_link_classes(mesh: Mesh) -> dict[str, str]:
    """axis name → link class for every axis of a mesh."""
    return {name: axis_link_class(name) for name in mesh.axis_names}


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
    empty = Sharded([], spec, mesh.shape)
    cuts = empty.cuts
    sizes = [_blocks(global_tensor.shape[dim], n,
                     f"dimension {dim} of {tuple(global_tensor.shape)}")
             for dim, n in cuts]
    shards = []
    for r in mesh.ranks:
        t = global_tensor
        for (dim, _), size, block in zip(cuts, sizes, empty.blocks(r.index)):
            t = t.narrow(dim, block * size, size)
        shards.append(t.to(r.device, copy=True).contiguous())
    return empty.like(shards)


def _block_slices(sharded: Sharded, blocks: tuple[int, ...]) -> list[slice]:
    """The global index of one block: a slice for each dimension."""
    shape = sharded[0].shape
    out = [slice(0, n) for n in shape]
    for (dim, _), block in zip(sharded.cuts, blocks):
        out[dim] = slice(block * shape[dim], (block + 1) * shape[dim])
    return out


def _remote(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def home_device(sharded: Sharded) -> torch.device:
    """The device of this process's first shard (another process's shards
    lie on the meta device here)."""
    return next((s.device for s in sharded if not _remote(s)), sharded[0].device)


def first_local_shard(sharded: Sequence[torch.Tensor]) -> torch.Tensor:
    """This process's first shard (another process's are placeholders)."""
    return next(s for s in sharded if not _remote(s))


def _pieces(sharded: Sharded, ranks: Sequence[int],
            piece: Callable[[int, torch.Tensor], torch.Tensor]) -> dict[int, torch.Tensor]:
    """{r: piece(r, shard r)} for each rank r of `ranks`: a local shard's
    piece as it is, another process's fetched through the group into host
    memory (its owner computes it by the same rule). Every process calls
    this together; a sharded operand without placeholders exchanges
    nothing."""
    out = {r: piece(r, sharded[r]) for r in ranks}
    if not any(_remote(s) for s in sharded):
        return out
    held = [r for r in range(len(sharded)) if not _remote(sharded[r])]
    asks = group.share_objects((held, sorted(r for r in ranks if _remote(sharded[r]))))
    owner = {r: p for p, (mine, _) in enumerate(asks) for r in mine}
    needed = sorted({r for _, theirs in asks for r in theirs})
    if not needed:
        return out
    got = group.all_gather_shards([owner[r] for r in needed],
                                  [piece(r, sharded[r]) for r in needed],
                                  processes=range(group.process_count()))
    out.update((r, t) for r, t in zip(needed, got) if r in out)
    return out


def gather(sharded: Sharded, device: torch.device | str | None = None) -> torch.Tensor:
    """The global tensor, put back together on `device` (default: this
    process's first shard's) from one holder of each block; a replicated
    operand's first copy."""
    device = home_device(sharded) if device is None else device
    cuts = sharded.cuts
    holders = sharded.holders()
    got = _pieces(sharded, list(holders.values()), lambda r, s: s)
    if not cuts:
        return got[holders[()]].to(device)
    shape = list(sharded[0].shape)
    for dim, n in cuts:
        shape[dim] *= n
    out = torch.empty(shape, dtype=sharded[0].dtype, device=device)
    for blocks, r in holders.items():
        out[tuple(_block_slices(sharded, blocks))] = got[r].to(device)
    return out


def global_block(sharded: Sharded, rows: int, cols: int) -> torch.Tensor:
    """global[:rows, :cols] of a 2-D operand on this process's first
    shard's device, read from the shards that hold it, without putting
    the rest together."""
    device = home_device(sharded)
    holders = sharded.holders()
    if not sharded.cuts:
        r = holders[()]
        return _pieces(sharded, [r], lambda _r, s: s[:rows, :cols])[r].to(device)
    h, w = sharded[0].shape
    extent = [h, w]
    for dim, n in sharded.cuts:
        extent[dim] *= n
    out = torch.empty((min(rows, extent[0]), min(cols, extent[1])),
                      dtype=sharded[0].dtype, device=device)

    def span(r: int) -> tuple[int, int, int, int]:
        (r0, r1), (c0, c1) = ((s.start, s.stop)
                              for s in _block_slices(sharded, sharded.blocks(r)))
        return r0, min(r1, out.shape[0]), c0, min(c1, out.shape[1])

    inside = [r for r in holders.values()
              if span(r)[0] < out.shape[0] and span(r)[2] < out.shape[1]]

    def piece(r: int, s: torch.Tensor) -> torch.Tensor:
        r0, r1, c0, c1 = span(r)
        return s[:r1 - r0, :c1 - c0]

    got = _pieces(sharded, inside, piece)
    for r in inside:
        r0, r1, c0, c1 = span(r)
        out[r0:r1, c0:c1] = got[r].to(device)
    return out


def stacked_item(sharded: Sharded, index: int) -> torch.Tensor:
    """global[index] of a stacked operand cut along dim 0 only: a view of
    the first shard that holds it, on its rank's device; fetched from
    another process onto this process's first shard's device."""
    if [dim for dim, _ in sharded.cuts] != [0]:
        raise ValueError(f"a stacked item needs dim 0 cut, got spec {sharded.spec}")
    per = sharded[0].shape[0]
    r = sharded.holders()[(index // per,)]
    piece = _pieces(sharded, [r], lambda _r, s: s[index % per])[r]
    return piece if not _remote(sharded[r]) else piece.to(home_device(sharded))


def sharded_normal(seed: int, shape: tuple[int, ...], dtype: torch.dtype,
                   mesh: Mesh, spec: tuple, *, count: int = 2) -> tuple[Sharded, ...]:
    """`count` random global arrays from the port's own generator
    (`ops/matmul.py random_operands`: standard normal, small uniform ints
    for int8), each made on this process's first rank's device and cut by
    `spec`: every process makes the one-process world's bits and keeps
    its own shards (the global array goes once it is cut). The JAX
    package's bits are not reproduced, as `random_operands` does not
    reproduce them either."""
    from tpu_matmul_bench_torch.ops.matmul import iter_random_operands

    out = []
    for g in iter_random_operands(seed, tuple(shape), dtype,
                                  device=mesh.first_local, count=count):
        out.append(shard_tensor(g, spec, mesh))
        del g  # the global array goes before the next is drawn
    return tuple(out)


def ring_perm(n: int) -> list[tuple[int, int]]:
    """Unidirectional ring permutation (rank d sends to d+1 mod n)."""
    return [(i, (i + 1) % n) for i in range(n)]


def ring_perm_rev(n: int) -> list[tuple[int, int]]:
    """Reverse-direction ring permutation (rank d sends to d−1 mod n): the
    counter-rotating half of a bidirectional ring."""
    return [(i, (i - 1) % n) for i in range(n)]


def mesh_device_kind(mesh: Mesh) -> str:
    """The ranks' device kind: the card's name, or 'cpu'."""
    from tpu_matmul_bench_torch.utils.device import device_kind_of

    return device_kind_of(mesh.first_local)
