"""The ring matmuls over a world of ranks: all-gather (K2) and
reduce-scatter (K3), and their bidirectional forms (K4, K5), as a schedule
of hand-written GEMMs on each rank's CUDA streams.

Replaces `tpu_matmul_bench/ops/pallas_ring_hbm.py` (`_hbm_ring_kernel`,
`_chunk_pipeline`, `ring_allgather_matmul_hbm`),
`tpu_matmul_bench/ops/pallas_ring_rs_hbm.py` (`_hbm_ring_rs_kernel`,
`_rs_chunk_pipeline`, `ring_reduce_scatter_matmul_hbm`),
`tpu_matmul_bench/ops/pallas_ring_bidir_hbm.py` (`_bidir_ring_kernel`,
`ring_allgather_matmul_bidir_hbm`) and
`tpu_matmul_bench/ops/pallas_ring_bidir_rs_hbm.py` (`_bidir_rs_kernel`,
`ring_reduce_scatter_matmul_bidir_hbm`). The Pallas kernels
run one program per TPU core that multiplies a resident chunk while
`make_async_remote_copy` moves it to the right neighbour, with semaphores
for flow control. Here every product is a hand-written kernel on the rank's
compute stream, and each semaphore becomes a CUDA event.

On ranks that share one card, the data moves inside the products, as the
Pallas kernels move it under the MXU work: each all-gather step's product
(`cm.cuda_matmul_ag`, the persistent GEMM of `csrc/ring_rs.cu` in its
forwarding mode) stores the chunk it loads into the reader's receive slot
(t+1) mod 2, and each reduce-scatter step's product (`cm.cuda_matmul_rs`)
stores its partial sum there. A rank then has one stream and no hop
(`ag_transfer` == "forward", `rs_transfer` == "store"):

| Pallas         | here, on one card                                      |
|----------------|--------------------------------------------------------|
| entry barrier  | every rank stream waits on the caller's current stream |
| DMA to the     | the step's product writes the reader's slot (t+1) mod 2|
| right          | in the same launch (K2, K4: the chunk, K3, K5: the sum)|
| `recv_sem`     | the compute stream waits on the writer's product of    |
|                | step t−1, which filled slot t mod 2                    |
| `send_sem`     | the product's own end: the slot is written when it is  |
| `free_sem`     | the compute stream waits on the reader's product of    |
|                | step t−1, which read slot (t+1) mod 2 (from t = 2 on)  |

Ranks in several processes (`parallel/group.py`) hop too: a step's
product is K1, and a hop into another process's slot crosses the group
(`_cross`: host copy, gloo send and receive), the remote ranks' products
being placeholders there. Ranks on several cards keep the hop (`_hop`: one `tmb_ring_hop` of
`csrc/ring.cu`, cudaMemcpyPeerAsync on the sender's copy stream) and its
events: a K2/K4 product is K1 of `csrc/matmul.cu`, and the chunk hops on
the copy stream once it has arrived (`recv_sem`) and the reader has read
the slot it goes into (`free_sem`: its product and its own forwarding
hop); a K3/K5 product writes a staging slot that a hop sends on. An
all-gather call on one card in which a step cannot forward (`cm.ag_forwards`
false: int8, fp32, rows TMA cannot describe) takes the hop schedule whole,
decided before its first launch.

The bidirectional rings split each chunk (K4) or each output chunk's
accumulator (K5) into a top half of h = mshard // 2 rows that goes right
and a bottom half of mshard − h rows that goes left. Each direction has its
own slots and its own `free_sem` events: the forward writer waits on its
right neighbour's reads, the backward writer on its left neighbour's; with
hops, each rank has a second copy stream for the left-going ones, so the
two directions run independently, as the Pallas kernels' two DMA streams
do. One loop serves each contract: it runs over the ring's directions
(`_Way`), one for K2 and K3, two for K4 and K5.

At exit the caller's current stream waits on every rank stream, so events
on it time the whole ring and nothing races a later call. Every buffer is
allocated on the caller's stream before the ring starts, and a later
allocation that reuses one is ordered after that exit join, so the rank
streams never meet a reused buffer.

The schedule is issued step by step (all ranks' step t before any step
t+1), so every event is recorded before it is waited on. It is written
once and shared by both devices: on the CPU a hop is `copy_`, a product is
the wrappers' plain version (with its forwarding copy), and the events are
no-ops, so the CPU tests run the same slot, chunk and homing arithmetic the
card runs. For CUDA tensors every product launches a kernel and every hop a
copy, or raises: nothing falls back to the plain versions.

Bound on the card: every ring computes the function of one m×k·k×n
product, 2mnk operations, reading each input once and writing each output
once (the forwarded chunks, hops and staged partials are the ring's own
traffic, not the function's); at bf16 16384² over 4 ranks that is 8.9 ms
of operations at 989 TFLOP/s against 0.48 ms of bytes at 3.35 TB/s, so all
four are bound by operations, and run about as fast as their products.

Left for later: one fused kernel per rank across cards, where SM stores or
TMA move the chunk and flags in peer memory replace the events (the fused
ring of ranks that share one card is `ops/cuda_ring_fused.py`, K6); the
W-resident mode (see `resolve_wres`).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Any, NamedTuple, Sequence

import torch

from tpu_matmul_bench_torch.ops import _build
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.parallel import group
from tpu_matmul_bench_torch.parallel.mesh import (
    COLS,
    ROWS,
    Mesh,
    Sharded,
    gather,
    ring_perm,
    ring_perm_rev,
)
from tpu_matmul_bench_torch.utils.metrics import matmul_out_dtype

# Counted where each launch happens, on the card only: RING_STEPS counts the
# ring's products (D² a call; 2·D² for K4 and K5), HOP_LAUNCHES its hops
# (D·(D−1) a call for K2 and K3, 2·D·(D−1) for K4 and K5, where their
# ranks span several cards; on one card only the all-gather calls that
# cannot forward hop). The products also count in cuda_matmul's LAUNCHES,
# ACC_LAUNCHES, RS_LAUNCHES and AG_LAUNCHES. RS_TRANSFERS and AG_TRANSFERS
# count the rings' calls on the card by how their data moved
# (`rs_transfer`; `ag_transfer`, or "hop" where a step cannot forward).
RING_STEPS = 0
HOP_LAUNCHES = 0
# hops between processes on the card (`_cross`): one a send or a receive
CROSS_HOPS = 0
RS_TRANSFERS = {"store": 0, "hop": 0}
AG_TRANSFERS = {"forward": 0, "hop": 0}


def resolve_wres(wres: bool | None, d: int,
                 w_shard_bytes: int | None = None) -> tuple[bool, str]:
    """The JAX package's wres rule (`pallas_ring_hbm.py:272-288`) on this
    card, as (engaged, reason). There W-resident mode engages on rings of
    ≥2 steps whose W shard fits the VMEM budget. Here no W-resident kernel
    exists: a W shard (128 MiB at bf16 16384² over 4 ranks) is far beyond a
    block's 227 KB of shared memory and even the card's 50 MB of L2, so
    None (auto) and False give (False, reason), and True raises with the
    reason."""
    if d < 2:
        reason = "rings need >= 2 ranks"
    else:
        shard = "" if w_shard_bytes is None else f" ({w_shard_bytes} B)"
        reason = (f"no W-resident kernel: the W shard{shard} is read from "
                  "device memory at every step; a block's shared memory "
                  "holds 227 KB")
    if wres:
        raise ValueError(
            f"wres=True but the W-resident layout is unavailable: {reason}")
    return False, reason


def rs_transfer(mesh: Mesh) -> str:
    """How a reduce-scatter ring over `mesh` moves its partial sums, chosen
    before the call: "store" when every rank shares one card in one process
    (each step's product is stored into the reader's receive slot), else
    "hop" (the sum goes to a staging slot, and a copy moves it to the
    reader's card, or through the process group to the reader's process; a
    store into a peer card's memory is later work)."""
    return "store" if mesh.shared_card else "hop"


def ag_transfer(mesh: Mesh) -> str:
    """How an all-gather ring over `mesh` moves its chunks, chosen before
    the call: "forward" when every rank shares one card in one process
    (each step's product stores the chunk it loads into the reader's
    receive slot), else "hop" (a copy, or a crossing between processes,
    moves the chunk to the reader after it has arrived)."""
    return "forward" if mesh.shared_card else "hop"


# a rank's streams: products, hops (the right-going ones in K4 and K5), and
# the left-going hops of K4 and K5; the copy streams only where the ring hops
_COMPUTE, _COPY, _COPY_BACK = 0, 1, 2
#: the caller's own stream, where a serialized baseline issues its work
CALLER = -1


class _Way(NamedTuple):
    """One direction of a ring: its name, the copy stream its hops run on,
    the rows [lo, hi) of each chunk (or accumulator) it carries, and
    `step`, +1 for hops to the right (`ring_perm`) or −1 to the left
    (`ring_perm_rev`)."""
    name: str
    copy: int
    lo: int
    hi: int
    step: int

    def neighbours(self, d: int, r: int) -> tuple[int, int]:
        """(writer, reader) of rank r in this direction: the rank whose hops
        fill r's slots, and the rank whose slots r's hops fill."""
        right, left = dict(ring_perm(d))[r], dict(ring_perm_rev(d))[r]
        return (left, right) if self.step > 0 else (right, left)


def ring_ways(rows: int, bidir: bool) -> list[_Way]:
    """A ring's directions over a chunk of `rows` rows: every row hops
    right, or (`bidir`) the top rows // 2 hop right and the rest left."""
    if not bidir:
        return [_Way("f", _COPY, 0, rows, +1)]
    h = rows // 2
    return [_Way("f", _COPY, 0, h, +1), _Way("b", _COPY_BACK, h, rows, -1)]


def rank_streams(mesh: Mesh, per_rank: int) -> list[tuple[Any, ...]]:
    """`per_rank` new streams on each rank's card, in rank order. A rank of
    another process gets streams on this process's card: its launches are
    placeholders, but a hop from it into a local slot (a receive) runs on
    its copy stream there, after the waits the schedule gives it."""
    local = mesh.cards[0]
    return [tuple(torch.cuda.Stream(device=dev if dev.type != "meta" else local)
                  for _ in range(per_rank))
            for dev in mesh.devices]


class _Schedule:
    """The streams and events of one ring call on the card; on the CPU
    every method is a no-op and each step runs at once, in issue order.
    While a schedule recorder runs (`analysis/recording.record_schedule`,
    which sets `recorder`), every launch (where `on` puts work on a
    stream), mark, wait and barrier is also logged, the same on the CPU
    (where a mark is a numbered event of the log) as on the card; `step`
    is the step the program is at, and `per_rank` the streams a rank has
    where there are none (the CPU)."""

    #: the log of the schedule recorder running now, if any
    recorder: Any = None

    def __init__(self, mesh: Mesh, streams: list[tuple[Any, ...]] | None,
                 per_rank: int = 0):
        self.mesh = mesh
        self.streams = streams
        self.log = _Schedule.recorder
        self.per_rank = per_rank
        self.step = 0

    def stream(self, r: int, which: int):
        return self.streams[r][which]

    def on(self, r: int, which: int, kind: str):
        """The block puts a launch of `kind` on rank r's stream `which`
        (`CALLER`: the caller's own)."""
        if self.log is not None:
            self.log.launch(kind, r, which, self.step)
        if self.streams is None or which == CALLER:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream(r, which))

    def mark(self, r: int, which: int) -> Any:
        event = None
        if self.streams is not None:
            event = torch.cuda.Event()
            event.record(self.stream(r, which))
        if self.log is not None:
            event = self.log.mark(r, which, event)
        return event

    def wait(self, r: int, which: int, *events: Any, reuse: bool = False) -> None:
        """Rank r's stream `which` waits on the events (None: nothing to
        wait for). `reuse`: the wait guards a buffer's reuse (the next
        launch overwrites what the marked one read), not data it reads."""
        events = tuple(e for e in events if e is not None)
        if self.log is not None and events:
            self.log.wait(r, which, events, reuse)
        if self.streams is None:
            return
        for event in events:
            self.stream(r, which).wait_event(event)

    def enter(self) -> None:
        """Every rank stream waits on the caller's current stream of every
        card (the entry barrier)."""
        if self.log is not None:
            self.log.barrier("enter")
        if self.streams is None:
            return
        marks = []
        for card in self.mesh.cards:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(card))
            marks.append(event)
        for rank_streams in self.streams:
            for s in rank_streams:
                for event in marks:
                    s.wait_event(event)

    def leave(self) -> None:
        """The caller's current stream of every card waits on every rank
        stream."""
        if self.streams is None and self.log is None:
            return
        if self.log is not None:
            self.log.barrier("leave")
        lanes = [len(s) for s in self.streams] if self.streams is not None \
            else [self.per_rank] * len(self.mesh.ranks)
        ends = [self.mark(r, which) for r, n in enumerate(lanes) for which in range(n)]
        if self.streams is None:
            return
        for card in self.mesh.cards:
            current = torch.cuda.current_stream(card)
            for event in ends:
                current.wait_event(event)


def _ring_lib() -> ctypes.CDLL:
    lib = _build.load("ring")
    if lib.tmb_ring_hop.argtypes is None:
        p = ctypes.c_void_p
        lib.tmb_ring_hop.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, p]
        lib.tmb_ring_hop.restype = ctypes.c_int
        lib.tmb_ring_error_string.argtypes = [ctypes.c_int]
        lib.tmb_ring_error_string.restype = ctypes.c_char_p
    return lib


def _hop(sched: _Schedule, r: int, dst: torch.Tensor, src: torch.Tensor,
         which: int = _COPY, reader: int | None = None) -> None:
    """One hop: rank r copies `src` into a neighbour's slot `dst`, on its
    copy stream `which` (on the CPU, at once). Where the neighbour (rank
    `reader`) is in another process the hop crosses the process group
    (`_cross`)."""
    global HOP_LAUNCHES
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"hop of {tuple(src.shape)} {src.dtype} into "
                         f"{tuple(dst.shape)} {dst.dtype}")
    if not (dst.is_contiguous() and src.is_contiguous()):
        raise ValueError("a hop copies whole contiguous chunks")
    if "meta" in (src.device.type, dst.device.type):
        _cross(sched, r, reader, dst, src, which)
        return
    if src.device.type == "cpu":
        with sched.on(r, which, "hop"):
            dst.copy_(src)
        return
    lib = _ring_lib()
    with sched.on(r, which, "hop"), torch.cuda.device(src.device):
        rc = lib.tmb_ring_hop(dst.data_ptr(), src.data_ptr(),
                              src.numel() * src.element_size(), dst.device.index,
                              src.device.index, sched.stream(r, which).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ring hop failed: "
                           f"{lib.tmb_ring_error_string(rc).decode()} (code {rc})")
    HOP_LAUNCHES += 1


def _cross(sched: _Schedule, r: int, reader: int | None, dst: torch.Tensor,
           src: torch.Tensor, which: int) -> None:
    """A hop between processes (`parallel/group.py`), on rank r's copy
    stream `which` after the waits the schedule gave it: the sender copies
    its chunk to host memory (which waits for that stream) and sends its
    bytes; the receiver, on the writer's stream here, takes them and copies
    them into its slot. Both processes issue every hop in the same order,
    so each send meets its receive. A hop between two other processes is
    nothing here."""
    global CROSS_HOPS
    if src.device.type == "meta" and dst.device.type == "meta":
        return
    if reader is None:
        raise ValueError("a hop between processes needs its reader rank")
    procs = [rank.process for rank in sched.mesh.ranks]
    with sched.on(r, which, "hop"):
        if src.device.type != "meta":
            group.send_tensor(src, procs[reader])
        else:
            dst.copy_(group.recv_tensor(dst, procs[r]))
    if dst.is_cuda or src.is_cuda:
        CROSS_HOPS += 1


def _count_step(device: torch.device) -> None:
    global RING_STEPS
    if device.type == "cuda":
        RING_STEPS += 1


def on_card(shards: Sequence[torch.Tensor]) -> bool:
    """Whether this process's shards are on the card (another process's
    are placeholders on the meta device)."""
    return any(s.is_cuda for s in shards)


def check_shards(mesh: Mesh, x: Sequence[torch.Tensor], w: Sequence[torch.Tensor],
                 reduce_scatter: bool) -> None:
    """One contiguous X and W shard per rank, on the rank's device, of one
    shape and dtype, with matching inner dimensions; for a reduce-scatter
    ring, X's rows cut into D chunks."""
    d = len(mesh.ranks)
    if len(x) != d or len(w) != d:
        raise ValueError(f"{len(x)} X and {len(w)} W shards for {d} ranks")
    for r, (xr, wr) in enumerate(zip(x, w)):
        want = mesh.devices[r]
        if xr.device != want or wr.device != want:
            raise ValueError(f"rank {r} lives on {want}, its shards on "
                             f"{xr.device} and {wr.device}")
        if xr.shape != x[0].shape or wr.shape != w[0].shape:
            raise ValueError("every rank's shards must have one shape")
        if xr.dtype != x[0].dtype or wr.dtype != x[0].dtype:
            raise TypeError("every shard must have one dtype")
        if not (xr.is_contiguous() and wr.is_contiguous()):
            raise ValueError("the ring takes contiguous shards")
    if x[0].ndim != 2 or w[0].ndim != 2 or x[0].shape[1] != w[0].shape[0]:
        raise ValueError(f"bad shard shapes {tuple(x[0].shape)} @ {tuple(w[0].shape)}")
    if reduce_scatter and x[0].shape[0] % d:
        raise ValueError(f"m = {x[0].shape[0]} does not split into {d} row chunks")


class RingMatmul:
    """A ring matmul over `mesh`: `fn(x_shards, w_shards) -> y_shards`.

    `reduce_scatter=False` is K2: Y = X·W with X row-sharded P("x", None),
    W column-sharded P(None, "x"), Y column-sharded P(None, "x").
    `reduce_scatter=True` is K3: X column-sharded P(None, "x"), W
    row-sharded P("x", None), Y row-sharded P("x", None). `bidir=True`
    gives the bidirectional form of either, K4 or K5, with the same
    contract.
    """

    def __init__(self, mesh: Mesh, *, reduce_scatter: bool,
                 blocks: tuple[int, int, int], wres: bool | None,
                 bidir: bool = False):
        resolve_wres(wres, len(mesh.ranks))  # wres=True raises
        self.mesh = mesh
        self.reduce_scatter = reduce_scatter
        self.bidir = bidir
        self.blocks = blocks
        # each rank's streams, by how many it has (1, 2 or 3)
        self._streams: dict[int, list[tuple[Any, ...]]] = {}

    def _schedule(self, card: bool, transfer: str = "hop") -> _Schedule:
        """The call's streams: on the card a compute stream a rank, and its
        copy streams where `transfer` is "hop" (one, two for K4 and K5)."""
        if not card:
            return _Schedule(self.mesh, None)
        per_rank = (3 if self.bidir else 2) if transfer == "hop" else 1
        if per_rank not in self._streams:
            self._streams[per_rank] = rank_streams(self.mesh, per_rank)
        return _Schedule(self.mesh, self._streams[per_rank])

    def _check(self, x: Sequence[torch.Tensor], w: Sequence[torch.Tensor]) -> None:
        check_shards(self.mesh, x, w, self.reduce_scatter)
        if not self.bidir:
            return
        d = len(self.mesh.ranks)
        if self.reduce_scatter and x[0].shape[0] // d < 2:
            raise ValueError(
                f"bidirectional RS ring needs ≥ 2 output rows per device "
                f"(m/d = {x[0].shape[0] // d}) — use ring_reduce_scatter_matmul_hbm")
        if not self.reduce_scatter and x[0].shape[0] < 2:
            raise ValueError(
                f"bidirectional ring needs ≥ 2 rows per shard, got {x[0].shape[0]}"
                " — use the unidirectional ring_allgather_matmul_hbm")

    def __call__(self, x: Sequence[torch.Tensor], w: Sequence[torch.Tensor]) -> Sharded:
        self._check(x, w)
        if not self.reduce_scatter:
            return self._allgather(x, w, ag_transfer(self.mesh))
        transfer = rs_transfer(self.mesh)
        card = on_card(x)
        if card:
            RS_TRANSFERS[transfer] += 1
        return self._reduce_scatter(self._schedule(card, transfer), x, w, transfer)

    def _ways(self, rows: int) -> list[_Way]:
        """The ring's directions (`ring_ways`): one for K2 and K3, two for
        K4 and K5."""
        return ring_ways(rows, self.bidir)

    def _product(self, sched: _Schedule, r: int, a: torch.Tensor, w: torch.Tensor,
                 dest: torch.Tensor, accin: torch.Tensor | None = None):
        """dest = a·w (+ accin, the pickup) on rank r's compute stream: K1
        for the all-gather rings that hop, `cm.cuda_matmul_rs` for the
        reduce-scatter rings; returns the event after it."""
        with sched.on(r, _COMPUTE, "product"):
            if a.device.type == "meta":
                pass  # a rank of another process: its product runs there
            elif self.reduce_scatter:
                cm.cuda_matmul_rs(a, w, accin, dest, blocks=self.blocks)
            else:
                cm.cuda_matmul(a, w, blocks=self.blocks, out=dest)
        _count_step(a.device)
        return sched.mark(r, _COMPUTE)

    def _forward(self, sched: _Schedule, r: int, a: torch.Tensor, w: torch.Tensor,
                 dest: torch.Tensor, fwd: torch.Tensor | None):
        """dest = a·w on rank r's compute stream, and a copied into the
        reader's slot `fwd` (None at the last step) by the same launch
        (`cm.cuda_matmul_ag`). Returns the event after it."""
        with sched.on(r, _COMPUTE, "product"):
            cm.cuda_matmul_ag(a, w, dest, fwd, blocks=self.blocks)
        _count_step(a.device)
        return sched.mark(r, _COMPUTE)

    def _allgather(self, x, w, transfer: str) -> Sharded:
        """K2 (`_hbm_ring_kernel`) and K4 (`_bidir_ring_kernel`). In each
        direction, at step t rank r holds rows [lo, hi) of the chunk that
        started at rank src = (r − step·t) mod D, multiplies them into Y
        rows [src·mshard + lo, src·mshard + hi), and passes them on into the
        next rank's slot (t+1) mod 2. K2 has one direction over whole
        chunks; K4 splits each chunk, its top half going right and its
        bottom half left.

        `transfer` (`ag_transfer`) says how the chunk reaches the reader:
        - "forward": the product stores it into the reader's slot (t+1) mod
          2 in the same launch. Before it, the compute stream waits on the
          writer's product of step t−1, which filled slot t mod 2
          (`recv_sem`), and on the reader's product of step t−1, which read
          slot (t+1) mod 2 (`free_sem`, from t = 2 on). On the card a call
          in which a step cannot forward (`cm.ag_forwards`) hops instead,
          decided before the first launch.
        - "hop": the direction's copy stream sends it once it has arrived
          and the reader's product and hop of step t−1 have read the slot
          it goes into (`free_sem`: the forward writer waits on its right
          neighbour's reads, the backward writer on its left neighbour's).
          Unlike `_bidir_ring_kernel:98-102`, where one program waits on
          both directions' acks before either DMA starts, a hop here never
          waits on the other direction."""
        d = len(self.mesh.ranks)
        mshard, k = x[0].shape
        nshard = w[0].shape[1]
        out = matmul_out_dtype(x[0].dtype)
        y = [torch.empty((mshard * d, nshard), dtype=out, device=dev)
             for dev in self.mesh.devices]
        ways = self._ways(mshard)
        slots = self._slots(ways, k, x[0].dtype) if d > 1 else {}

        # (t, r, way, writer, reader, chunk, dest, fwd) of every product, in
        # issue order
        steps = []
        for t in range(d):
            for r in range(d):
                for way in ways:
                    writer, reader = way.neighbours(d, r)
                    chunk = x[r][way.lo:way.hi] if t == 0 else slots[way.name][r][t % 2]
                    row0 = (r - way.step * t) % d * mshard
                    fwd = slots[way.name][reader][(t + 1) % 2] if t + 1 < d else None
                    steps.append((t, r, way, writer, reader, chunk,
                                  y[r][row0 + way.lo:row0 + way.hi], fwd))
        card = on_card(x)
        if transfer == "forward" and card and not all(
                fwd is None or cm.ag_forwards(chunk, w[r], dest, fwd, self.blocks)
                for _, r, _, _, _, chunk, dest, fwd in steps):
            transfer = "hop"
        if card:
            AG_TRANSFERS[transfer] += 1
        sched = self._schedule(card, transfer)
        hop_done: dict[tuple[str, int, int], Any] = {}
        reads: dict[tuple[str, int, int], tuple] = {}
        products: dict[tuple[str, int, int], Any] = {}
        sched.enter()
        for t, r, way, writer, reader, chunk, dest, fwd in steps:
            if transfer == "forward":
                freed = (products[(way.name, reader, t - 1)]
                         if fwd is not None and t >= 2 else None)
                sched.wait(r, _COMPUTE, products.get((way.name, writer, t - 1)), freed)
                products[(way.name, r, t)] = self._forward(sched, r, chunk, w[r], dest, fwd)
                continue
            arrived = hop_done.get((way.name, writer, t - 1))  # recv_sem
            sched.wait(r, _COMPUTE, arrived)
            product = self._product(sched, r, chunk, w[r], dest)
            if fwd is not None:
                # free_sem: the reader read its slot (t+1) mod 2 at step t−1
                # (a slot from t−1 = 1 on; its step 0 read its own X)
                freed = reads[(way.name, reader, t - 1)] if t >= 2 else ()
                sched.wait(r, way.copy, arrived, *freed)
                _hop(sched, r, fwd, chunk, way.copy, reader)
                hop_done[(way.name, r, t)] = sched.mark(r, way.copy)
            reads[(way.name, r, t)] = (product, hop_done.get((way.name, r, t)))
        sched.leave()
        return Sharded(y, COLS)

    def _slots(self, ways: list[_Way], n: int, dtype: torch.dtype
               ) -> dict[str, list[torch.Tensor]]:
        """Two slots of each direction's rows × n a rank: an all-gather
        ring's receive slots (n = k), a reduce-scatter ring's receive slots,
        or its staging slots."""
        return {way.name: [torch.empty((2, way.hi - way.lo, n), dtype=dtype, device=dev)
                           for dev in self.mesh.devices] for way in ways}

    def _reduce_scatter(self, sched: _Schedule, x, w, transfer: str) -> Sharded:
        """K3 (`_hbm_ring_rs_kernel`) and K5 (`_bidir_rs_kernel`). In each
        direction, at step t rank r holds rows [lo, hi) of the accumulator
        of row chunk c = (r − step·(1+t)) mod D, and adds its own product of
        those rows to the partial that arrived in its receive slot t mod 2
        (no partial at t = 0). After D−1 steps chunk r is home; the last step
        writes Y rows [lo, hi). K3 has one direction over whole chunks; K5
        splits each accumulator, its top half going right and its bottom
        half left, and a step waits only on its own direction's events.
        Partials are carried in the output dtype, rounded at every step.

        `transfer` (`rs_transfer`) says how the sum reaches the reader:
        - "store": the product writes it straight into the reader's receive
          slot (t+1) mod 2. Before it, the compute stream waits on the
          writer's product of step t−1, which filled slot t mod 2
          (`recv_sem`), and on the reader's product of step t−1, which read
          slot (t+1) mod 2 (`free_sem`, from t = 2 on).
        - "hop": the product writes staging slot t mod 2 and the copy
          stream sends it into the reader's slot once the reader's pickup of
          step t−1 has read that slot; a staging slot is written again only
          after the hop that read it, two steps earlier."""
        d = len(self.mesh.ranks)
        m, _ = x[0].shape
        n = w[0].shape[1]
        mshard = m // d
        out = matmul_out_dtype(x[0].dtype)
        y = [torch.empty((mshard, n), dtype=out, device=dev) for dev in self.mesh.devices]
        ways = self._ways(mshard)
        recv = self._slots(ways, n, out) if d > 1 else {}
        stage = self._slots(ways, n, out) if d > 1 and transfer == "hop" else {}
        hop_done: dict[tuple[str, int, int], Any] = {}
        product: dict[tuple[str, int, int], Any] = {}
        sched.enter()
        for t in range(d):
            last = t + 1 == d
            for r in range(d):
                for way in ways:
                    writer, reader = way.neighbours(d, r)
                    row0 = (r - way.step * (1 + t)) % d * mshard
                    rows = x[r][row0 + way.lo:row0 + way.hi]
                    accin = recv[way.name][r][t % 2] if t else None
                    if transfer == "store":
                        dest = (y[r][way.lo:way.hi] if last
                                else recv[way.name][reader][(t + 1) % 2])
                        sched.wait(r, _COMPUTE, product.get((way.name, writer, t - 1)),
                                   None if last or t < 2 else product[(way.name, reader, t - 1)])
                        product[(way.name, r, t)] = self._product(sched, r, rows, w[r],
                                                                  dest, accin)
                        continue
                    dest = y[r][way.lo:way.hi] if last else stage[way.name][r][t % 2]
                    # recv_sem of this step's partial; send_sem of the hop
                    # that last read this staging slot, two steps ago
                    sched.wait(r, _COMPUTE, hop_done.get((way.name, writer, t - 1)),
                               hop_done.get((way.name, r, t - 2)))
                    product[(way.name, r, t)] = self._product(sched, r, rows, w[r], dest, accin)
                    if not last:
                        # free_sem: the reader's pickup read its slot (t+1)
                        # mod 2 at step t−1 (a slot from t−1 = 1 on)
                        freed = product[(way.name, reader, t - 1)] if t >= 2 else None
                        sched.wait(r, way.copy, product[(way.name, r, t)], freed)
                        _hop(sched, r, recv[way.name][reader][(t + 1) % 2], dest,
                             way.copy, reader)
                        hop_done[(way.name, r, t)] = sched.mark(r, way.copy)
        sched.leave()
        return Sharded(y, ROWS)


def _tile_request(block_m: int | None, block_n: int | None,
            block_k: int | None) -> tuple[int, int, int]:
    """The products' tile request: explicit values over DEFAULT_TILE (the
    JAX package's `default_hbm_blocks` is a table of TPU measurements and
    does not carry over); `effective_blocks` resolves it per product."""
    return tuple(v if v is not None else dflt for v, dflt in
                 zip((block_m, block_n, block_k), cm.DEFAULT_TILE))


def ring_allgather_matmul_hbm(mesh: Mesh, block_m: int | None = None,
                              block_n: int | None = None,
                              block_k: int | None = None,
                              wres: bool | None = None) -> RingMatmul:
    """K2: `fn(x_shards, w_shards) -> y_shards` with x P("x", None), w
    P(None, "x"), y P(None, "x") (`ring_allgather_matmul_hbm`,
    `pallas_ring_hbm.py:291-383`). `wres`: see `resolve_wres`."""
    return RingMatmul(mesh, reduce_scatter=False,
                      blocks=_tile_request(block_m, block_n, block_k), wres=wres)


def ring_reduce_scatter_matmul_hbm(mesh: Mesh, block_m: int | None = None,
                                   block_n: int | None = None,
                                   block_k: int | None = None,
                                   wres: bool | None = None) -> RingMatmul:
    """K3: `fn(x_shards, w_shards) -> y_shards` with x P(None, "x"), w
    P("x", None), y P("x", None) (`ring_reduce_scatter_matmul_hbm`,
    `pallas_ring_rs_hbm.py:259-353`). `wres`: see `resolve_wres`."""
    return RingMatmul(mesh, reduce_scatter=True,
                      blocks=_tile_request(block_m, block_n, block_k), wres=wres)


def ring_allgather_matmul_bidir_hbm(mesh: Mesh, block_m: int | None = None,
                                    block_n: int | None = None,
                                    block_k: int | None = None,
                                    wres: bool | None = None) -> RingMatmul:
    """K4: K2's contract with each chunk split into two counter-rotating
    halves (`ring_allgather_matmul_bidir_hbm`,
    `pallas_ring_bidir_hbm.py:143-238`). Needs ≥ 2 rows per shard. `wres`:
    see `resolve_wres`."""
    return RingMatmul(mesh, reduce_scatter=False, bidir=True,
                      blocks=_tile_request(block_m, block_n, block_k), wres=wres)


def ring_reduce_scatter_matmul_bidir_hbm(mesh: Mesh, block_m: int | None = None,
                                         block_n: int | None = None,
                                         block_k: int | None = None,
                                         wres: bool | None = None) -> RingMatmul:
    """K5: K3's contract with each output chunk's accumulator split into
    two counter-rotating halves (`ring_reduce_scatter_matmul_bidir_hbm`,
    `pallas_ring_bidir_rs_hbm.py:165-272`). Needs ≥ 2 output rows per rank.
    `wres`: see `resolve_wres`."""
    return RingMatmul(mesh, reduce_scatter=True, bidir=True,
                      blocks=_tile_request(block_m, block_n, block_k), wres=wres)


def ring_allgather_matmul_plain(x: Sequence[torch.Tensor],
                                w: Sequence[torch.Tensor]) -> Sharded:
    """The plain version of K2, its dense definition: each rank's Y is
    `matmul_plain(gather(X), W_r)`."""
    xs = Sharded(x, ROWS)
    return Sharded([cm.matmul_plain(gather(xs, wr.device), wr) for wr in w], COLS)


def ring_reduce_scatter_matmul_plain(x: Sequence[torch.Tensor],
                                     w: Sequence[torch.Tensor]) -> Sharded:
    """The plain version of K3, in its hop order and with its rounding:
    chunk c's sum starts at rank c+1 and is rounded to the output dtype
    after every rank's contribution, in ring order, ending at rank c
    ("per-hop rounding matches the lax form", `pallas_ring_rs_hbm.py:
    270-272`)."""
    d = len(x)
    mshard = x[0].shape[0] // d
    return Sharded([_hop_sum(x, w, c * mshard, (c + 1) * mshard, c, +1)
                    for c in range(d)], ROWS)


def ring_reduce_scatter_matmul_bidir_plain(x: Sequence[torch.Tensor],
                                           w: Sequence[torch.Tensor]) -> Sharded:
    """The plain version of K5, in its hop orders and with its rounding: the
    top h = mshard // 2 rows of chunk c sum ranks c+1, c+2, …, c (the
    forward ring), the bottom rows ranks c−1, c−2, …, c (the backward
    ring), each rounded to the output dtype after every contribution."""
    d = len(x)
    mshard = x[0].shape[0] // d
    h = mshard // 2
    return Sharded([torch.cat([_hop_sum(x, w, c * mshard, c * mshard + h, c, +1),
                               _hop_sum(x, w, c * mshard + h, (c + 1) * mshard, c, -1)])
                    for c in range(d)], ROWS)


def _hop_sum(x: Sequence[torch.Tensor], w: Sequence[torch.Tensor], row0: int,
             row1: int, c: int, step: int) -> torch.Tensor:
    """Σ over ranks q = c+step, c+2·step, …, c (mod D) of X_q[row0:row1]·W_q,
    rounded to the output dtype after every rank's contribution; on rank
    c's device."""
    d = len(x)
    acc = None
    for j in range(1, d + 1):
        q = (c + step * j) % d
        rows = x[q][row0:row1]
        acc = (cm.matmul_plain(rows, w[q]) if acc is None
               else cm.matmul_acc_plain(rows, w[q], acc.to(rows.device)))
    return acc
