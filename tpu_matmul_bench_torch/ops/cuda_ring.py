"""The ring matmuls over a world of ranks: all-gather (K2) and
reduce-scatter (K3), as a schedule of hand-written GEMMs and ring hops on
each rank's CUDA streams.

Replaces `tpu_matmul_bench/ops/pallas_ring_hbm.py` (`_hbm_ring_kernel`,
`_chunk_pipeline`, `ring_allgather_matmul_hbm`) and
`tpu_matmul_bench/ops/pallas_ring_rs_hbm.py` (`_hbm_ring_rs_kernel`,
`_rs_chunk_pipeline`, `ring_reduce_scatter_matmul_hbm`). The Pallas kernels
run one program per TPU core that multiplies a resident chunk while
`make_async_remote_copy` moves it to the right neighbour, with semaphores
for flow control. On Hopper, copies between cards leave the GEMM kernel:
here each rank has a compute stream
and a copy stream, every product is a hand-written kernel of
`csrc/matmul.cu` (K1, or its pickup form for K3), every hop is one
`tmb_ring_hop` of `csrc/ring.cu` (cudaMemcpyPeerAsync on the sender's copy
stream), and each semaphore becomes a CUDA event:

| Pallas         | here                                                   |
|----------------|--------------------------------------------------------|
| entry barrier  | every rank stream waits on the caller's current stream |
| `recv_sem`     | event after a hop; the receiver waits on it before it  |
|                | reads the slot                                         |
| `send_sem`     | event after a hop; waited on before its source slot is |
|                | written again (K3's wait two steps later)              |
| `free_sem`     | the receiver's events after every read of a slot (its  |
|                | product, and for K2 its forwarding hop); the writer    |
|                | waits on them before it overwrites the slot            |

At exit the caller's current stream waits on every rank stream, so events
on it time the whole ring and nothing races a later call. Every buffer is
allocated on the caller's stream before the ring starts, and a later
allocation that reuses one is ordered after that exit join, so the rank
streams never meet a reused buffer.

The schedule is issued step by step (all ranks' step t before any step
t+1), so every event is recorded before it is waited on. It is written
once and shared by both devices: on the CPU a hop is `copy_`, a product is
the wrappers' plain version, and the events are no-ops, so the CPU tests
run the same slot, chunk and homing arithmetic the card runs. For CUDA
tensors every product launches a kernel and every hop a copy, or raises:
nothing falls back to the plain versions.

Bound on the card: both rings do the work of one m×k·k×n product, 2mnk
operations, and move each input once, each output once and D·(D−1)
chunks through the hops; at bf16 16384² over 4 ranks that is 8.9 ms of
operations at 989 TFLOP/s against about 1.4 ms (K2) and 2.4 ms (K3) of
bytes at 3.35 TB/s, so both are bound by operations. The products are K1,
so the rings run about as fast as K1 does.

Left for later: one fused kernel per rank, where SM stores or TMA move the
chunk and flags in peer memory replace the events; the W-resident mode
(see `resolve_wres`).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Any, Sequence

import torch

from tpu_matmul_bench_torch.ops import _build
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.parallel.mesh import COLS, ROWS, Mesh, Sharded, gather
from tpu_matmul_bench_torch.utils.metrics import matmul_out_dtype

# Counted where each launch happens, on the card only: RING_STEPS counts the
# ring's products (D² a call), HOP_LAUNCHES its hops (D·(D−1) a call). The
# products also count in cuda_matmul's LAUNCHES and ACC_LAUNCHES.
RING_STEPS = 0
HOP_LAUNCHES = 0


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


_COMPUTE, _COPY = 0, 1


class _Schedule:
    """The streams and events of one ring call on the card; on the CPU
    every method is a no-op and each step runs at once, in issue order."""

    def __init__(self, mesh: Mesh, streams: list[tuple[Any, Any]] | None):
        self.mesh = mesh
        self.streams = streams

    def stream(self, r: int, which: int):
        return self.streams[r][which]

    def on(self, r: int, which: int):
        if self.streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream(r, which))

    def mark(self, r: int, which: int) -> torch.cuda.Event | None:
        if self.streams is None:
            return None
        event = torch.cuda.Event()
        event.record(self.stream(r, which))
        return event

    def wait(self, r: int, which: int, *events: torch.cuda.Event | None) -> None:
        for event in events:
            if event is not None:
                self.stream(r, which).wait_event(event)

    def enter(self) -> None:
        """Every rank stream waits on the caller's current stream of every
        card (the entry barrier)."""
        if self.streams is None:
            return
        marks = []
        for card in self.mesh.cards:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(card))
            marks.append(event)
        for pair in self.streams:
            for s in pair:
                for event in marks:
                    s.wait_event(event)

    def leave(self) -> None:
        """The caller's current stream of every card waits on every rank
        stream."""
        if self.streams is None:
            return
        ends = [self.mark(r, which) for r in range(len(self.streams))
                for which in (_COMPUTE, _COPY)]
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


def _hop(sched: _Schedule, r: int, dst: torch.Tensor, src: torch.Tensor) -> None:
    """One hop: rank r copies `src` into the next rank's slot `dst`, on its
    copy stream (on the CPU, at once)."""
    global HOP_LAUNCHES
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"hop of {tuple(src.shape)} {src.dtype} into "
                         f"{tuple(dst.shape)} {dst.dtype}")
    if not (dst.is_contiguous() and src.is_contiguous()):
        raise ValueError("a hop copies whole contiguous chunks")
    if src.device.type == "cpu":
        dst.copy_(src)
        return
    lib = _ring_lib()
    with torch.cuda.device(src.device):
        rc = lib.tmb_ring_hop(dst.data_ptr(), src.data_ptr(),
                              src.numel() * src.element_size(), dst.device.index,
                              src.device.index, sched.stream(r, _COPY).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ring hop failed: "
                           f"{lib.tmb_ring_error_string(rc).decode()} (code {rc})")
    HOP_LAUNCHES += 1


def _count_step(device: torch.device) -> None:
    global RING_STEPS
    if device.type == "cuda":
        RING_STEPS += 1


class RingMatmul:
    """A ring matmul over `mesh`: `fn(x_shards, w_shards) -> y_shards`.

    `reduce_scatter=False` is K2: Y = X·W with X row-sharded P("x", None),
    W column-sharded P(None, "x"), Y column-sharded P(None, "x").
    `reduce_scatter=True` is K3: X column-sharded P(None, "x"), W
    row-sharded P("x", None), Y row-sharded P("x", None).
    """

    def __init__(self, mesh: Mesh, *, reduce_scatter: bool,
                 blocks: tuple[int, int, int], wres: bool | None):
        resolve_wres(wres, len(mesh.ranks))  # wres=True raises
        self.mesh = mesh
        self.reduce_scatter = reduce_scatter
        self.blocks = blocks
        self._streams: list[tuple[Any, Any]] | None = None

    def _schedule(self, card: bool) -> _Schedule:
        if card and self._streams is None:
            self._streams = [(torch.cuda.Stream(device=dev), torch.cuda.Stream(device=dev))
                             for dev in self.mesh.devices]
        return _Schedule(self.mesh, self._streams if card else None)

    def _check(self, x: Sequence[torch.Tensor], w: Sequence[torch.Tensor]) -> None:
        d = len(self.mesh.ranks)
        if len(x) != d or len(w) != d:
            raise ValueError(f"{len(x)} X and {len(w)} W shards for {d} ranks")
        for r, (xr, wr) in enumerate(zip(x, w)):
            want = self.mesh.devices[r]
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
        if self.reduce_scatter and x[0].shape[0] % d:
            raise ValueError(f"m = {x[0].shape[0]} does not split into {d} row chunks")

    def __call__(self, x: Sequence[torch.Tensor], w: Sequence[torch.Tensor]) -> Sharded:
        self._check(x, w)
        sched = self._schedule(x[0].is_cuda)
        run = self._reduce_scatter if self.reduce_scatter else self._allgather
        return run(sched, x, w)

    def _allgather(self, sched: _Schedule, x, w) -> Sharded:
        """K2 (`_hbm_ring_kernel`): at step t rank r holds the chunk that
        started at rank src = (r − t) mod D and multiplies it into Y rows
        [src·mshard, (src+1)·mshard), while its copy stream forwards the
        chunk into the right neighbour's slot (t+1) mod 2."""
        d = len(self.mesh.ranks)
        mshard, k = x[0].shape
        nshard = w[0].shape[1]
        out = matmul_out_dtype(x[0].dtype)
        y = [torch.empty((mshard * d, nshard), dtype=out, device=dev)
             for dev in self.mesh.devices]
        slots = [torch.empty((2, mshard, k), dtype=x[0].dtype, device=dev)
                 for dev in self.mesh.devices] if d > 1 else []
        hop_done: dict[tuple[int, int], Any] = {}
        reads: dict[tuple[int, int], tuple] = {}
        sched.enter()
        for t in range(d):
            for r in range(d):
                left, right = (r - 1) % d, (r + 1) % d
                chunk = x[r] if t == 0 else slots[r][t % 2]
                arrived = hop_done.get((left, t - 1))  # recv_sem
                src = (r - t) % d
                sched.wait(r, _COMPUTE, arrived)
                with sched.on(r, _COMPUTE):
                    cm.cuda_matmul(chunk, w[r], blocks=self.blocks,
                                   out=y[r][src * mshard:(src + 1) * mshard])
                _count_step(chunk.device)
                product = sched.mark(r, _COMPUTE)
                if t + 1 < d:
                    # free_sem: the right neighbour read its slot (t+1) mod 2
                    # at step t−1 (a slot from t−1 = 1 on; its step 0 read
                    # its own X)
                    freed = reads[(right, t - 1)] if t >= 2 else ()
                    sched.wait(r, _COPY, arrived, *freed)
                    _hop(sched, r, slots[right][(t + 1) % 2], chunk)
                    hop_done[(r, t)] = sched.mark(r, _COPY)
                reads[(r, t)] = (product, hop_done.get((r, t)))
        sched.leave()
        return Sharded(y, COLS)

    def _reduce_scatter(self, sched: _Schedule, x, w) -> Sharded:
        """K3 (`_hbm_ring_rs_kernel`): at step t rank r holds the
        accumulator of row chunk c = (r − 1 − t) mod D, adds its own
        product of those rows to the partial that arrived in receive slot
        t mod 2 (the pickup kernel; plain K1 at t = 0), and sends the sum
        from staging slot t mod 2 into the right neighbour's receive slot
        (t+1) mod 2. After D−1 hops chunk r is home; the last step writes Y.
        Partials are carried in the output dtype, rounded at every hop."""
        d = len(self.mesh.ranks)
        m, _ = x[0].shape
        n = w[0].shape[1]
        mshard = m // d
        out = matmul_out_dtype(x[0].dtype)
        y = [torch.empty((mshard, n), dtype=out, device=dev) for dev in self.mesh.devices]
        recv, stage = [], []
        if d > 1:
            recv = [torch.empty((2, mshard, n), dtype=out, device=dev)
                    for dev in self.mesh.devices]
            stage = [torch.empty((2, mshard, n), dtype=out, device=dev)
                     for dev in self.mesh.devices]
        hop_done: dict[tuple[int, int], Any] = {}
        product: dict[tuple[int, int], Any] = {}
        sched.enter()
        for t in range(d):
            for r in range(d):
                left, right = (r - 1) % d, (r + 1) % d
                c = (r - 1 - t) % d
                rows = x[r][c * mshard:(c + 1) * mshard]
                last = t + 1 == d
                dest = y[r] if last else stage[r][t % 2]
                # recv_sem of this step's partial; send_sem of the hop that
                # last read this staging slot, two steps ago
                sched.wait(r, _COMPUTE, hop_done.get((left, t - 1)),
                           hop_done.get((r, t - 2)))
                with sched.on(r, _COMPUTE):
                    if t == 0:
                        cm.cuda_matmul(rows, w[r], blocks=self.blocks, out=dest)
                    else:
                        cm.cuda_matmul_acc(rows, w[r], recv[r][t % 2], dest,
                                           blocks=self.blocks)
                _count_step(rows.device)
                product[(r, t)] = sched.mark(r, _COMPUTE)
                if not last:
                    # free_sem: the right neighbour's pickup read its slot
                    # (t+1) mod 2 at step t−1 (a slot from t−1 = 1 on)
                    freed = product[(right, t - 1)] if t >= 2 else None
                    sched.wait(r, _COPY, product[(r, t)], freed)
                    _hop(sched, r, recv[right][(t + 1) % 2], dest)
                    hop_done[(r, t)] = sched.mark(r, _COPY)
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
    out = []
    for c in range(d):
        acc = None
        for j in range(1, d + 1):
            q = (c + j) % d
            rows = x[q][c * mshard:(c + 1) * mshard]
            acc = (cm.matmul_plain(rows, w[q]) if acc is None
                   else cm.matmul_acc_plain(rows, w[q], acc.to(rows.device)))
        out.append(acc)
    return Sharded(out, ROWS)
