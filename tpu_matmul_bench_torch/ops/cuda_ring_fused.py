"""The fused all-gather ring matmul (K6): the whole ring, for every rank of
a world that shares one card, in one cooperative launch of
`csrc/ring_fused.cu`.

Replaces `tpu_matmul_bench/ops/pallas_ring.py` (`_ring_kernel`,
`ring_allgather_matmul`): K2's contract, Y = X·W with X row-sharded
P("x", None), W column-sharded P(None, "x") and Y column-sharded
P(None, "x"), with every operand resident on the chip and the whole ring
inside one kernel. The Pallas kernel keeps the operands in VMEM; here they
are meant to stay in the card's L2 (nothing pins them, and no run has
measured it), and `parallel/overlap.py cuda_ring_max_size` caps the size
as `pallas_ring_max_size` caps it to the VMEM budget. The source
says why one grid-wide barrier a step replaces the three semaphores.

It runs on the caller's current stream, with no rank streams and no events,
and needs every rank on one card: a world that spans several cards raises
(the peer-memory form is later work, ROADMAP B6). On the CPU the same step
loop runs, with each rank's two slots, `copy_` hops and plain products, so
the CPU tests exercise the slot arithmetic; for CUDA tensors it launches
the kernel or raises: nothing falls back.

Each chunk's product is rounded once, as `_ring_kernel:100-102` does, so
the plain version is K2's: `cuda_ring.ring_allgather_matmul_plain`.

The kernel has two forms, chosen by `fused_route` from the shards before
the launch: `wgmma` (bf16 and f16 that TMA can describe: TMA loads, wgmma
tiles of 128×64×64 and the chunk copied by TMA stores out of the loaded
tiles) and the first form for the rest (`wmma` tiles of 64×64×32, SIMT for
fp32). `fused_plan` mirrors the launch's grid.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from tpu_matmul_bench_torch.ops import _build
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops.cuda_ring import check_shards
from tpu_matmul_bench_torch.parallel.mesh import COLS, Mesh, Sharded
from tpu_matmul_bench_torch.utils.metrics import matmul_out_dtype

# Launches of the fused kernel, counted where each happens (one a call, on
# the card only), and by route.
FUSED_RING_LAUNCHES = 0
FUSED_LAUNCHES_BY_ROUTE = dict.fromkeys(cm.ROUTES, 0)
# Output tile (bm, bn, bk) of each form: the wgmma form's fills the card in
# one wave at the cap (2048² bf16 over 4 ranks: 32 tiles a rank a step).
FUSED_TILES = {"wgmma": (128, 64, 64), "wmma": (64, 64, 32), "simt": (64, 64, 16)}
# The most ranks one launch takes: the size of the pointer arrays in
# `_RingArgs` (TMB_FUSED_MAX_RANKS in csrc/ring_fused.cu).
FUSED_MAX_RANKS = 8
_INT_MAX = 2**31 - 1

_Pointers = ctypes.c_void_p * FUSED_MAX_RANKS


class _RingArgs(ctypes.Structure):
    """`TmbRingArgs` of csrc/ring_fused.cu: every rank's pointers and the
    shapes."""

    _fields_ = [("x", _Pointers), ("w", _Pointers), ("y", _Pointers),
                ("slots", _Pointers), ("ranks", ctypes.c_int),
                ("mshard", ctypes.c_int), ("k", ctypes.c_int),
                ("nshard", ctypes.c_int)]


def fused_route(dtype: torch.dtype, k: int, nshard: int, pointers: Sequence[int]) -> str:
    """The form of K6 for these shards (csrc/ring_fused.cu refuses a
    `wgmma` request that breaks the rule): `wgmma` for bf16 and f16 whose
    every X shard, slot and W shard pointer is 16-byte aligned and whose
    rows (k elements of X, nshard of W) are whole 16-byte units, with k ≥ 1;
    else `simt` for fp32 and `wmma` for the others, the first form."""
    if dtype not in (torch.bfloat16, torch.float16):
        return "simt" if dtype == torch.float32 else "wmma"
    item = 2
    if (k < 1 or k * item % 16 or nshard * item % 16
            or any(ptr % 16 for ptr in pointers)):
        return "wmma"
    return "wgmma"


def fused_plan(route: str, ranks: int, mshard: int, nshard: int, sms: int,
               per_sm: int) -> dict[str, int]:
    """The launch's grid, as csrc/ring_fused.cu `grid_share` sizes it: the
    form's output tiles a rank has at each step, and as many blocks as the
    card holds at once (`sms` × `per_sm` resident blocks), an equal share a
    rank and no more than its tiles. `per_rank` 0 means the card cannot hold
    one block a rank, and the runtime refuses the launch."""
    bm, bn, _ = FUSED_TILES[route]
    tiles = -(-mshard // bm) * -(-nshard // bn)
    per_rank = min(per_sm * sms // ranks, tiles)
    return {"tiles_per_rank": tiles, "per_rank": per_rank,
            "grid_blocks": per_rank * ranks, "waves": -(-tiles // per_rank) if per_rank else 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load("ring_fused")
    if lib.tmb_ring_fused.argtypes is None:
        lib.tmb_ring_fused.argtypes = [ctypes.POINTER(_RingArgs), ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        lib.tmb_ring_fused.restype = ctypes.c_int
        lib.tmb_ring_fused_occupancy.argtypes = [ctypes.c_int, ctypes.c_int,
                                                 ctypes.POINTER(ctypes.c_int)]
        lib.tmb_ring_fused_occupancy.restype = ctypes.c_int
        lib.tmb_ring_fused_max_ranks.argtypes = []
        lib.tmb_ring_fused_max_ranks.restype = ctypes.c_int
        lib.tmb_ring_fused_error_string.argtypes = [ctypes.c_int]
        lib.tmb_ring_fused_error_string.restype = ctypes.c_char_p
        built = lib.tmb_ring_fused_max_ranks()
        if built != FUSED_MAX_RANKS:
            raise RuntimeError(f"csrc/ring_fused.cu takes {built} ranks a launch, "
                               f"ops/cuda_ring_fused.py {FUSED_MAX_RANKS}")
    return lib


class FusedRing:
    """K6 over `mesh`: `fn(x_shards, w_shards) -> y_shards`."""

    def __init__(self, mesh: Mesh):
        d = len(mesh.ranks)
        if d > FUSED_MAX_RANKS:
            raise ValueError(f"the fused ring takes at most {FUSED_MAX_RANKS} ranks "
                             f"in one launch, got {d}")
        if mesh.spans_processes:
            raise ValueError(
                f"the fused ring (cuda_ring) runs every rank in one cooperative "
                f"launch in one process; this world of {d} ranks spans processes "
                f"{mesh.processes} (run it in one process, or take cuda_ring_hbm)")
        if len(mesh.cards) > 1:
            raise ValueError(
                f"the fused ring runs every rank in one cooperative launch on one "
                f"card; this world of {d} ranks spans {len(mesh.cards)} cards (the "
                "form with flags in peer memory is ROADMAP B6's later work)")
        self.mesh = mesh
        self.grid_blocks = 0  # the last launch's grid
        self.route = None  # the last launch's form

    def __call__(self, x: Sequence[torch.Tensor], w: Sequence[torch.Tensor]) -> Sharded:
        check_shards(self.mesh, x, w, reduce_scatter=False)
        d = len(self.mesh.ranks)
        mshard, k = x[0].shape
        nshard = w[0].shape[1]
        out = matmul_out_dtype(x[0].dtype)
        y = [torch.empty((mshard * d, nshard), dtype=out, device=dev)
             for dev in self.mesh.devices]
        slots = [torch.empty((2, mshard, k), dtype=x[0].dtype, device=dev)
                 for dev in self.mesh.devices] if d > 1 else []
        if x[0].device.type == "cpu":
            self._steps(x, w, y, slots)
        else:
            self._launch(x, w, y, slots)
        return Sharded(y, COLS)

    @staticmethod
    def _steps(x, w, y, slots) -> None:
        """The kernel's step loop on the CPU: at step t rank r multiplies
        the chunk it holds (X_r, then slot t mod 2) into Y rows src·mshard,
        src = (r − t) mod D, and copies it into slot (t+1) mod 2 of rank
        r+1. Within a step no slot is both read and written, so the order
        of the ranks does not matter, as on the card."""
        d = len(x)
        mshard = x[0].shape[0]
        for t in range(d):
            for r in range(d):
                held = x[r] if t == 0 else slots[r][t % 2]
                src = (r - t) % d
                y[r][src * mshard:(src + 1) * mshard] = cm.matmul_plain(held, w[r])
                if t + 1 < d:
                    slots[(r + 1) % d][(t + 1) % 2].copy_(held)

    def _launch(self, x, w, y, slots) -> None:
        global FUSED_RING_LAUNCHES
        if x[0].dtype not in cm.OUT_DTYPES:  # the operand dtypes, as K1's
            raise TypeError(f"unsupported operand dtype {x[0].dtype}; the kernel "
                            f"takes {sorted(str(t) for t in cm.OUT_DTYPES)}")
        d = len(x)
        (mshard, k), nshard = x[0].shape, w[0].shape[1]
        if max(mshard * d, k, nshard) > _INT_MAX:
            raise ValueError(f"fused ring: shard shapes {tuple(x[0].shape)} and "
                             f"{tuple(w[0].shape)} exceed the kernel's int range")
        args = _RingArgs(ranks=d, mshard=mshard, k=k, nshard=nshard)
        for r in range(d):
            args.x[r], args.w[r], args.y[r] = x[r].data_ptr(), w[r].data_ptr(), y[r].data_ptr()
            args.slots[r] = slots[r].data_ptr() if slots else None
        route = fused_route(x[0].dtype, k, nshard,
                            [t.data_ptr() for t in (*x, *w, *slots)])
        lib = _lib()
        card = self.mesh.devices[0]
        blocks = ctypes.c_int(0)
        with torch.cuda.device(card):
            rc = lib.tmb_ring_fused(ctypes.byref(args), cm._CODES[x[0].dtype],
                                    cm.ROUTES.index(route),
                                    torch.cuda.current_stream(card).cuda_stream,
                                    ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"fused ring launch failed ({route}): "
                               f"{lib.tmb_ring_fused_error_string(rc).decode()} (code {rc})")
        self.grid_blocks, self.route = blocks.value, route
        FUSED_RING_LAUNCHES += 1
        FUSED_LAUNCHES_BY_ROUTE[route] += 1


def occupancy(dtype: torch.dtype, route: str, device: torch.device | str = "cuda") -> int:
    """Resident blocks per SM of K6's form `route` for operands of `dtype`,
    as the CUDA runtime computes it on `device`."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        rc = lib.tmb_ring_fused_occupancy(cm._CODES[dtype], cm.ROUTES.index(route),
                                          ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"fused ring occupancy ({route}, {dtype}) failed: "
                           f"{lib.tmb_ring_fused_error_string(rc).decode()} (code {rc})")
    return blocks.value


def ring_allgather_matmul(mesh: Mesh) -> FusedRing:
    """K6: `fn(x_shards, w_shards) -> y_shards` with x P("x", None), w
    P(None, "x"), y P(None, "x") (`ring_allgather_matmul`,
    `pallas_ring.py:121-174`), every rank on one card."""
    return FusedRing(mesh)
