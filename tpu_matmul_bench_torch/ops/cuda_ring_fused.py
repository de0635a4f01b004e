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
# the card only).
FUSED_RING_LAUNCHES = 0
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


def _lib() -> ctypes.CDLL:
    lib = _build.load("ring_fused")
    if lib.tmb_ring_fused.argtypes is None:
        lib.tmb_ring_fused.argtypes = [ctypes.POINTER(_RingArgs), ctypes.c_int,
                                       ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        lib.tmb_ring_fused.restype = ctypes.c_int
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
        if len(mesh.cards) > 1:
            raise ValueError(
                f"the fused ring runs every rank in one cooperative launch on one "
                f"card; this world of {d} ranks spans {len(mesh.cards)} cards (the "
                "form with flags in peer memory is ROADMAP B6's later work)")
        self.mesh = mesh
        self.grid_blocks = 0  # the last launch's grid

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
        lib = _lib()
        card = self.mesh.devices[0]
        blocks = ctypes.c_int(0)
        with torch.cuda.device(card):
            rc = lib.tmb_ring_fused(ctypes.byref(args), cm._CODES[x[0].dtype],
                                    torch.cuda.current_stream(card).cuda_stream,
                                    ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError("fused ring launch failed: "
                               f"{lib.tmb_ring_fused_error_string(rc).decode()} (code {rc})")
        self.grid_blocks = blocks.value
        FUSED_RING_LAUNCHES += 1


def ring_allgather_matmul(mesh: Mesh) -> FusedRing:
    """K6: `fn(x_shards, w_shards) -> y_shards` with x P("x", None), w
    P(None, "x"), y P(None, "x") (`ring_allgather_matmul`,
    `pallas_ring.py:121-174`), every rank on one card."""
    return FusedRing(mesh)
