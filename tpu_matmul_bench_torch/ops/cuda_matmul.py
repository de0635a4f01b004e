"""The hand-written Hopper GEMMs (`csrc/matmul.cu`): wrappers, plain
versions, tile rules and launch counters.

Counterpart of `tpu_matmul_bench/ops/pallas_matmul.py`: `cuda_matmul` is
`pallas_matmul` (the `--matmul-impl cuda` path, where the JAX package has
`--matmul-impl pallas`) and `cuda_matmul_ksplit` is `pallas_matmul_ksplit`.
`cuda_matmul_acc` is the reduce-scatter ring's pickup, `_rs_acc_kernel` of
`tpu_matmul_bench/ops/pallas_ring_rs_hbm.py`, and `cuda_matmul_rs` the
reduce-scatter rings' step product, which takes the persistent pickup GEMM
of `csrc/ring_rs.cu` where it can; `cuda_matmul_ag` is the all-gather
rings' step product, the same persistent GEMM in its forwarding mode, which
also copies the chunk it loads into the reader's receive slot. Each
launches its kernels for
tensors on the card and runs its plain version for tensors on the CPU,
where there is no kernel to launch. For a CUDA tensor it launches or
raises: nothing falls back.

Each product takes one of three routes, chosen by `gemm_route` from the
operands alone before the launch: `wgmma` (TMA, wgmma and an mbarrier
pipeline; bf16 and f16 that TMA can describe), `wmma` (int8, and bf16/f16
that TMA cannot describe) or `simt` (fp32). A reduce-scatter step's product
may take a fourth, `wgmma_persistent` (`step_route`: the persistent GEMM
with a TMA-store epilogue, which an all-gather step's product also takes to
forward its chunk). A route that fails raises; no other route
is tried.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_matmul_bench_torch.ops import _build
from tpu_matmul_bench_torch.utils.metrics import (
    as_dtype,
    is_integer_dtype,
    matmul_acc_dtype,
    matmul_out_dtype,
)

# Kernel launches, counted where each launch happens (a CUDA-graph replay
# re-runs captured launches without counting them): LAUNCHES counts the GEMM
# kernel (one per `cuda_matmul`, one per split `cuda_matmul_ksplit`),
# REDUCE_LAUNCHES the split-K reduction, ACC_LAUNCHES the pickup kernel,
# RS_LAUNCHES the persistent pickup GEMM of csrc/ring_rs.cu (tmb_rs_step),
# AG_LAUNCHES the same GEMM as an all-gather step (tmb_ag_step, forwarding
# or not).
LAUNCHES = 0
REDUCE_LAUNCHES = 0
ACC_LAUNCHES = 0
RS_LAUNCHES = 0
AG_LAUNCHES = 0
# The GEMM kernels' launches (those of LAUNCHES, ACC_LAUNCHES, RS_LAUNCHES
# and AG_LAUNCHES) by route: Route codes 0, 1, 2 of csrc/matmul.cu, then the
# persistent GEMM, whose entry points (csrc/ring_rs.cu tmb_rs_step and
# tmb_ag_step) are its route.
ROUTES = ("simt", "wmma", "wgmma", "wgmma_persistent")
LAUNCHES_BY_ROUTE = dict.fromkeys(ROUTES, 0)

# The tensor-core tiles (bm, bn, bk) instantiated in csrc/matmul.cu on both
# tensor-core routes, ordered by size: volume, then output area, then bm.
TILES = ((64, 128, 32), (128, 64, 32), (128, 128, 32), (128, 128, 64),
         (128, 256, 32), (256, 128, 32), (128, 256, 64))
# the fastest tile of the wgmma route at bf16 16384^3 on an H100 (PERF.md);
# 128x128x32 before it, on the wmma route
DEFAULT_TILE = (128, 256, 64)
SIMT_TILE = (64, 64, 16)  # fp32 operands: the one SIMT tile
# the tiles of the persistent pickup GEMM (TMB_RS_TILES of csrc/ring_rs.cu)
PERSISTENT_TILES = ((128, 256, 64),)
GRID_ORDERS = ("mnk", "nmk")

# dtype codes of csrc/matmul.cu
_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
          torch.int8: 3, torch.int32: 4}
# operand dtype -> the output dtypes the kernel can store
OUT_DTYPES = {
    torch.bfloat16: (torch.bfloat16, torch.float32),
    torch.float16: (torch.float16, torch.float32),
    torch.float32: (torch.float32,),
    torch.int8: (torch.int32,),
}
_INT_MAX = 2**31 - 1


def effective_blocks(m: int, n: int, k: int, bm: int, bn: int, bk: int,
                     dtype: torch.dtype | str) -> tuple[int, int, int]:
    """The tile the kernel runs for a requested (bm, bn, bk) on an
    m×k·k×n problem of `dtype`.

    fp32 always runs the SIMT tile. Otherwise the result is the last tile
    of TILES with every dimension ≤ the request, or the smallest tile,
    TILES[0], when none is. Unlike the Pallas kernel's rule, the problem's
    size does not enter: the kernel masks ragged edges, so every tile runs
    at every shape (m, n, k are taken for the same call as the JAX
    package's `effective_blocks`). Tuners dedupe and label records on this,
    not on the request.
    """
    del m, n, k  # see above
    if min(bm, bn, bk) <= 0:
        raise ValueError(f"block sizes must be positive, got {(bm, bn, bk)}")
    if as_dtype(dtype) == torch.float32:
        return SIMT_TILE
    fits = [t for t in TILES if t[0] <= bm and t[1] <= bn and t[2] <= bk]
    return fits[-1] if fits else TILES[0]


def gemm_route(dtype: torch.dtype | str, m: int, n: int, k: int, lda: int,
               ldb: int, a_ptr: int, b_ptr: int, splits: int = 1) -> str:
    """The kernel route of one product (csrc/matmul.cu checks the same rule
    and refuses a `wgmma` request that breaks it).

    `wgmma` for bf16 and f16 operands that TMA can describe: both base
    pointers 16-byte aligned, both row strides (`lda`, `ldb` elements) whole
    16-byte units, no empty dimension, and a split's K width `k` a multiple
    of 64 when `splits` > 1 (so no K step straddles two slabs). Other bf16
    and f16 operands, and int8, take `wmma` (8-bit wgmma wants B K-major;
    here B is row-major K x N); fp32 takes `simt`."""
    dtype = as_dtype(dtype)
    if dtype == torch.float32:
        return "simt"
    if dtype not in (torch.bfloat16, torch.float16):
        return "wmma"
    item = 2
    describable = (a_ptr % 16 == 0 and b_ptr % 16 == 0 and lda * item % 16 == 0
                   and ldb * item % 16 == 0)
    if not describable or min(m, n, k) < 1 or (splits > 1 and k % 64):
        return "wmma"
    return "wgmma"


# Shared memory a wgmma block may spend on its stages (kSmemBudget of
# csrc/hopper_tile.cuh), its stage cap, and the most a block may use; and
# what the persistent pickup may spend on its stages and its tile buffer
# together (kRsBudget of csrc/ring_rs.cu).
_WGMMA_STAGE_BUDGET, _WGMMA_MAX_STAGES, SMEM_PER_BLOCK = 200 * 1024, 5, 232448
_RS_BUDGET = 212 * 1024


def wgmma_plan(tile: tuple[int, int, int], persistent: bool = False) -> dict[str, int]:
    """The wgmma route's geometry for one tile, as `tmb::WgTile` in
    csrc/hopper_tile.cuh computes it: the two consumer warpgroups' split
    (along M when bm >= 128, else along N), each one's rows and columns
    (`wm`, `wn`; one wgmma is m64 x wn), its m64 wgmmas (`mi`), A's swizzle
    in bytes (one row of the A tile), the shared-memory stages and the
    block's dynamic shared memory (stages, 1 KB of alignment, barriers).

    `persistent`: the persistent pickup's plan (`RsTile` of
    csrc/ring_rs.cu) instead, whose tile buffer (`epilogue_bytes`: the
    bm x bn tile in 16-bit elements, for accin and the result) comes out
    of the stages' room, with two more barriers."""
    bm, bn, bk = tile
    wg_m = 2 if bm >= 128 else 1
    wm, wn = bm // wg_m, bn // (2 // wg_m)
    stage = bm * bk * 2 + (bn // 64) * bk * 128
    plan = {"wg_m": wg_m, "wg_n": 2 // wg_m, "wm": wm, "wn": wn, "mi": wm // 64,
            "a_swizzle": bk * 2, "stage_bytes": stage}
    if not persistent:
        stages = min(_WGMMA_MAX_STAGES, _WGMMA_STAGE_BUDGET // stage)
        return {**plan, "stages": stages, "smem_bytes": stages * stage + 1024 + 2 * stages * 8}
    epilogue = bm * bn * 2
    stages = min(_WGMMA_MAX_STAGES, (_RS_BUDGET - epilogue) // stage)
    return {**plan, "stages": stages, "epilogue_bytes": epilogue,
            "smem_bytes": stages * stage + epilogue + 1024 + (2 * stages + 2) * 8}


RASTER_GROUP = 8  # kGroup of csrc/hopper_tile.cuh


def raster(block: int, tm: int, tn: int, m_slow: bool) -> tuple[int, int]:
    """The output tile (m, n) of wgmma block `block` of a tm × tn grid of
    tiles (`tmb::raster`): groups of RASTER_GROUP tiles of the slow axis (M
    for grid order "mnk", N for "nmk"), and inside a group the fast axis's
    tiles in turn."""
    slow, fast = (tm, tn) if m_slow else (tn, tm)
    first = block // (RASTER_GROUP * fast) * RASTER_GROUP
    rows = min(slow - first, RASTER_GROUP)
    inside = block - first * fast
    s, f = first + inside % rows, inside // rows
    return (s, f) if m_slow else (f, s)


def persistent_tiles(block: int, grid: int, tm: int, tn: int,
                     m_slow: bool = True) -> list[tuple[int, int]]:
    """The output tiles (m, n) that persistent block `block` of a `grid`
    walks, in its order: tiles block, block + grid, ... of `raster`'s
    grouped order over tm × tn tiles."""
    return [raster(t, tm, tn, m_slow) for t in range(block, tm * tn, grid)]


def forwarded_boxes(mt: int, nt: int, tn: int, ktiles: int) -> list[tuple[int, int]]:
    """The A boxes (row tile, k-step) that output tile (mt, nt) of a grid
    tn tiles wide stores into the forwarding slot (csrc/ring_rs.cu's copier,
    over `ktiles` k-steps): box (mt, kt) goes with tile (mt, kt mod tn), so
    the tiles of a row store each box of their rows once between them."""
    return [(mt, kt) for kt in range(nt, ktiles, tn)]


def step_route(dtype: torch.dtype | str, m: int, n: int, k: int, lda: int, ldb: int,
               ldc: int, ldx: int | None, a_ptr: int, b_ptr: int, c_ptr: int,
               x_ptr: int | None, tile: tuple[int, int, int], forward: bool = False) -> str:
    """The route of one ring step's product dest = A·B, chosen before the
    launch. Its third operand X (absent where `ldx` and `x_ptr` are None) is
    accin, m×n and summed into dest at a reduce-scatter step after the
    first, or, with `forward`, the reader's receive slot, m×k, which an
    all-gather step but the last copies A into. csrc/ring_rs.cu's check
    (tmb_rs_check, tmb_ag_check) is the same rule and refuses what breaks it.

    `wgmma_persistent` when `gemm_route` gives `wgmma` for A and B, the
    resolved `tile` is one of PERSISTENT_TILES, each operand's rows are at
    least its width apart (A's and the slot's k, B's, dest's and accin's n),
    and TMA can describe dest and X too (16-byte aligned bases, rows `ldc`
    and `ldx` elements apart in whole 16-byte units). Otherwise `gemm_route`'s
    route: the pickup kernel takes the step (K1 at a first step), and an
    all-gather ring that cannot forward hops its chunks."""
    route = gemm_route(dtype, m, n, k, lda, ldb, a_ptr, b_ptr)
    results = [(c_ptr, ldc, n)] + ([] if x_ptr is None else [(x_ptr, ldx, k if forward else n)])
    if (route != "wgmma" or tuple(tile) not in PERSISTENT_TILES or lda < k or ldb < n
            or any(ptr % 16 or ld * 2 % 16 or ld < width for ptr, ld, width in results)):
        return route
    return "wgmma_persistent"


def effective_ksplit(k: int, splits: int) -> int:
    """The split count `cuda_matmul_ksplit` uses for a K dimension of `k`:
    `splits` when a 128-aligned equal split exists, else 1 (a single pass).
    The same rule as the JAX package's `effective_ksplit`, so both packages
    label the same runs alike."""
    if splits <= 1 or k % splits or (k // splits) % 128:
        return 1
    return int(splits)


def _check_grid_order(grid_order: str) -> int:
    if grid_order not in GRID_ORDERS:
        raise ValueError(f"unknown grid_order {grid_order!r} "
                         "(choose 'mnk' or 'nmk')")
    return GRID_ORDERS.index(grid_order)


def _out_dtype(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype | None) -> torch.dtype:
    """Check what the kernel and its plain version both take: two 2-D
    operands of one supported dtype on one device, with matching inner
    dimensions. Returns the output dtype."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} and {b.dtype}")
    if a.dtype not in OUT_DTYPES:
        raise TypeError(f"unsupported operand dtype {a.dtype}; the kernel "
                        f"takes {sorted(str(d) for d in OUT_DTYPES)}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} and {b.device}")
    out = matmul_out_dtype(a.dtype) if out_dtype is None else out_dtype
    if out not in OUT_DTYPES[a.dtype]:
        raise TypeError(f"{a.dtype} operands cannot store {out}; choose from "
                        f"{[str(d) for d in OUT_DTYPES[a.dtype]]}")
    return out


def _check_result_operand(x: torch.Tensor, name: str, a: torch.Tensor,
                          b: torch.Tensor, out: torch.dtype) -> None:
    """An m×n tensor of the output dtype beside the operands, with unit
    column stride and rows at least n apart (accin, or a given `out`)."""
    shape = (a.shape[0], b.shape[1])
    if tuple(x.shape) != shape or x.dtype != out or x.device != a.device:
        raise ValueError(f"{name} must be {shape} {out} on {a.device}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if (x.stride(1) != 1 and shape[1] > 1) or (x.stride(0) < shape[1] and shape[0] > 1):
        raise ValueError(f"{name} must have unit column stride and rows at "
                         f"least {shape[1]} apart, got strides {x.stride()}")


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: upcast, multiply, and
    downcast once. Floats multiply in fp32. int8 multiplies in int32 on the
    CPU and in float64 on the card, which has no integer matmul; float64 is
    exact here, since |sum| <= 64·k stays far below 2**53."""
    out = _out_dtype(a, b, out_dtype)
    if is_integer_dtype(a.dtype):
        wide = torch.int32 if a.device.type == "cpu" else torch.float64
        return (a.to(wide) @ b.to(wide)).to(out)
    return (a.float() @ b.float()).to(out)


def matmul_acc_plain(a: torch.Tensor, b: torch.Tensor, accin: torch.Tensor, *,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The plain version of the pickup kernel: `matmul_plain`'s product,
    plus accin, in the same wide dtype (fp32; int32 on the CPU and float64
    on the card for int8), then one downcast."""
    out = _out_dtype(a, b, out_dtype)
    _check_result_operand(accin, "accin", a, b, out)
    if is_integer_dtype(a.dtype):
        wide = torch.int32 if a.device.type == "cpu" else torch.float64
        return (a.to(wide) @ b.to(wide) + accin.to(wide)).to(out)
    return (a.float() @ b.float() + accin.float()).to(out)


def matmul_ksplit_plain(a: torch.Tensor, b: torch.Tensor, *,
                        splits: int = 2) -> torch.Tensor:
    """The plain version of the split-K: each K slab's partial in the
    accumulator dtype (`matmul_plain` with fp32, or int32 for int8, stores),
    summed in the order s = 0..S-1, then one downcast. A single pass when
    `effective_ksplit` gives 1."""
    out = _out_dtype(a, b, None)
    s_eff = effective_ksplit(a.shape[1], splits)
    if s_eff == 1:
        return matmul_plain(a, b)
    kc = a.shape[1] // s_eff
    acc_dtype = matmul_acc_dtype(out)
    acc = None
    for s in range(s_eff):
        part = matmul_plain(a[:, s * kc:(s + 1) * kc], b[s * kc:(s + 1) * kc],
                            out_dtype=acc_dtype)
        acc = part if acc is None else acc + part
    return acc.to(out)


def _resolve(a: torch.Tensor, b: torch.Tensor,
             blocks: tuple[int, int, int] | None) -> tuple[int, int, int]:
    (m, k), n = a.shape, b.shape[1]
    return effective_blocks(m, n, k, *(blocks or DEFAULT_TILE), a.dtype)


def _check_card_operands(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    """CUDA operands with unit column stride (rows may be strided: a K slab
    is a view) and dimensions within the kernel's int range."""
    if a.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA or CPU tensors, not {a.device}")
    for x in (a, b):
        if ((x.stride(1) != 1 and x.shape[1] > 1)
                or (x.stride(0) < x.shape[1] and x.shape[0] > 1)):
            raise ValueError(f"{name} takes row-major operands (unit column "
                             f"stride, rows apart), got strides {x.stride()}")
    if max(*a.shape, b.shape[1], a.stride(0), b.stride(0)) > _INT_MAX:
        raise ValueError(f"{name}: dimensions {tuple(a.shape)}x{b.shape[1]} "
                         "exceed the kernel's int range")


def _ld(x: torch.Tensor) -> int:
    """Row stride in elements, at least the row length."""
    return max(x.stride(0), x.shape[1])


def _raise_on(rc: int, what: str, lib: ctypes.CDLL,
              strerror: str = "tmb_error_string") -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{getattr(lib, strerror)(rc).decode()} (code {rc})")


def _route(a: torch.Tensor, b: torch.Tensor, k: int, splits: int = 1) -> str:
    return gemm_route(a.dtype, a.shape[0], b.shape[1], k, _ld(a), _ld(b),
                      a.data_ptr(), b.data_ptr(), splits)


def launch_plan(a: torch.Tensor, b: torch.Tensor,
                blocks: tuple[int, int, int] | None = None,
                splits: int = 1) -> tuple[str, tuple[int, int, int], int]:
    """(route, tile, splits) of the GEMM launch that `cuda_matmul` (with
    `splits` > 1, `cuda_matmul_ksplit`) makes for these operands: pure
    functions of their dtype, shapes, row strides and pointers, so the
    same on the CPU, where the wrappers run their plain versions. The cost
    books (`obs/attribution.py`) describe this launch."""
    s = effective_ksplit(a.shape[1], splits)
    return _route(a, b, a.shape[1] // s, s), _resolve(a, b, blocks), s


def _count(route: str) -> None:
    LAUNCHES_BY_ROUTE[route] += 1


def cuda_matmul(a: torch.Tensor, b: torch.Tensor, *,
                out_dtype: torch.dtype | None = None,
                blocks: tuple[int, int, int] | None = None,
                grid_order: str = "mnk",
                out: torch.Tensor | None = None) -> torch.Tensor:
    """C = A @ B through the hand-written kernel.

    `out_dtype` overrides the store dtype: fp32 for bf16/f16 operands
    keeps the accumulator's precision. Default: the operand dtype, int32
    for int8. `blocks` is the requested (bm, bn, bk), resolved to an
    instantiated tile by `effective_blocks` (default DEFAULT_TILE).
    `grid_order` is the raster of output tiles: "mnk" (M slowest) or
    "nmk" (N slowest). `out`, a contiguous m×n tensor of the output dtype,
    receives C in place of a new tensor (the all-gather ring writes each
    product straight into its row block of Y).
    """
    global LAUNCHES
    order = _check_grid_order(grid_order)
    dtype = _out_dtype(a, b, out_dtype)
    bm, bn, bk = _resolve(a, b, blocks)
    if out is not None:
        _check_result_operand(out, "out", a, b, dtype)
        if not out.is_contiguous():
            raise ValueError(f"out must be contiguous, got strides {out.stride()}")
    if a.device.type == "cpu":
        c = matmul_plain(a, b, out_dtype=dtype)
        return c if out is None else out.copy_(c)
    _check_card_operands(a, b, "cuda_matmul")
    (m, k), n = a.shape, b.shape[1]
    c = torch.empty((m, n), dtype=dtype, device=a.device) if out is None else out
    route = _route(a, b, k)
    lib = _lib(a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.tmb_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                            _ld(a), _ld(b), _CODES[a.dtype], _CODES[dtype],
                            bm, bn, bk, order, ROUTES.index(route), stream)
    _raise_on(rc, f"matmul ({route})", lib)
    LAUNCHES += 1
    _count(route)
    return c


def cuda_matmul_acc(a: torch.Tensor, b: torch.Tensor, accin: torch.Tensor,
                    out: torch.Tensor | None = None, *,
                    out_dtype: torch.dtype | None = None,
                    blocks: tuple[int, int, int] | None = None,
                    grid_order: str = "mnk") -> torch.Tensor:
    """C = A @ B + accin through the pickup kernel: the product in fp32
    (int32 for int8) plus accin, rounded once to the output dtype.

    accin and `out` (a new tensor when None) are m×n in the output dtype
    (`out_dtype`, default as `cuda_matmul`), with unit column stride and
    rows that may be further apart than n. The other arguments are
    `cuda_matmul`'s. Counterpart of `_rs_acc_kernel`
    (`tpu_matmul_bench/ops/pallas_ring_rs_hbm.py:52-66`).
    """
    global ACC_LAUNCHES
    order = _check_grid_order(grid_order)
    dtype = _out_dtype(a, b, out_dtype)
    bm, bn, bk = _resolve(a, b, blocks)
    _check_result_operand(accin, "accin", a, b, dtype)
    if out is not None:
        _check_result_operand(out, "out", a, b, dtype)
    if a.device.type == "cpu":
        c = matmul_acc_plain(a, b, accin, out_dtype=dtype)
        return c if out is None else out.copy_(c)
    _check_card_operands(a, b, "cuda_matmul_acc")
    (m, k), n = a.shape, b.shape[1]
    c = torch.empty((m, n), dtype=dtype, device=a.device) if out is None else out
    if max(_ld(accin), _ld(c)) > _INT_MAX:
        raise ValueError("cuda_matmul_acc: a row stride exceeds the kernel's int range")
    route = _route(a, b, k)
    lib = _lib(a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.tmb_matmul_acc(a.data_ptr(), b.data_ptr(), accin.data_ptr(),
                                c.data_ptr(), m, n, k, _ld(a), _ld(b), _ld(accin),
                                _ld(c), _CODES[a.dtype], _CODES[dtype],
                                bm, bn, bk, order, ROUTES.index(route), stream)
    _raise_on(rc, f"pickup matmul ({route})", lib)
    ACC_LAUNCHES += 1
    _count(route)
    return c


def cuda_matmul_rs(a: torch.Tensor, b: torch.Tensor, accin: torch.Tensor | None,
                   out: torch.Tensor, *, blocks: tuple[int, int, int] | None = None,
                   grid_order: str = "mnk") -> torch.Tensor:
    """One reduce-scatter ring step's product: out = A @ B + accin, or
    out = A @ B at a ring's first step (accin None), summed in fp32 (int32
    for int8) and rounded once to the operand dtype (int32 for int8).

    `out` (the reader's receive slot, or the home rows of Y) and accin are
    m×n, with unit column stride and rows that may be further apart than n.
    For CUDA tensors `step_route` decides before the launch: the persistent
    pickup GEMM of csrc/ring_rs.cu (RS_LAUNCHES, route `wgmma_persistent`),
    or else `cuda_matmul_acc` (`cuda_matmul` without accin, which takes a
    contiguous `out`) on its own route. The other arguments are
    `cuda_matmul`'s."""
    global RS_LAUNCHES
    order = _check_grid_order(grid_order)
    dtype = _out_dtype(a, b, None)
    tile = _resolve(a, b, blocks)
    _check_result_operand(out, "out", a, b, dtype)
    if accin is not None:
        _check_result_operand(accin, "accin", a, b, dtype)
    if a.device.type == "cpu":
        c = matmul_plain(a, b) if accin is None else matmul_acc_plain(a, b, accin)
        return out.copy_(c)
    _check_card_operands(a, b, "cuda_matmul_rs")
    (m, k), n = a.shape, b.shape[1]
    if max(_ld(out), 0 if accin is None else _ld(accin)) > _INT_MAX:
        raise ValueError("cuda_matmul_rs: a row stride exceeds the kernel's int range")
    route = step_route(a.dtype, m, n, k, _ld(a), _ld(b), _ld(out),
                       None if accin is None else _ld(accin), a.data_ptr(), b.data_ptr(),
                       out.data_ptr(), None if accin is None else accin.data_ptr(), tile)
    if route != "wgmma_persistent":
        if accin is None:
            return cuda_matmul(a, b, blocks=blocks, grid_order=grid_order, out=out)
        return cuda_matmul_acc(a, b, accin, out, blocks=blocks, grid_order=grid_order)
    lib = _rs_lib(a.device)
    grid = ctypes.c_int(0)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.tmb_rs_step(a.data_ptr(), b.data_ptr(),
                             None if accin is None else accin.data_ptr(), out.data_ptr(),
                             m, n, k, _ld(a), _ld(b), 0 if accin is None else _ld(accin),
                             _ld(out), _CODES[a.dtype], *tile, order, stream,
                             ctypes.byref(grid))
    _raise_on(rc, "persistent pickup matmul", lib, "tmb_rs_error_string")
    RS_LAUNCHES += 1
    _count(route)
    return out


def _check_forward_slot(fwd: torch.Tensor, a: torch.Tensor) -> None:
    """The forwarding slot: A's shape, dtype and device, with unit column
    stride and rows at least k apart."""
    if tuple(fwd.shape) != tuple(a.shape) or fwd.dtype != a.dtype or fwd.device != a.device:
        raise ValueError(f"fwd must be {tuple(a.shape)} {a.dtype} on {a.device}, got "
                         f"{tuple(fwd.shape)} {fwd.dtype} on {fwd.device}")
    if ((fwd.stride(1) != 1 and fwd.shape[1] > 1)
            or (fwd.stride(0) < fwd.shape[1] and fwd.shape[0] > 1)):
        raise ValueError(f"fwd must have unit column stride and rows at least "
                         f"{fwd.shape[1]} apart, got strides {fwd.stride()}")


def ag_forwards(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, fwd: torch.Tensor,
                blocks: tuple[int, int, int] | None = None) -> bool:
    """Whether `cuda_matmul_ag(a, b, out, fwd)` forwards A in its own launch
    (`step_route` gives `wgmma_persistent` for these tensors). A ring call
    on one card forwards where every step does, and hops its chunks where
    one does not."""
    (m, k), n = a.shape, b.shape[1]
    return step_route(a.dtype, m, n, k, _ld(a), _ld(b), _ld(out), _ld(fwd), a.data_ptr(),
                      b.data_ptr(), out.data_ptr(), fwd.data_ptr(), _resolve(a, b, blocks),
                      forward=True) == "wgmma_persistent"


def cuda_matmul_ag(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                   fwd: torch.Tensor | None = None, *,
                   blocks: tuple[int, int, int] | None = None,
                   grid_order: str = "mnk") -> torch.Tensor:
    """One all-gather ring step's product: out = A @ B, summed in fp32
    (int32 for int8) and rounded once to the operand dtype (int32 for int8);
    with `fwd` (the reader's receive slot, A's shape and dtype), A is also
    copied into fwd unchanged.

    `out` (Y's rows of the chunk) is m×n and `fwd` m×k, each with unit
    column stride and rows that may be further apart than their width. For
    CUDA tensors `step_route` decides before the launch: the persistent GEMM
    of csrc/ring_rs.cu in its forwarding mode (AG_LAUNCHES, route
    `wgmma_persistent`), or else, without `fwd`, `cuda_matmul` on its own
    route; a `fwd` that route cannot forward raises (`ag_forwards` tells
    the caller beforehand). The other arguments are `cuda_matmul`'s."""
    global AG_LAUNCHES
    order = _check_grid_order(grid_order)
    dtype = _out_dtype(a, b, None)
    tile = _resolve(a, b, blocks)
    _check_result_operand(out, "out", a, b, dtype)
    if fwd is not None:
        _check_forward_slot(fwd, a)
    if a.device.type == "cpu":
        out.copy_(matmul_plain(a, b))
        if fwd is not None:
            fwd.copy_(a)
        return out
    _check_card_operands(a, b, "cuda_matmul_ag")
    (m, k), n = a.shape, b.shape[1]
    if max(_ld(out), 0 if fwd is None else _ld(fwd)) > _INT_MAX:
        raise ValueError("cuda_matmul_ag: a row stride exceeds the kernel's int range")
    route = step_route(a.dtype, m, n, k, _ld(a), _ld(b), _ld(out),
                       None if fwd is None else _ld(fwd), a.data_ptr(), b.data_ptr(),
                       out.data_ptr(), None if fwd is None else fwd.data_ptr(), tile,
                       forward=True)
    if route != "wgmma_persistent":
        if fwd is not None:
            raise ValueError(f"cuda_matmul_ag: the {route} route does not forward; "
                             "run cuda_matmul and copy the chunk (ag_forwards)")
        return cuda_matmul(a, b, blocks=blocks, grid_order=grid_order, out=out)
    lib = _rs_lib(a.device)
    grid = ctypes.c_int(0)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.tmb_ag_step(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             None if fwd is None else fwd.data_ptr(), m, n, k, _ld(a),
                             _ld(b), _ld(out), 0 if fwd is None else _ld(fwd),
                             _CODES[a.dtype], *tile, order, stream, ctypes.byref(grid))
    _raise_on(rc, "all-gather step matmul", lib, "tmb_rs_error_string")
    AG_LAUNCHES += 1
    _count(route)
    return out


def step_check(dtype: torch.dtype, m: int, n: int, k: int, lda: int, ldb: int, ldc: int,
               ldx: int | None, a_ptr: int, b_ptr: int, c_ptr: int, x_ptr: int | None,
               tile: tuple[int, int, int], forward: bool = False,
               device: torch.device | str = "cuda") -> int:
    """What csrc/ring_rs.cu says of a ring step's operands without launching
    (tmb_rs_check, or tmb_ag_check with `forward`, X then the slot): 0 where
    it takes them, else the cudaError_t code it refuses them with.
    `step_route` gives `wgmma_persistent` exactly where this is 0
    (`chip_smoke.py` holds the two together on the card)."""
    lib = _rs_lib(torch.device(device))
    ldx, code = 0 if ldx is None else ldx, _CODES.get(dtype, -1)
    if forward:
        return lib.tmb_ag_check(a_ptr, b_ptr, c_ptr, x_ptr, m, n, k, lda, ldb, ldc, ldx,
                                code, *tile)
    return lib.tmb_rs_check(a_ptr, b_ptr, x_ptr, c_ptr, m, n, k, lda, ldb, ldx, ldc,
                            code, *tile)


def cuda_matmul_ksplit(a: torch.Tensor, b: torch.Tensor, *, splits: int = 2,
                       blocks: tuple[int, int, int] | None = None,
                       grid_order: str = "mnk") -> torch.Tensor:
    """C = Σ_s A[:, K_s]·B[K_s, :] through the split-K kernels: one GEMM
    launch writes the S partials, in fp32 (int32 for int8), into a
    workspace [S, m, n]; the reduction kernel adds them in order and
    stores C once in the output dtype. When `effective_ksplit(k, splits)`
    is 1 this is `cuda_matmul`: one pass, no workspace, no reduction.

    The workspace comes from PyTorch's caching allocator on the operands'
    device, so the pair can be captured in a CUDA graph.
    """
    global LAUNCHES, REDUCE_LAUNCHES
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    order = _check_grid_order(grid_order)
    out = _out_dtype(a, b, None)
    s_eff = effective_ksplit(a.shape[1], splits)
    if s_eff == 1:
        return cuda_matmul(a, b, blocks=blocks, grid_order=grid_order)
    bm, bn, bk = _resolve(a, b, blocks)
    if a.device.type == "cpu":
        return matmul_ksplit_plain(a, b, splits=s_eff)
    _check_card_operands(a, b, "cuda_matmul_ksplit")
    (m, k), n = a.shape, b.shape[1]
    ws = torch.empty((s_eff, m, n), dtype=matmul_acc_dtype(out), device=a.device)
    c = torch.empty((m, n), dtype=out, device=a.device)
    route = _route(a, b, k // s_eff, s_eff)
    lib = _lib(a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.tmb_matmul_ksplit(a.data_ptr(), b.data_ptr(), ws.data_ptr(),
                                   m, n, k // s_eff, s_eff, _ld(a), _ld(b),
                                   _CODES[a.dtype], bm, bn, bk, order,
                                   ROUTES.index(route), stream)
        _raise_on(rc, f"split-K matmul ({route})", lib)
        LAUNCHES += 1
        _count(route)
        rc = lib.tmb_reduce_partials(ws.data_ptr(), c.data_ptr(), s_eff,
                                     m * n, _CODES[out], stream)
    _raise_on(rc, "split-K reduction", lib)
    REDUCE_LAUNCHES += 1
    return c


def occupancy(tile: tuple[int, int, int], dtype: torch.dtype = torch.bfloat16,
              device: torch.device | str = "cuda", route: str = "wmma",
              forward: bool = False) -> int:
    """Resident blocks per SM of the tensor-core kernel of `route` at `tile`
    for operands of `dtype`, as the CUDA runtime computes it on `device`;
    `forward`: the persistent GEMM's forwarding instantiation."""
    if route not in ("wmma", "wgmma", "wgmma_persistent") or dtype not in (
            (torch.bfloat16, torch.float16) if route != "wmma"
            else (torch.bfloat16, torch.float16, torch.int8)):
        raise TypeError(f"{dtype} operands take no {route} tile")
    if forward and route != "wgmma_persistent":
        raise ValueError(f"the {route} route does not forward")
    blocks = ctypes.c_int(0)
    device = torch.device(device)
    if route == "wgmma_persistent":
        lib = _rs_lib(device)
        fn = lib.tmb_ag_occupancy if forward else lib.tmb_rs_occupancy
        with torch.cuda.device(device):
            rc = fn(_CODES[dtype], *tile, ctypes.byref(blocks))
        _raise_on(rc, "occupancy", lib, "tmb_rs_error_string")
        return blocks.value
    lib = _lib(device)
    _raise_on(lib.tmb_occupancy(_CODES[dtype], ROUTES.index(route), *tile,
                                ctypes.byref(blocks)), "occupancy", lib)
    return blocks.value


_INITIALIZED: set[int] = set()


def _lib(device: torch.device) -> ctypes.CDLL:
    """The kernel library, with its argument types set and `tmb_init` run
    once for `device` (the first call on a device must not be inside a
    CUDA-graph capture; the timing protocols make an eager call first)."""
    lib = _build.load("matmul")
    if lib.tmb_matmul.argtypes is None:
        i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        lib.tmb_matmul.argtypes = [p, p, p] + [i] * 12 + [p]
        lib.tmb_matmul_ksplit.argtypes = [p, p, p] + [i] * 12 + [p]
        lib.tmb_matmul_acc.argtypes = [p, p, p, p] + [i] * 14 + [p]
        lib.tmb_reduce_partials.argtypes = [p, p, i, ll, i, p]
        lib.tmb_occupancy.argtypes = [i] * 5 + [ctypes.POINTER(ctypes.c_int)]
        lib.tmb_init.argtypes = []
        for fn in (lib.tmb_matmul, lib.tmb_matmul_ksplit, lib.tmb_matmul_acc,
                   lib.tmb_reduce_partials, lib.tmb_init, lib.tmb_occupancy):
            fn.restype = i
        lib.tmb_error_string.argtypes = [i]
        lib.tmb_error_string.restype = ctypes.c_char_p
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _INITIALIZED:
        with torch.cuda.device(index):
            _raise_on(lib.tmb_init(), "init", lib)
        _INITIALIZED.add(index)
    return lib


_RS_INITIALIZED: set[int] = set()


def _rs_lib(device: torch.device) -> ctypes.CDLL:
    """The persistent GEMM's library (csrc/ring_rs.cu), with its argument
    types set and `tmb_rs_init` run once for `device` (outside any CUDA-graph
    capture: the ring's first call is eager)."""
    lib = _build.load("ring_rs")
    if lib.tmb_rs_step.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        for step in (lib.tmb_rs_step, lib.tmb_ag_step):
            step.argtypes = [p, p, p, p] + [i] * 12 + [p, ctypes.POINTER(i)]
        for check in (lib.tmb_rs_check, lib.tmb_ag_check):
            check.argtypes = [p, p, p, p] + [i] * 11
        for occupancy_of in (lib.tmb_rs_occupancy, lib.tmb_ag_occupancy):
            occupancy_of.argtypes = [i] * 4 + [ctypes.POINTER(i)]
        lib.tmb_rs_init.argtypes = []
        for fn in (lib.tmb_rs_step, lib.tmb_ag_step, lib.tmb_rs_check, lib.tmb_ag_check,
                   lib.tmb_rs_occupancy, lib.tmb_ag_occupancy, lib.tmb_rs_init):
            fn.restype = i
        lib.tmb_rs_error_string.argtypes = [i]
        lib.tmb_rs_error_string.restype = ctypes.c_char_p
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _RS_INITIALIZED:
        with torch.cuda.device(index):
            _raise_on(lib.tmb_rs_init(), "persistent pickup init", lib, "tmb_rs_error_string")
        _RS_INITIALIZED.add(index)
    return lib
