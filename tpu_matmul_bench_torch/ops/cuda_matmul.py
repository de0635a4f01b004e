"""The hand-written Hopper GEMMs (`csrc/matmul.cu`): wrappers, plain
versions, tile rules and launch counters.

Counterpart of `tpu_matmul_bench/ops/pallas_matmul.py`: `cuda_matmul` is
`pallas_matmul` (the `--matmul-impl cuda` path, where the JAX package has
`--matmul-impl pallas`) and `cuda_matmul_ksplit` is `pallas_matmul_ksplit`.
Each launches its kernels for tensors on the card and runs its plain
version for tensors on the CPU, where there is no kernel to launch. For a
CUDA tensor it launches or raises: nothing falls back.
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
# REDUCE_LAUNCHES the split-K reduction.
LAUNCHES = 0
REDUCE_LAUNCHES = 0

# The tensor-core tiles (bm, bn, bk) instantiated in csrc/matmul.cu, ordered
# by size: volume, then output area, then bm.
TILES = ((64, 128, 32), (128, 64, 32), (128, 128, 32), (128, 128, 64),
         (128, 256, 32), (256, 128, 32))
DEFAULT_TILE = (128, 128, 32)
SIMT_TILE = (64, 64, 16)  # fp32 operands: the one SIMT tile
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


def _raise_on(rc: int, what: str, lib: ctypes.CDLL) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.tmb_error_string(rc).decode()} (code {rc})")


def cuda_matmul(a: torch.Tensor, b: torch.Tensor, *,
                out_dtype: torch.dtype | None = None,
                blocks: tuple[int, int, int] | None = None,
                grid_order: str = "mnk") -> torch.Tensor:
    """C = A @ B through the hand-written kernel.

    `out_dtype` overrides the store dtype: fp32 for bf16/f16 operands
    keeps the accumulator's precision. Default: the operand dtype, int32
    for int8. `blocks` is the requested (bm, bn, bk), resolved to an
    instantiated tile by `effective_blocks` (default DEFAULT_TILE).
    `grid_order` is the raster of output tiles: "mnk" (M slowest) or
    "nmk" (N slowest).
    """
    global LAUNCHES
    order = _check_grid_order(grid_order)
    out = _out_dtype(a, b, out_dtype)
    bm, bn, bk = _resolve(a, b, blocks)
    if a.device.type == "cpu":
        return matmul_plain(a, b, out_dtype=out)
    _check_card_operands(a, b, "cuda_matmul")
    (m, k), n = a.shape, b.shape[1]
    c = torch.empty((m, n), dtype=out, device=a.device)
    lib = _lib(a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.tmb_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                            _ld(a), _ld(b), _CODES[a.dtype], _CODES[out],
                            bm, bn, bk, order, stream)
    _raise_on(rc, "matmul", lib)
    LAUNCHES += 1
    return c


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
    lib = _lib(a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.tmb_matmul_ksplit(a.data_ptr(), b.data_ptr(), ws.data_ptr(),
                                   m, n, k // s_eff, s_eff, _ld(a), _ld(b),
                                   _CODES[a.dtype], bm, bn, bk, order, stream)
        _raise_on(rc, "split-K matmul", lib)
        LAUNCHES += 1
        rc = lib.tmb_reduce_partials(ws.data_ptr(), c.data_ptr(), s_eff,
                                     m * n, _CODES[out], stream)
    _raise_on(rc, "split-K reduction", lib)
    REDUCE_LAUNCHES += 1
    return c


def occupancy(tile: tuple[int, int, int], dtype: torch.dtype = torch.bfloat16,
              device: torch.device | str = "cuda") -> int:
    """Resident blocks per SM of the tensor-core kernel at `tile` for
    operands of `dtype`, as the CUDA runtime computes it on `device`."""
    if dtype not in (torch.bfloat16, torch.float16, torch.int8):
        raise TypeError(f"{dtype} operands take no tensor-core tile")
    lib = _lib(torch.device(device))
    blocks = ctypes.c_int(0)
    _raise_on(lib.tmb_occupancy(_CODES[dtype], *tile, ctypes.byref(blocks)),
              "occupancy", lib)
    return blocks.value


_INITIALIZED: set[int] = set()


def _lib(device: torch.device) -> ctypes.CDLL:
    """The kernel library, with its argument types set and `tmb_init` run
    once for `device` (the first call on a device must not be inside a
    CUDA-graph capture; the timing protocols make an eager call first)."""
    lib = _build.load("matmul")
    if lib.tmb_matmul.argtypes is None:
        i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        lib.tmb_matmul.argtypes = [p, p, p] + [i] * 11 + [p]
        lib.tmb_matmul_ksplit.argtypes = [p, p, p] + [i] * 11 + [p]
        lib.tmb_reduce_partials.argtypes = [p, p, i, ll, i, p]
        lib.tmb_occupancy.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.tmb_init.argtypes = []
        for fn in (lib.tmb_matmul, lib.tmb_matmul_ksplit, lib.tmb_reduce_partials,
                   lib.tmb_init, lib.tmb_occupancy):
            fn.restype = i
        lib.tmb_error_string.argtypes = [i]
        lib.tmb_error_string.restype = ctypes.c_char_p
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _INITIALIZED:
        with torch.cuda.device(index):
            _raise_on(lib.tmb_init(), "init", lib)
        _INITIALIZED.add(index)
    return lib
