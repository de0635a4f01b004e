"""The hand-written Hopper GEMM (`csrc/matmul.cu`): wrapper, plain version
and launch counter.

Counterpart of `tpu_matmul_bench/ops/pallas_matmul.py` `pallas_matmul`,
the `--matmul-impl pallas` path of the JAX package; here it is the
`--matmul-impl cuda` path. `cuda_matmul` launches the kernel for tensors on
the card and runs `matmul_plain` for tensors on the CPU, where there is no
kernel to launch. For a CUDA tensor it launches or raises: nothing falls
back.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_matmul_bench_torch.ops import _build
from tpu_matmul_bench_torch.utils.metrics import is_integer_dtype, matmul_out_dtype

# Kernel launches made by `cuda_matmul`, counted where each launch happens
# (a CUDA-graph replay re-runs captured launches without counting them).
LAUNCHES = 0

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


def cuda_matmul(a: torch.Tensor, b: torch.Tensor, *,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = A @ B through the hand-written kernel.

    `out_dtype` overrides the store dtype: fp32 for bf16/f16 operands
    keeps the accumulator's precision (for partial sums that are added up
    before one downcast). Default: the operand dtype, int32 for int8.
    """
    global LAUNCHES
    out = _out_dtype(a, b, out_dtype)
    if a.device.type == "cpu":
        return matmul_plain(a, b, out_dtype=out)
    if a.device.type != "cuda":
        raise ValueError(f"cuda_matmul takes CUDA or CPU tensors, not {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("cuda_matmul takes contiguous row-major operands")
    (m, k), n = a.shape, b.shape[1]
    if max(m, n, k) > _INT_MAX:
        raise ValueError(f"dimensions {m}x{k}x{n} exceed the kernel's int range")
    lib = _lib()
    c = torch.empty((m, n), dtype=out, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.tmb_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                            _CODES[a.dtype], _CODES[out], stream)
    if rc != 0:
        raise RuntimeError(f"matmul kernel launch failed: "
                           f"{lib.tmb_error_string(rc).decode()} (code {rc})")
    LAUNCHES += 1
    return c


def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul")
    if lib.tmb_matmul.argtypes is None:
        lib.tmb_matmul.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
        lib.tmb_matmul.restype = ctypes.c_int
        lib.tmb_error_string.argtypes = [ctypes.c_int]
        lib.tmb_error_string.restype = ctypes.c_char_p
    return lib
