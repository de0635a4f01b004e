"""Dense matmul ops — the hot path of the benchmark.

Port of `tpu_matmul_bench/ops/matmul.py`. Three implementations:
- `torch`: the library product, `torch.matmul` for floats and
  `torch._int_mm` for int8 on the card (the counterpart of `xla`);
- `cuda`: the hand-written kernel, `ops/cuda_matmul.py` (the counterpart
  of `pallas`);
- `auto`: routed per (dtype, shape) by `ops/impl_select.py`.
Every implementation keeps the dtype contract of `matmul_out_dtype`: floats
keep their dtype with fp32 accumulation, int8 gives int32.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tpu_matmul_bench_torch.utils.metrics import is_integer_dtype

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _library(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The library product. cuBLAS's int8 product (`torch._int_mm`) needs
    m > 16 and k, n multiples of 8; the CPU multiplies int8 in int32."""
    if not is_integer_dtype(a.dtype):
        return torch.matmul(a, b)
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32)
    (m, k), n = a.shape, b.shape[1]
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"torch._int_mm needs m > 16 and k, n multiples of "
                         f"8; got {m}x{k}x{n}")
    return torch._int_mm(a, b)


def matmul_2d(impl: str = "torch", blocks: tuple[int, int, int] | None = None,
              device_kind: str | None = None) -> Matmul:
    """A 2-D C = A @ B. `blocks` is the kernel's tile request
    (config.blocks): the `cuda` impl runs at it, the library product
    ignores it. `impl="auto"` routes each call's (dtype, shape) to the
    implementation `ops/impl_select.py` names for `device_kind`, the name
    of the device the operands live on; an explicit `blocks` goes with a
    route to the kernel."""
    if impl == "auto":
        from tpu_matmul_bench_torch.ops.impl_select import select_impl

        kind = device_kind or ""

        def _auto(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
            choice = select_impl(a.shape[0], b.shape[1], a.shape[1], kind,
                                 a.dtype)
            return matmul_2d(choice.impl, blocks)(a, b)

        return _auto
    if impl == "cuda":
        from tpu_matmul_bench_torch.ops.cuda_matmul import cuda_matmul

        return lambda a, b: cuda_matmul(a, b, blocks=blocks)
    if impl != "torch":
        raise ValueError(f"unknown matmul impl {impl!r}")
    return _library


def make_matmul(impl: str = "torch", blocks: tuple[int, int, int] | None = None,
                device_kind: str | None = None) -> Matmul:
    """The timed C = A @ B. The JAX package jit-compiles `matmul_2d` here;
    PyTorch runs eagerly, so this is `matmul_2d` itself."""
    return matmul_2d(impl, blocks, device_kind)


def make_bmm() -> Matmul:
    """Batched matmul (≙ `torch.bmm`, reference `matmul_scaling_benchmark.py:
    142`) with `matmul_2d`'s dtype contract: floats keep their dtype with
    fp32 accumulation, int8 accumulates in int32 (as the JAX package's
    `preferred_element_type=jnp.int32`). `torch.bmm` has no integer path
    on the card, so int8 takes the library's int8 product (`_library`) one
    matrix at a time."""
    def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if is_integer_dtype(a.dtype):
            return torch.stack([_library(x, y) for x, y in zip(a, b)])
        return torch.bmm(a, b)

    return bmm


# Integer operands draw uniformly from [-INT_OPERAND_BOUND, INT_OPERAND_BOUND).
# Small magnitudes keep int32 accumulation exact at any benchmark size
# (|sum| ≤ 64·16384 ≪ 2³¹).
INT_OPERAND_BOUND = 8


def random_operands(seed: int, shape: tuple[int, ...], dtype: torch.dtype, *,
                    device: torch.device | str, count: int = 2
                    ) -> tuple[torch.Tensor, ...]:
    """`count` random operands drawn in turn from one generator seeded with
    `seed` on `device`: standard normal for floats, small uniform integers
    for int8."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if is_integer_dtype(dtype):
        return tuple(torch.randint(-INT_OPERAND_BOUND, INT_OPERAND_BOUND, shape,
                                   generator=gen, device=device, dtype=dtype)
                     for _ in range(count))
    return tuple(torch.randn(shape, generator=gen, device=device, dtype=dtype)
                 for _ in range(count))


def operands_from_numpy(*arrays: np.ndarray, device: torch.device | str
                        ) -> tuple[torch.Tensor, ...]:
    """Tensors on `device` with the same bits as the numpy arrays (float32,
    float16, int8, and ml_dtypes bfloat16, which is how a JAX bf16 array
    reaches numpy). torch cannot read bfloat16 from numpy, so its 16 bits
    travel as int16 and are reinterpreted."""
    out = []
    for arr in arrays:
        # a writable copy: a JAX array reaches numpy read-only, and the
        # tensors own their memory
        arr = np.array(arr, order="C", copy=True)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.uint16).view(np.int16)).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append(t.to(device))
    return tuple(out)
