"""Workload definitions for the matmul benchmark.

Port of `tpu_matmul_bench/models/workloads.py:24-77`: the square C = A·B
and the rectangular C[m,n] = A[m,k]·B[k,n]. Operands are made on the device
they are asked for, from a seeded generator.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_matmul_bench_torch.ops.matmul import random_operands
from tpu_matmul_bench_torch.utils.metrics import (
    bytes_per_element,
    matmul_flops,
    matmul_out_dtype,
    matrix_memory_gib,
)


@dataclasses.dataclass(frozen=True)
class MatmulWorkload:
    """One square matmul C = A·B of `size`×`size` matrices."""

    size: int
    dtype: torch.dtype
    seed: int = 0

    @property
    def flops(self) -> float:
        return matmul_flops(self.size)

    @property
    def memory_gib(self) -> float:
        # A, B and the produced C (int8 operands produce an int32 C)
        return matrix_memory_gib(self.size, self.dtype, count=2) + \
            matrix_memory_gib(self.size, matmul_out_dtype(self.dtype))

    def operands(self, device: torch.device | str, seed_offset: int = 0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        a, b = random_operands(self.seed + seed_offset, (self.size, self.size),
                               self.dtype, device=device)
        return a, b


@dataclasses.dataclass(frozen=True)
class RectMatmulWorkload:
    """One rectangular matmul C[m,n] = A[m,k]·B[k,n]."""

    m: int
    k: int
    n: int
    dtype: torch.dtype
    seed: int = 0

    @property
    def flops(self) -> float:
        return matmul_flops(self.m, self.n, self.k)

    @property
    def memory_gib(self) -> float:
        bpe = bytes_per_element(self.dtype)
        out_bpe = bytes_per_element(matmul_out_dtype(self.dtype))
        return ((self.m * self.k + self.k * self.n) * bpe
                + self.m * self.n * out_bpe) / (1024 ** 3)

    def operands(self, device: torch.device | str, seed_offset: int = 0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        (a,) = random_operands(self.seed + seed_offset, (self.m, self.k),
                               self.dtype, device=device, count=1)
        (b,) = random_operands(self.seed + seed_offset + 1, (self.k, self.n),
                               self.dtype, device=device, count=1)
        return a, b
