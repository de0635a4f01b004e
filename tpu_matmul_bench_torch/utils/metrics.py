"""Metrics math: FLOPs, TFLOPS, memory footprint, efficiency.

Port of `tpu_matmul_bench/utils/metrics.py`, with the same math and dtype
contract on torch dtypes. Every function takes a `torch.dtype` or a dtype
name ("bfloat16", as records carry it). The peak table gains H100 rows keyed
by a lowercase substring of `torch.cuda.get_device_name()`; the TPU rows stay
as reference rows.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def as_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ("bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    found = getattr(torch, str(dtype), None)
    if not isinstance(found, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return found


def dtype_name(dtype: Any) -> str:
    """'bfloat16' for torch.bfloat16 (the name records and tables use)."""
    return str(as_dtype(dtype)).removeprefix("torch.")


def matmul_flops(m: int, n: int | None = None, k: int | None = None) -> float:
    """FLOPs of one dense (m×k)·(k×n) matmul = 2·m·n·k; with one argument,
    the square case 2·n³."""
    n = m if n is None else n
    k = m if k is None else k
    return 2.0 * m * n * k


def calculate_tflops(matrix_size: int, time_seconds: float, num_ops: int = 1,
                     flops: float | None = None) -> float:
    """TFLOPS of `num_ops` square matmuls of `matrix_size` done in
    `time_seconds`. Pass `flops` to override the square 2n³ count."""
    if time_seconds <= 0:
        return float("inf")
    if flops is None:
        flops = matmul_flops(matrix_size) * num_ops
    return flops / time_seconds / 1e12


def bytes_per_element(dtype: Any) -> int:
    return as_dtype(dtype).itemsize


def is_integer_dtype(dtype: Any) -> bool:
    d = as_dtype(dtype)
    return not (d.is_floating_point or d.is_complex) and d != torch.bool


def matmul_out_dtype(dtype: Any) -> torch.dtype:
    """Output dtype of C = A·B: floats keep their dtype (accumulate in fp32,
    store low, as cuBLAS does for bf16); int8 accumulates and stores int32,
    since sums of int8 products overflow int8."""
    d = as_dtype(dtype)
    return torch.int32 if is_integer_dtype(d) else d


def matmul_acc_dtype(dtype: Any) -> torch.dtype:
    """Accumulator dtype: int32 for integer operands, fp32 otherwise."""
    return torch.int32 if is_integer_dtype(dtype) else torch.float32


def throughput_unit(dtype: Any) -> str:
    """'TFLOPS' for float dtypes, 'TOPS' for integer ones."""
    return "TOPS" if is_integer_dtype(dtype) else "TFLOPS"


def matrix_memory_gib(size: int, dtype: Any, count: int = 1) -> float:
    """Memory of `count` size×size matrices in GiB."""
    return count * size * size * bytes_per_element(dtype) / (1024**3)


# Theoretical dense-matmul peak per device, TFLOPS (TOPS for int8), keyed by
# a lowercase substring of the device name; the first matching key wins, so
# the H100 PCIe row comes before the generic H100 row. The H100 rows are
# NVIDIA's H100 datasheet (dense, without sparsity): SXM 989 bf16/fp16, 495
# TF32, 67 fp32 (no tensor cores), 1979 int8; PCIe 756 / 378 / 51 / 1513.
# "tfloat32" is the row a float32 product uses when TF32 is enabled
# (`--precision high`), so a TF32 run cannot read above 100%.
# The TPU rows are Google's per-chip specs and the GPU rows after them the
# reference's constants; they stay as reference rows.
_PEAKS: dict[str, dict[str, float | None]] = {
    "h100 pcie": {"bfloat16": 756.0, "float16": 756.0, "float32": 51.0,
                  "tfloat32": 378.0, "int8": 1513.0},
    "h100": {"bfloat16": 989.0, "float16": 989.0, "float32": 67.0,
             "tfloat32": 495.0, "int8": 1979.0},
    "v6 lite": {"bfloat16": 918.0, "float16": 918.0, "float32": None,
                "int8": 1836.0},
    "v6e": {"bfloat16": 918.0, "float16": 918.0, "float32": None,
            "int8": 1836.0},
    "v5p": {"bfloat16": 459.0, "float16": 459.0, "float32": None, "int8": 918.0},
    "v5 lite": {"bfloat16": 197.0, "float16": 197.0, "float32": None,
                "int8": 394.0},
    "v5e": {"bfloat16": 197.0, "float16": 197.0, "float32": None, "int8": 394.0},
    "v4": {"bfloat16": 275.0, "float16": 275.0, "float32": None},
    "v3": {"bfloat16": 123.0, "float16": 123.0, "float32": None},
    "v2": {"bfloat16": 45.0, "float16": 45.0, "float32": None},
    "rtx 6000 ada": {"bfloat16": 182.2, "float16": 182.2, "float32": 91.1},
    "radeon": {"bfloat16": 123.0, "float16": 123.0, "float32": 61.4},
    "amd": {"bfloat16": 123.0, "float16": 123.0, "float32": 61.4},
}


def theoretical_peak_tflops(device_kind: str, dtype: Any, *,
                            tf32: bool = False) -> float | None:
    """Per-device peak for the efficiency %; None when unknown. `tf32`
    selects the TF32 row for float32 products."""
    kind = device_kind.lower()
    name = dtype_name(dtype)
    if tf32 and name == "float32":
        name = "tfloat32"
    for key, peaks in _PEAKS.items():
        if key in kind:
            return peaks.get(name)
    return None


# Device-memory bandwidth (GB/s), keyed like the peak table: NVIDIA's H100
# datasheet (SXM 3350, PCIe 2000) and Google's per-chip TPU specs.
_HBM_GBPS: dict[str, float] = {
    "h100 pcie": 2000.0,
    "h100": 3350.0,
    "v6 lite": 1640.0,
    "v6e": 1640.0,
    "v5p": 2765.0,
    "v5 lite": 819.0,
    "v5e": 819.0,
    "v4": 1228.0,
    "v3": 900.0,
    "v2": 700.0,
}


def hbm_spec_gbps(device_kind: str) -> float | None:
    """Datasheet device-memory bandwidth only."""
    kind = device_kind.lower()
    for key, bw in _HBM_GBPS.items():
        if key in kind:
            return bw
    return None


# Measured sustained bandwidth, consulted before the datasheet. The H100
# row is `membw`'s triad at bf16 16384² (3 arrays of 512 MiB, far above the
# 50 MiB L2) on an NVIDIA H100 80GB HBM3 with a 700 W power limit: 3087
# GB/s, 92% of the datasheet's 3350; keyed by that card's name, so the
# PCIe part keeps its datasheet row. The v5e rows are the JAX package's
# measured STREAM result on that TPU.
_MEASURED_HBM_GBPS: dict[str, float] = {
    "h100 80gb hbm3": 3087.0,
    "v5 lite": 665.0,
    "v5e": 665.0,
}


def hbm_bandwidth_gbps(device_kind: str) -> float | None:
    """Roofline denominator: TPU_BENCH_HBM_GBPS (a measurement on this
    device) > the measured table > the datasheet."""
    override = os.environ.get("TPU_BENCH_HBM_GBPS")
    if override:
        try:
            bw = float(override)
            if bw > 0:
                return bw
        except ValueError:
            pass  # malformed override falls through to the tables
    kind = device_kind.lower()
    for key, bw in _MEASURED_HBM_GBPS.items():
        if key in kind:
            return bw
    return hbm_spec_gbps(device_kind)


def matmul_roofline_s(
    size: int, dtype: Any, device_kind: str, *, tf32: bool = False
) -> tuple[float, float] | None:
    """Roofline lower bound for one square matmul: (compute-bound seconds,
    memory-bound seconds), counting one read of A and B and one write of
    C. Actual time ≥ max of the two."""
    peak = theoretical_peak_tflops(device_kind, dtype, tf32=tf32)
    bw = hbm_bandwidth_gbps(device_kind)
    if not peak or not bw:
        return None
    t_flops = matmul_flops(size) / (peak * 1e12)
    c_bytes = bytes_per_element(matmul_out_dtype(dtype))  # int8 writes int32 C
    t_hbm = size * size * (2 * bytes_per_element(dtype) + c_bytes) / (bw * 1e9)
    return t_flops, t_hbm


def scaling_efficiency(total_tflops: float, single_tflops: float, world: int) -> float | None:
    """Scaling efficiency % = total / (single·world) · 100; None when the
    single-device figure is unavailable or world == 0."""
    if world <= 0 or single_tflops <= 0 or not np.isfinite(single_tflops):
        return None
    return total_tflops / (single_tflops * world) * 100.0
