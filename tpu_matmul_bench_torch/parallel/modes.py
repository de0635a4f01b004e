"""Result validation for `--validate`.

Port of `tpu_matmul_bench/parallel/modes.py:88-160`: the corner check
that compares a result's top-left corner with a recomputed reference. The
scaling modes of that file come with the scaling slice.
"""

from __future__ import annotations

from typing import Any

import torch

from tpu_matmul_bench_torch.utils.metrics import as_dtype, is_integer_dtype

# --validate corner size (the reference's 10×10 spot check, widened)
VALIDATION_CORNER = 128


def validation_tolerance(dtype: Any) -> float:
    """Integer matmuls are exact; half dtypes get rounding headroom; fp32
    keeps the reference's 1e-3, or 2e-2 while TF32 is allowed (products
    rounded to a 10-bit mantissa), the headroom the JAX package gives fp32
    on the TPU for its bf16 passes."""
    d = as_dtype(dtype)
    if is_integer_dtype(d):
        return 0.0
    if d.itemsize >= 4:
        return 2e-2 if torch.backends.cuda.matmul.allow_tf32 else 1e-3
    return 3e-2


def expected_corner(a: torch.Tensor, b: torch.Tensor,
                    corner: int = VALIDATION_CORNER) -> torch.Tensor:
    """Reference for C[:corner, :corner]: full-K product of A's first rows
    and B's first columns in float64, on the operands' device. float64 is
    exact for the int8 operands (the card has no integer matmul) and is
    unaffected by the TF32 switch."""
    c = min(corner, a.shape[0], b.shape[1])
    return a[:c].double() @ b[:, :c].double()


def corner_validation(got: torch.Tensor, expected: torch.Tensor, dtype: Any,
                      tol: float | None = None) -> dict:
    """Compare a result corner with the reference: max |got - expected|
    relative to max |expected|, against the dtype's tolerance."""
    g = got.detach().double().cpu()
    e = expected.detach().double().cpu()
    denom = float(e.abs().max()) or 1.0
    err = float((g - e).abs().max()) / denom
    if tol is None:
        tol = validation_tolerance(dtype)
    return {
        "validation": "ok" if err <= tol else "FAILED",
        "validation_max_rel_err": round(err, 8),
        "validation_tolerance": tol,
    }
