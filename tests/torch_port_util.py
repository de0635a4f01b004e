"""Shared helpers for the PyTorch/CUDA port's tests (tests/test_torch_*.py)."""

import ml_dtypes
import numpy as np
import pytest
import torch

# max |port - jax| / max |jax| for a matmul of the same operands:
# - float32 1e-5: both sum in fp32, in different orders;
# - bfloat16 1e-2: both sum in fp32 and round once to bf16, so a result can
#   differ by one bf16 ulp (0.125 at magnitude 92 for 256x384x128);
# - float16 2e-3: the same with fp16's 10-bit mantissa;
# - int8 exact: both sum in int32.
TOLERANCE = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 2e-3, "int8": 0.0}


def numpy_operands(seed, m, k, n, dtype_name):
    """A[m,k], B[k,n] made with numpy from a seed, in the JAX package's
    dtypes (ml_dtypes bfloat16 for bf16): normal floats, int8 in [-8, 8)."""
    rng = np.random.default_rng(seed)
    if dtype_name == "int8":
        return (rng.integers(-8, 8, size=(m, k)).astype(np.int8),
                rng.integers(-8, 8, size=(k, n)).astype(np.int8))
    np_dtype = ml_dtypes.bfloat16 if dtype_name == "bfloat16" else np.dtype(dtype_name)
    return (rng.standard_normal((m, k)).astype(np_dtype),
            rng.standard_normal((k, n)).astype(np_dtype))


def as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) or 1.0)


@pytest.fixture(scope="module")
def single_torch_thread():
    """One intra-op thread while a port test module runs: its products are
    small, and the JAX tests sharing the worker process keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
