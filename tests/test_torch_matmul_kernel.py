"""The port's matmul kernel module (`ops/cuda_matmul.py`) against the JAX
package's Pallas kernel (`ops/pallas_matmul.py`).

The same numpy operands go to `pallas_matmul`, run in interpret mode as the
JAX package's own tests run it on the CPU, and to the port's `cuda_matmul`
on CPU tensors, where the wrapper runs the kernel's plain version. The
tolerances, with their reasons, are `torch_port_util.TOLERANCE`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (  # noqa: F401 — single_torch_thread is a fixture
    TOLERANCE,
    as_numpy,
    numpy_operands,
    rel_err,
    single_torch_thread,
)

from tpu_matmul_bench.ops.pallas_matmul import pallas_matmul
from tpu_matmul_bench_torch.ops import _build
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops.matmul import operands_from_numpy

pytestmark = pytest.mark.usefixtures("single_torch_thread")

# (m, k, n): square and rectangular blocks, then the padding-path shapes of
# tests/test_pallas_matmul.py::test_fuzz_shapes_vs_xla
SHAPES = [(128, 128, 128), (256, 256, 256), (128, 64, 256),
          (7, 13, 5), (129, 64, 257), (100, 300, 200), (1, 128, 1),
          (255, 255, 255), (64, 1, 64)]


@pytest.mark.parametrize("mkn", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype_name", list(TOLERANCE))
def test_kernel_matches_pallas(dtype_name, mkn):
    a_np, b_np = numpy_operands(sum(mkn), *mkn, dtype_name)
    want = pallas_matmul(jnp.asarray(a_np), jnp.asarray(b_np))
    a, b = operands_from_numpy(a_np, b_np, device="cpu")
    got = cm.cuda_matmul(a, b)
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    err = rel_err(as_numpy(got), want)
    assert err <= TOLERANCE[dtype_name], (dtype_name, mkn, err)


def test_int8_stores_int32_exactly():
    a_np, b_np = numpy_operands(5, 96, 160, 64, "int8")
    want = np.asarray(pallas_matmul(jnp.asarray(a_np), jnp.asarray(b_np)))
    got = cm.cuda_matmul(*operands_from_numpy(a_np, b_np, device="cpu"))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float16"])
def test_out_dtype_override_keeps_fp32(dtype_name):
    # the store-dtype override the K-split variant uses: fp32 partials
    a_np, b_np = numpy_operands(6, 128, 256, 128, dtype_name)
    want = np.asarray(pallas_matmul(jnp.asarray(a_np), jnp.asarray(b_np),
                                    out_dtype="float32"))
    got = cm.cuda_matmul(*operands_from_numpy(a_np, b_np, device="cpu"),
                         out_dtype=torch.float32)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert rel_err(got.numpy(), want) <= 1e-5


def test_bf16_accumulates_fp32():
    # ones(256)·ones(256) sums 256 exactly only with fp32 accumulation
    a = torch.ones((256, 256), dtype=torch.bfloat16)
    assert torch.equal(cm.cuda_matmul(a, a).float(),
                       torch.full((256, 256), 256.0))


def test_plain_version_is_the_cpu_path():
    a_np, b_np = numpy_operands(7, 64, 96, 32, "bfloat16")
    a, b = operands_from_numpy(a_np, b_np, device="cpu")
    assert torch.equal(cm.cuda_matmul(a, b), cm.matmul_plain(a, b))


@pytest.mark.parametrize("bad, error", [
    (lambda: (torch.ones(4, 8), torch.ones(4, 8)), ValueError),
    (lambda: (torch.ones(4, 8), torch.ones(8, 4, dtype=torch.float16)), TypeError),
    (lambda: (torch.ones(4, 8, dtype=torch.float64),
              torch.ones(8, 4, dtype=torch.float64)), TypeError),
    (lambda: (torch.ones(2, 4, 8), torch.ones(8, 4)), ValueError),
], ids=["inner-dim", "mixed-dtypes", "float64", "3-d"])
def test_rejects_what_the_kernel_does_not_take(bad, error):
    with pytest.raises(error):
        cm.cuda_matmul(*bad())


def test_rejects_unsupported_store_dtype():
    a = torch.ones(8, 8, dtype=torch.int8)
    with pytest.raises(TypeError, match="cannot store"):
        cm.cuda_matmul(a, a, out_dtype=torch.int8)


def test_other_devices_raise_instead_of_falling_back():
    a = torch.ones(8, 8, device="meta")
    before = cm.LAUNCHES
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cm.cuda_matmul(a, a)
    assert cm.LAUNCHES == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.nvcc_path()


def test_library_path_follows_the_source():
    lib = _build.library_path("matmul")
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("libmatmul-") and lib.suffix == ".so"
    assert lib == _build.library_path("matmul")  # stable for one source
