"""The port's split-K (`ops/cuda_matmul.py` `cuda_matmul_ksplit`) against
the JAX package's `pallas_matmul_ksplit`.

The same numpy operands go to `pallas_matmul_ksplit`, run in interpret mode
as tests/test_pallas_matmul.py runs it on the CPU, and to the port's
wrapper on CPU tensors, where it runs the plain version of the split-K
kernels. The tolerances are the JAX test's own for fp32 and
`torch_port_util.TOLERANCE` for the others.
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

from tpu_matmul_bench.ops.pallas_matmul import effective_ksplit as jax_effective_ksplit
from tpu_matmul_bench.ops.pallas_matmul import pallas_matmul_ksplit
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops.matmul import operands_from_numpy

pytestmark = pytest.mark.usefixtures("single_torch_thread")

DTYPES = ["float32", "bfloat16", "float16", "int8"]


@pytest.mark.parametrize("splits", [2, 4, 3], ids=["S2", "S4", "S3-fallback"])
@pytest.mark.parametrize("dtype_name", DTYPES)
def test_ksplit_matches_pallas(dtype_name, splits):
    # (256, 512, 128): K=512 splits into 2 or 4 slabs of 128-multiples; 3
    # has no equal 128-aligned split and falls back to one pass
    a_np, b_np = numpy_operands(21, 256, 512, 128, dtype_name)
    want = np.asarray(pallas_matmul_ksplit(
        jnp.asarray(a_np), jnp.asarray(b_np), splits=splits, block_m=128,
        block_n=64, block_k=128))
    got = cm.cuda_matmul_ksplit(*operands_from_numpy(a_np, b_np, device="cpu"),
                                splits=splits)
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    if dtype_name == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    elif dtype_name == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert rel_err(as_numpy(got), want) <= TOLERANCE[dtype_name]


def test_fallback_is_the_single_pass():
    a_np, b_np = numpy_operands(22, 128, 512, 64, "bfloat16")
    a, b = operands_from_numpy(a_np, b_np, device="cpu")
    assert cm.effective_ksplit(512, 3) == 1
    assert torch.equal(cm.cuda_matmul_ksplit(a, b, splits=3), cm.cuda_matmul(a, b))
    assert torch.equal(cm.matmul_ksplit_plain(a, b, splits=3), cm.matmul_plain(a, b))


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float16"])
def test_partials_add_in_order_then_round_once(dtype_name):
    # fp32 partials, added s = 0..S-1 as pallas_matmul_ksplit's `acc + part`
    # loop, then one downcast: no partial is rounded to the operand dtype
    a_np, b_np = numpy_operands(23, 64, 512, 96, dtype_name)
    a, b = operands_from_numpy(a_np, b_np, device="cpu")
    parts = [a[:, s * 128:(s + 1) * 128].float() @ b[s * 128:(s + 1) * 128].float()
             for s in range(4)]
    want = (((parts[0] + parts[1]) + parts[2]) + parts[3]).to(a.dtype)
    assert torch.equal(cm.matmul_ksplit_plain(a, b, splits=4), want)


def test_int8_partials_stay_exact():
    a = torch.full((32, 1024), 7, dtype=torch.int8)
    b = torch.full((1024, 16), -8, dtype=torch.int8)
    got = cm.cuda_matmul_ksplit(a, b, splits=8)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.full((32, 16), 7 * -8 * 1024, dtype=torch.int32))


@pytest.mark.parametrize("k", [0, 128, 256, 384, 512, 1000, 1024, 4096, 8192, 16384])
def test_effective_ksplit_matches_jax(k):
    for splits in (0, 1, 2, 3, 4, 5, 8, 16, 32):
        assert cm.effective_ksplit(k, splits) == jax_effective_ksplit(k, splits)


def test_ksplit_rejects_bad_arguments():
    a = torch.ones(8, 256)
    b = torch.ones(256, 8)
    with pytest.raises(ValueError, match="splits"):
        cm.cuda_matmul_ksplit(a, b, splits=0)
    with pytest.raises(ValueError, match="grid_order"):
        cm.cuda_matmul_ksplit(a, b, grid_order="kmn")
    with pytest.raises(ValueError, match="shapes"):
        cm.cuda_matmul_ksplit(a, a)


def test_cpu_ksplit_launches_nothing():
    before = (cm.LAUNCHES, cm.REDUCE_LAUNCHES)
    a = torch.ones(16, 256, dtype=torch.bfloat16)
    cm.cuda_matmul_ksplit(a, a.T.contiguous(), splits=2)
    assert (cm.LAUNCHES, cm.REDUCE_LAUNCHES) == before


def test_other_devices_raise_instead_of_falling_back():
    a = torch.ones(8, 256, device="meta")
    b = torch.ones(256, 8, device="meta")
    before = (cm.LAUNCHES, cm.REDUCE_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cm.cuda_matmul_ksplit(a, b, splits=2)
    assert (cm.LAUNCHES, cm.REDUCE_LAUNCHES) == before
