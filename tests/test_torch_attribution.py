"""The kernels' own cost books (`obs/attribution.py`) and the `cost_analysis`
blocks of the port's `matmul` and `tune` records, against the JAX
package's blocks (`tpu_matmul_bench/obs/attribution.py`).

The JAX package reads XLA's books; the port counts what its kernel's launch
geometry implies, so these cases are derived by hand. On the CPU the
wrappers run their plain versions, but the launch they describe (route,
tile, splits) is chosen from the operands alone and is the same there.
"""

import pytest
import torch
from torch_port_util import single_torch_thread  # noqa: F401 — a fixture

from tpu_matmul_bench.obs import attribution as jax_attribution
from tpu_matmul_bench_torch.benchmarks import cuda_tune
from tpu_matmul_bench_torch.benchmarks.matmul_benchmark import _bench_rect, _bench_single
from tpu_matmul_bench_torch.obs import attribution
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args
from tpu_matmul_bench_torch.utils.metrics import theoretical_peak_tflops

pytestmark = pytest.mark.usefixtures("single_torch_thread")

H100 = "NVIDIA H100 80GB HBM3"
SMALL = ["--iterations", "1", "--warmup", "0", "--device", "cpu"]


def _config(*flags):
    return config_from_args(build_parser("t").parse_args([*SMALL, *flags]))


# --------------------------------------------------------- hand-derived


def test_aligned_problem_agrees_exactly():
    block = attribution.attribution_block("wgmma", 256, 256, 256, (128, 128, 32))
    assert block["flops"] == block["hand_model_flops"] == 2 * 256**3
    assert block["flops_ratio"] == 1.0 and block["agrees"]
    # 4 output tiles, each loading 128 rows of A and 128 columns of B over
    # K, and C stored once, in bf16
    assert block["bytes_accessed"] == 4 * (128 + 128) * 256 * 2 + 256 * 256 * 2
    assert block["arithmetic_intensity"] == round(2 * 256**3 / block["bytes_accessed"], 3)


def test_ragged_problem_counts_whole_tiles():
    # 520x1000x264 at 128x256x64 runs as 640x1024x320: TMA fills the edge
    # with zeros and wgmma computes the whole tile
    cost = attribution.kernel_cost("wgmma", 520, 1000, 264, (128, 256, 64))
    assert cost["flops"] == 2 * 640 * 1024 * 320
    assert cost["bytes_accessed"] == (5 * 4) * (128 + 256) * 320 * 2 + 520 * 1000 * 2
    assert cost["min_bytes"] == (520 * 264 + 264 * 1000) * 2 + 520 * 1000 * 2
    block = attribution.attribution_block("wgmma", 520, 1000, 264, (128, 256, 64))
    assert block["flops_ratio"] == round(640 * 1024 * 320 / (520 * 1000 * 264), 6)
    assert not block["agrees"]


@pytest.mark.parametrize("dtype, acc_item", [("bfloat16", 4), ("int8", 4)])
def test_split_k_adds_its_partials_each_way(dtype, acc_item):
    m, n, k = 256, 512, 1024
    one = attribution.kernel_cost("wgmma", m, n, k, (128, 128, 64), 1, dtype)
    two = attribution.kernel_cost("wgmma", m, n, k, (128, 128, 64), 2, dtype)
    assert two["flops"] == one["flops"] == 2 * m * n * k
    # S=2 fp32 (int32) partials of m x n: written once, read back once
    assert two["bytes_accessed"] - one["bytes_accessed"] == 2 * (2 * m * n * acc_item)
    assert two["min_bytes"] == one["min_bytes"]


def test_split_slabs_pad_separately():
    # k = 2 x 96: each slab pads to 128 at bk 64
    cost = attribution.kernel_cost("wgmma", 128, 128, 192, (128, 128, 64), 2)
    assert cost["flops"] == 2 * 128 * 128 * 256


def test_int8_stores_int32():
    cost = attribution.kernel_cost("wmma", 64, 64, 64, (64, 128, 32), 1, "int8")
    assert cost["min_bytes"] == (64 * 64 * 2) * 1 + 64 * 64 * 4


def test_kernel_cost_rejects_an_uneven_split():
    with pytest.raises(ValueError, match="splits"):
        attribution.kernel_cost("wgmma", 64, 64, 100, (64, 128, 32), 3)


# ------------------------------------------------- the JAX block's keys


class _FakeCompiled:
    """A compiled executable's `cost_analysis()`, as tests/test_obs.py fakes it."""

    def __init__(self, result):
        self._result = result

    def cost_analysis(self):
        return self._result


def test_block_keys_equal_jax():
    m, k, n = 64, 32, 16
    jax_block = jax_attribution.attribution_block(
        _FakeCompiled([{"flops": float(2 * m * k * n), "bytes accessed": 1024.0}]), m, k, n)
    block = attribution.attribution_block("wgmma", m, n, k, (64, 128, 32))
    assert set(block) == set(jax_block)
    assert block["tolerance_pct"] == jax_block["tolerance_pct"] == 10.0
    assert block["hand_model_flops"] == jax_block["hand_model_flops"]


# ------------------------------------------------------- the bound


@pytest.mark.parametrize("m, n, k, extra, ms", [
    (16384, 16384, 16384, 0, 8.894),
    # K1b tall, S=2: its fp32 partials do not make it bound by bytes
    (28672, 8192, 4096, 2 * 2 * 28672 * 8192 * 4, 1.946),
])
def test_bound_reads_the_h100_rows(m, n, k, extra, ms):
    assert round(attribution.bound_ms(m, n, k, "bfloat16", H100, extra_bytes=extra), 3) == ms
    assert attribution.bound(m, n, k, "bfloat16", H100, extra)[1] == "operations"


def test_bound_by_bytes_for_a_thin_product():
    ms, by = attribution.bound(16384, 16384, 8, "bfloat16", H100)
    assert by == "bytes"
    assert ms == pytest.approx((16384 * 8 * 2 * 2 + 16384 * 16384 * 2) / 3350e9 * 1e3)


def test_bound_needs_a_peak_row():
    with pytest.raises(ValueError, match="no peak"):
        attribution.bound_ms(64, 64, 64, "bfloat16", "cpu")


def test_peak_matches_the_table():
    assert attribution.bound_ms(1, 1, 1, "bfloat16", H100) > 0
    assert theoretical_peak_tflops(H100, "bfloat16") == 989.0


# ------------------------------------------- the launch that is described


@pytest.mark.parametrize("dtype, shape, route, tile", [
    (torch.bfloat16, (256, 256, 256), "wgmma", cm.DEFAULT_TILE),
    (torch.float16, (7, 13, 5), "wmma", cm.DEFAULT_TILE),  # rows TMA cannot describe
    (torch.int8, (64, 64, 64), "wmma", cm.DEFAULT_TILE),
    (torch.float32, (64, 64, 64), "simt", cm.SIMT_TILE),
])
def test_launch_plan(dtype, shape, route, tile):
    m, k, n = shape
    a, b = torch.zeros(m, k, dtype=dtype), torch.zeros(k, n, dtype=dtype)
    assert cm.launch_plan(a, b) == (route, tile, 1)


def test_launch_plan_of_a_split():
    a, b = torch.zeros(256, 512, dtype=torch.bfloat16), torch.zeros(512, 256, dtype=torch.bfloat16)
    assert cm.launch_plan(a, b, (64, 128, 32), 2) == ("wgmma", (64, 128, 32), 2)
    # no 128-aligned equal split of K=512 in 3: one pass
    assert cm.launch_plan(a, b, None, 3)[2] == 1


# ----------------------------------------------------- the records


def test_bench_single_record_carries_cost_analysis():
    # tests/test_obs.py's JAX case, under the hand-written kernel
    rec = _bench_single(_config("--dtype", "float32", "--matmul-impl", "cuda"), 64, "cpu",
                        torch.device("cpu"))
    block = rec.extras["cost_analysis"]
    assert block["agrees"]
    assert block["hand_model_flops"] == 2 * 64 ** 3
    assert block == attribution.attribution_block("simt", 64, 64, 64, cm.SIMT_TILE,
                                                  dtype=torch.float32)


@pytest.mark.parametrize("impl", ["torch", "auto"])
def test_library_records_carry_no_books(impl):
    # the library product keeps no books the port can read, and `auto`
    # resolves to it on the CPU, an unrouted device kind
    rec = _bench_single(_config("--matmul-impl", impl), 64, "cpu", torch.device("cpu"))
    assert "cost_analysis" not in rec.extras


def test_rect_record_describes_its_padded_launch():
    rec = _bench_rect(_config("--matmul-impl", "cuda", "--dtype", "bfloat16"),
                      (64, 96, 32), "cpu", torch.device("cpu"))
    block = rec.extras["cost_analysis"]
    assert block == attribution.attribution_block("wgmma", 64, 32, 96, cm.DEFAULT_TILE)
    assert block["flops"] == 2 * 128 * 256 * 128 and not block["agrees"]


def test_tune_records_carry_split_books(tmp_path):
    records = cuda_tune.main(["--sizes", "256", *SMALL, "--candidates", "128,128,64",
                              "--ksplit", "2", "--confirm-top", "0"])
    (rec,) = records
    block = rec.extras["cost_analysis"]
    want = attribution.kernel_cost("wgmma", 256, 256, 256, (128, 128, 64), 2)
    assert block["bytes_accessed"] == want["bytes_accessed"]
    assert block["flops_ratio"] == 1.0


def test_tune_books_follow_the_tile():
    records = cuda_tune.main(["--sizes", "200", *SMALL, "--confirm-top", "0",
                              "--candidates", "128,256,64", "64,128,32"])
    ratios = [r.extras["cost_analysis"]["flops_ratio"] for r in records]
    # 200³ pads to 256x256x256 at 128x256x64 and to 256x256x224 at 64x128x32
    assert ratios == [round(256**3 / 200**3, 6), round(256 * 256 * 224 / 200**3, 6)]
