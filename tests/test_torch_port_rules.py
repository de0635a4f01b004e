"""Rules of the PyTorch/CUDA port, and its small modules against the JAX
package's.

- The port and chip_smoke.py import neither jax nor the JAX package.
- Entry points run on the card unless the CPU is asked for.
- A CPU call to the kernel's wrapper launches nothing.
- The H100 rows of the peak table, and TF32's.
- Operands cross from numpy with identical bits.
- Metrics, tolerances, validation and sample statistics agree with the
  JAX package's on the same inputs.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_port_util import (  # noqa: F401 — single_torch_thread is a fixture
    as_numpy,
    numpy_operands,
    single_torch_thread,
)

from tpu_matmul_bench.parallel import modes as jax_modes
from tpu_matmul_bench.utils import metrics as jax_metrics
from tpu_matmul_bench.utils import timing as jax_timing
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops.impl_select import auto_extras, select_impl
from tpu_matmul_bench_torch.ops.matmul import operands_from_numpy
from tpu_matmul_bench_torch.parallel import modes
from tpu_matmul_bench_torch.utils import metrics, timing
from tpu_matmul_bench_torch.utils.device import resolve_devices
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "tpu_matmul_bench_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "scripts" / "port_ab.py"]
DTYPES = ["float32", "float16", "bfloat16", "int8"]

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.append(node.module)
    return names


def _is_forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "tpu_matmul_bench"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imported_modules(path) if _is_forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_scan_sees_forbidden_imports():
    for module in ("jax", "jax.numpy", "jaxlib", "tpu_matmul_bench",
                   "tpu_matmul_bench.utils.durable"):
        assert _is_forbidden(module)
    assert not _is_forbidden("tpu_matmul_bench_torch.utils.durable")


def test_entry_points_need_the_card_unless_cpu_is_asked_for():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_devices("cuda")
    assert resolve_devices("cpu") == [torch.device("cpu")]
    # one rank to a device unless TMB_RANKS_PER_CARD says more
    with pytest.raises(ValueError, match="--num-devices 2: 1 available"):
        resolve_devices("cpu", num_devices=2)


def test_port_main_without_a_card_raises():
    from tpu_matmul_bench_torch.benchmarks.matmul_benchmark import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--sizes", "64", "--iterations", "1"])


def test_cpu_call_launches_no_kernel():
    before = cm.LAUNCHES
    a = torch.ones(32, 32, dtype=torch.bfloat16)
    cm.cuda_matmul(a, a)
    assert cm.LAUNCHES == before


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe",
                                  "NVIDIA H100 NVL"])
def test_select_impl_routes_an_h100_to_the_library(name):
    choice = select_impl(16384, 16384, 16384, name, torch.bfloat16)
    assert choice.impl == "torch" and choice.source == "table"
    assert "unrouted" in choice.provenance
    extras = auto_extras("auto", 16384, 16384, 16384, name, torch.bfloat16)
    assert extras["matmul_impl_resolved"] == "torch"
    assert auto_extras("cuda", 1, 1, 1, name, torch.bfloat16) == {}


@pytest.mark.parametrize("name, row", [
    ("NVIDIA H100 PCIe", {"bfloat16": 756.0, "float16": 756.0, "float32": 51.0,
                          "int8": 1513.0, "tf32": 378.0, "hbm": 2000.0}),
    ("NVIDIA H100 80GB HBM3", {"bfloat16": 989.0, "float16": 989.0,
                               "float32": 67.0, "int8": 1979.0, "tf32": 495.0,
                               "hbm": 3350.0}),
])
def test_h100_peak_rows(name, row):
    for dtype in DTYPES:
        assert metrics.theoretical_peak_tflops(name, dtype) == row[dtype]
    assert metrics.theoretical_peak_tflops(name, torch.float32, tf32=True) == row["tf32"]
    # tf32 leaves the other dtypes' rows alone
    assert metrics.theoretical_peak_tflops(name, "bfloat16", tf32=True) == row["bfloat16"]
    assert metrics.hbm_spec_gbps(name) == row["hbm"]


def test_tpu_rows_stay_as_reference_rows():
    for kind in ("TPU v5 lite", "TPU v6e", "TPU v4"):
        for dtype in ("bfloat16", "float32", "int8"):
            assert metrics.theoretical_peak_tflops(kind, dtype) == \
                jax_metrics.theoretical_peak_tflops(kind, dtype)


def _fp32_record(tflops, precision):
    return BenchmarkRecord(
        "matmul", "single", 16384, "float32", 1, 50, 10, 0.02, tflops, tflops,
        device_kind="NVIDIA H100 80GB HBM3",
        extras={"float32_matmul_precision": precision}).finalize()


def test_tf32_records_use_the_tf32_peak():
    assert _fp32_record(400.0, "high").peak_efficiency_pct == pytest.approx(
        100.0 * 400.0 / 495.0)
    assert _fp32_record(50.0, "highest").peak_efficiency_pct == pytest.approx(
        100.0 * 50.0 / 67.0)


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("np_dtype", [np.float32, np.float16, np.int8,
                                      ml_dtypes.bfloat16],
                         ids=["float32", "float16", "int8", "bfloat16"])
def test_operands_from_numpy_keep_the_bits(np_dtype):
    rng = np.random.default_rng(3)
    if np_dtype is np.int8:
        arr = rng.integers(-128, 128, size=(5, 7)).astype(np.int8)
    else:
        arr = rng.standard_normal((5, 7)).astype(np_dtype)
        arr[0, :4] = np.array([-0.0, np.inf, -np.inf, np.nan]).astype(np_dtype)
    (t,) = operands_from_numpy(arr, device="cpu")
    assert str(t.dtype).removeprefix("torch.") == np.dtype(np_dtype).name
    assert tuple(t.shape) == arr.shape
    assert _bits(t) == arr.tobytes()


def test_operands_from_numpy_take_a_jax_array():
    x = jnp.asarray(np.arange(12, dtype=np.float32).reshape(3, 4), jnp.bfloat16)
    (t,) = operands_from_numpy(np.asarray(x), device="cpu")
    assert t.dtype == torch.bfloat16
    assert torch.equal(t.float(), torch.arange(12.0).reshape(3, 4))


@pytest.mark.parametrize("name", DTYPES)
def test_dtype_contract_matches_jax(name):
    assert str(metrics.matmul_out_dtype(name)).removeprefix("torch.") == \
        jax_metrics.matmul_out_dtype(name).name
    assert str(metrics.matmul_acc_dtype(name)).removeprefix("torch.") == \
        jax_metrics.matmul_acc_dtype(name).name
    assert metrics.throughput_unit(name) == jax_metrics.throughput_unit(name)
    assert metrics.bytes_per_element(name) == jax_metrics.bytes_per_element(name)
    assert metrics.matrix_memory_gib(4096, name, 3) == \
        jax_metrics.matrix_memory_gib(4096, name, 3)
    assert modes.validation_tolerance(name) == jax_modes.validation_tolerance(name)


def test_metrics_math_matches_jax():
    for args in ((16384, 0.045), (4096, 0.0), (8192, 0.01, 4)):
        assert metrics.calculate_tflops(*args) == jax_metrics.calculate_tflops(*args)
    assert metrics.matmul_flops(3, 5, 7) == jax_metrics.matmul_flops(3, 5, 7)
    assert metrics.scaling_efficiency(700.0, 190.0, 4) == \
        jax_metrics.scaling_efficiency(700.0, 190.0, 4)
    assert metrics.matmul_roofline_s(16384, "bfloat16", "TPU v5 lite") == \
        jax_metrics.matmul_roofline_s(16384, "bfloat16", "TPU v5 lite")


def test_tf32_widens_the_fp32_validation_tolerance(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert modes.validation_tolerance(torch.float32) == 2e-2
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    assert modes.validation_tolerance(torch.float32) == 1e-3


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int8"])
def test_corner_validation_matches_jax(dtype_name):
    a_np, b_np = numpy_operands(9, 160, 96, 140, dtype_name)
    a, b = operands_from_numpy(a_np, b_np, device="cpu")
    want = jax_modes.expected_corner(jnp.asarray(a_np), jnp.asarray(b_np))
    got = modes.expected_corner(a, b)
    assert tuple(got.shape) == tuple(want.shape) == (128, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64),
                               rtol=1e-5, atol=1e-4)
    result = cm.cuda_matmul(a, b)[:128, :128]
    port = modes.corner_validation(result, got, dtype_name)
    ref = jax_modes.corner_validation(as_numpy(result), want, dtype_name)
    assert port["validation"] == ref["validation"] == "ok"
    assert port["validation_tolerance"] == ref["validation_tolerance"]
    assert port["validation_max_rel_err"] == pytest.approx(
        ref["validation_max_rel_err"], abs=1e-6)


def test_corner_validation_fails_a_wrong_result():
    e = torch.ones(4, 4, dtype=torch.float64)
    assert modes.corner_validation(e * 1.1, e, "float32")["validation"] == "FAILED"
    assert modes.corner_validation(e.int() + 1, e, "int8")["validation"] == "FAILED"


def test_sample_stats_and_extras_match_jax():
    samples = [0.012, 0.0101, 0.0103, 0.0099, 0.0100, 0.0102, 0.0098, 0.0101]
    assert timing.sample_stats(samples) == jax_timing.sample_stats(samples)
    for t_port, t_jax in [
        (timing.Timing(1.0, 10), jax_timing.Timing(1.0, 10)),
        (timing.Timing(1.0, 10, reliable=False, chain="none"),
         jax_timing.Timing(1.0, 10, reliable=False, chain="none")),
    ]:
        for protocol in ("dispatch", "fused"):
            assert timing.protocol_extras(protocol, t_port) == \
                jax_timing.protocol_extras(protocol, t_jax)
    assert timing.effective_warmup("fused", 50, 10) == \
        jax_timing.effective_warmup("fused", 50, 10) == 50
    with pytest.raises(ValueError):
        timing.choose_timer("events")
