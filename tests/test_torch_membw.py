"""The port's STREAM-style bandwidth program (`benchmarks/membw_benchmark.py`,
`membw`) against the JAX package's.

The byte model is JAX's: the same ops in the same order with the same
arrays moved a call (copy, scale and dot 2, add and triad 3), as JAX's
`tests/test_membw.py` pins them. Each op's call computes its STREAM
formula on the operands (exactly for copy, scale and add; triad within one
bf16 rounding; dot within the fp32 sum's order). A CPU time is no device
number: here only the records' math and schema are held.
"""

import json

import numpy as np
import pytest
import torch
from torch_port_util import single_torch_thread  # noqa: F401

from tpu_matmul_bench.benchmarks import membw_benchmark as jmembw
from tpu_matmul_bench_torch.benchmarks import membw_benchmark as membw
from tpu_matmul_bench_torch.ops.matmul import random_operands
from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def test_byte_model_is_jax():
    assert list(membw.STREAM_OPS) == list(jmembw.STREAM_OPS)
    assert {k: v[1] for k, v in membw.STREAM_OPS.items()} == \
        {k: v[1] for k, v in jmembw.STREAM_OPS.items()} == \
        {"copy": 2, "scale": 2, "add": 3, "triad": 3, "dot": 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", list(membw.STREAM_OPS))
def test_each_op_computes_its_stream_formula(op, dtype):
    a, b = random_operands(3, (64, 64), dtype, device="cpu")
    out = torch.empty((), dtype=dtype) if op == "dot" else torch.empty_like(a)
    got = membw.STREAM_OPS[op][0](a, b, out)
    assert got.data_ptr() == out.data_ptr()  # written in place: no new array
    exact = {"copy": a, "scale": a * membw.SCALAR, "add": a + b}
    if op in exact:
        assert torch.equal(got, exact[op])
        return
    af, bf = a.double(), b.double()
    want = af + membw.SCALAR * bf if op == "triad" else (af * bf).sum()
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert float((got.double() - want).abs().max()) <= tol * float(want.abs().max())


def test_records(tmp_path):
    out = tmp_path / "bw.jsonl"
    recs = membw.main(["--device", "cpu", "--sizes", "128", "--iterations", "2",
                       "--warmup", "1", "--dtype", "float32", "--json-out", str(out)])
    assert [r.mode for r in recs] == list(membw.STREAM_OPS)
    for r in recs:
        assert r.benchmark == "membw" and r.world == 1
        assert r.algbw_gbps and r.algbw_gbps > 0
        assert r.tflops_total == 0.0
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert lines[0]["record_type"] == "manifest"
    by_mode = {x["mode"]: x for x in lines[1:]}
    per = 128 * 128 * 4
    for op, (_, factor) in membw.STREAM_OPS.items():
        assert by_mode[op]["bytes_per_device"] == factor * per
        assert by_mode[op]["extras"]["bytes_factor"] == factor
        assert by_mode[op]["extras"]["stream_op"] == op
    assert "pct_of_spec_hbm_bw" not in by_mode["copy"]["extras"]  # no datasheet for a CPU


def test_single_op_bf16():
    recs = membw.main(["--device", "cpu", "--sizes", "128", "--iterations", "2",
                       "--warmup", "1", "--dtype", "bfloat16", "--mode", "triad",
                       "--timing", "fused"])
    assert [r.mode for r in recs] == ["triad"]
    assert recs[0].bytes_per_device == 3 * 128 * 128 * 2
    assert recs[0].extras["timing"] == "fused"


def test_pct_is_of_the_datasheet_not_the_measured_table():
    config = config_from_args(build_parser("t", modes=["all"]).parse_args(
        ["--device", "cpu", "--sizes", "64", "--iterations", "2", "--warmup", "1"]))
    rec = membw.bench_membw(config, 64, "triad", torch.device("cpu"),
                            "NVIDIA H100 80GB HBM3")
    assert rec.extras["pct_of_spec_hbm_bw"] == round(100.0 * rec.algbw_gbps / 3350.0, 1)
    assert np.isfinite(rec.algbw_gbps)


def test_a_failed_size_exits_1(monkeypatch):
    real = membw.bench_membw

    def failing(config, size, op, device, kind):
        if op == "add":
            raise RuntimeError("seeded failure")
        return real(config, size, op, device, kind)

    monkeypatch.setattr(membw, "bench_membw", failing)
    with pytest.raises(SystemExit) as e:
        membw.main(["--device", "cpu", "--sizes", "64", "--iterations", "1",
                    "--warmup", "0"])
    assert e.value.code == 1


def test_membw_needs_the_card_unless_cpu_is_asked_for():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        membw.main(["--sizes", "64"])


def test_measured_row_of_the_h100():
    from tpu_matmul_bench_torch.utils import metrics
    from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord

    assert metrics.hbm_bandwidth_gbps("NVIDIA H100 80GB HBM3") == 3087.0
    assert metrics.hbm_spec_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert metrics.hbm_bandwidth_gbps("NVIDIA H100 PCIe") == 2000.0  # no measured row
    # a comm-free record where the memory leg binds names the rate it used
    rec = BenchmarkRecord("matmul", "single", 256, "bfloat16", 1, 5, 1, 1e-6, 1.0, 1.0,
                          device_kind="NVIDIA H100 80GB HBM3").finalize()
    assert rec.extras["roofline_bw_gbps"] == 3087.0
