"""The port's matmul slice as a whole against the JAX package.

The same numpy operands go through the JAX package's `make_matmul` and the
port's; then each package's `matmul_benchmark.main` runs the same small
problem, the port with `--device cpu`, and the two records are held to
the same contract: a manifest first, `validation: ok`, the same field
names.
"""

import json

import jax.numpy as jnp
import pytest
import torch
from torch_port_util import (  # noqa: F401 — single_torch_thread is a fixture
    TOLERANCE,
    as_numpy,
    numpy_operands,
    rel_err,
    single_torch_thread,
)

from tpu_matmul_bench.benchmarks import matmul_benchmark as jax_bench
from tpu_matmul_bench.ops.matmul import make_matmul as jax_make_matmul
from tpu_matmul_bench_torch.benchmarks import matmul_benchmark as port_bench
from tpu_matmul_bench_torch.benchmarks.runner import run_sizes
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops.matmul import make_matmul, operands_from_numpy
from tpu_matmul_bench_torch.utils import timing
from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord

SMALL = ["--sizes", "128", "--iterations", "2", "--warmup", "1", "--validate"]

pytestmark = pytest.mark.usefixtures("single_torch_thread")


@pytest.mark.parametrize("impls", [("pallas", "cuda"), ("xla", "torch")],
                         ids=["kernel", "library"])
@pytest.mark.parametrize("dtype_name", list(TOLERANCE))
def test_make_matmul_matches_jax(impls, dtype_name):
    jax_impl, port_impl = impls
    a_np, b_np = numpy_operands(11, 256, 384, 128, dtype_name)
    want = jax_make_matmul(jax_impl)(jnp.asarray(a_np), jnp.asarray(b_np))
    got = make_matmul(port_impl)(*operands_from_numpy(a_np, b_np, device="cpu"))
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    assert rel_err(as_numpy(got), want) <= TOLERANCE[dtype_name]


def test_auto_routes_to_the_library_on_the_cpu():
    a_np, b_np = numpy_operands(12, 64, 64, 64, "float32")
    a, b = operands_from_numpy(a_np, b_np, device="cpu")
    before = cm.LAUNCHES
    got = make_matmul("auto", "cpu")(a, b)
    assert torch.equal(got, torch.matmul(a, b))
    assert cm.LAUNCHES == before


def _ledger(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def test_main_matches_jax_record_contract(tmp_path):
    jax_out, port_out = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jax_recs = jax_bench.main(SMALL + ["--num-devices", "1", "--matmul-impl",
                                       "pallas", "--json-out", str(jax_out)])
    port_recs = port_bench.main(SMALL + ["--device", "cpu", "--matmul-impl",
                                         "cuda", "--json-out", str(port_out)])
    assert len(jax_recs) == len(port_recs) == 1
    jax_lines, port_lines = _ledger(jax_out), _ledger(port_out)
    for lines in (jax_lines, port_lines):
        assert lines[0]["record_type"] == "manifest"
        assert lines[1]["extras"]["validation"] == "ok"
    assert set(jax_lines[1]) == set(port_lines[1])  # same record fields
    # the manifest keeps the schema-v2 keys; only the versions differ
    # ("artifacts" appears only under --trace-out in the port, while the
    # JAX package keeps earlier runs' artifacts for the whole process)
    renamed = {"jax_version": "torch_version", "jaxlib_version": "cuda_version"}
    assert {renamed.get(k, k) for k in jax_lines[0]} - {"artifacts"} == \
        set(port_lines[0])
    assert set(jax_lines[0]["config"]) == set(port_lines[0]["config"])
    port = port_lines[1]
    assert port["size"] == 128 and port["device_kind"] == "cpu"
    assert port["mode"] == "single" and port["world"] == 1


def test_main_fused_timing_on_the_cpu(tmp_path):
    out = tmp_path / "fused.jsonl"
    (rec,) = port_bench.main(SMALL + ["--device", "cpu", "--matmul-impl", "cuda",
                                      "--timing", "fused", "--json-out", str(out)])
    assert rec.extras["validation"] == "ok"
    assert rec.extras["timing"] == "fused"
    assert "chain" not in rec.extras  # the operand chain was live
    assert rec.iterations % 2 == 0 and rec.warmup == 2
    assert _ledger(out)[1]["extras"]["timing"] == "fused"


def test_main_mkn_matches_jax(tmp_path):
    mkn = ["--mkn", "64", "96", "32"]
    base = ["--iterations", "2", "--warmup", "1", "--validate"]
    (jrec,) = jax_bench.main(base + mkn + ["--num-devices", "1"])
    (prec,) = port_bench.main(base + mkn + ["--device", "cpu",
                                            "--json-out", str(tmp_path / "r.jsonl")])
    for rec in (jrec, prec):
        assert rec.extras["shape"] == "64x96x32"
        assert rec.flops_per_op == 2.0 * 64 * 96 * 32
        assert rec.size == 96
        assert rec.extras["validation"] == "ok"


def test_main_int8_through_the_library(tmp_path):
    (rec,) = port_bench.main(SMALL + ["--device", "cpu", "--dtype", "int8",
                                      "--matmul-impl", "torch"])
    assert rec.extras["validation"] == "ok"
    assert rec.extras["validation_tolerance"] == 0.0
    assert rec.extras["throughput_unit"] == "TOPS"


def test_main_samples_percentiles_and_trace(tmp_path):
    trace = tmp_path / "trace.json"
    (rec,) = port_bench.main(SMALL + ["--device", "cpu", "--samples",
                                      "--percentiles", "--repeats", "2",
                                      "--trace-out", str(trace)])
    assert rec.extras["samples"]["n"] == 2
    assert set(rec.extras["latency_ms"]) == {"p50", "p90", "p99", "min", "max"}
    assert rec.extras["repeats"] == 2
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"compile", "warmup", "sync-calibrate", "measure",
            "size:128"} <= names


def test_fused_chain_feeds_each_call_the_previous_output():
    a = torch.full((4, 4), 0.5)
    b = torch.eye(4)
    state: dict = {}
    fused = timing.fuse_iterations(lambda x, y: x @ y + 0.25, 3, chain_state=state)
    got = fused(a, b)
    # by hand: each call's operands carry clamp(prev[0, 0], 0, 1) in [0, 0]
    x, y = a.clone(), b.clone()
    out = x @ y + 0.25
    for _ in range(2):
        v = out[0, 0].clamp(0, 1)
        x[0, 0], y[0, 0] = v, v
        out = x @ y + 0.25
    assert torch.equal(got, out)
    assert state == {"chain": "operand"}
    assert torch.equal(a, torch.full((4, 4), 0.5))  # caller's operands intact


def test_time_fused_counts_every_call():
    a = torch.ones(8, 8)
    t = timing.time_fused(lambda x, y: x @ y, (a, a), iterations=3)
    assert t.iterations % 3 == 0 and t.chain == "operand" and t.total_s > 0


def _config(*extra):
    return config_from_args(build_parser("t").parse_args(
        ["--sizes", "64", "128", "--device", "cpu", *extra]))


def test_runner_skips_an_oom_size_and_goes_on():
    def bench_one(size):
        if size == 64:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return BenchmarkRecord("matmul", "single", size, "bfloat16", 1, 1, 1,
                               1e-3, 1.0, 1.0)

    records = run_sizes(_config(), bench_one)
    assert [r.size for r in records] == [128]


def test_runner_memory_guard_skips_before_allocating():
    called = []
    records = run_sizes(_config(), lambda s: called.append(s),
                        memory_gib=lambda s: float(s), memory_limit_gib=10.0)
    assert records == [] and called == []


def test_json_writer_append_repairs_a_torn_tail(tmp_path):
    from tpu_matmul_bench_torch.utils.reporting import JsonWriter
    from tpu_matmul_bench_torch.utils.telemetry import build_manifest, is_manifest

    path = tmp_path / "ledger.jsonl"
    rec = BenchmarkRecord("matmul", "single", 64, "bfloat16", 1, 1, 1, 1e-3,
                          1.0, 1.0)
    with JsonWriter(str(path), manifest=build_manifest()) as jw:
        jw.write(rec)
    with open(path, "a") as fh:
        fh.write('{"torn": ')  # a crash mid-line
    with JsonWriter(str(path), manifest=build_manifest(), append=True) as jw:
        jw.write(rec)
    lines = _ledger(path)
    assert is_manifest(lines[0]) and lines[0]["backend"] == "cpu"
    assert [is_manifest(x) for x in lines] == [True, False, False]


def test_cli_program_table(capsys):
    from tpu_matmul_bench_torch.__main__ import main

    with pytest.raises(SystemExit) as e:
        main([])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    assert "matmul" in capsys.readouterr().out
