"""The port's `collectives` program (`parallel/collective_bench.py`,
`benchmarks/collective_benchmark.py`) against the JAX package's.

All six ops run on D ranks that share the CPU, the JAX package's programs
on the first D devices of the conftest's 8-device mesh, from the same numpy
payloads: outputs equal to JAX's and to `_collective_reference` (exact for
the ops that only move data, the dtype's validation tolerance for the
sums), the same reference, the same algbw/busbw conventions and record
fields. `collectives selftest` exits 0 over 8 CPU ranks and 1 with fewer
than 2.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_port_util import as_numpy, rel_err, single_torch_thread  # noqa: F401

from tpu_matmul_bench.benchmarks import collective_benchmark as jax_bench
from tpu_matmul_bench.parallel import collective_bench as jcb
from tpu_matmul_bench.parallel.mesh import make_mesh as jax_make_mesh
from tpu_matmul_bench.utils.config import parse_config as jax_parse_config
from tpu_matmul_bench_torch import __main__ as port_main
from tpu_matmul_bench_torch.benchmarks import collective_benchmark as bench
from tpu_matmul_bench_torch.parallel import collective_bench as cb
from tpu_matmul_bench_torch.parallel import mesh
from tpu_matmul_bench_torch.parallel.mesh import ROWS, gather, shard_from_numpy
from tpu_matmul_bench_torch.parallel.modes import validation_tolerance
from tpu_matmul_bench_torch.utils.config import parse_config

pytestmark = pytest.mark.usefixtures("single_torch_thread")

OPS = list(jcb.COLLECTIVES)
SUMS = ("psum", "reduce_scatter")
SMALL = ["--sizes", "16", "--iterations", "2", "--warmup", "1"]


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def port_mesh(d: int) -> mesh.Mesh:
    return mesh.make_mesh([torch.device("cpu")] * d)


def _config(*extra, dtype="float32"):
    return parse_config([*SMALL, "--device", "cpu", "--dtype", dtype, *extra], "t",
                        modes=OPS, extra_dtypes=("int8",), fused_timing=True, wres=False)


def _jax_config(*extra, dtype="float32"):
    return jax_parse_config([*SMALL, "--dtype", dtype, *extra], "t", modes=OPS,
                            extra_dtypes=("int8",), fused_timing=True)


def _payload(d: int, size: int, dtype: str) -> np.ndarray:
    rng = np.random.default_rng(d * 100 + size)
    if dtype == "int8":
        return rng.integers(-8, 8, size=(d * size, size)).astype(np.int8)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return rng.normal(size=(d * size, size)).astype(np_dtype)


def test_the_ops_and_conventions_match_jax():
    assert list(cb.COLLECTIVES) == list(jcb.COLLECTIVES)
    for op, spec in cb.COLLECTIVES.items():
        jspec = jcb.COLLECTIVES[op]
        assert spec.name == jspec.name == op
        assert spec.needs_divisible_size == jspec.needs_divisible_size
        for d in range(1, 9):
            assert spec.bus_factor(d) == jspec.bus_factor(d)
            assert spec.mem_factor(d) == jspec.mem_factor(d)
            assert spec.conv_size(d, 4096) == jspec.conv_size(d, 4096)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("op", OPS)
def test_reference_matches_jax(op, d):
    x = _payload(d, 8, "float32")
    np.testing.assert_array_equal(cb._collective_reference(op, d, x),
                                  jcb._collective_reference(op, d, x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("op", OPS)
def test_op_matches_jax_and_reference(devices, op, d, dtype):
    size = 16
    x = _payload(d, size, dtype)
    jmesh = jax_make_mesh(devices[:d])
    jfn, jx, _ = jcb.collective_setup(_jax_config(dtype=dtype), jmesh, size, op)
    want = np.asarray(jfn(jax.device_put(jnp.asarray(x), jx.sharding))).astype(np.float64)
    pm = port_mesh(d)
    fn, _, _ = cb.collective_setup(_config(dtype=dtype), pm, size, op)
    out = fn(shard_from_numpy(x, ROWS, pm))
    assert out.spec == ROWS and len(out) == d
    got = as_numpy(gather(out)).astype(np.float64)
    ref = cb._collective_reference(op, d, x.astype(np.float64))
    assert got.shape == want.shape == ref.shape
    if op in SUMS and dtype != "int8":
        # the sums round once to the dtype, each side in its own order
        tol = validation_tolerance(dtype)
        assert rel_err(got, want) <= tol and rel_err(got, ref) <= tol
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("op", OPS)
def test_validate_collective_is_ok(op):
    assert cb.validate_collective(_config(dtype="bfloat16"), port_mesh(4), op)[
        "validation"] == "ok"


@pytest.mark.parametrize("timing", ["dispatch", "fused"])
@pytest.mark.parametrize("op", OPS)
def test_record_fields_match_jax(devices, op, timing):
    d = 4
    argv = ["--validate", "--timing", timing]
    jrec = jcb.run_collective_benchmark(_jax_config(*argv), jax_make_mesh(devices[:d]), 16, op)
    rec = cb.run_collective_benchmark(_config(*argv), port_mesh(d), 16, op)
    jrec.finalize()
    rec.finalize()
    assert set(vars(rec)) == set(vars(jrec))
    assert set(rec.extras) == set(jrec.extras) | {"cards", "ranks_per_card"}
    assert (rec.extras["cards"], rec.extras["ranks_per_card"]) == (1, d)
    for key in ("benchmark", "mode", "size", "dtype", "world", "warmup",
                "bytes_per_device", "tflops_per_device", "tflops_total",
                "peak_efficiency_pct", "device_kind"):
        assert getattr(rec, key) == getattr(jrec, key), key
    assert rec.iterations >= 2  # the timed loop stretches short windows
    assert rec.extras["validation"] == jrec.extras["validation"] == "ok"
    assert rec.extras["bus_factor"] == jrec.extras["bus_factor"]
    spec = cb.COLLECTIVES[op]
    assert rec.algbw_gbps == pytest.approx(
        spec.conv_size(d, rec.bytes_per_device) / rec.avg_time_s / 1e9)
    assert rec.busbw_gbps == pytest.approx(rec.algbw_gbps * spec.bus_factor(d))
    assert rec.comm_time_s == rec.avg_time_s


def test_cli_runs_every_op_over_cpu_ranks(ranks8, tmp_path):
    for op in OPS:
        (rec,) = port_main.main(["collectives", *SMALL, "--device", "cpu", "--mode", op,
                                 "--validate", "--json-out", str(tmp_path / f"{op}.jsonl")])
        assert (rec.mode, rec.world, rec.extras["validation"]) == (op, 8, "ok")


def test_cli_default_mode_and_divisible_sizes(ranks8, capsys):
    (rec,) = port_main.main(["collectives", *SMALL, "--device", "cpu"])
    assert rec.mode == "psum"
    recs = port_main.main(["collectives", "--sizes", "12", "16", "--iterations", "1",
                           "--device", "cpu", "--mode", "all_to_all"])
    assert [r.size for r in recs] == [16]
    assert "Skipping size 12: all_to_all needs the size divisible by the 8-device world" \
        in capsys.readouterr().out


def test_cli_needs_two_ranks(capsys):
    with pytest.raises(SystemExit) as e:
        port_main.main(["collectives", *SMALL, "--device", "cpu"])
    assert e.value.code == 1
    assert "needs >= 2 devices" in capsys.readouterr().out


def test_selftest_passes_over_eight_ranks(ranks8, capsys):
    assert port_main.main(["collectives", "selftest", "--device", "cpu"]) == []
    out = capsys.readouterr().out
    assert "Comm-quant selftest passed." in out and "FAILED" not in out
    assert out.count("PASSED") == 8


def test_selftest_checks_match_jax(ranks8, capsys):
    port_main.main(["collectives", "selftest", "--device", "cpu"])
    port = [line for line in capsys.readouterr().out.splitlines() if "PASSED" in line]
    jax_bench.comm_quant_selftest()
    jax = [line for line in capsys.readouterr().out.splitlines() if "PASSED" in line]
    # the same checks, in order, each PASSED; the numbers are the port's own
    assert [line.split(":")[0] for line in port] == [line.split(":")[0] for line in jax]


def test_selftest_needs_two_ranks(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(["selftest", "--device", "cpu"])
    assert e.value.code == 1
    assert "needs >= 2 ranks" in capsys.readouterr().out


def test_selftest_fails_on_a_broken_format(ranks8, monkeypatch, capsys):
    from tpu_matmul_bench_torch.parallel import collectives

    # a wire that drops the sum: every bound fails, and the selftest exits 1
    monkeypatch.setattr(collectives, "wire_psum",
                        lambda m, shards, fmt, out_dtype=None: [s * 0 for s in shards])
    with pytest.raises(SystemExit) as e:
        bench.main(["selftest", "--device", "cpu"])
    assert e.value.code == 1
    assert "FAILED" in capsys.readouterr().out
