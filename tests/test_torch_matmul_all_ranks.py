"""`matmul` over every rank: one independent product a rank, as the JAX
package's `_bench_all_devices` runs one a device.

The JAX program runs on the conftest's 8 host devices; the port's on 8
ranks that share the CPU (`TMB_RANKS_PER_CARD=8`). Both take the same
flags; the records are held to JAX's contract (`world` 8, the total the
rank count times one product's TFLOPS) and to the port's per-card count
(`tflops_per_device` = total / cards, one CPU "card" here).
"""

import json

import pytest
from torch_port_util import single_torch_thread  # noqa: F401 — a fixture

from tpu_matmul_bench.benchmarks import matmul_benchmark as jax_bench
from tpu_matmul_bench_torch.benchmarks import matmul_benchmark as port_bench
from tpu_matmul_bench_torch.parallel import mesh
from tpu_matmul_bench_torch.utils.metrics import calculate_tflops

pytestmark = pytest.mark.usefixtures("single_torch_thread")

BASE = ["--sizes", "64", "128", "--iterations", "3", "--warmup", "1", "--validate"]


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def _ledger(path):
    return [json.loads(line) for line in path.read_text().splitlines()][1:]


def _runs(tmp_path, extra):
    jax_recs = jax_bench.main(BASE + extra)
    port_recs = port_bench.main(BASE + extra + [
        "--device", "cpu", "--num-devices", "8",
        "--json-out", str(tmp_path / "port.jsonl")])
    return jax_recs, port_recs


@pytest.mark.parametrize("timing", ["dispatch", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_every_rank_runs_a_product_as_in_jax(tmp_path, ranks8, timing, dtype):
    jax_recs, port_recs = _runs(tmp_path, ["--timing", timing, "--dtype", dtype])
    assert [r.size for r in jax_recs] == [r.size for r in port_recs] == [64, 128]
    for jrec, prec in zip(jax_recs, port_recs):
        assert jrec.world == prec.world == 8
        assert jrec.tflops_total == 8 * jrec.tflops_per_device  # JAX's test_all_devices
        # the port's total: 8 products a call over the call's time
        assert prec.tflops_total == pytest.approx(
            8 * calculate_tflops(prec.size, prec.avg_time_s), rel=1e-12)
        # one CPU "card": the per-card figure is the whole total
        assert prec.tflops_per_device == prec.tflops_total
        assert prec.extras["cards"] == 1 and prec.extras["ranks_per_card"] == 8
        for key in ("validation", "validation_tolerance"):
            assert prec.extras[key] == jrec.extras[key]
        assert prec.extras["validation"] == "ok"
        if timing == "fused":
            assert prec.extras["timing"] == jrec.extras["timing"] == "fused"
    written = _ledger(tmp_path / "port.jsonl")
    assert [r["world"] for r in written] == [8, 8]


def test_extras_are_jax_keys_and_the_card_count(tmp_path, ranks8):
    """The all-rank record carries what JAX's does, what the port's
    one-rank record adds to JAX's one-device record, and `cards` and
    `ranks_per_card`."""
    (jax_one,) = jax_bench.main(BASE[:1] + ["64"] + BASE[3:] + ["--num-devices", "1"])
    (port_one,) = port_bench.main(BASE[:1] + ["64"] + BASE[3:] + ["--device", "cpu",
                                                                  "--num-devices", "1"])
    jax_recs, port_recs = _runs(tmp_path, [])
    port_only = set(port_one.extras) - set(jax_one.extras)
    for jrec, prec in zip(jax_recs, port_recs):
        assert set(prec.extras) == (set(jrec.extras) | port_only
                                    | {"cards", "ranks_per_card"})


def test_kernel_record_carries_one_launchs_books(tmp_path, ranks8):
    (rec,) = port_bench.main(["--sizes", "64", "--iterations", "2", "--warmup", "1",
                              "--device", "cpu", "--num-devices", "8",
                              "--matmul-impl", "cuda", "--dtype", "bfloat16"])
    (one,) = port_bench.main(["--sizes", "64", "--iterations", "2", "--warmup", "1",
                              "--device", "cpu", "--num-devices", "1",
                              "--matmul-impl", "cuda", "--dtype", "bfloat16"])
    assert rec.world == 8
    assert rec.extras["cost_analysis"] == one.extras["cost_analysis"]


@pytest.mark.parametrize("ranks", [1, 2, 8])
def test_world_is_the_rank_count(tmp_path, ranks8, ranks):
    (rec,) = port_bench.main(["--sizes", "64", "--iterations", "2", "--warmup", "1",
                              "--device", "cpu", "--num-devices", str(ranks)])
    assert rec.world == ranks
    assert rec.tflops_total == pytest.approx(
        ranks * calculate_tflops(64, rec.avg_time_s), rel=1e-12)
    assert ("cards" in rec.extras) == (ranks > 1)


def test_mkn_over_several_ranks_exits_as_jax_does(ranks8):
    argv = ["--mkn", "64", "96", "32", "--iterations", "2", "--warmup", "1"]
    with pytest.raises(SystemExit) as jax_exit:
        jax_bench.main(argv)
    with pytest.raises(SystemExit) as port_exit:
        port_bench.main(argv + ["--device", "cpu", "--num-devices", "8"])
    assert str(port_exit.value) == str(jax_exit.value)
    assert "--mkn is single-device" in str(port_exit.value)
