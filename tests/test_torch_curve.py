"""The port's scaling-curve driver (`benchmarks/scaling_curve.py`, `curve`)
against the JAX package's.

`render_curve`, `default_counts` and `_parse_counts` are pure: the same
records and inputs go through both packages' functions and must give the
same text and values (records whose ranks share a card add the port's
note under the table). Then one port run at 64² fp32 over 8 ranks on the
CPU, which JAX's whole `curve` does not need to repeat.
"""

import argparse
import json

import pytest
from torch_port_util import single_torch_thread  # noqa: F401

from tpu_matmul_bench.benchmarks import scaling_curve as jcurve
from tpu_matmul_bench.utils.reporting import BenchmarkRecord as JaxRecord
from tpu_matmul_bench_torch.benchmarks import scaling_curve as curve
from tpu_matmul_bench_torch.parallel import mesh
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord

pytestmark = pytest.mark.usefixtures("single_torch_thread")


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


ROWS = [(1, 190.04, 190.04, None), (2, 372.5, 186.25, 98.04), (4, 700.0, 175.0, 92.1),
        (8, 1380.55, 172.57, 90.5)]


def _rows(cls, extras=None):
    out = []
    for n, total, per, eff in ROWS:
        rec = cls(benchmark="scaling", mode="independent", size=16384, dtype="bfloat16",
                  world=n, iterations=5, warmup=1, avg_time_s=0.1,
                  tflops_per_device=per, tflops_total=total,
                  scaling_efficiency_pct=eff, extras=dict(extras(n) if extras else {}))
        out.append((n, rec))
    return out


@pytest.mark.parametrize("mode", ["independent", "batch_parallel"])
@pytest.mark.parametrize("count", [0, 1, 4])
def test_render_curve_matches_jax(mode, count):
    assert curve.render_curve(mode, 16384, _rows(BenchmarkRecord)[:count]) == \
        jcurve.render_curve(mode, 16384, _rows(JaxRecord)[:count])


def test_render_curve_names_the_cards_of_shared_ranks():
    rows = _rows(BenchmarkRecord, lambda n: {"cards": 1, "ranks_per_card": n})
    text = curve.render_curve("batch_parallel", 16384, rows)
    table = jcurve.render_curve("batch_parallel", 16384, _rows(JaxRecord))
    assert text.startswith(table + "\n\n")
    assert text.endswith("Devices are ranks: 2 on 1 card(s), 4 on 1 card(s), 8 on 1 "
                         "card(s); TFLOPS/device and Scaling count cards.")


@pytest.mark.parametrize("world", range(1, 17))
def test_default_counts_match_jax(world):
    assert curve.default_counts(world) == jcurve.default_counts(world)


@pytest.mark.parametrize("text", ["1,2,4", "4,2,1,2", " 8 , 1", "1,,2", "", ",", "a,b",
                                  "0,2", "-1", "1.5"])
def test_parse_counts_matches_jax(text):
    def outcome(fn):
        try:
            return "ok", fn(text)
        except argparse.ArgumentTypeError as e:
            return "error", str(e)

    assert outcome(curve._parse_counts) == outcome(jcurve._parse_counts)


def test_curve_over_eight_cpu_ranks(ranks8, tmp_path):
    md, out = tmp_path / "curve.md", tmp_path / "curve.jsonl"
    recs = curve.main(["--device", "cpu", "--mode", "independent", "--sizes", "64",
                       "--iterations", "2", "--warmup", "1", "--dtype", "float32",
                       "--markdown-out", str(md), "--json-out", str(out)])
    # the default counts: powers of two up to the 8 ranks
    assert [r.world for r in recs] == [1, 2, 4, 8]
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert lines[0]["record_type"] == "manifest"
    lines = lines[1:]
    assert [x["extras"]["curve_devices"] for x in lines] == [1, 2, 4, 8]
    assert lines[0]["scaling_efficiency_pct"] is None
    assert all(x["scaling_efficiency_pct"] is not None for x in lines[1:])
    assert all((x["extras"]["cards"], x["extras"]["ranks_per_card"]) == (1, x["world"])
               for x in lines)
    table = md.read_text()
    assert table.count("\n| ") == 4 and "| Devices |" in table and "| 8 |" in table
    assert "Devices are ranks: 2 on 1 card(s), 4 on 1 card(s), 8 on 1 card(s)" in table


def test_curve_counts_flag_and_refusals(ranks8):
    recs = curve.main(["--device", "cpu", "--mode", "batch_parallel", "--sizes", "64",
                       "--iterations", "1", "--warmup", "0", "--dtype", "float32",
                       "--device-counts", "2,1"])
    assert [r.world for r in recs] == [1, 2]
    with pytest.raises(SystemExit, match="ONE size"):
        curve.main(["--device", "cpu", "--sizes", "64", "128"])
    with pytest.raises(ValueError, match="--num-devices 16: 8 available"):
        curve.main(["--device", "cpu", "--sizes", "64", "--device-counts", "16"])


def test_curve_with_a_failed_count_exits_1(ranks8, monkeypatch):
    from tpu_matmul_bench_torch.benchmarks import matmul_scaling_benchmark as scaling

    real = scaling.run
    monkeypatch.setattr(scaling, "run",
                        lambda c, **kw: [] if c.num_devices == 2 else real(c, **kw))
    with pytest.raises(SystemExit) as e:
        curve.main(["--device", "cpu", "--sizes", "64", "--iterations", "1",
                    "--warmup", "0", "--dtype", "float32", "--device-counts", "1,2"])
    assert e.value.code == 1


def test_curve_needs_the_card_unless_cpu_is_asked_for():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        curve.main(["--sizes", "64"])
