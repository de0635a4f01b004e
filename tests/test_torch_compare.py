"""The port's comparison driver (`benchmarks/compare_benchmarks.py`,
`compare`) against the JAX package's.

- The row keys are JAX's, its five `pallas_ring*` keys mapped to the port's
  ring modes by one table (`RING_ROW_KEYS`).
- `bf16_vs_fp32_line`, `summarize` and `render_markdown` are pure: the same
  records go through both packages' functions (keyed by each package's
  names) and give the same text, once JAX's `pallas_` names read `cuda_`
  and runs of spaces are one (the summary pads names to 20 columns, and
  the ring names differ in length).
- The port's own table at 64² fp32 over 8 CPU ranks has every row; the
  `--only` typo refusal; `--isolate` children, its probe, its failed-row
  and rc rules, and the reporting gate restored after it. JAX's whole
  `compare` is not rerun here (its CPU runtime aborts xdist workers).
"""

import json
import re

import pytest
from torch_port_util import single_torch_thread  # noqa: F401

from tpu_matmul_bench.benchmarks import compare_benchmarks as jcompare
from tpu_matmul_bench.utils.reporting import BenchmarkRecord as JaxRecord
from tpu_matmul_bench_torch import __main__ as port_main
from tpu_matmul_bench_torch.benchmarks import compare_benchmarks as compare
from tpu_matmul_bench_torch.parallel import mesh
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord, reporting_process_override

pytestmark = pytest.mark.usefixtures("single_torch_thread")

ARGS = ["--device", "cpu", "--size", "64", "--iterations", "2", "--warmup", "1",
        "--dtype", "float32"]


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def test_row_keys_are_jax_keys_mapped():
    assert set(compare.RING_ROW_KEYS) == {k for k in jcompare.ROW_KEYS if "pallas" in k}
    assert compare.ROW_KEYS == {compare.RING_ROW_KEYS.get(k, k) for k in jcompare.ROW_KEYS}
    assert all(v == k.replace("pallas_", "cuda_") for k, v in compare.RING_ROW_KEYS.items())


def test_main_registry_has_the_five_programs():
    for name, module in (("curve", "scaling_curve"), ("membw", "membw_benchmark"),
                         ("doctor", "doctor"), ("compare", "compare_benchmarks")):
        assert port_main._PROGRAMS[name] == f"tpu_matmul_bench_torch.benchmarks.{module}"
    assert port_main._PROGRAMS["train"] == "tpu_matmul_bench_torch.train.cli"
    assert port_main._PROGRAMS["serve"] == "tpu_matmul_bench_torch.serve.cli"
    assert len(port_main._PROGRAMS) == 15


# ------------------------------------------------------------- the renderers

def _table(cls, key=lambda k: k, timing=None):
    """One record a row key (JAX's keys, or the port's through `key`)."""
    out = {}
    for i, name in enumerate(sorted(jcompare.ROW_KEYS)):
        extras = {}
        if name == "batch_parallel":
            extras["note"] = "global batch grown from 4 to 8 to cover 8 devices"
        if name == "collective_matmul":
            extras["overlap_speedup_x"] = 1.069
        if name == "summa":
            extras["grid"] = "2x4"
        if timing and "pallas" not in name:
            extras["timing"] = timing
        if timing and "pallas" in name:
            extras["timing"] = "dispatch"
        out[key(name)] = cls(
            benchmark="x", mode=name, size=16384, dtype="bfloat16", world=8,
            iterations=5, warmup=1, avg_time_s=0.01 + 0.001 * i,
            tflops_per_device=100.0 + i, tflops_total=800.0 + 8 * i,
            comm_time_s=None if i % 3 else 0.002 * i,
            scaling_efficiency_pct=None if i % 2 else 90.0 + i, extras=extras)
    return out


def _port_key(k):
    return compare.RING_ROW_KEYS.get(k, k)


def _same(port_text: str, jax_text: str) -> None:
    def norm(t):
        return re.sub(r" +", " ", t)

    assert norm(port_text) == norm(jax_text.replace("pallas_", "cuda_"))


@pytest.mark.parametrize("subset", ["all", "no_rings", "dtype_only", "one", "empty"])
@pytest.mark.parametrize("timing", [None, "fused"])
def test_renderers_match_jax(subset, timing):
    j, p = _table(JaxRecord, timing=timing), _table(BenchmarkRecord, _port_key, timing)
    keep = {"all": lambda k: True, "no_rings": lambda k: "pallas" not in k,
            "dtype_only": lambda k: k.startswith("single_"),
            "one": lambda k: k == "independent", "empty": lambda k: False}[subset]
    j = {k: v for k, v in j.items() if keep(k)}
    p = {_port_key(k): p[_port_key(k)] for k in j}
    _same(compare.summarize(p), jcompare.summarize(j))
    _same(compare.render_markdown(p), jcompare.render_markdown(j))
    assert compare.bf16_vs_fp32_line(p) == jcompare.bf16_vs_fp32_line(j)
    if subset == "no_rings":  # no name to map: the text is JAX's exactly
        assert compare.summarize(p) == jcompare.summarize(j)
        assert compare.render_markdown(p) == jcompare.render_markdown(j)


@pytest.mark.parametrize("rows", [("single_float32", "single_bfloat16"),
                                  ("single_float32", "single_bfloat16", "single_float32_strict"),
                                  ("single_float32",), ()])
def test_bf16_vs_fp32_line_matches_jax(rows):
    j, p = _table(JaxRecord), _table(BenchmarkRecord)
    assert compare.bf16_vs_fp32_line({k: p[k] for k in rows}) == \
        jcompare.bf16_vs_fp32_line({k: j[k] for k in rows})


# --------------------------------------------------------------- the table

def test_table_over_eight_cpu_ranks_has_every_row(ranks8, tmp_path):
    out, md = tmp_path / "cmp.jsonl", tmp_path / "cmp.md"
    results = compare.main([*ARGS, "--validate", "--json-out", str(out),
                            "--markdown-out", str(md)])
    assert set(results) == compare.ROW_KEYS
    # --validate reached every row: the step modes' programs give no verdict
    steps = {"no_overlap", "overlap", "pipeline"}
    assert {k for k, r in results.items() if r.extras["validation"] == "ok"} == \
        compare.ROW_KEYS - steps
    assert all(results[k].extras["validation"].startswith("n/a") for k in steps)
    assert results["single_float32"] is results["single"]  # the table's dtype
    assert results["cuda_ring"].mode == "cuda_ring"  # no cap on the CPU
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert lines[0]["record_type"] == "manifest"
    assert {x["comparison_key"] for x in lines[1:]} == compare.ROW_KEYS
    assert all(x["tflops_total"] > 0 for x in lines[1:])
    assert "| cuda_ring_bidir_rs_hbm |" in md.read_text()


def test_only_typo_refused_as_jax_refuses():
    with pytest.raises(SystemExit, match="unknown row key") as port:
        compare.main([*ARGS, "--only", "overlp"])
    with pytest.raises(SystemExit) as ref:
        jcompare.compare(64, "float32", None, 1, 0, only={"overlp"})
    assert str(port.value).split("; valid")[0] == str(ref.value).split("; valid")[0]
    with pytest.raises(SystemExit, match="pallas_ring"):
        compare.main([*ARGS, "--only", "pallas_ring"])  # the JAX name is not the port's


def test_only_runs_the_rows_asked_for(ranks8):
    results = compare.main([*ARGS, "--only", " independent ,single_float32_strict"])
    assert set(results) == {"independent", "single_float32_strict"}
    assert results["single_float32_strict"].extras.get("precision") == "highest"


def test_comm_quant_rides_the_quantizable_rows_only(ranks8):
    results = compare.main([*ARGS, "--comm-quant", "int8-block:16",
                            "--only", "batch_parallel,hybrid,single,overlap"])
    assert results["batch_parallel"].extras["comm_quant"]["spec"] == "int8-block:16"
    assert results["hybrid"].extras["comm_quant"]["spec"] == "int8-block:16"
    assert "comm_quant" not in results["single"].extras
    assert set(results) == {"batch_parallel", "hybrid", "single", "overlap"}


def test_timing_fused_threads_and_rings_demote(ranks8, tmp_path):
    md = tmp_path / "t.md"
    results = compare.main([*ARGS, "--timing", "fused", "--markdown-out", str(md),
                            "--only", "single,batch_parallel,cuda_ring_hbm,single_bfloat16"])
    assert results["single"].extras["timing"] == "fused"
    assert results["batch_parallel"].extras["timing"] == "fused"
    assert results["single_bfloat16"].extras["timing"] == "fused"
    assert results["cuda_ring_hbm"].extras["timing"] == "dispatch"
    assert "dispatch-demoted rows: cuda_ring_hbm" in md.read_text()


def test_fused_ring_gated_by_its_cap_on_the_card(monkeypatch, capsys):
    # under --isolate the cap comes from the probe child's L2: 4 ranks on
    # an H100's 50 MiB L2 hold 2048² bf16, so 16384² prints JAX's skip line
    monkeypatch.setattr(compare, "_probe_backend", lambda t, d: ("cuda", 4, 52428800))
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "4")

    def no_child(*a, **k):
        raise AssertionError("no row should run")

    monkeypatch.setattr(compare, "_run_isolated", no_child)
    assert compare.compare(16384, "bfloat16", None, 1, 0, isolate=True,
                           only={"cuda_ring"}) == {}
    assert ("cuda_ring skipped — L2-resident cap ~2048 < 16384; see cuda_ring_hbm"
            in capsys.readouterr().out)


# ----------------------------------------------------------------- isolate

def test_isolated_row_reads_the_child_records(ranks8):
    recs = compare._run_isolated(
        "tpu_matmul_bench_torch.benchmarks.matmul_benchmark",
        ["--device", "cpu", "--sizes", "64", "--iterations", "2", "--warmup", "1",
         "--dtype", "float32", "--num-devices", "1"], timeout_s=240.0)
    assert len(recs) == 1 and recs[0].mode == "single" and recs[0].tflops_total > 0


def test_a_failed_child_leaves_its_row_out(capsys):
    # no card and no --device cpu: the child stops with rc 1
    recs = compare._run_isolated("tpu_matmul_bench_torch.benchmarks.matmul_benchmark",
                                 ["--sizes", "64"], timeout_s=240.0)
    assert recs == []
    assert "exited rc=1 — row skipped" in capsys.readouterr().out


def test_a_hung_child_is_killed(capsys):
    recs = compare._run_isolated("tpu_matmul_bench_torch.benchmarks.matmul_benchmark",
                                 ["--device", "cpu", "--sizes", "64"], timeout_s=0.2)
    assert recs == []
    assert "killed, row skipped" in capsys.readouterr().out


def test_probe_reports_the_ranks(ranks8):
    assert compare._probe_backend(240.0, "cpu") == ("cpu", 8, None)
    assert compare._probe_backend(240.0, "cuda") == (None, 0, None)  # no card here


def test_isolate_e2e_restores_the_reporting_gate(ranks8):
    assert reporting_process_override() is None
    results = compare.compare(64, "float32", None, 2, 1, isolate=True, device="cpu",
                              mode_timeout=240.0, only={"single", "hybrid"})
    assert set(results) == {"single", "hybrid"}
    assert results["hybrid"].world == 8  # the world came from the probe
    assert reporting_process_override() is None


def test_isolate_aborts_when_the_probe_fails(monkeypatch):
    monkeypatch.setattr(compare, "_probe_backend", lambda t, d: (None, 0, None))
    with pytest.raises(SystemExit) as e:
        compare.main(["--size", "64", "--isolate", "--mode-timeout", "30"])
    assert e.value.code == 3


def test_no_rows_exits_4(monkeypatch, tmp_path):
    monkeypatch.setattr(compare, "_run_isolated", lambda *a, **k: [])
    md = tmp_path / "empty.md"
    with pytest.raises(SystemExit) as e:
        compare.main([*ARGS, "--isolate", "--only", "single", "--markdown-out", str(md)])
    assert e.value.code == 4
    assert md.exists()


def test_compare_needs_the_card_unless_cpu_is_asked_for():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compare.main(["--size", "64", "--only", "single"])
