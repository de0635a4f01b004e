"""The port's tune program (`benchmarks/cuda_tune.py`) against the JAX
package's (`benchmarks/pallas_tune.py`), and the tile rules it stands on.

Both programs run the same small problem, the port with `--device cpu`,
where the kernel wrappers run their plain versions; their records are held
to the same contract. The behaviours that tests/test_tune.py pins for the
JAX tuner are pinned here for the port's, with the port's tiles.
"""

import json
import re
from pathlib import Path

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

from tpu_matmul_bench.benchmarks import pallas_tune as jax_tune
from tpu_matmul_bench.ops.pallas_matmul import pallas_matmul
from tpu_matmul_bench.tune.cli import SUBCOMMANDS as JAX_SUBCOMMANDS
from tpu_matmul_bench_torch.benchmarks import cuda_tune
from tpu_matmul_bench_torch.ops import _build
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops.matmul import operands_from_numpy
from tpu_matmul_bench_torch.tune import cli as tune_cli
from tpu_matmul_bench_torch.utils import timing
from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args
from tpu_matmul_bench_torch.utils.reporting import JsonWriter

pytestmark = pytest.mark.usefixtures("single_torch_thread")

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--iterations", "2", "--warmup", "1"]
CPU = ["--device", "cpu"]


def _ledger(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _tiles(records):
    return [tuple(r.extras[f"block_{d}"] for d in "mnk") for r in records]


# ------------------------------------------------------------- tile rules

def test_tiles_match_the_cuda_source():
    src = (REPO / "tpu_matmul_bench_torch/csrc/matmul.cu").read_text()
    macro = re.search(r"#define TMB_TILES\(X\)(.*?)\n\n", src, re.S).group(1)
    listed = tuple(tuple(int(v) for v in t.split(","))
                   for t in re.findall(r"X\(([\d, ]+)\)", macro))
    assert listed == cm.TILES


def test_tiles_are_ordered_by_size():
    key = [(bm * bn * bk, bm * bn, bm) for bm, bn, bk in cm.TILES]
    assert key == sorted(key) and len(set(key)) == len(key)
    # the default is the wgmma route's fastest tile at bf16 16384^3 on the
    # H100 (PERF.md), the tile added for that route; 128x128x32 was the
    # wmma route's default
    assert cm.DEFAULT_TILE == (128, 256, 64) and cm.DEFAULT_TILE in cm.TILES


@pytest.mark.parametrize("want, tile", [
    ((128, 128, 32), (128, 128, 32)),
    ((64, 128, 32), (64, 128, 32)),
    ((256, 128, 32), (256, 128, 32)),
    ((96, 96, 96), (64, 128, 32)),       # none fits: the smallest tile
    ((128, 128, 48), (128, 128, 32)),    # bk cut to the tile below it
    ((512, 512, 512), (128, 256, 64)),   # the last tile that fits
    ((512, 512, 32), (256, 128, 32)),    # the last tile that fits at bk 32
    ((128, 512, 64), (128, 256, 64)),
    ((128, 96, 64), (128, 64, 32)),
])
def test_effective_blocks_rule(want, tile):
    assert cm.effective_blocks(4096, 4096, 4096, *want, torch.bfloat16) == tile
    # the problem's size does not enter: the kernel masks ragged edges
    assert cm.effective_blocks(7, 13, 5, *want, "bfloat16") == tile


def test_effective_blocks_fp32_is_the_simt_tile():
    for want in cm.TILES + ((8, 8, 8),):
        assert cm.effective_blocks(256, 256, 256, *want, torch.float32) == cm.SIMT_TILE


def test_effective_blocks_rejects_non_positive():
    with pytest.raises(ValueError, match="positive"):
        cm.effective_blocks(64, 64, 64, 0, 128, 32, torch.bfloat16)


@pytest.mark.parametrize("fn", [cm.cuda_matmul, cm.cuda_matmul_ksplit])
def test_unknown_grid_order_raises(fn):
    a = torch.ones(8, 256)
    with pytest.raises(ValueError, match="grid_order"):
        fn(a, a.T.contiguous(), grid_order="kmn")


@pytest.mark.parametrize("order", ["mnk", "nmk"])
@pytest.mark.parametrize("tile", [(64, 128, 32), (256, 128, 32)],
                         ids=lambda t: "x".join(map(str, t)))
def test_tile_and_order_match_pallas(tile, order):
    a_np, b_np = numpy_operands(31, 129, 64, 257, "bfloat16")
    want = pallas_matmul(jnp.asarray(a_np), jnp.asarray(b_np), grid_order=order)
    got = cm.cuda_matmul(*operands_from_numpy(a_np, b_np, device="cpu"),
                         blocks=tile, grid_order=order)
    assert rel_err(as_numpy(got), want) <= TOLERANCE["bfloat16"]


def test_block_flags_fill_from_the_default_tile():
    def cfg(*flags):
        return config_from_args(build_parser("t").parse_args(list(flags)))

    assert cfg().blocks is None
    assert cfg("--block-n", "128").blocks == (128, 128, 64)
    assert cfg("--block-m", "64", "--block-n", "128", "--block-k", "64"
               ).blocks == (64, 128, 64)
    with pytest.raises(ValueError, match="positive"):
        cfg("--block-n", "0").blocks


# ----------------------------------------------------------------- build

def test_build_keeps_the_ptxas_report():
    assert ("-Xptxas", "-v") == _build.NVCC_FLAGS[-2:]


PTXAS_SAMPLE = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19wmma_gemmI13__nv_bfloat16Lb1ELi128ELi128ELi32EEEvPKT_S4_Pviiiimib' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19wmma_gemmI13__nv_bfloat16Lb1ELi128ELi128ELi32EEEvPKT_S4_Pviiiimib
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113simt_gemm_f32EPKfS1_Pfiiiiimi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113simt_gemm_f32EPKfS1_Pfiiiiimi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, 412 bytes cmem[0]
"""


def test_parse_ptxas_report():
    usage = _build.parse_ptxas(PTXAS_SAMPLE)
    wmma, simt = sorted(usage, key=len, reverse=True)
    assert usage[wmma] == {"registers": 168, "stack_bytes": 0,
                           "spill_store_bytes": 8, "spill_load_bytes": 12}
    assert usage[simt]["registers"] == 48 and usage[simt]["spill_load_bytes"] == 0


@pytest.mark.parametrize("readable, short", [
    ("void <unnamed>::wmma_gemm<__nv_bfloat16, (bool)1, (int)128, (int)128, (int)32>"
     "(const T1 *, const T1 *, void *, int, int)",
     "wmma_gemm<__nv_bfloat16, true, 128, 128, 32>"),
    ("void (anonymous namespace)::reduce_partials<float, __half, (bool)0>"
     "(const T1 *, T2 *, int, unsigned long)",
     "reduce_partials<float, __half, false>"),
    ("<unnamed>::simt_gemm_f32(const float *, int)", "simt_gemm_f32"),
])
def test_kernel_short_names(readable, short):
    assert _build.short_name(readable) == short


# ------------------------------------------------------------ the program

def test_tune_matches_jax_record_contract(tmp_path):
    common = ["--sizes", "256", *SMALL, "--validate", "--confirm-top", "0",
              "--candidates", "128,128,32", "64,128,32"]
    jax_out, port_out = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jax_recs = jax_tune.main(common + ["--num-devices", "1",
                                       "--json-out", str(jax_out)])
    port_recs = cuda_tune.main(common + CPU + ["--json-out", str(port_out)])
    assert len(jax_recs) == len(port_recs) == 2
    jax_lines, port_lines = _ledger(jax_out), _ledger(port_out)
    for lines in (jax_lines, port_lines):
        assert lines[0]["record_type"] == "manifest"
        assert all(r["extras"]["validation"] == "ok" for r in lines[1:])
        assert all(r["benchmark"] == "tune" for r in lines[1:])
    assert {r["mode"] for r in port_lines[1:]} == {"cuda_tune"}
    assert set(jax_lines[1]) == set(port_lines[1])  # the same record fields
    # the same extras keys, `cost_analysis` included where JAX's record has
    # one: the port's is its kernel's own books (obs/attribution.py), with
    # the keys of XLA's block
    for j, p in zip(jax_lines[1:], port_lines[1:]):
        assert set(j["extras"]) == set(p["extras"]) - (
            set() if "cost_analysis" in j["extras"] else {"cost_analysis"})
        if "cost_analysis" in j["extras"]:
            assert set(j["extras"]["cost_analysis"]) == set(p["extras"]["cost_analysis"])
        assert p["extras"]["cost_analysis"]["agrees"]  # 256³ is whole tiles
    assert _tiles(port_recs) == [(128, 128, 32), (64, 128, 32)]


def test_tune_rect_mkn(tmp_path, capsys):
    records = cuda_tune.main([
        "--mkn", "32", "96", "64", *SMALL, *CPU, "--dtype", "bfloat16",
        "--candidates", "64,128,32", "--json-out", str(tmp_path / "rect.jsonl")])
    assert "[32x96x64] BEST" in capsys.readouterr().out
    assert len(records) == 1
    assert records[0].extras["shape"] == "32x96x64"
    assert records[0].flops_per_op == 2 * 32 * 96 * 64


def test_tune_dedupes_resolved_candidates(capsys):
    # 96,96,96 fits no tile and resolves to the smallest, 64,128,32; the
    # explicit 64,128,32 is then what already ran
    records = cuda_tune.main(["--sizes", "128", *SMALL, *CPU,
                              "--candidates", "96,96,96", "64,128,32"])
    out = capsys.readouterr().out
    assert "requested (96, 96, 96)" in out
    assert "skip" in out and "already-measured" in out
    assert _tiles(records) == [(64, 128, 32)]


def test_tune_fp32_runs_the_one_simt_tile():
    records = cuda_tune.main(["--sizes", "64", *SMALL, *CPU, "--dtype", "float32"])
    assert _tiles(records) == [cm.SIMT_TILE]


def test_tune_honors_block_flags():
    records = cuda_tune.main(["--sizes", "64", *SMALL, *CPU, "--block-m", "128",
                              "--block-n", "256", "--block-k", "32",
                              "--candidates", "64,128,32", "--confirm-top", "0"])
    assert _tiles(records) == [(128, 256, 32), (64, 128, 32)]  # flags first


def test_tune_cli_end_to_end(tmp_path, capsys):
    out = tmp_path / "tune.jsonl"
    records = cuda_tune.main(["--sizes", "64", *SMALL, *CPU, "--confirm-top", "0",
                              "--json-out", str(out)])
    assert "BEST: --block-m" in capsys.readouterr().out
    assert sorted(_tiles(records)) == sorted(cm.TILES)  # every tile by default
    lines = _ledger(out)
    assert len(lines) == 1 + len(cm.TILES) and lines[0]["record_type"] == "manifest"


def test_tune_rejects_bad_candidate():
    with pytest.raises(SystemExit):
        cuda_tune.main(["--candidates", "64,64"])


def test_tune_fused_timing(tmp_path):
    records = cuda_tune.main([
        "--sizes", "64", "--iterations", "3", "--warmup", "5", *CPU,
        "--candidates", "128,128,32", "64,128,32", "--timing", "fused",
        "--validate", "--confirm-top", "0"])
    assert len(records) == 2
    for r in records:
        assert r.extras["timing"] == "fused"
        assert r.extras["validation"] == "ok"
        assert r.warmup == 3  # one fused pass = iterations calls
        assert r.iterations % 3 == 0


def test_tune_confirm_pass(capsys):
    records = cuda_tune.main(["--sizes", "64", *SMALL, *CPU,
                              "--candidates", "128,128,32", "64,128,32",
                              "--confirm-top", "2"])
    assert "confirm pass: top 2 interleaved" in capsys.readouterr().out
    assert len([r for r in records if r.extras.get("confirm_pass")]) == 2


def test_tune_confirm_disabled(capsys):
    records = cuda_tune.main(["--sizes", "64", *SMALL, *CPU,
                              "--candidates", "128,128,32", "64,128,32",
                              "--confirm-top", "0"])
    assert "confirm pass" not in capsys.readouterr().out
    assert not [r for r in records if r.extras.get("confirm_pass")]


@pytest.mark.parametrize("margin_pct, tied", [(0.2, True), (5.0, False)])
def test_tune_confirm_tie_note(capsys, monkeypatch, margin_pct, tied):
    class _Wl:
        flops = 2 * 64**3

    class _Info:
        device_kind = "cpu"

    cfg = config_from_args(build_parser("t").parse_args(
        ["--sizes", "64", "--iterations", "1", "--warmup", "0", *CPU]))
    base = 1e-3
    times = [timing.Timing(total_s=base, iterations=1),
             timing.Timing(total_s=base * (1 + margin_pct / 100), iterations=1)]
    monkeypatch.setattr(cuda_tune, "time_variants_n", lambda *a, **k: times)
    a = torch.ones(64, 64)
    recs: list = []
    results = [((128, 128, 32), 100.0), ((64, 128, 32), 99.0)]
    cuda_tune._confirm_top(list(results), 2, cfg, _Wl(), 64, (a, a), "64",
                           _Info(), JsonWriter(None), recs)
    assert ("treat as a tie" in capsys.readouterr().out) == tied
    flagged = [r for r in recs if "tie_margin_pct" in r.extras]
    assert len(flagged) == (2 if tied else 0)
    assert all(r.extras["tie_margin_pct"] < 1.0 for r in flagged)


def test_tune_structural_axes_cli(tmp_path):
    out = tmp_path / "tune.jsonl"
    records = cuda_tune.main(["--sizes", "256", *SMALL, *CPU,
                              "--candidates", "128,128,32", "64,128,32",
                              "--grid-order", "nmk", "--ksplit", "2",
                              "--validate", "--confirm-top", "2",
                              "--json-out", str(out)])
    assert records
    for rec in _ledger(out)[1:]:
        assert rec["extras"]["grid_order"] == "nmk"
        assert rec["extras"]["ksplit"] == 2
    assert any(r.extras.get("confirm_pass") for r in records)
    assert all(r.extras["validation"] == "ok" for r in records
               if not r.extras.get("confirm_pass"))


def test_tune_ksplit_fallback_not_mislabeled(tmp_path, capsys):
    out = tmp_path / "tune.jsonl"
    cuda_tune.main(["--sizes", "256", *SMALL, *CPU, "--candidates", "128,128,32",
                    "--ksplit", "3", "--confirm-top", "0", "--json-out", str(out)])
    assert "running single-pass" in capsys.readouterr().out
    recs = _ledger(out)[1:]
    assert recs
    for rec in recs:
        assert "ksplit" not in rec["extras"], rec["extras"]


def test_tune_launches_nothing_on_the_cpu():
    before = (cm.LAUNCHES, cm.REDUCE_LAUNCHES)
    cuda_tune.main(["--sizes", "256", *SMALL, *CPU, "--ksplit", "2",
                    "--candidates", "128,128,32", "--confirm-top", "0"])
    assert (cm.LAUNCHES, cm.REDUCE_LAUNCHES) == before


def test_tune_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_tune.main(["--sizes", "64", "--iterations", "1"])


@pytest.mark.parametrize("name", JAX_SUBCOMMANDS)
def test_tune_db_subcommands_fail_by_name(name):
    # each of the JAX package's subcommands is served by the port's front end
    # (tune/cli.py), or refused by name with the ROADMAP item it waits for
    if name in tune_cli.SUBCOMMANDS:
        with pytest.raises(SystemExit) as e:
            tune_cli.main([name, "--help"])
        assert e.value.code == 0
    else:
        with pytest.raises(SystemExit, match=f"tune {name}: not ported.*A1[34]"):
            tune_cli.main([name])


def test_cli_program_table_has_tune(capsys):
    from tpu_matmul_bench_torch.__main__ import main

    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    assert "tune" in capsys.readouterr().out
    assert main(["tune", "prune", "--size", "256"]) == 0
    # `tune fill` is served now (it drives the campaign runner): without
    # its campaign directory it is a usage error, not a refusal
    with pytest.raises(SystemExit) as e:
        main(["tune", "fill"])
    assert e.value.code == 2
    assert "the following arguments are required: --dir" in capsys.readouterr().err
    (rec,) = main(["tune", "--sizes", "64", *SMALL, *CPU,
                   "--candidates", "64,128,32"])
    assert rec.benchmark == "tune"


# ------------------------------------------------------------- timing

def test_time_variants_n_times_each_variant():
    a = torch.ones(16, 16)
    fns = [lambda x, y: x @ y, lambda x, y: x @ y + 1.0]
    ts = timing.time_variants_n(fns, (a, a), iterations=3, warmup=1, repeats=3)
    assert len(ts) == 2 and all(t.iterations >= 3 and t.total_s > 0 for t in ts)
    fused = timing.time_variants_n(fns, (a, a), iterations=4, repeats=1,
                                   protocol="fused")
    assert all(t.iterations % 4 == 0 and t.chain == "operand" for t in fused)
    with pytest.raises(ValueError, match="protocol"):
        timing.time_variants_n(fns, (a, a), protocol="events")


def test_time_variants_n_takes_the_median_round(monkeypatch):
    seconds = iter([3.0, 1.0, 2.0])  # one variant, three rounds
    monkeypatch.setattr(timing, "time_jitted", lambda *a, **k: timing.Timing(
        next(seconds), 1))
    (t,) = timing.time_variants_n([lambda: None], (), repeats=3)
    assert t.total_s == 2.0

