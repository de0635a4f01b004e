"""The port's overlap program (`benchmarks/matmul_overlap_benchmark.py`) and
its mode machinery against the JAX package's.

The port's ring modes run on ranks that share the CPU (`TMB_RANKS_PER_CARD`
set per test), the JAX package's on the conftest's 8-device CPU mesh, at
the same small sizes; their records are held to one contract.
"""

import json

import jax.numpy as jnp
import pytest
import torch
from torch_port_util import single_torch_thread  # noqa: F401 — a fixture

from tpu_matmul_bench.benchmarks import matmul_overlap_benchmark as jax_overlap
from tpu_matmul_bench.parallel import modes as jax_modes
from tpu_matmul_bench.parallel.modes import run_mode_benchmark as jax_run_mode
from tpu_matmul_bench.parallel.overlap import OVERLAP_MODES as JAX_MODES
from tpu_matmul_bench.utils.config import parse_config as jax_parse_config
from tpu_matmul_bench_torch.benchmarks import matmul_overlap_benchmark as overlap
from tpu_matmul_bench_torch.parallel import mesh, modes
from tpu_matmul_bench_torch.parallel.mesh import gather
from tpu_matmul_bench_torch.parallel.overlap import OVERLAP_MODE_NAMES, OVERLAP_MODES
from tpu_matmul_bench_torch.utils import timing
from tpu_matmul_bench_torch.utils.config import parse_config
from tpu_matmul_bench_torch.utils.device import resolve_devices
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord, format_record

pytestmark = pytest.mark.usefixtures("single_torch_thread")

PORTED = {"cuda_ring_hbm": "pallas_ring_hbm", "cuda_ring_rs_hbm": "pallas_ring_rs_hbm"}
SMALL = ["--sizes", "64", "--iterations", "2", "--warmup", "1", "--dtype", "float32"]


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def port_mesh(d: int) -> mesh.Mesh:
    return mesh.make_mesh(resolve_devices("cpu", d))


def _config(*extra):
    return parse_config([*SMALL, "--device", "cpu", *extra], "t",
                        modes=list(OVERLAP_MODE_NAMES), default_mode="cuda_ring_hbm",
                        extra_dtypes=("int8",), fused_timing=True)


def test_mode_names_are_the_jax_suites():
    assert set(OVERLAP_MODE_NAMES) == {
        name.replace("pallas_", "cuda_") for name in JAX_MODES}
    assert {m for m, q in OVERLAP_MODE_NAMES.items() if q is None} == set(OVERLAP_MODES)


def test_parse_config_takes_mode_and_wres():
    cfg = _config()
    assert cfg.mode == "cuda_ring_hbm" and cfg.wres == "auto" and cfg.wres_override is None
    cfg = _config("--mode", "cuda_ring_rs_hbm", "--wres", "off", "--timing", "fused")
    assert (cfg.mode, cfg.wres_override, cfg.timing) == ("cuda_ring_rs_hbm", False, "fused")
    assert _config("--wres", "on").wres_override is True
    with pytest.raises(SystemExit):  # the overlap program offers no --repeats
        _config("--repeats", "3")
    with pytest.raises(SystemExit):
        _config("--mode", "no_such_mode")


@pytest.mark.parametrize("port_mode", list(PORTED))
def test_record_extras_match_jax(mesh, ranks8, port_mode):
    # JAX's record at size 64 on 8 devices; the port's on 8 ranks
    jcfg = jax_parse_config([*SMALL, "--validate"], "t", modes=list(JAX_MODES))
    jrec = jax_run_mode(JAX_MODES[PORTED[port_mode]](jcfg, mesh, 64), jcfg).finalize()
    cfg = _config("--validate")
    rec = modes.run_mode_benchmark(OVERLAP_MODES[port_mode](cfg, port_mesh(8), 64),
                                   cfg).finalize()
    assert set(rec.extras) == set(jrec.extras) | {"cards", "ranks_per_card", "wres_reason"}
    for key in ("baseline", "validation"):
        assert rec.extras[key] == jrec.extras[key]
    assert rec.extras["validation_tolerance"] == jrec.extras["validation_tolerance"]
    assert rec.extras["kernel"].startswith("CUDA HBM ring")
    assert rec.world == jrec.world == 8 and rec.mode == port_mode
    assert rec.extras["cards"] == 1 and rec.extras["ranks_per_card"] == 8
    assert rec.extras["wres_engaged"] is False
    assert rec.tflops_per_device == rec.tflops_total  # one card holds them all


@pytest.mark.parametrize("port_mode", list(PORTED))
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int8"])
def test_baseline_and_ring_agree(ranks8, port_mode, dtype_name):
    cfg = _config("--dtype", dtype_name, "--block-m", "8", "--block-n", "8",
                  "--block-k", "8", "--matmul-impl", "cuda")
    setup = OVERLAP_MODES[port_mode](cfg, port_mesh(4), 64)
    x, w = setup.operands
    base, ring = gather(setup.compute(x, w)), gather(setup.full(x, w))
    assert base.dtype == ring.dtype and base.shape == ring.shape == (64, 64)
    tol = modes.validation_tolerance(dtype_name)
    err = (base.double() - ring.double()).abs().max() / base.double().abs().max()
    assert float(err) <= tol
    assert setup.fusable is False


def test_wres_on_raises(ranks8):
    cfg = _config("--wres", "on")
    for mode in OVERLAP_MODES.values():
        with pytest.raises(ValueError, match="wres=True but the W-resident layout"):
            mode(cfg, port_mesh(2), 64)
    off = _config("--wres", "off")
    setup = OVERLAP_MODES["cuda_ring_rs_hbm"](off, port_mesh(2), 64)
    x = modes.run_mode_benchmark(setup, off).finalize().extras
    assert (x["wres"], x["wres_engaged"]) == ("off", False)
    assert f"({64 * 32 * 4} B)" in x["wres_reason"]  # a float32 W shard
    # the program reports the size's error and returns no record for it
    assert overlap.main([*SMALL, "--device", "cpu", "--num-devices", "2",
                         "--wres", "on"]) == []


@pytest.mark.parametrize("name", [m for m, q in OVERLAP_MODE_NAMES.items() if q])
def test_unported_mode_fails_by_name(name):
    with pytest.raises(SystemExit) as e:
        overlap.main([*SMALL, "--device", "cpu", "--mode", name])
    assert name in str(e.value) and "ROADMAP" in str(e.value)


def test_too_many_ranks_name_the_count(monkeypatch):
    monkeypatch.delenv(mesh.RANKS_PER_CARD_ENV, raising=False)
    with pytest.raises(ValueError, match="--num-devices 4: 1 available"):
        overlap.main([*SMALL, "--device", "cpu", "--num-devices", "4"])


def _ledger(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


@pytest.mark.parametrize("port_mode", list(PORTED))
def test_program_runs_end_to_end(ranks8, tmp_path, capsys, port_mode):
    out = tmp_path / "o.jsonl"
    (rec,) = overlap.main([*SMALL, "--device", "cpu", "--mode", port_mode,
                           "--num-devices", "4", "--validate", "--matmul-impl", "cuda",
                           "--json-out", str(out)])
    lines = _ledger(out)
    assert lines[0]["record_type"] == "manifest" and len(lines) == 2
    assert lines[1]["mode"] == port_mode and lines[1]["benchmark"] == "overlap"
    assert lines[1]["extras"]["validation"] == "ok"
    assert (rec.world, rec.extras["cards"], rec.extras["ranks_per_card"]) == (4, 1, 4)
    printed = capsys.readouterr().out
    assert "ppermute (ring shift): PASSED" in printed
    assert "4 ranks; cards: 1, ranks_per_card: 4" in printed


def test_program_record_fields_match_jax(ranks8, tmp_path):
    jax_out, port_out = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jax_overlap.main([*SMALL, "--mode", "pallas_ring_rs_hbm", "--num-devices", "4",
                      "--validate", "--json-out", str(jax_out)])
    overlap.main([*SMALL, "--device", "cpu", "--mode", "cuda_ring_rs_hbm",
                  "--num-devices", "4", "--validate", "--json-out", str(port_out)])
    (jax_rec,), (port_rec,) = _ledger(jax_out)[1:], _ledger(port_out)[1:]
    assert set(jax_rec) == set(port_rec)
    assert jax_rec["extras"]["validation"] == port_rec["extras"]["validation"] == "ok"
    assert jax_rec["world"] == port_rec["world"] == 4


def test_fused_timing_demotes_the_rings(ranks8):
    cfg = _config("--timing", "fused")
    rec = modes.run_mode_benchmark(OVERLAP_MODES["cuda_ring_hbm"](cfg, port_mesh(2), 64),
                                   cfg)
    assert rec.extras["timing"] == "dispatch"
    assert rec.warmup == cfg.warmup


@pytest.mark.parametrize("port_mode", ["cuda_ring_hbm", "cuda_ring_rs_hbm",
                                       "cuda_ring_bidir_hbm", "cuda_ring_bidir_rs_hbm",
                                       "collective_matmul", "collective_matmul_rs", "cuda_ring"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_memory_estimate_matches_jax(port_mode, d):
    jax_mode = port_mode.replace("cuda_", "pallas_")
    for dtype_name in ("bfloat16", "int8"):
        args = ["--dtype", dtype_name]
        want = jax_modes.estimate_memory_gib(
            jax_mode, jax_parse_config(args, "t", extra_dtypes=("int8",)), d, 16384)
        got = modes.estimate_memory_gib(
            port_mode, parse_config(args, "t", extra_dtypes=("int8",)), d, 16384)
        assert got == pytest.approx(want)


def test_memory_guard_sums_the_ranks_on_a_card(ranks8, monkeypatch, capsys):
    # 4 ranks of 16384² bf16 (1.5 GiB each) would not fit a 4 GiB device
    import dataclasses

    from tpu_matmul_bench_torch.benchmarks import matmul_scaling_benchmark as msb

    per_rank = modes.estimate_memory_gib("cuda_ring_hbm", _config("--dtype", "bfloat16"),
                                         4, 16384)
    assert per_rank == pytest.approx(1.5)
    info = msb.collect_device_info(resolve_devices("cpu", 4))
    assert info.ranks_per_card == 4 and info.cards == 1
    monkeypatch.setattr(msb, "collect_device_info",
                        lambda devices: dataclasses.replace(info, memory_gib=4.0))
    assert overlap.main(["--sizes", "16384", "--device", "cpu", "--num-devices", "4"]) == []
    assert "needs ~6.0 GiB" in capsys.readouterr().out


def test_time_variants_reports_the_difference():
    t_c, t_f, comm = timing.time_variants(lambda a: a + 1, lambda a: (a @ a) @ a,
                                          (torch.ones(64, 64),), iterations=2,
                                          warmup=1, repeats=1)
    assert comm == max(t_f.avg_s - t_c.avg_s, 0.0)


def test_sync_and_last_tensor_take_per_rank_lists():
    shards = [torch.ones(2), [torch.zeros(3), torch.full((1,), 7.0)]]
    assert timing._last_tensor(shards).item() == 7.0
    assert len(timing._tensors(shards)) == 3
    timing.sync(shards)  # CPU tensors: nothing to wait for
    assert not timing._on_card(shards)


def test_banner_names_cards_when_ranks_share_one():
    rec = BenchmarkRecord("overlap", "cuda_ring_hbm", 64, "bfloat16", 4, 2, 1,
                          1e-3, 0.5, 0.5,
                          extras={"cards": 1, "ranks_per_card": 4}).finalize()
    text = format_record(rec)
    assert "TFLOPS per card: 0.50" in text
    assert "Total TFLOPS (4 ranks; cards: 1, ranks_per_card: 4): 0.50" in text
    plain = format_record(BenchmarkRecord("matmul", "single", 64, "bfloat16", 1, 2, 1,
                                          1e-3, 0.5, 0.5))
    assert "Total TFLOPS (1 device(s))" in plain


def test_cli_program_table_has_overlap(capsys):
    from tpu_matmul_bench_torch.__main__ import main

    with pytest.raises(SystemExit):
        main(["--help"])
    assert "overlap" in capsys.readouterr().out


def test_jax_float_tolerances_hold_for_the_port():
    for name in ("float32", "bfloat16", "int8"):
        assert modes.validation_tolerance(name) == jax_modes.validation_tolerance(
            jnp.dtype(name))
