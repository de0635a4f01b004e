"""`tune --ring` of the port (`benchmarks/cuda_tune.py`) against the JAX
package's (`benchmarks/pallas_tune.py`), and the ring builders' table
(`ops.ring_matmul_builders`) against the JAX package's.

The JAX sweep runs its Pallas rings in interpret mode on the conftest's
8-device CPU mesh; the port's runs on 8 ranks that share the CPU
(`TMB_RANKS_PER_CARD=8`), where every step product runs its plain version
and no kernel launches. The cases of tests/test_tune.py:119-236 are carried
over to the port's mode names and tiles.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P
from torch_port_util import (  # noqa: F401 — single_torch_thread is a fixture
    as_numpy,
    numpy_operands,
    rel_err,
    single_torch_thread,
)

from tpu_matmul_bench import ops as jax_ops
from tpu_matmul_bench.benchmarks import pallas_tune as jax_tune
from tpu_matmul_bench.parallel import mesh as jax_mesh
from tpu_matmul_bench_torch import ops
from tpu_matmul_bench_torch.benchmarks import cuda_tune
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops import cuda_ring as cr
from tpu_matmul_bench_torch.parallel import mesh
from tpu_matmul_bench_torch.parallel.mesh import COLS, ROWS, gather, shard_from_numpy
from tpu_matmul_bench_torch.utils.device import resolve_devices

pytestmark = pytest.mark.usefixtures("single_torch_thread")

SMALL = ["--iterations", "1", "--warmup", "0"]
CPU = ["--device", "cpu"]
# port mode -> the JAX package's mode of the same ring
RINGS = {"cuda_ring_hbm": "pallas_ring_hbm",
         "cuda_ring_bidir_hbm": "pallas_ring_bidir_hbm",
         "cuda_ring_rs_hbm": "pallas_ring_rs_hbm",
         "cuda_ring_bidir_rs_hbm": "pallas_ring_bidir_rs_hbm"}
# the modes' validation tolerance for the two dtypes (parallel/modes.py)
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def ranks8(monkeypatch):
    """8 ranks share the CPU, as the JAX tests' 8 virtual devices."""
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def _ledger(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _tiles(records):
    return [tuple(r.extras[f"block_{d}"] for d in "mnk") for r in records]


# ---------------------------------------------------- the builders' table

def test_builders_table_mirrors_jax():
    port, jax_table = ops.ring_matmul_builders(), jax_ops.ring_matmul_builders()
    assert set(port) == set(RINGS) == set(cuda_tune.RING_MODES)
    for mode, jax_mode in RINGS.items():
        assert port[mode][1] == jax_table[jax_mode][1]  # the sharding kind
    assert port["cuda_ring_hbm"][0] is cr.ring_allgather_matmul_hbm
    assert port["cuda_ring_bidir_rs_hbm"][0] is cr.ring_reduce_scatter_matmul_bidir_hbm


def _jax_put(arr, jmesh, spec):
    return jax.device_put(jnp.asarray(arr), NamedSharding(jmesh, P(*spec)))


@pytest.mark.parametrize("dtype_name", list(TOL))
@pytest.mark.parametrize("mode", list(RINGS))
def test_ring_output_matches_jax(devices, mode, dtype_name):
    # the same seeded numpy operands through both tables' builders, at 64²
    # over 8 ranks, and a float64 product of them
    x_np, w_np = numpy_operands(41, 64, 64, 64, dtype_name)
    jax_build, kind = jax_ops.ring_matmul_builders()[RINGS[mode]]
    build, _ = ops.ring_matmul_builders()[mode]
    x_spec, w_spec = (ROWS, COLS) if kind == "ag" else (COLS, ROWS)
    jmesh = jax_mesh.make_mesh(devices)
    want = np.asarray(jax_build(jmesh, block_m=8, block_n=8, block_k=8)(
        _jax_put(x_np, jmesh, x_spec), _jax_put(w_np, jmesh, w_spec)), np.float64)
    pmesh = mesh.make_mesh(resolve_devices("cpu", 8))
    got = as_numpy(gather(build(pmesh)(shard_from_numpy(x_np, x_spec, pmesh),
                                       shard_from_numpy(w_np, w_spec, pmesh))))
    exact = np.asarray(x_np, np.float64) @ np.asarray(w_np, np.float64)
    assert got.shape == want.shape == (64, 64)
    assert rel_err(got, want) <= TOL[dtype_name]
    assert rel_err(got, exact) <= TOL[dtype_name]


# ------------------------------------------------ records against the JAX's

@pytest.mark.parametrize("dtype_name", list(TOL))
@pytest.mark.parametrize("mode", list(RINGS))
def test_ring_records_match_jax(tmp_path, mode, dtype_name):
    common = ["--sizes", "64", *SMALL, "--dtype", dtype_name, "--validate"]
    jax_out, port_out = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jax_recs = jax_tune.main(["--ring", RINGS[mode], *common, "--candidates", "8,8,8",
                              "--json-out", str(jax_out)])
    port_recs = cuda_tune.main(["--ring", mode, *common, *CPU,
                                "--candidates", "128,256,64", "--json-out", str(port_out)])
    assert len(jax_recs) == len(port_recs) == 1
    jax_lines, port_lines = _ledger(jax_out), _ledger(port_out)
    for lines in (jax_lines, port_lines):
        assert lines[0]["record_type"] == "manifest" and len(lines) == 2
        assert lines[1]["extras"]["validation"] == "ok"
        assert lines[1]["world"] == 8 and lines[1]["benchmark"] == "tune"
    assert port_lines[1]["mode"] == f"tune_{mode}"
    assert jax_lines[1]["mode"] == f"tune_{RINGS[mode]}"
    assert set(jax_lines[1]) == set(port_lines[1])  # the same record fields
    assert set(port_lines[1]["extras"]) == set(jax_lines[1]["extras"]) | {
        "step_route", "transfer"}
    extras = port_lines[1]["extras"]
    assert extras["ring"] == mode and extras["wres_engaged"] is False
    # on the CPU the step products run their plain versions: no launch, no
    # transfer on the card
    assert (extras["step_route"], extras["transfer"]) == ("plain", "plain")


# ----------------------------------------- tests/test_tune.py's ring cases

def test_tune_ring_end_to_end(tmp_path, capsys):
    records = cuda_tune.main([
        "--sizes", "64", "--iterations", "2", "--warmup", "1", *CPU,
        "--dtype", "bfloat16", "--ring", "cuda_ring_hbm", "--validate",
        "--candidates", "128,256,64", "64,128,32",
        "--json-out", str(tmp_path / "ringtune.jsonl")])
    assert "BEST: --block-m" in capsys.readouterr().out
    assert len(records) == 2
    for r in records:
        assert r.mode == "tune_cuda_ring_hbm"
        assert r.world == 8
        assert r.extras["ring"] == "cuda_ring_hbm"
        assert r.extras["validation"] == "ok"
    assert _tiles(records) == [(128, 256, 64), (64, 128, 32)]
    lines = (tmp_path / "ringtune.jsonl").read_text().splitlines()
    assert len(lines) == 3  # manifest header + 2 candidate records


def test_tune_ring_rejects_mkn():
    with pytest.raises(SystemExit, match="cannot combine"):
        cuda_tune.main(["--ring", "cuda_ring_hbm", "--mkn", "64", "64", "64", *CPU])


@pytest.mark.parametrize("flags", [["--grid-order", "nmk"], ["--ksplit", "2"]])
def test_tune_ring_rejects_structural_axes(flags):
    with pytest.raises(SystemExit, match="cannot combine with --ring"):
        cuda_tune.main(["--ring", "cuda_ring_hbm", "--sizes", "64", *CPU, *flags])


def test_tune_ring_rejects_fused():
    with pytest.raises(SystemExit, match="dispatch protocol"):
        cuda_tune.main(["--ring", "cuda_ring_hbm", "--sizes", "64", *CPU,
                        "--timing", "fused"])


def test_tune_ring_rejects_unknown_mode():
    with pytest.raises(SystemExit):
        cuda_tune.main(["--ring", "cuda_ring", "--sizes", "64", *CPU])


def test_tune_ring_indivisible_size_skipped(capsys):
    # a size that does not divide the ring is reported and skipped, not a
    # crash mid-sweep
    records = cuda_tune.main(["--sizes", "100", *SMALL, *CPU, "--dtype", "bfloat16",
                              "--ring", "cuda_ring_hbm", "--candidates", "128,256,64"])
    assert records == []
    assert "skip: size must divide" in capsys.readouterr().out


def test_tune_ring_dedupes_resolved_candidates(capsys):
    # requests resolve to the instantiated tile the step products run;
    # the sweep dedupes on that tile and reports it, not the request
    records = cuda_tune.main(["--sizes", "64", *SMALL, *CPU, "--dtype", "bfloat16",
                              "--ring", "cuda_ring_hbm",
                              "--candidates", "512,512,512", "1024,512,512"])
    out = capsys.readouterr().out
    assert len(records) == 1
    assert "skip (1024, 512, 512)" in out and "already-measured" in out
    assert _tiles(records) == [cm.DEFAULT_TILE]
    # the per-candidate decision the record exists for
    assert records[0].extras["wres_engaged"] is False


def test_tune_ring_fp32_runs_the_one_simt_tile():
    records = cuda_tune.main(["--sizes", "64", *SMALL, *CPU, "--dtype", "float32",
                              "--ring", "cuda_ring_rs_hbm",
                              "--candidates", "128,256,64", "64,128,32"])
    assert _tiles(records) == [cm.SIMT_TILE]


@pytest.mark.parametrize("mode", ["cuda_ring_bidir_hbm", "cuda_ring_bidir_rs_hbm"])
def test_tune_ring_bidir_min_rows_skipped(capsys, mode):
    # 8 rows over 8 ranks are 1-row chunks: the bidirectional rings cannot
    # split them; one clean skip, not one error per candidate
    records = cuda_tune.main(["--sizes", "8", *SMALL, *CPU, "--ring", mode,
                              "--candidates", "128,256,64"])
    out = capsys.readouterr().out
    assert records == []
    assert "need ≥ 2 rows" in out
    assert "FAILED" not in out


def test_tune_ring_wres_on_fails_each_candidate(capsys):
    records = cuda_tune.main(["--sizes", "64", *SMALL, *CPU, "--ring", "cuda_ring_hbm",
                              "--wres", "on", "--candidates", "128,256,64"])
    assert records == []
    assert "FAILED: ValueError: wres=True" in capsys.readouterr().out


def test_tune_ring_counts_cards_not_ranks():
    # 8 ranks on one device: the per-device rate is the card's total, as the
    # overlap program's records count it
    (rec,) = cuda_tune.main(["--sizes", "64", *SMALL, *CPU, "--ring", "cuda_ring_hbm",
                             "--candidates", "128,256,64"])
    assert rec.world == 8
    assert rec.tflops_per_device == rec.tflops_total


def test_risen_names_the_counters_that_moved():
    assert cuda_tune._risen({"a": 1, "b": 2}, {"a": 1, "b": 3}) == "b"
    assert cuda_tune._risen({"a": 1, "b": 2}, {"a": 2, "b": 3}) == "a+b"
    assert cuda_tune._risen({"a": 1}, {"a": 1}) == "plain"


@pytest.mark.parametrize("mode, kind, bidir, dims", [
    ("cuda_ring_hbm", "ag", False, (8, 8, 64)),
    ("cuda_ring_bidir_rs_hbm", "rs", True, (4, 64, 8)),
])
def test_ring_effective_blocks_resolve_the_step_problem(mode, kind, bidir, dims, monkeypatch):
    seen = []
    real = cuda_tune.effective_blocks
    monkeypatch.setattr(cuda_tune, "effective_blocks",
                        lambda *a: seen.append(a[:3]) or real(*a))
    eff = cuda_tune._ring_effective_blocks(kind, bidir, 64, 8, (96, 96, 96), "bfloat16")
    assert eff == cm.TILES[0]  # none fits: the smallest tile
    assert seen == [dims]  # (rows, n, k) of one step's product


def test_tune_ring_cli_through_the_program_table(capsys):
    from tpu_matmul_bench_torch.__main__ import main

    (rec,) = main(["tune", "--ring", "cuda_ring_rs_hbm", "--sizes", "64", *SMALL, *CPU,
                   "--candidates", "128,256,64"])
    assert rec.mode == "tune_cuda_ring_rs_hbm"
    assert "ring cuda_ring_rs_hbm" in capsys.readouterr().out
