"""`python -m tpu_matmul_bench_torch tune {show,prune,promote,selftest}` and
`python -m tpu_matmul_bench_torch.tune.regen` on the CPU, against the
committed port store (measurements/torch/tune_db.jsonl), beside the JAX
package's front end where both answer the same question."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from torch_port_util import single_torch_thread  # noqa: F401 — a fixture

from tpu_matmul_bench.tune import cli as jax_cli
from tpu_matmul_bench_torch.__main__ import main as port_main
from tpu_matmul_bench_torch.tune import cli, db, regen

pytestmark = pytest.mark.usefixtures("single_torch_thread")

REPO = Path(__file__).resolve().parent.parent
LEDGER = "measurements/r4/tune_int8_16k_b.jsonl"


def _tune_ledger(path: Path, tflops=(100.0, 90.0), size=4096) -> str:
    recs = [{"benchmark": "tune", "mode": "cuda_tune", "size": size, "dtype": "bfloat16",
             "tflops_total": t, "extras": {"block_m": bm, "block_n": bn, "block_k": 64}}
            for t, (bm, bn) in zip(tflops, ((128, 256), (128, 128)))]
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return str(path)


def test_show_lists_the_committed_cells(capsys):
    assert cli.main(["show"]) == 0
    out = capsys.readouterr().out
    assert "30 live cells (30 records)" in out
    assert "0 stale under a CPU build of torch" in out
    assert out.count("[measured]") == 30 and " h100 " in out


def test_show_check_drift_and_filters(capsys):
    assert cli.main(["show", "--check-drift", "--stale-only"]) == 0
    out = capsys.readouterr().out
    assert "0 of 30 cells match [stale-only]" in out and "STALE" not in out
    assert cli.main(["show", "--provenance", "analytic"]) == 0
    assert "0 of 30 cells match [provenance=analytic]" in capsys.readouterr().out


def test_show_flags_a_bumped_digest(tmp_path, capsys):
    path = tmp_path / "db.jsonl"
    shutil.copy(db.default_path(), path)
    lines = path.read_text().splitlines()
    rec = json.loads(lines[0])
    rec["program_digest"] = "f" * 16
    path.write_text("\n".join([json.dumps(rec)] + lines[1:]) + "\n")
    assert cli.main(["show", "--db", str(path), "--check-drift", "--stale-only"]) == 0
    out = capsys.readouterr().out
    assert "1 of 30 cells match" in out and "DRIFT-style" in out
    with pytest.raises(SystemExit) as e:
        cli.main(["selftest", "--db", str(path)])
    assert e.value.code == 1
    assert "FAILED" in capsys.readouterr().out
    assert cli.main(["selftest", "--db", str(path), "--no-drift"]) == 0


def test_prune_prints_the_kept_tiles(capsys):
    assert cli.main(["prune", "--size", "16384", "--emit-flags"]) == 0
    out = capsys.readouterr().out
    assert "[16384x16384x16384/bfloat16] prune (wgmma): 7 candidates → 4 measured " \
           "trials (-42.9%)" in out
    assert "--block-m 128 --block-n 256 --block-k 64" in out
    assert cli.main(["prune", "--mkn", "28672x4096x8192", "--dtype", "int8",
                     "--top-k", "2"]) == 0
    assert "(wmma): 7 candidates → 2 measured trials" in capsys.readouterr().out


def test_prune_ring_reports_the_wire_as_jax_does(capsys):
    assert cli.main(["prune", "--size", "16384", "--ring", "cuda_ring_bidir_hbm"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert jax_cli.main(["prune", "--size", "16384", "--ring", "pallas_ring_bidir_hbm"]) == 0
    jax = capsys.readouterr().out.splitlines()
    # the same step problem and wire bytes: the first and last lines' numbers
    assert port[0].split("]")[0] == jax[0].split("]")[0] == "[1024x16384x2048/bfloat16"
    assert port[-1].replace("cuda_", "pallas_") == jax[-1]


def test_promote_writes_and_refuses(tmp_path, capsys):
    dbp = str(tmp_path / "db.jsonl")
    ledger = _tune_ledger(tmp_path / "sweep.jsonl")
    assert cli.main(["promote", ledger, "--db", dbp, "--dry-run"]) == 0
    assert "(dry run" in capsys.readouterr().out and not Path(dbp).exists()
    assert cli.main(["promote", ledger, "--db", dbp]) == 0
    out = capsys.readouterr().out
    assert "promoted bfloat16 4096x4096x4096 → cuda blocks=128x256x64" in out
    assert "1 promoted, 0 skipped" in out
    (cell,) = db.TuningDB.load(dbp).cells()
    assert cell.device_kind == "h100" and cell.artifact == ledger
    tie = _tune_ledger(tmp_path / "tie.jsonl", tflops=(100.0, 99.9), size=8192)
    with pytest.raises(SystemExit) as e:
        cli.main(["promote", tie, "--db", dbp])
    assert e.value.code == 1
    assert "0 promoted, 1 skipped" in capsys.readouterr().out


def test_selftest_passes_on_the_committed_db(capsys):
    assert cli.main(["selftest"]) == 0
    assert "tune selftest ok: 30 cells" in capsys.readouterr().out
    assert port_main(["tune", "selftest", "--no-drift"]) == 0


def test_selftest_fails_on_a_dead_artifact(tmp_path, capsys):
    store = db.TuningDB(path=str(tmp_path / "db.jsonl"))
    store.put(db.Cell(m=64, k=64, n=64, dtype="int8", device_kind="h100", impl="torch",
                      provenance_kind="measured",
                      artifact="measurements/torch/never_measured.jsonl"))
    with pytest.raises(SystemExit) as e:
        cli.main(["selftest", "--db", store.path, "--no-drift"])
    assert e.value.code == 1
    assert "does not exist" in capsys.readouterr().out


@pytest.mark.parametrize("name, item", [("fill", "A14")])
def test_unported_subcommands_are_refused_by_name(name, item):
    with pytest.raises(SystemExit, match=f"tune {name}: not ported yet; it waits for {item}"):
        port_main(["tune", name])


def test_online_selftest_exits_0(capsys):
    assert port_main(["tune", "online", "selftest", "--requests", "1000"]) == 0
    assert "tune online selftest ok: 1000 seeded requests" in capsys.readouterr().out


def test_artifacts_show_lists_an_empty_store(tmp_path, capsys):
    store = str(tmp_path / "store")
    assert port_main(["tune", "artifacts", "show", "--store", store]) == 0
    assert f"artifact store {store}: 0 live artifacts (0 records)" in capsys.readouterr().out
    assert port_main(["tune", "artifacts", "verify", "--store", store]) == 0


def test_flag_style_falls_through_to_the_sweep():
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    (rec,) = cli.main(["--sizes", "64", "--iterations", "1", "--warmup", "1",
                       "--device", "cpu", "--candidates", "64,128,32",
                       "--confirm-top", "0"])
    assert rec.benchmark == "tune" and rec.extras["block_m"] == 64


def test_regen_check_passes_and_catches_a_change(tmp_path, capsys):
    assert regen.main(["--check"]) == 0
    assert "tune DB up to date: 30 cells" in capsys.readouterr().out
    path = tmp_path / "db.jsonl"
    text = Path(db.default_path()).read_text()
    # timestamps alone are no difference
    path.write_text(text.replace('"created_at": "2', '"created_at": "1'))
    assert regen.main(["--check", "--out", str(path)]) == 0
    path.write_text(text.replace('"impl": "torch"', '"impl": "cuda"', 1))
    assert regen.main(["--check", "--out", str(path)]) == 1
    # a fresh regen into another file checks clean
    capsys.readouterr()
    assert regen.main(["--out", str(path)]) == 0
    assert regen.main(["--check", "--out", str(path)]) == 0


def test_cli_as_a_process():
    out = subprocess.run([sys.executable, "-m", "tpu_matmul_bench_torch", "tune", "selftest"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "tune selftest ok: 30 cells" in out.stdout
    out = subprocess.run([sys.executable, "-m", "tpu_matmul_bench_torch.tune.regen", "--check"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
