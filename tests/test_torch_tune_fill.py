"""`tune fill` and the routing counter in the port, on the CPU.

- `tune fill --dry-run` prints the card fill spec's job plan and measures
  nothing.
- A fill through an injected launch (a fake child that writes a fixture
  tune ledger) runs the campaign, promotes the winner into the DB it is
  given (never the committed one), and `auto` through that DB routes from
  the cell; `tune_route_total{source="db"}` counts it.
- A fill whose campaign fails and promotes nothing exits 1.
- `tune_route_total{source}` counts the same sources as the JAX package's
  `select_impl` over the same DB cells and lookups.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from tpu_matmul_bench.obs.registry import get_registry as jax_registry
from tpu_matmul_bench.ops import impl_select as jax_select
from tpu_matmul_bench.tune import db as jax_db
from tpu_matmul_bench_torch.__main__ import main as port_main
from tpu_matmul_bench_torch.campaign import executor
from tpu_matmul_bench_torch.obs.registry import get_registry
from tpu_matmul_bench_torch.ops import impl_select
from tpu_matmul_bench_torch.tune import db, promote

REPO = Path(__file__).resolve().parent.parent
COMMITTED_DB = REPO / "measurements" / "torch" / "tune_db.jsonl"


def _route_counts(registry) -> dict[str, float]:
    counters = registry.snapshot().get("counters", {})
    return {src: counters.get(f'tune_route_total{{source="{src}"}}', 0.0)
            for src in ("db", "table", "online")}


def _delta(before, after):
    return {k: after[k] - before[k] for k in before}


def test_fill_dry_run_prints_the_card_plan(tmp_path, capsys):
    assert port_main(["tune", "fill", "--dir", str(tmp_path / "fill"), "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "8 jobs (dry run; nothing executed)" in out
    assert "-m tpu_matmul_bench_torch tune --sizes 16384" in out
    assert "--candidates 128,256,64 128,256,32 256,128,32 128,128,64" in out
    assert not list((tmp_path / "fill").glob("jobs/*.jsonl"))


def _fixture_launch(tiles_tflops: dict[tuple[int, int, int], float]):
    """A fake `tune` child: its ledger holds one sweep record a tile, the
    manifest first, as cuda_tune writes them."""
    def launch(cmd, *, log, timeout_s, env):
        argv = cmd[cmd.index("tune") + 1:]
        size = int(argv[argv.index("--sizes") + 1])
        ledger = cmd[cmd.index("--json-out") + 1]
        with open(ledger, "w") as fh:
            fh.write(json.dumps({"record_type": "manifest", "schema_version": 2}) + "\n")
            for (bm, bn, bk), tflops in tiles_tflops.items():
                fh.write(json.dumps({
                    "benchmark": "tune", "mode": "cuda_tune", "size": size,
                    "dtype": "bfloat16", "world": 1, "iterations": 10, "warmup": 3,
                    "avg_time_s": 2 * size ** 3 / (tflops * 1e12),
                    "tflops_per_device": tflops, "tflops_total": tflops,
                    "extras": {"block_m": bm, "block_n": bn, "block_k": bk}}) + "\n")
        return executor.LaunchResult(rc=0)
    return launch


def _one_job_spec(tmp_path) -> Path:
    spec = tmp_path / "fill.toml"
    spec.write_text(
        '[campaign]\nname = "fill"\n\n[[job]]\nid = "bf16_8k"\nprogram = "tune"\n'
        'flags = ["--sizes", "8192", "--dtype", "bfloat16", "--iterations", "10",\n'
        '         "--candidates", "128,256,64", "128,256,32"]\n')
    return spec


def test_fill_promotes_into_the_given_db_and_auto_routes_from_it(tmp_path, monkeypatch,
                                                                  capsys):
    committed = COMMITTED_DB.read_bytes()
    monkeypatch.setattr(executor, "_default_launch", _fixture_launch(
        {(128, 256, 64): 700.0, (128, 256, 32): 650.0}))
    store = tmp_path / "tune_db.jsonl"
    assert port_main(["tune", "fill", "--spec", str(_one_job_spec(tmp_path)),
                      "--dir", str(tmp_path / "fill"), "--db", str(store)]) == 0
    out = capsys.readouterr().out
    assert "promoted bfloat16 8192x8192x8192 → cuda blocks=128x256x64" in out
    assert COMMITTED_DB.read_bytes() == committed
    filled = db.TuningDB.load(str(store))
    (cell,) = filled.cells()
    assert (cell.impl, cell.blocks, cell.device_kind) == ("cuda", (128, 256, 64), "h100")
    assert cell.artifact.endswith("fill/jobs/bf16_8k.jsonl")
    before = _route_counts(get_registry())
    choice = impl_select.select_impl(8192, 8192, 8192, promote.H100, torch.bfloat16,
                                     db=filled)
    assert (choice.source, choice.impl, choice.blocks) == ("db", "cuda", (128, 256, 64))
    assert _delta(before, _route_counts(get_registry())) == \
        {"db": 1.0, "table": 0.0, "online": 0.0}


def test_fill_fails_when_the_campaign_fails_and_nothing_is_promoted(tmp_path, monkeypatch,
                                                                    capsys):
    monkeypatch.setattr(executor, "_default_launch",
                        lambda cmd, **kw: executor.LaunchResult(rc=1))
    spec = _one_job_spec(tmp_path)
    spec.write_text(spec.read_text().replace('program = "tune"',
                                             'program = "tune"\nretries = 0'))
    with pytest.raises(SystemExit) as e:
        port_main(["tune", "fill", "--spec", str(spec), "--dir", str(tmp_path / "fill"),
                   "--db", str(tmp_path / "db.jsonl")])
    assert e.value.code == 1
    assert "campaign: 0/1 jobs done, 1 FAILED: bf16_8k" in capsys.readouterr().out


# --------------------------------------------------------- route counter

_KIND = "test card"
_CELLS = [((256, 256, 256), "bfloat16", "measured"),
          ((512, 256, 1024), "bfloat16", "measured-online"),
          ((1024, 1024, 1024), "int8", "analytic"),
          ((128, 4096, 128), "float32", "measured-online")]
_LOOKUPS = [((256, 256, 256), "bfloat16"), ((512, 1024, 256), "bfloat16"),
            ((1024, 1024, 1024), "int8"), ((1024, 1024, 1024), "bfloat16"),
            ((128, 128, 4096), "float32"), ((2048, 2048, 2048), "int8"),
            ((256, 256, 256), "bfloat16"), ((7, 9, 11), "float32")]


def _dbs(tmp_path):
    port = db.TuningDB(path=str(tmp_path / "port.jsonl"))
    ref = jax_db.TuningDB(path=str(tmp_path / "jax.jsonl"))
    for (m, k, n), dtype, kind in _CELLS:
        common = dict(m=m, k=k, n=n, dtype=dtype, device_kind=_KIND, provenance_kind=kind,
                      artifact="measurements/x.jsonl", program_digest="d",
                      created_at="1970-01-01T00:00:00+00:00")
        port.put(db.Cell(impl="cuda", torch_version="t", **common), fsync=False)
        ref.put(jax_db.Cell(impl="pallas", jax_version="j", **common), fsync=False)
    return port, ref


def test_route_counter_counts_the_sources_jax_counts(tmp_path):
    port_db, ref_db = _dbs(tmp_path)
    port_before, ref_before = _route_counts(get_registry()), _route_counts(jax_registry())
    port_sources, ref_sources = [], []
    for (m, n, k), dtype in _LOOKUPS:
        port_sources.append(impl_select.select_impl(
            m, n, k, _KIND, getattr(torch, dtype), db=port_db).source)
        ref_sources.append(jax_select.select_impl(m, n, k, _KIND, dtype, db=ref_db).source)
    assert port_sources == ref_sources
    assert set(port_sources) == {"db", "online", "table"}
    port_delta = _delta(port_before, _route_counts(get_registry()))
    assert port_delta == _delta(ref_before, _route_counts(jax_registry()))
    assert port_delta == {s: float(port_sources.count(s)) for s in ("db", "table", "online")}


def test_resolve_route_counts_nothing(tmp_path):
    # the audit-facing spelling keeps the counter to real routing decisions
    port_db, _ = _dbs(tmp_path)
    before = _route_counts(get_registry())
    impl_select.resolve_route(256, 256, 256, _KIND, torch.bfloat16, db=port_db)
    assert _route_counts(get_registry()) == before
