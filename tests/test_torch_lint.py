"""The `lint` program of the port (`tpu_matmul_bench_torch/analysis/`):
the CLI and its ledger against JAX's, and each rule fired by a seeded
violation of the port's own code.

The whole `lint --device cpu` runs once, behind a module fixture; the
seeded tests call single group functions over 8 ranks on the CPU.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_matmul_bench.analysis import findings as jax_findings
from tpu_matmul_bench_torch.analysis import auditor as aud
from tpu_matmul_bench_torch.analysis import cli
from tpu_matmul_bench_torch.analysis import comms_model as cm
from tpu_matmul_bench_torch.analysis import findings
from tpu_matmul_bench_torch.analysis import memory_model as mm
from tpu_matmul_bench_torch.parallel import mesh as pmesh
from tpu_matmul_bench_torch.utils.device import resolve_devices
from torch_port_util import single_torch_thread  # noqa: F401 — a fixture

pytestmark = pytest.mark.usefixtures("single_torch_thread")

REPO = Path(__file__).resolve().parent.parent


def _rules(found):
    return sorted({(f.rule, f.severity) for f in found})


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(pmesh.RANKS_PER_CARD_ENV, "8")


@pytest.fixture
def cpu8(ranks8):
    return resolve_devices("cpu", None)


@pytest.fixture(scope="module")
def full_lint(tmp_path_factory):
    ledger = tmp_path_factory.mktemp("lint") / "lint.jsonl"
    records = cli.main(["--device", "cpu", "--fail-on", "error", "--quiet",
                        "--json-out", str(ledger)])
    return records, [json.loads(line) for line in ledger.read_text().splitlines()]


# ------------------------------------------------------------- the program

def test_full_lint_exits_0_on_the_port(full_lint):
    records, ledger = full_lint
    assert records == []  # no finding at all, and no SystemExit
    manifest, summary = ledger[0], ledger[-1]
    assert manifest["record_type"] == "manifest" and manifest["schema_version"] >= 2
    assert summary == {"record_type": "lint_summary", "info": 0, "warn": 0, "error": 0}
    lint = manifest["lint"]
    assert list(lint["groups"]) == list(aud.audit_groups())
    assert set(lint["peak_memory"]) == {f"{m}@d{w}" for w in (4, 8)
                                        for m in aud._all_modes()}
    assert all(peak > 0 for peak in lint["peak_memory"].values())


def test_ledger_has_jax_record_types_and_keys(tmp_path):
    seeded = [("COLL-001", "mode:x@d4", "m", "error"), ("SPEC-003", "s.toml:j", "m", ""),
              ("REG-002", "registry:x", "m", "")]
    port = [findings.Finding(r, w, m, s) for r, w, m, s in seeded]
    ref = [jax_findings.Finding(r, w, m, s) for r, w, m, s in seeded]
    findings.write_ledger(str(tmp_path / "p.jsonl"), port, extra={"fail_on": "error"})
    jax_findings.write_ledger(str(tmp_path / "j.jsonl"), ref, extra={"fail_on": "error"})
    p = [json.loads(x) for x in (tmp_path / "p.jsonl").read_text().splitlines()]
    j = [json.loads(x) for x in (tmp_path / "j.jsonl").read_text().splitlines()]
    assert [r["record_type"] for r in p] == [r["record_type"] for r in j]
    assert p[0]["lint"] == j[0]["lint"] and p[0]["schema_version"] == j[0]["schema_version"]
    for a, b in zip(p[1:], j[1:]):
        assert set(a) == set(b)
        assert {k: v for k, v in a.items() if k != "rule_doc"} == \
            {k: v for k, v in b.items() if k != "rule_doc"}
    assert findings.summarize(port) == jax_findings.summarize(ref)
    for fail_on in ("warn", "error"):
        assert findings.should_fail(port, fail_on) == jax_findings.should_fail(ref, fail_on)
        assert findings.should_fail(port[1:], fail_on) == \
            jax_findings.should_fail(ref[1:], fail_on)


def test_every_ported_rule_keeps_jax_severity():
    for rule, (sev, _doc) in findings.RULES.items():
        assert jax_findings.RULES[rule][0] == sev, rule
    ported = {"DTYPE-001", "DTYPE-002", "COLL-001", "COLL-002", "COLL-003", "PURE-001",
              "DONATE-001", "PALLAS-001", "PALLAS-002", "PALLAS-003", "REG-001",
              "REG-002", "TUNE-001", "TUNE-002", "TUNE-003", "COLL-Q-001", "COLL-Q-002",
              "COLL-Q-003", "DTYPE-Q-001", "DTYPE-Q-002", "ART-001", "ART-002",
              "COLL-H-001", "COLL-H-002", "COLL-H-003", "MEM-001", "MEM-002", "MEM-003",
              "TRAIN-001", "TRAIN-002", "TRAIN-003", "TRAIN-004", "TRAIN-005"} | {
        f"SPEC-{i:03d}" for i in range(1, 11)}
    ported |= {f"SCHED-{i:03d}" for i in range(1, 5)} | {"DRIFT-001", "DRIFT-002"} | {
        f"{family}-{i:03d}" for family in ("CONC", "SCHEMA") for i in range(1, 6)}
    assert ported <= set(findings.RULES)
    assert set(findings.RULES) == set(jax_findings.RULES)


def test_without_a_card_lint_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([])
    assert e.value.code == 2 and "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("family", ["conc", "schema"])
def test_source_certifiers_exit_2_naming_a15b(family):
    # the source certifiers' selftests run, exit 0, and import no torch
    code = ("import runpy, sys\n"
            f"sys.argv = ['tpu_matmul_bench_torch', 'lint', '{family}', 'selftest']\n"
            "try:\n"
            "    runpy.run_module('tpu_matmul_bench_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "assert 'torch' not in sys.modules, 'the selftest imported torch'\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"{family} selftest ok" in out.stdout


def test_no_hlo_skips_exactly_jax_s_hlo_family(tmp_path):
    ledger = tmp_path / "lint.jsonl"
    assert cli.main(["--device", "cpu", "--no-hlo", "--quiet", "--json-out",
                     str(ledger), "--skip", "comm_quant", "train"]) == []
    lint = json.loads(ledger.read_text().splitlines()[0])["lint"]
    assert lint["skipped"] == ["comm_quant", "train", "sched", "memory", "fingerprint"]
    assert list(lint["groups"]) == [g for g in aud.audit_groups()
                                    if g not in lint["skipped"]]


def test_skip_choices_are_the_audit_registry():
    parser = cli.build_parser()
    skip = next(a for a in parser._actions if "--skip" in a.option_strings)
    assert tuple(skip.choices) == aud.audit_groups()
    assert {"conc", "schema", "sched", "fingerprint"} <= set(skip.choices)
    assert "pallas" not in skip.choices
    assert aud.HLO_AUDITS == ("sched", "memory", "fingerprint")


def test_campaign_lint_gate_stops_a_seeded_spec_before_any_job(tmp_path):
    spec = tmp_path / "bad.toml"
    text = (REPO / "specs" / "torch" / "card.toml").read_text()
    spec.write_text(text.replace("[[job]]\n", "[[job]]\ntimout_s = 60\n", 1))
    out = subprocess.run(
        [sys.executable, "-m", "tpu_matmul_bench_torch", "campaign", "run", str(spec),
         "--lint", "--no-hlo", "--dir", str(tmp_path / "d")],
        capture_output=True, text=True, timeout=600, cwd=str(REPO),
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode != 0
    assert "SPEC-002" in out.stdout and "lint gate failed" in out.stderr
    assert not (tmp_path / "d").exists()  # no job, no journal


# ------------------------------------------------------------ seeded rules

def test_seeded_downcasts_fire_dtype_001_002():
    def two_downcasts(a, b):
        return (a.float() @ b.float()).to(torch.bfloat16).float().to(torch.bfloat16)

    a = torch.ones(8, 8, dtype=torch.bfloat16)
    found = aud._dtype_findings(aud.run_recorded(two_downcasts, a, a), "seed")
    assert _rules(found) == [("DTYPE-001", "error"), ("DTYPE-002", "error")]


def test_seeded_inventories_fire_coll_001_002(cpu8):
    mesh = pmesh.make_mesh(cpu8[:4])
    cfg = aud._audit_config("bfloat16", "cuda")
    for mode, audited_as, world, rule in (("model_parallel", "matrix_parallel", 4, "COLL-001"),
                                          ("matrix_parallel", "matrix_parallel", 8, "COLL-002")):
        s = aud._all_modes()[mode](cfg, mesh, aud.AUDIT_SIZE)
        uses = aud.per_collective(aud.run_recorded(s.full, *s.operands), mesh)
        found = aud._inventory_findings(uses, audited_as, world, aud.AUDIT_SIZE,
                                        torch.bfloat16, "seed")
        assert _rules(found) == [(rule, "error")]


def test_seeded_mode_fires_coll_003_and_pure_001(cpu8, monkeypatch):
    real = aud._all_modes()["data_parallel"]

    def leaky(config, mesh, size):
        s = real(config, mesh, size)

        def compute(x, y):  # the collective and a host read in the compute leg
            out = s.full(x, y)
            out[0].float().sum().item()
            return out
        return dataclasses.replace(s, compute=compute)

    monkeypatch.setattr(aud, "_all_modes", lambda: {"data_parallel": leaky})
    found = aud.audit_modes(cpu8, worlds=(4,))
    assert _rules(found) == [("COLL-003", "error"), ("PURE-001", "error")]
    assert aud.audit_modes(resolve_devices("cpu", 2), worlds=(4,))[0].severity == "warn"


def test_seeded_cloning_chain_fires_donate_001(monkeypatch):
    from tpu_matmul_bench_torch.ops import cuda_matmul
    from tpu_matmul_bench_torch.utils import timing

    assert aud.audit_donation([torch.device("cpu")]) == []
    # a kernel that ignores `out` leaves it unwritten
    real_mm = cuda_matmul.cuda_matmul
    monkeypatch.setattr(cuda_matmul, "cuda_matmul",
                        lambda a, b, out=None, **kw: real_mm(a, b, **kw))
    assert [f.where for f in aud.audit_donation([torch.device("cpu")])] == [
        "donation:ops.matmul_2d(cuda) writes into out"]
    monkeypatch.setattr(cuda_matmul, "cuda_matmul", real_mm)
    real = timing._chain
    monkeypatch.setattr(timing, "_chain",
                        lambda ops, src: real([timing._clone(op) for op in ops], src))
    found = aud.audit_donation([torch.device("cpu")])
    assert [(f.rule, f.where) for f in found] == [
        ("DONATE-001", "donation:timing.fuse_iterations(cuda-matmul, 3) chains operand 0")]


def test_seeded_tiles_fire_pallas_001_002_003():
    from tpu_matmul_bench_torch.ops.cuda_matmul import DEFAULT_TILE, SIMT_TILE

    assert aud.check_tile("seed", DEFAULT_TILE, "bfloat16") == []
    assert aud.check_tile("seed", SIMT_TILE, "float32") == []
    assert _rules(aud.check_tile("seed", (96, 96, 32), "bfloat16")) == [("PALLAS-001", "error")]
    assert _rules(aud.check_tile("seed", DEFAULT_TILE, "float32")) == [("PALLAS-001", "error")]
    assert _rules(aud.check_plan("seed", (64, 96, 24))) == [("PALLAS-002", "error")]
    assert _rules(aud.check_plan("seed", DEFAULT_TILE, smem_limit=100_000)) == [
        ("PALLAS-003", "error")]
    assert aud.audit_cuda_static() == []


def test_seeded_wire_programs_fire_coll_q(cpu8, monkeypatch):
    mesh = pmesh.make_mesh(cpu8[:4])
    cfg = dataclasses.replace(aud._audit_config("bfloat16", "cuda"), comm_quant="fp8")
    s = aud._all_modes()["model_parallel"](cfg, mesh, aud.AUDIT_SIZE)
    uses = aud.per_collective(aud.run_recorded(s.full, *s.operands), mesh)
    assert aud._scale_pairing_findings(uses, "seed") == []
    no_scales = [u for u in uses if u[3] != "float32"]
    assert _rules(aud._scale_pairing_findings(no_scales, "seed")) == [("COLL-Q-001", "error")]
    # per-row fp8 audited as the block format: the scales' bytes differ
    assert _rules(aud._wire_inventory_findings(uses, "model_parallel", 4, "fp8-block:32",
                                               "seed")) == [("COLL-Q-002", "error")]
    monkeypatch.setattr(cm, "_WIRE_ITEMSIZE", 2)  # price the wire 2 bytes wide
    assert ("COLL-Q-003", "error") in _rules(aud._wire_inventory_findings(
        uses, "model_parallel", 4, "fp8", "seed"))


def test_seeded_leaky_world1_fires_dtype_q_002(cpu8, monkeypatch):
    from tpu_matmul_bench_torch.parallel import collectives

    real = collectives.wire_psum

    def leaky(mesh, shards, fmt, out_dtype=None):
        if len(shards) == 1:  # a world-1 short-circuit that rounds anyway
            return [s.to(torch.int8).to(s.dtype) for s in shards]
        return real(mesh, shards, fmt, out_dtype=out_dtype)

    assert aud._world1_inert_findings(cpu8) == []
    monkeypatch.setattr(collectives, "wire_psum", leaky)
    assert ("DTYPE-Q-002", "error") in _rules(aud._world1_inert_findings(cpu8))


def test_seeded_axis_inventories_fire_coll_h(cpu8):
    cfg = aud._audit_config("bfloat16", "cuda")
    (_, mesh, build), (_, _, summa_build) = aud._hier_cases("dcn:2,ici:4", cpu8)
    s = build(cfg)
    uses = aud.per_collective(aud.run_recorded(s.full, *s.operands), mesh)
    assert aud._hier_inventory_findings(uses, "hybrid", "dcn:2,ici:4", None, "seed") == []
    assert _rules(aud._hier_inventory_findings(uses, "summa", "dcn:2,ici:4", None,
                                               "seed")) == [("COLL-H-001", "error")]
    # summa's panels on one factorization audited as the transposed one's
    s = summa_build(cfg)
    steps = cm.hier_mode_steps("summa", "dcn:2,ici:4")
    panels = aud.per_collective(aud.run_recorded(s.full, *s.operands), mesh, steps)
    assert aud._hier_inventory_findings(panels, "summa", "dcn:2,ici:4", None, "seed") == []
    assert _rules(aud._hier_inventory_findings(panels, "summa", "dcn:4,ici:2", None,
                                               "seed")) == [("COLL-H-002", "error")]
    # the exact program audited as dcn-quantized: no wire dtype on dcn
    assert _rules(aud._hier_routing_findings(uses, aud.HIER_QUANT, "seed")) == [
        ("COLL-H-003", "error")]
    wrong = [(k, "ici", n, "float8_e4m3fn") for k, a, n, d in uses]
    assert ("COLL-H-003", "error") in _rules(aud._hier_routing_findings(
        wrong, aud.HIER_QUANT, "seed"))


def test_seeded_memory_fires_mem_001_002_003(cpu8, monkeypatch):
    mm._mode_peak_bytes.cache_clear()
    try:
        found = mm.audit_memory(cpu8, worlds=(4,), budget_gib=1e-6)
        assert _rules(found) == [("MEM-001", "error")] and len(found) == 5
        mm._mode_peak_bytes.cache_clear()
        monkeypatch.setattr(mm, "estimate_peak_bytes", lambda fn, *a: 1)  # undercounts
        assert _rules(mm.audit_memory(cpu8, worlds=(4,))) == [("MEM-002", "warn")]
    finally:
        mm._mode_peak_bytes.cache_clear()
    assert _rules(mm.check_stream_budget(4096, "bfloat16", 8, panels=4,
                                         budget_gib=0.001)) == [("MEM-003", "error")]


def test_seeded_routing_fires_reg_001_and_tune_001(tmp_path, monkeypatch):
    from tpu_matmul_bench_torch.ops import impl_select
    from tpu_matmul_bench_torch.tune.db import TuningDB

    assert aud.audit_registry() == [] and aud.audit_tune() == []
    # no DB cell, and a table tier that routes to the kernel on a hunch
    empty = TuningDB.load(str(tmp_path / "empty.jsonl"))
    monkeypatch.setattr(impl_select, "table_select",
                        lambda *a, **k: impl_select.ImplChoice("cuda", "a hunch"))
    assert _rules(aud.audit_registry(db=empty)) == [("REG-001", "warn")]
    assert _rules(aud.audit_tune(db=empty)) == [("TUNE-001", "error")]


def test_seeded_store_fires_art_001(tmp_path):
    from tpu_matmul_bench_torch.tune.artifacts import ArtifactMeta, ArtifactStore

    store = ArtifactStore.load(str(tmp_path / "store"))
    rec = store.put(ArtifactMeta.build(16, 16, 16, "bfloat16", impl="cuda",
                                       device_kind="h100"), b"library bytes" * 8)
    assert [f.rule for f in aud.audit_artifacts(store=store) if f.rule == "ART-001"] == []
    (Path(store.root) / rec["blob"]).write_bytes(b"tampered")
    found = aud.audit_artifacts(store=ArtifactStore.load(store.root))
    assert ("ART-001", "error") in _rules(found)


def test_seeded_host_read_fires_train_005(cpu8, monkeypatch):
    from tpu_matmul_bench_torch.train import step

    real = step.make_train_setup

    def impure(*a, **kw):
        s = real(*a, **kw)

        def step_fn(x, w):
            out = s.step(x, w)
            out[0].float().sum().item()  # a loss read back inside the step
            return out
        return dataclasses.replace(s, step=step_fn)

    monkeypatch.setattr(step, "make_train_setup", impure)
    found = aud.audit_train(cpu8)
    assert {f.rule for f in found} == {"TRAIN-005"}
    assert all(f.where.startswith("train:") for f in found)
