"""The port's fault subsystem (`tpu_matmul_bench_torch/faults/`) against
the JAX package's, on the CPU.

- Retry: `RetryPolicy.delay` is bitwise JAX's over seed × attempt × kind ×
  jitter, and the budget spends alike.
- Plans: the inline grammar parses and prints JAX's plan strings
  identically, rejects the same malformed ones with the same message, and
  the runtime fires on the same occurrence with the same exception.
- Span hook: the port's `telemetry.span` fires a plan and touches the
  heartbeat file; with neither variable set no fault module is imported.
- Supervisor: the escalation ladder on real (stdlib) children.
- Chaos matrix: `specs/chaos.toml` gives the same cells, and the lint the
  same findings on JAX's seeded bad matrices.
- Static audits: FAULT-001/002 clean on the port's tree, tripped by seeded
  fixtures and by a stale registry entry; every listed file exists.
- Workloads and certifier: the port's resumable workloads converge after a
  tear in process, and the JAX package's state extractors read the port's
  artifacts as the port's do; `faults selftest`; `faults audit --smoke`
  and the chaos matrix's serve and campaign kill9 cells in child
  processes (the serve cell with `--device cpu`).
"""

from __future__ import annotations

import dataclasses
import errno
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tpu_matmul_bench.campaign.spec import _parse_toml as jax_parse_toml
from tpu_matmul_bench.faults import audit as jax_audit
from tpu_matmul_bench.faults import plan as jax_plan
from tpu_matmul_bench.faults import retry as jax_retry
from tpu_matmul_bench_torch.faults import audit, plan, retry, supervisor, workloads
from tpu_matmul_bench_torch.faults import cli as faults_cli

REPO = Path(__file__).resolve().parent.parent
CHAOS = REPO / "specs" / "chaos.toml"
PORT_ROOT = REPO / "tpu_matmul_bench_torch"


@pytest.fixture(autouse=True)
def reporting_override_restored():
    """The ledger workload forces this process to report (as a chaos child
    does); the worker's other tests get the setting back."""
    from tpu_matmul_bench_torch.utils.reporting import (
        force_reporting_process,
        reporting_process_override,
    )

    before = reporting_process_override()
    yield
    force_reporting_process(before)


# ---------------------------------------------------------------- retry

@pytest.mark.parametrize("jitter", [0.0, 7.5, 20.0, 50.0])
def test_retry_delays_are_jax_bits(jitter):
    for seed in (0, 1, 11, 12, 2**31 - 1):
        for base in (0.01, 1.0, 30.0, 180.0):
            port = retry.RetryPolicy(base_s=base, jitter_pct=jitter, seed=seed)
            ref = jax_retry.RetryPolicy(base_s=base, jitter_pct=jitter, seed=seed)
            for attempt in range(0, 12):
                for kind in ("error", "transport", "timeout", "transient"):
                    assert port.delay(attempt, kind) == ref.delay(attempt, kind)
    assert (retry.BACKOFF_CAP_S, retry.TRANSPORT_MIN_BACKOFF_S) == \
        (jax_retry.BACKOFF_CAP_S, jax_retry.TRANSPORT_MIN_BACKOFF_S)


def test_retry_budget_spends_exactly_retries():
    for n in range(4):
        port, ref = retry.RetryBudget(retries=n), jax_retry.RetryBudget(retries=n)
        while port.allow():
            assert ref.allow()
            port.spend()
            ref.spend()
        assert not ref.allow() and port.attempts == ref.attempts == n + 1


# ---------------------------------------------------------------- plans

_PLANS = [
    "kill9@w:record#2",
    "hang:60000@w:record",
    "hang:1500@w:cell;torn-write:*.jsonl@w:cell#3",
    "torn-write:ledger.jsonl@w:record#3",
    "transient-exc:transport@job:*",
    "transient-exc:oom@w:record, disk-full@w:snapshot#2",
    "transient-exc:overload@s;transient-exc:runtime@s#4",
    "kill9@",
    "  kill9@serve:batch#2 ; ",
]


@pytest.mark.parametrize("text", _PLANS)
def test_inline_plans_parse_and_print_as_jax(text):
    port, ref = plan.parse_inline(text, seed=7), jax_plan.parse_inline(text, seed=7)
    assert [dataclasses.asdict(s) for s in port.specs] == \
        [dataclasses.asdict(s) for s in ref.specs]
    assert port.seed == ref.seed == 7
    assert port.to_inline() == ref.to_inline()
    assert plan.parse_inline(port.to_inline(), seed=7) == port


@pytest.mark.parametrize("bad", [
    "kill9", "meteor-strike@w:record", "hang@w:cell", "hang:zero@w:cell",
    "torn-write@w:cell", "kill9@w:record#0", "kill9@w:record#two",
    "kill9:arg@w:record", "transient-exc:gamma-ray@w:record", "",
])
def test_malformed_plans_rejected_as_jax(bad):
    with pytest.raises(plan.FaultPlanError) as port:
        plan.parse_inline(bad)
    with pytest.raises(jax_plan.FaultPlanError) as ref:
        jax_plan.parse_inline(bad)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("suffix, body", [
    (".toml", 'seed = 9\n[[fault]]\nkind = "transient-exc"\nphase = "w:record"\n'
              'errclass = "transport"\noccurrence = 2\n'),
    (".json", json.dumps({"seed": 3, "fault": [{"kind": "hang", "delay_ms": 5,
                                                 "phase": "x:*"}]})),
])
def test_plan_files_parse_as_jax(tmp_path, suffix, body):
    p = tmp_path / f"plan{suffix}"
    p.write_text(body)
    port, ref = plan.parse_plan(str(p)), jax_plan.parse_plan(str(p))
    assert port.seed == ref.seed
    assert port.to_inline() == ref.to_inline()


def _fires(mod, text, spans):
    """The exception each span open raises under a plan (None if none)."""
    active = mod.ActivePlan(mod.parse_inline(text))
    out = []
    for name in spans:
        try:
            active.on_span(name)
            out.append(None)
        except BaseException as e:  # noqa: BLE001 — the injected fault is the value
            out.append((type(e).__name__, str(e), getattr(e, "errno", None)))
    return out, active.hits, active.fired


@pytest.mark.parametrize("text", [
    "transient-exc:transport@w:x#2", "transient-exc:oom@w:*#3", "disk-full@w:x",
    "transient-exc:runtime@w:y;disk-full@w:x#2", "hang:1@w:x#2",
])
def test_runtime_fires_as_jax(text):
    spans = ["w:x", "other", "w:y", "w:x", "w:x", "w:z"]
    assert _fires(plan, text, spans) == _fires(jax_plan, text, spans)


def test_injected_faults_classify_transient():
    from tpu_matmul_bench_torch.utils.errors import OVERLOAD, TRANSIENT, classify

    for inline, want in (("transient-exc:transport@s", TRANSIENT),
                         ("transient-exc:oom@s", TRANSIENT), ("disk-full@s", TRANSIENT),
                         ("transient-exc:overload@s", OVERLOAD)):
        with pytest.raises(BaseException) as e:
            plan.ActivePlan(plan.parse_inline(inline)).on_span("s")
        assert classify(e.value) == want, inline
    with pytest.raises(OSError) as e:
        plan.ActivePlan(plan.parse_inline("disk-full@s")).on_span("s")
    assert e.value.errno == errno.ENOSPC


@pytest.mark.parametrize("content", [
    b'{"a": 1}\n{"b": 22222222}\n', b'{"a": 1}\n{"b": 2', b"x\n", b"", b"one line"])
def test_tear_file_cuts_as_jax(tmp_path, content):
    (tmp_path / "p").write_bytes(content)
    (tmp_path / "j").write_bytes(content)
    assert plan.tear_file(tmp_path / "p") == jax_plan.tear_file(tmp_path / "j")
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()


# ------------------------------------------------------------ span hook

def test_port_span_fires_a_plan_and_touches_the_heartbeat(monkeypatch, tmp_path):
    from tpu_matmul_bench_torch.utils import telemetry

    hb = tmp_path / "job.log.hb"
    monkeypatch.setenv(plan.HEARTBEAT_ENV, str(hb))
    monkeypatch.setenv(plan.FAULT_PLAN_ENV, "transient-exc:runtime@chaos:test#2")
    plan.reset_active_plan()
    try:
        with telemetry.span("chaos:other"):
            pass
        assert hb.exists()
        os.utime(hb, (0, 0))
        with telemetry.span("chaos:test"):  # occurrence 1: no fire
            pass
        assert os.stat(hb).st_mtime > 0
        with pytest.raises(RuntimeError, match="injected"):
            with telemetry.span("chaos:test"):
                pass
    finally:
        plan.reset_active_plan()


def test_port_span_without_fault_vars_imports_no_fault_module():
    code = ("import sys\n"
            "from tpu_matmul_bench_torch.utils import telemetry\n"
            "with telemetry.span('w:record'):\n"
            "    pass\n"
            "with telemetry.session('-'):\n"
            "    with telemetry.span('w:cell'):\n"
            "        pass\n"
            "print('FAULTS', sorted(m for m in sys.modules if '.faults' in m))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in (plan.FAULT_PLAN_ENV, plan.HEARTBEAT_ENV)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FAULTS []" in out.stdout


# ------------------------------------------------------------ supervisor

def _supervise(code, tmp_path, **kw):
    return supervisor.supervised_run([sys.executable, "-c", code],
                                     log_path=tmp_path / "jobs" / "t.log", **kw)


def test_supervisor_clean_and_failed_exits(tmp_path):
    res = _supervise("print('ok')", tmp_path)
    assert (res.rc, res.timed_out, res.escalation) == (0, False, "")
    assert supervisor.heartbeat_path(tmp_path / "jobs" / "t.log").exists()
    assert _supervise("raise SystemExit(3)", tmp_path).rc == 3
    res = supervisor.supervised_run([str(tmp_path / "no-such-binary")],
                                    log_path=tmp_path / "jobs" / "t.log")
    assert res.rc is None and "spawn failed" in res.error


def test_supervisor_stall_watchdog_then_sigkill(tmp_path):
    start = time.monotonic()
    res = _supervise("import time; time.sleep(60)", tmp_path, timeout_s=30.0,
                     heartbeat_timeout_s=1.0)
    assert res.rc is None and res.timed_out and "heartbeat stale" in res.error
    assert time.monotonic() - start < 15.0
    code = ("import signal, time\nsignal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
            "time.sleep(60)\n")
    res = _supervise(code, tmp_path, timeout_s=1.0, term_grace_s=0.3)
    assert res.escalation == "SIGTERM+SIGKILL" and "deadline" in res.error
    log = (tmp_path / "jobs" / "t.log").read_text()
    assert "sending SIGTERM" in log and "sending SIGKILL" in log


def test_executor_launch_keeps_the_heartbeat_off_the_jobs_dir(tmp_path):
    from tpu_matmul_bench_torch.campaign.executor import _default_launch

    log = tmp_path / "camp" / "jobs" / "j.log"
    res = _default_launch([sys.executable, "-c", "print('hi')"], log=log,
                          timeout_s=30.0, env=None)
    assert res.rc == 0
    assert (tmp_path / "camp" / ".state" / "hb" / "j.log.hb").exists()
    assert not list(log.parent.glob("*.hb"))


# ---------------------------------------------------------- chaos matrix

def test_chaos_matrix_cells_match_jax():
    port, ref = audit.load_chaos_spec(CHAOS), jax_audit.load_chaos_spec(CHAOS)
    assert port.seed == ref.seed
    assert [dataclasses.asdict(c) for c in port.cells] == \
        [dataclasses.asdict(c) for c in ref.cells]
    assert [c.fault_spec().to_inline() for c in port.cells] == \
        [c.fault_spec().to_inline() for c in ref.cells]
    assert [c.label(i) for i, c in enumerate(port.cells)] == \
        [c.label(i) for i, c in enumerate(ref.cells)]
    assert audit.SUBSYSTEMS == jax_audit.SUBSYSTEMS
    assert audit.DEFAULT_PHASE == jax_audit.DEFAULT_PHASE
    assert [i for i, _ in audit.smoke_cells(port)] == [i for i, _ in jax_audit.smoke_cells(ref)]


@pytest.mark.parametrize("data", [
    jax_parse_toml(CHAOS.read_text()),
    {"chaos": "not-a-table"},
    {"chaos": {"seed": 1}},
    {"chaos": {"blast": 1, "cell": [{"fault": "kill9", "subsystem": "ledger"}]}},
    {"chaos": {"cell": [{"fault": "kill9", "subsystem": "ledger", "radius": 2}]}},
    {"chaos": {"cell": [{"fault": "meteor", "subsystem": "ledger"}]}},
    {"chaos": {"cell": [{"fault": "kill9", "subsystem": "ledger", "units": 1}]}},
    {"chaos": {"cell": [{"fault": "hang", "subsystem": "campaign", "delay_ms": 9}]}},
    {"chaos": {"cell": ["not a table", {"fault": "kill9", "subsystem": "gpu"}]}},
], ids=["shipped", "not-table", "no-cells", "chaos-key", "cell-key", "kind", "units",
        "hang-no-heartbeat", "mixed"])
def test_chaos_lint_findings_match_jax(data):
    def rows(findings):
        return [(f.rule, f.where, f.message, f.severity) for f in findings]

    assert rows(audit.lint_chaos_data(data, "<t>")) == \
        rows(jax_audit.lint_chaos_data(data, "<t>"))


# -------------------------------------------------------- static audits

def test_static_audits_are_clean_on_the_ports_tree():
    findings = audit.static_findings()
    assert not findings, [f"{f.rule} {f.where}" for f in findings]


def test_every_listed_file_exists_and_has_its_site():
    for rel in supervisor.SPAWN_ALLOWLIST:
        text = (PORT_ROOT / rel).read_text()
        assert audit._SPAWN_RE.search(text), rel
    for rel in audit.WRITER_REGISTRY:
        assert audit._FSYNC_RE.search((PORT_ROOT / rel).read_text()), rel
    # the metric-history store's fsync site (obs/history.py) is registered
    assert "obs/history.py" in audit.WRITER_REGISTRY


@pytest.mark.parametrize("source, rules", [
    ("import subprocess\n" + "subprocess" + ".run(['true'])\n", [("FAULT-001", "rogue.py:2")]),
    ("import os\n" + "os" + ".fsync(3)\n", [("FAULT-002", "rogue.py:2")]),
    ("import os\n" + "os" + ".system('true')\n", [("FAULT-001", "rogue.py:2")]),
    ("# " + "subprocess" + ".run(['x']) is forbidden\nx = 1  # " + "os" + ".fsync(3)\n", []),
])
def test_seeded_fixtures_trip_as_jax(tmp_path, source, rules):
    (tmp_path / "rogue.py").write_text(source)
    port = audit.static_findings(tmp_path, spawn_allowlist={}, writer_registry={})
    ref = jax_audit.static_findings(tmp_path, spawn_allowlist={}, writer_registry={})
    assert [(f.rule, f.where) for f in port] == [(f.rule, f.where) for f in ref] == rules
    assert [f.message for f in port] == [f.message for f in ref]


def test_stale_registry_entry_trips_fault_002(tmp_path):
    # a registered writer the tree does not hold (analysis/spec_lint.py
    # reads specs and fsyncs nothing)
    stale = "analysis/spec_lint.py"
    found = audit.static_findings(tmp_path, spawn_allowlist={},
                                  writer_registry={stale: "not ported"})
    assert [(f.rule, f.where) for f in found] == [("FAULT-002", stale)]
    # ... as it would on the port's tree
    found = audit.static_findings(
        writer_registry={**audit.WRITER_REGISTRY, stale: "not ported"})
    assert [(f.rule, f.where) for f in found] == [("FAULT-002", stale)]


def test_an_unlisted_port_spawn_site_trips_fault_001():
    allow = {k: v for k, v in supervisor.SPAWN_ALLOWLIST.items() if k != "ops/_build.py"}
    found = audit.static_findings(spawn_allowlist=allow)
    assert {f.rule for f in found} == {"FAULT-001"}
    assert {f.where.split(":")[0] for f in found} == {"ops/_build.py"}


# ------------------------------------------- workloads and the certifier

def test_ledger_workload_converges_after_a_tear(tmp_path):
    clean, torn = tmp_path / "clean.jsonl", tmp_path / "torn.jsonl"
    workloads.run_ledger(str(clean), records=4)
    workloads.run_ledger(str(torn), records=2)
    plan.tear_file(torn)
    workloads.run_ledger(str(torn), records=4)
    problems: list[str] = []
    state = audit._ledger_state(torn, 4, problems)
    assert state == audit._ledger_state(clean, 4, problems) and not problems
    # the JAX package's extractor reads the port's ledgers alike
    ref_problems: list[str] = []
    assert jax_audit._ledger_state(torn, 4, ref_problems) == state and not ref_problems


def test_tune_and_obs_workloads_resume(tmp_path):
    db = tmp_path / "tune_db.jsonl"
    workloads.run_tune(str(db), cells=2)
    plan.tear_file(db)
    workloads.run_tune(str(db), cells=4)
    problems: list[str] = []
    cells = audit._tune_state(db, 4, problems)
    assert sorted(cells) == [f"chaos-{i}" for i in range(4)] and not problems
    workloads.run_obs(str(tmp_path / "obs"), snapshots=2)
    workloads.run_obs(str(tmp_path / "obs"), snapshots=4)
    state = audit._obs_state(tmp_path / "obs", 4, problems)
    assert state["values"] == [1, 2, 3, 4] and not problems
    ref_problems: list[str] = []
    assert jax_audit._obs_state(tmp_path / "obs", 4, ref_problems) == state
    assert not ref_problems


def test_serve_lines_validate_through_the_ports_validators():
    good = {"record_type": "serve_batch", "seq": 1, "bucket": "256x256x256/float32",
            "n": 4, "failed": 0, "batch_ms": 1.25}
    assert audit._validate_serve_line(good) == []
    assert audit._validate_serve_line({**good, "seq": 0})
    assert audit._validate_serve_line({"record_type": "other"}) == []


def test_faults_selftest_passes_in_process(capsys):
    assert faults_cli.main(["selftest"]) == []
    out = capsys.readouterr().out
    assert "faults selftest: all invariants hold" in out
    assert "FAIL" not in out


def _audit(tmp_path, argv):
    return subprocess.run(
        [sys.executable, "-m", "tpu_matmul_bench_torch", "faults", "audit",
         "--dir", str(tmp_path / "audit"), *argv],
        cwd=REPO, capture_output=True, text=True, timeout=600)


def _verdicts(tmp_path):
    lines = (tmp_path / "audit" / audit.AUDIT_LEDGER_NAME).read_text().splitlines()
    return {r["cell"]: r for r in map(json.loads, lines)}


def test_audit_smoke_passes_over_the_chaos_matrix(tmp_path):
    out = _audit(tmp_path, ["--smoke", "--spec", str(CHAOS)])
    assert out.returncode == 0, out.stdout + out.stderr
    verdicts = _verdicts(tmp_path)
    assert {r["subsystem"] for r in verdicts.values()} == {"ledger", "tune", "obs"}
    assert all(r["status"] == "PASS" for r in verdicts.values())
    assert "fault audit: 3/3 cells PASS" in out.stdout


def test_audit_serve_and_campaign_kill9_cells_pass_on_the_cpu(tmp_path):
    """The chaos matrix's serve cell, verbatim, and its campaign kill9 cell:
    `serve selftest` killed at its second `serve:batch` span (here with
    `--device cpu`), and a campaign whose child dies mid-run, retried, then
    resumed."""
    data = jax_parse_toml(CHAOS.read_text())
    cells = [c for c in data["chaos"]["cell"]
             if c["subsystem"] == "serve" or (c["subsystem"] == "campaign"
                                              and c["fault"] == "kill9")]
    assert len(cells) == 2
    spec = tmp_path / "cells.toml"
    body = [f"[chaos]\nseed = {data['chaos']['seed']}\n"]
    for cell in cells:
        body.append("[[chaos.cell]]\n" + "".join(
            f"{k} = {json.dumps(v)}\n" for k, v in cell.items()))
    spec.write_text("\n".join(body))
    out = _audit(tmp_path, ["--spec", str(spec), "--device", "cpu"])
    assert out.returncode == 0, out.stdout + out.stderr
    verdicts = _verdicts(tmp_path)
    assert [r["status"] for r in verdicts.values()] == ["PASS", "PASS"]
    camp = next(r for r in verdicts.values() if r["subsystem"] == "campaign")
    assert camp["attempts"] == 2  # the fault re-fires on every restart
