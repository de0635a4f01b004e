"""The port's campaign runner end to end on the CPU: real child processes
through `python -m tpu_matmul_bench_torch campaign`, with tiny `matmul
--device cpu --matmul-impl torch` jobs.

- A two-job campaign: its ledgers, logs and spec copy; one merged Chrome
  trace; each job manifest naming the campaign run that spawned it; the
  obs snapshots; `status`; the gate against itself and against a doctored
  baseline; the JAX package's store summarising the port's directory as
  the port's does.
- The crash-safety case: SIGKILL the campaign and its in-flight child
  after the first job is done, resume, and every job ends done exactly
  once with its ledger present.
- Every program a spec names accepts the flags the executor injects
  (`--json-out`, `--trace-out`), and every card spec's job parses in full.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tpu_matmul_bench.campaign.store import CampaignStore as JaxStore
from tpu_matmul_bench_torch.__main__ import main as port_main
from tpu_matmul_bench_torch.campaign import cli, executor, spec, state
from tpu_matmul_bench_torch.campaign import gate as gate_mod
from tpu_matmul_bench_torch.campaign.store import CampaignStore

REPO = Path(__file__).resolve().parent.parent
_CPU = ["--device", "cpu", "--matmul-impl", "torch", "--num-devices", "1",
        "--iterations", "2", "--warmup", "1"]
_SMOKE_SPEC = {
    "campaign": {"name": "smoke"},
    "defaults": {"timeout_s": 300.0, "retries": 0},
    "job": [{"id": "small", "program": "matmul", "flags": ["--sizes", "32", *_CPU]},
            {"id": "large", "program": "matmul", "flags": ["--sizes", "64", *_CPU]}],
}


def _campaign(args: list[str], timeout: float = 300.0):
    return subprocess.run(
        [sys.executable, "-m", "tpu_matmul_bench_torch", "campaign", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def campaign_dir(tmp_path_factory):
    """One completed two-job CPU campaign, shared by the read-only tests."""
    root = tmp_path_factory.mktemp("torch_campaign_e2e")
    spec_path = root / "spec.json"
    spec_path.write_text(json.dumps(_SMOKE_SPEC))
    d = root / "run"
    out = _campaign(["run", str(spec_path), "--dir", str(d)])
    assert out.returncode == 0, out.stdout + out.stderr
    assert "campaign: 2/2 jobs done" in out.stdout
    return d


def test_campaign_artifacts(campaign_dir):
    events = state.load_events(campaign_dir)
    assert len(state.finished_fingerprints(events)) == 2
    for job_id in ("small", "large"):
        ledger = campaign_dir / "jobs" / f"{job_id}.jsonl"
        assert executor.ledger_measurement_count(ledger) == 1
        assert (campaign_dir / "jobs" / f"{job_id}.log").exists()
        manifest = json.loads(ledger.read_text().splitlines()[0])
        assert manifest["backend"] == "cpu" and "torch_version" in manifest
    assert (campaign_dir / "spec.json").exists()


def test_campaign_trace_and_run_id_propagation(campaign_dir):
    merged = json.loads((campaign_dir / executor.MERGED_TRACE_NAME).read_text())
    evs = merged["traceEvents"]
    assert {e["args"]["name"] for e in evs if e.get("ph") == "M"} == {"small", "large"}
    assert len({e["pid"] for e in evs}) == 2
    assert any(e.get("ph") == "X" for e in evs)

    from tpu_matmul_bench_torch.obs.export import read_snapshots

    snaps = read_snapshots(campaign_dir / "obs" / "obs_snapshot.jsonl")
    assert snaps
    assert snaps[-1]["counters"]['campaign_jobs_total{status="done"}'] == 2
    campaign_run = snaps[-1]["run_id"]
    for job_id in ("small", "large"):
        ledger = campaign_dir / "jobs" / f"{job_id}.jsonl"
        trace = json.loads(ledger.read_text().splitlines()[0])["trace"]
        assert trace["run_id"] and trace["parent_run_id"] == campaign_run


def test_status_and_dry_run(campaign_dir, tmp_path, capsys):
    assert cli.main(["status", str(campaign_dir)]) == 0
    out = capsys.readouterr().out
    assert "small" in out and "large" in out and "done=2" in out
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(_SMOKE_SPEC))
    assert cli.main(["run", str(spec_path), "--dir", str(tmp_path / "nope"),
                     "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "2 jobs (dry run; nothing executed)" in out
    assert "-m tpu_matmul_bench_torch matmul" in out and "--json-out" in out
    assert not (tmp_path / "nope").exists()


def test_jax_store_summarises_the_ports_campaign_alike(campaign_dir):
    port, ref = CampaignStore.load(campaign_dir), JaxStore.load(campaign_dir)
    assert port.summary() == ref.summary()
    assert port.merged_records() == ref.merged_records()
    assert len(port.summary()) == 2


def test_gate_against_itself_passes_and_a_doctored_baseline_fails(campaign_dir, tmp_path,
                                                                   capsys):
    snap = tmp_path / "baseline.json"
    assert cli.main(["gate", str(campaign_dir), "--baseline", str(campaign_dir),
                     "--write-baseline", str(snap)]) == 0
    assert "gate: PASS (2 compared, 0 failing, exit 0)" in capsys.readouterr().out
    data = json.loads(snap.read_text())
    assert data["kind"] == gate_mod.BASELINE_KIND and len(data["jobs"]) == 2
    # one job's baseline 1.5x what the campaign measured: a 33% loss
    fp = sorted(data["jobs"])[0]
    data["jobs"][fp]["tflops_per_device"] *= 1.5
    doctored = tmp_path / "doctored.json"
    doctored.write_text(json.dumps(data))
    with pytest.raises(SystemExit) as e:
        cli.main(["gate", str(campaign_dir), "--baseline", str(doctored)])
    assert e.value.code == gate_mod.EXIT_REGRESSION
    out = capsys.readouterr().out
    assert "REGRESSION" in out and "gate: FAIL (2 compared, 1 failing, exit 1)" in out
    res = _campaign(["gate", str(campaign_dir), "--baseline", str(doctored)])
    assert res.returncode == gate_mod.EXIT_REGRESSION, res.stdout + res.stderr


def _campaign_children(d: Path) -> list[int]:
    """Pids of live port children whose argv names the campaign dir."""
    pids = []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            argv = (entry / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        if b"tpu_matmul_bench_torch" in argv and any(str(d).encode() in a for a in argv) \
                and b"campaign" not in argv:
            pids.append(int(entry.name))
    return pids


def test_sigkill_mid_campaign_then_resume_completes(tmp_path):
    spec_d = {
        "campaign": {"name": "killable"},
        "defaults": {"timeout_s": 300.0, "retries": 0},
        "job": [{"id": f"j{n}", "program": "matmul",
                 "flags": ["--sizes", str(s), *_CPU]}
                for n, s in enumerate((48, 64, 80), start=1)],
    }
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec_d))
    d = tmp_path / "run"
    journal = d / state.JOURNAL_NAME
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_matmul_bench_torch", "campaign", "run",
         str(spec_path), "--dir", str(d)],
        cwd=REPO, start_new_session=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 180.0
        while time.monotonic() < deadline:
            if journal.exists() and '"status": "done"' in journal.read_text():
                break
            if proc.poll() is not None:
                pytest.fail("campaign exited before its first job finished")
            time.sleep(0.05)
        else:
            pytest.fail("no job finished within the deadline")
        # the campaign's group, and the in-flight child's own session (the
        # supervisor starts each child in a session of its own, so killing
        # the campaign's group does not reach it)
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        for pid in _campaign_children(d):
            os.killpg(pid, signal.SIGKILL)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    deadline = time.monotonic() + 30.0
    while _campaign_children(d) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _campaign_children(d)

    done_before = state.finished_fingerprints(state.load_events(d))
    assert 1 <= len(done_before) < 3
    res = _campaign(["resume", str(d)])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "3/3 jobs done" in res.stdout

    events = state.load_events(d)
    done = [ev.fingerprint for ev in events if ev.status == state.DONE]
    assert len(done) == len(set(done)) == 3
    for fp in done_before:  # the finished job never re-launched
        assert len([ev for ev in events if ev.fingerprint == fp
                    and ev.status == state.RUNNING and not ev.detail]) == 1
    job_ids = {j.fingerprint: j.job_id for j in spec.load_spec(d / "spec.json").jobs}
    parents = {}
    for n in (1, 2, 3):
        lines = (d / "jobs" / f"j{n}.jsonl").read_text().splitlines()
        assert executor.ledger_measurement_count(d / "jobs" / f"j{n}.jsonl") == 1
        assert sum('"record_type": "manifest"' in line for line in lines) == 1
        parents[f"j{n}"] = json.loads(lines[0])["trace"]["parent_run_id"]
    pre = {parents[job_ids[fp]] for fp in done_before}
    post = {p for j, p in parents.items() if j not in {job_ids[fp] for fp in done_before}}
    assert all(parents.values()) and pre.isdisjoint(post)
    merged = json.loads((d / executor.MERGED_TRACE_NAME).read_text())
    assert {e["args"]["name"] for e in merged["traceEvents"] if e.get("ph") == "M"} \
        == {"j1", "j2", "j3"}


# --------------------------------------- the injected flags, every program

class _Parsed(Exception):
    def __init__(self, ns):
        super().__init__("parsed")
        self.ns = ns


@pytest.fixture
def parse_only(monkeypatch):
    """The first full argv parse of a program raises its namespace instead
    of running the program."""
    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)


def _all_jobs():
    jobs = []
    for path in sorted((REPO / "specs").glob("*.toml")) + sorted(
            (REPO / "specs" / "torch").glob("*.toml")):
        try:
            s = spec.load_spec(path)
        except spec.CampaignSpecError:
            continue  # no jobs (chaos, history, tenants)
        jobs += [(path, j) for j in s.jobs]
    return jobs


# the words the programs' front ends dispatch on
_SUBCOMMANDS = ("bench", "ab", "selftest", "stream", "run")


def _subcommand(argv) -> tuple[str, ...]:
    """The subcommand of a job's argv (`serve bench`, `train bench`,
    `parallel stream`, which may stand among the flags), or none."""
    return tuple(a for a in argv if a in _SUBCOMMANDS)[:1]


# plus the chaos matrix's campaign cells' job, `faults run`
_PROGRAM_CALLS = sorted({(j.program, _subcommand(j.argv)) for _p, j in _all_jobs()}
                        | {("faults", ("run",))})


@pytest.mark.parametrize("program, sub", _PROGRAM_CALLS,
                         ids=lambda v: v if isinstance(v, str) else "-".join(v) or "flags")
def test_every_program_a_spec_names_takes_the_injected_flags(parse_only, program, sub,
                                                             tmp_path):
    extra = ["--workload", "ledger"] if program == "faults" else []
    json_out, trace_out = str(tmp_path / "l.jsonl"), str(tmp_path / "t.json")
    with pytest.raises(_Parsed) as parsed:
        port_main([program, *sub, *extra, "--json-out", json_out, "--trace-out", trace_out])
    assert parsed.value.ns.json_out == json_out
    assert parsed.value.ns.trace_out == trace_out


@pytest.mark.parametrize("path, job", [(p, j) for p, j in _all_jobs()
                                       if p.parent.name == "torch"],
                         ids=lambda v: v.job_id if isinstance(v, spec.Job) else v.stem)
def test_every_card_spec_job_parses(parse_only, path, job, tmp_path):
    ledger, _log = executor.job_paths(tmp_path, job)
    cmd = executor.job_command(job, tmp_path, ledger)
    assert cmd[:3] == [sys.executable, "-m", "tpu_matmul_bench_torch"]
    with pytest.raises(_Parsed) as parsed:
        port_main(cmd[3:])
    assert parsed.value.ns.json_out == str(ledger)
