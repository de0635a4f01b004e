"""The port's campaign subsystem (`tpu_matmul_bench_torch/campaign/`)
against the JAX package's, on the CPU, with no child process (the process
tests are in tests/test_torch_campaign_e2e.py).

- Specs: every `specs/*.toml` and `specs/torch/*.toml` expands to the same
  job plan in both packages (ids, argv, policy, fingerprints, the
  canonical spec copy), as do seeded random specs.
- Journal: one event sequence under a fixed clock writes byte-identical
  lines, and each package reads the other's journal, torn tail included.
- Gate: seeded random summaries (throughput rows, serve rows with SLO
  attainment and noise) give equal rows, tolerances, exit codes, reports
  and baseline snapshot bytes.
- Store: both packages summarise one port-built campaign directory alike.
- Executor: the JAX package's journal contract under an injected launch
  (retries, transport floor, resume), and a parent that never asks CUDA.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from tpu_matmul_bench.campaign import gate as jax_gate
from tpu_matmul_bench.campaign import spec as jax_spec
from tpu_matmul_bench.campaign import state as jax_state
from tpu_matmul_bench.campaign.store import CampaignStore as JaxStore
from tpu_matmul_bench_torch.campaign import cli, executor, gate, spec, state
from tpu_matmul_bench_torch.campaign.store import CampaignStore

REPO = Path(__file__).resolve().parent.parent
SPECS = sorted((REPO / "specs").glob("*.toml")) + sorted(
    (REPO / "specs" / "torch").glob("*.toml"))
#: the observatory's detection-window spec beside the card specs: a
#: [history] table, no campaign (`obs detect`, `obs report`)
HISTORY_SPEC = "history.toml"


# ---------------------------------------------------------------- specs

def _plan(mod, path):
    """(name, [(id, program, argv, policy, fingerprint)], to_json) of a
    spec, or the error it raises."""
    try:
        s = mod.load_spec(path)
    except mod.CampaignSpecError as e:
        return ("error", str(e))
    return (s.name,
            [(j.job_id, j.program, j.argv, j.timeout_s, j.retries, j.backoff_s,
              j.heartbeat_s, j.fingerprint) for j in s.jobs],
            s.to_json())


@pytest.mark.parametrize("path", SPECS, ids=lambda p: str(p.relative_to(REPO)))
def test_spec_plans_match_jax(path):
    port, ref = _plan(spec, path), _plan(jax_spec, path)
    assert port == ref
    if path.parent.name == "torch" and path.name != HISTORY_SPEC:
        assert port[0] != "error" and port[1], "a card spec declares jobs"


def test_card_specs_name_the_port_implementations():
    # the card's specs keep no TPU implementation or VMEM tile
    for path in (REPO / "specs" / "torch").glob("*.toml"):
        if path.name == HISTORY_SPEC:
            continue
        for job in spec.load_spec(path).jobs:
            argv = list(job.argv)
            if "--matmul-impl" in argv:
                assert argv[argv.index("--matmul-impl") + 1] in ("cuda", "torch", "auto")
            if "--candidates" in argv:
                tiles = []
                for t in argv[argv.index("--candidates") + 1:]:
                    if t.startswith("--"):
                        break
                    tiles.append(tuple(map(int, t.split(","))))
                # instantiated card tiles: no TPU VMEM block (512 and up)
                assert tiles and all(max(t) <= 256 for t in tiles), tiles


def test_fingerprint_pinned_literal():
    # a persisted format: the JAX package's literal
    assert spec.job_fingerprint("matmul", ["--sizes", "64", "--iterations", "2"]) \
        == "934da6f2166c10cf"


def _random_spec(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    programs = ["matmul", "tune", "scaling", "overlap", "serve", "train"]
    flags = ["--sizes", "--iterations", "--warmup", "--dtype", "--timing", "{dir}/x"]

    def argv():
        return [str(rng.choice(flags)) if rng.random() < 0.5 else str(int(rng.integers(1, 9999)))
                for _ in range(int(rng.integers(0, 6)))]

    d = {"campaign": {"name": f"fuzz{seed}"},
         "defaults": {"flags": argv(), "timeout_s": float(rng.integers(1, 900)),
                      "retries": int(rng.integers(0, 4))},
         "job": [{"id": f"j{i}", "program": str(rng.choice(programs)), "flags": argv(),
                  "backoff_s": float(rng.random() * 10)}
                 for i in range(int(rng.integers(1, 4)))],
         "sweep": [{"program": str(rng.choice(programs)), "id_prefix": f"s{seed}",
                    "sizes": [int(v) for v in rng.integers(32, 4096, size=2)],
                    "dtypes": ["bfloat16", "int8"][:int(rng.integers(1, 3))],
                    "num_devices": [1, 8][:int(rng.integers(1, 3))],
                    "flags": argv(), "heartbeat_s": float(rng.integers(0, 3))}]}
    return d


@pytest.mark.parametrize("seed", range(8))
def test_seeded_random_specs_expand_alike(seed):
    d = _random_spec(seed)
    port, ref = spec.spec_from_dict(d), jax_spec.spec_from_dict(d)
    assert port.to_json() == ref.to_json()
    assert [j.fingerprint for j in port.jobs] == [j.fingerprint for j in ref.jobs]


@pytest.mark.parametrize("mutate", [
    lambda d: d.update(extra=1),
    lambda d: d["job"][0].update(program="nope"),
    lambda d: d["job"][0].update(flags=["--json-out", "x"]),
    lambda d: d["job"].append(dict(d["job"][0])),
    lambda d: d["job"][0].update(retries=-1),
    lambda d: d.update(job=[]),
])
def test_spec_errors_match_jax(mutate):
    d = {"campaign": {"name": "t"},
         "job": [{"id": "j1", "program": "matmul", "flags": ["--sizes", "64"]}]}
    mutate(d)
    with pytest.raises(spec.CampaignSpecError) as port:
        spec.spec_from_dict(d)
    with pytest.raises(jax_spec.CampaignSpecError) as ref:
        jax_spec.spec_from_dict(d)
    # the choice list names each package's own programs
    assert str(port.value).split(" (choose")[0] == str(ref.value).split(" (choose")[0]


def test_known_programs_are_the_ports():
    from tpu_matmul_bench_torch.__main__ import _PROGRAMS

    assert set(spec._known_programs()) == set(_PROGRAMS) - {"campaign"}
    assert "faults" in spec._known_programs()


# -------------------------------------------------------------- journal

_EVENTS = [
    ("fp1", "j1", "pending", {}),
    ("fp2", "j2", "pending", {}),
    ("fp1", "j1", "running", {"attempt": 1}),
    ("fp1", "j1", "running", {"attempt": 1, "rc": 1, "detail": "retry in 30s: transport"}),
    ("fp1", "j1", "running", {"attempt": 2}),
    ("fp1", "j1", "done", {"attempt": 2, "rc": 0, "detail": "3 records"}),
    ("fp2", "j2", "running", {"attempt": 1}),
    ("fp2", "j2", "failed", {"attempt": 1, "rc": -9, "detail": "error"}),
    ("fp1", "j1", "skipped", {"detail": "resume: already done"}),
]


def _write_journal(mod, path, events):
    with mod.Journal(path) as j:
        for fp, job_id, status, kw in events:
            j.record(fp, job_id, status, **kw)


def _as_tuples(events):
    return [(e.fingerprint, e.job_id, e.status, e.attempt, e.rc, e.detail, e.ts)
            for e in events]


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(state.time, "time", lambda: 1760000000.123456)


def test_journal_lines_are_jax_bytes(tmp_path, fixed_clock):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    _write_journal(state, tmp_path / "port" / state.JOURNAL_NAME, _EVENTS)
    _write_journal(jax_state, tmp_path / "jax" / jax_state.JOURNAL_NAME, _EVENTS)
    port = (tmp_path / "port" / state.JOURNAL_NAME).read_bytes()
    assert port == (tmp_path / "jax" / jax_state.JOURNAL_NAME).read_bytes()
    assert len(port.splitlines()) == len(_EVENTS)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_journal(tmp_path, fixed_clock, writer):
    mod = state if writer == "port" else jax_state
    _write_journal(mod, tmp_path / state.JOURNAL_NAME, _EVENTS)
    # a kill mid-append: a torn last line
    with open(tmp_path / state.JOURNAL_NAME, "a") as fh:
        fh.write('{"fingerprint": "fp3", "status": "runn')
    port, ref = state.load_events(tmp_path), jax_state.load_events(tmp_path)
    assert _as_tuples(port) == _as_tuples(ref)
    assert len(port) == len(_EVENTS)
    assert state.finished_fingerprints(port) == jax_state.finished_fingerprints(ref) == {"fp1"}
    assert {k: v.status for k, v in state.latest_status(port).items()} == \
        {k: v.status for k, v in jax_state.latest_status(ref).items()}
    # the other package appends after repairing the tail, as its own would
    other = jax_state if writer == "port" else state
    _write_journal(other, tmp_path / state.JOURNAL_NAME, [("fp3", "j3", "done", {})])
    after = tmp_path / state.JOURNAL_NAME
    assert all(json.loads(line) for line in after.read_text().splitlines())
    assert state.finished_fingerprints(state.load_events(tmp_path)) == {"fp1", "fp3"}


def test_journal_rejects_an_unknown_status(tmp_path):
    with state.Journal(tmp_path / state.JOURNAL_NAME) as j:
        with pytest.raises(ValueError, match="unknown journal status"):
            j.record("fp", "j", "exploded")


# ------------------------------------------------------------------ gate

def _random_summaries(seed: int):
    """(current, baseline) summary dicts: throughput rows, serve rows with
    p99, worst-tenant SLO attainment and noise, missing and new jobs."""
    rng = np.random.default_rng(seed)
    base, cur = {}, {}
    for i in range(int(rng.integers(2, 9))):
        fp = f"{int(rng.integers(0, 2**32)):08x}{i:08x}"
        serve = rng.random() < 0.4
        noise = [None, float(rng.random() * 6)][int(rng.integers(0, 2))]
        if serve:
            row = {"job_id": f"serve_{i}", "status": "done",
                   "p99_latency_ms": float(rng.uniform(0.5, 20)),
                   "slo_attainment_pct": float(rng.uniform(80, 100)),
                   "tflops_per_device": float(rng.uniform(1, 600)),
                   "noise_pct": noise, "n_records": 1}
        else:
            row = {"job_id": f"job_{i}", "status": "done",
                   "tflops_per_device": float(rng.uniform(1, 800)),
                   "avg_time_s": float(rng.random()), "n_records": 2,
                   "noise_pct": noise}
        side = rng.random()
        if side < 0.8:
            base[fp] = row
        if side > 0.1:
            moved = dict(row)
            for key in ("tflops_per_device", "p99_latency_ms", "slo_attainment_pct"):
                if key in moved:
                    moved[key] = moved[key] * float(rng.uniform(0.85, 1.15))
            cur[fp] = moved
    return cur, base


@pytest.mark.parametrize("seed", range(16))
@pytest.mark.parametrize("threshold", [0.0, 5.0])
def test_gate_matches_jax_on_seeded_summaries(seed, threshold):
    cur, base = _random_summaries(seed)
    port = gate.run_gate(cur, base, threshold_pct=threshold)
    ref = jax_gate.run_gate(cur, base, threshold_pct=threshold)
    assert [dataclasses.asdict(r) for r in port.rows] == \
        [dataclasses.asdict(r) for r in ref.rows]
    assert port.exit_code == ref.exit_code
    assert port.format() == ref.format()
    for fp in set(cur) & set(base):
        assert gate.tolerance_pct(threshold, base[fp], cur[fp]) == \
            jax_gate.tolerance_pct(threshold, base[fp], cur[fp])


@pytest.mark.parametrize("seed", range(4))
def test_write_baseline_is_jax_bytes(tmp_path, seed):
    cur, _ = _random_summaries(seed)
    gate.write_baseline(cur, tmp_path / "port.json")
    jax_gate.write_baseline(cur, tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert gate.load_summary(tmp_path / "jax.json") == jax_gate.load_summary(tmp_path / "port.json")


def test_gate_constants_and_unusable_input_match_jax(tmp_path):
    assert (gate.NOISE_FLOOR_PCT, gate.DEFAULT_THRESHOLD_PCT, gate.BASELINE_KIND) == \
        (jax_gate.NOISE_FLOOR_PCT, jax_gate.DEFAULT_THRESHOLD_PCT, jax_gate.BASELINE_KIND)
    assert (gate.EXIT_PASS, gate.EXIT_REGRESSION, gate.EXIT_UNUSABLE) == (0, 1, 2)
    assert gate.run_gate({}, {}).exit_code == jax_gate.run_gate({}, {}).exit_code == 2
    bad = tmp_path / "bad.json"
    bad.write_text('{"kind": "other"}')
    with pytest.raises(RuntimeError, match="not a campaign baseline"):
        gate.load_summary(bad)


# ---------------------------------------------------- executor and store

def _ok_launch(records=1, serve=False):
    """A fake successful child: writes the ledger --json-out names, with a
    manifest and `records` measurement records (serve records carry the
    serve block the store summarises)."""
    def launch(cmd, *, log, timeout_s, env):
        ledger = cmd[cmd.index("--json-out") + 1]
        with open(ledger, "w") as fh:
            fh.write(json.dumps({"record_type": "manifest", "schema_version": 2}) + "\n")
            for i in range(records):
                rec = {"benchmark": "serve" if serve else "matmul", "mode": "single",
                       "size": 64, "iterations": 2, "tflops_per_device": 1.0 + i,
                       "avg_time_s": 0.01 * (i + 1),
                       "extras": {"samples": {"stddev_ms": 0.1 * (i + 1), "p50_ms": 2.0}}}
                if serve:
                    rec["extras"]["serve"] = {
                        "p99_ms": 5.0 - i, "p50_ms": 1.0, "shed_rate_pct": 0.0,
                        "goodput_qps": 100.0 + i, "slo_attainment_pct": 99.0,
                        "scheduler": "continuous", "p99_noise_pct": 3.0,
                        "tenants": {"a": {"slo_ms": 10.0, "slo_attainment_pct": 97.5 + i},
                                    "b": {"slo_ms": None, "slo_attainment_pct": 50.0}}}
                fh.write(json.dumps(rec) + "\n")
        return executor.LaunchResult(rc=0)
    return launch


def _two_job_spec():
    return spec.spec_from_dict({
        "campaign": {"name": "s"},
        "job": [{"id": "j1", "program": "matmul", "flags": ["--sizes", "64"]},
                {"id": "srv", "program": "serve", "flags": ["bench", "--qps", "10"]}]})


def _launch_by_job():
    plain, serve = _ok_launch(records=3), _ok_launch(records=2, serve=True)

    def launch(cmd, **kw):
        return (serve if "serve" in cmd else plain)(cmd, **kw)
    return launch


def test_store_summaries_match_jax(tmp_path):
    executor.run_campaign(_two_job_spec(), tmp_path, env={}, launch=_launch_by_job(),
                          sleep=lambda s: None)
    port, ref = CampaignStore.load(tmp_path), JaxStore.load(tmp_path)
    assert port.summary() == ref.summary()
    assert port.merged_records() == ref.merged_records()
    assert port.status_counts() == ref.status_counts() == {"done": 2}
    rows = port.summary()
    srv = next(r for r in rows.values() if r["job_id"] == "srv")
    # the worst budgeted tenant, the min p99 and the serve noise estimate
    assert srv["slo_attainment_pct"] == 98.5 and srv["p99_latency_ms"] == 4.0
    assert srv["noise_pct"] == 3.0
    j1 = next(r for r in rows.values() if r["job_id"] == "j1")
    assert j1["tflops_per_device"] == 3.0 and j1["noise_pct"] == pytest.approx(15.0)


def test_child_command_runs_the_port(tmp_path):
    job = _two_job_spec().jobs[0]
    ledger, _log = executor.job_paths(tmp_path, job)
    cmd = executor.job_command(job, tmp_path, ledger)
    assert cmd[1:4] == ["-m", "tpu_matmul_bench_torch", "matmul"]
    assert cmd[-4:] == ["--json-out", str(ledger), "--trace-out",
                        str(executor.job_trace_path(tmp_path, job))]


def test_child_env_carries_the_run_context_and_the_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    env = executor._campaign_env({"PYTHONPATH": "/elsewhere"})
    assert env["PYTHONPATH"].split(":")[:2] == [str(REPO), "/elsewhere"]
    assert env["TPU_BENCH_PARENT_RUN_ID"]
    # the children share the kernel build directory of the checkout, not
    # a compilation cache of the JAX package's
    assert "JAX_COMPILATION_CACHE_DIR" not in env


def test_transport_failure_backs_off_at_the_floor_then_fails(tmp_path):
    s = spec.spec_from_dict({"campaign": {"name": "t"}, "defaults": {"retries": 2,
                                                                     "backoff_s": 1.0},
                             "job": [{"id": "j1", "program": "matmul", "flags": []}]})
    delays = []

    def transport(cmd, *, log, timeout_s, env):
        with open(log, "a") as fh:
            fh.write("gloo AllReduce failed: Connection closed by peer\n")
        return executor.LaunchResult(rc=1)

    outcomes = executor.run_campaign(s, tmp_path, env={}, launch=transport,
                                     sleep=delays.append)
    assert [o.status for o in outcomes] == ["failed"] and outcomes[0].attempts == 3
    assert delays == [executor.TRANSPORT_MIN_BACKOFF_S] * 2
    # an OOM on the card reads transient: the plain exponential, no floor
    assert executor.backoff_delay(s.jobs[0], 2, "transient") == 2.0


def test_resume_runs_only_unfinished_jobs(tmp_path):
    s = _two_job_spec()
    calls = []

    def first_fails(cmd, **kw):
        calls.append(cmd[3])
        if cmd[3] == "serve" and calls.count("serve") == 1:
            return executor.LaunchResult(rc=1)
        return _launch_by_job()(cmd, **kw)

    s0 = spec.spec_from_dict({**json.loads(s.to_json()),
                              "job": [{**j, "retries": 0} for j in json.loads(s.to_json())["job"]]})
    out = executor.run_campaign(s0, tmp_path, env={}, launch=first_fails, sleep=lambda _: None)
    assert [o.status for o in out] == ["done", "failed"]
    out = executor.run_campaign(s0, tmp_path, resume=True, env={}, launch=first_fails,
                                sleep=lambda _: None)
    assert [o.status for o in out] == ["skipped", "done"]
    assert calls == ["matmul", "serve", "serve"]
    with pytest.raises(RuntimeError, match="resume"):
        executor.run_campaign(s0, tmp_path, env={}, launch=first_fails, sleep=lambda _: None)


def test_the_parent_never_asks_cuda(tmp_path, monkeypatch, capsys):
    """run, status and gate in the campaign parent touch no CUDA call:
    the children own the card."""
    import torch

    def forbidden(*_a, **_k):
        raise AssertionError("the campaign parent asked CUDA")

    for name in ("is_available", "device_count", "init", "get_device_name",
                 "synchronize", "current_device"):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    monkeypatch.setattr(executor, "_default_launch", _launch_by_job())
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(_two_job_spec().to_json())
    d = tmp_path / "run"
    assert cli.main(["run", str(spec_path), "--dir", str(d),
                     "--trace-out", str(tmp_path / "t.json")]) == 0
    assert cli.main(["status", str(d)]) == 0
    assert cli.main(["gate", str(d), "--baseline", str(d)]) == 0
    out = capsys.readouterr().out
    assert "campaign: 2/2 jobs done" in out and "gate: PASS (3 compared" in out


@pytest.mark.parametrize("argv, item", [
    # A15a came with the lint program: --lint runs its gate before any job
    # (stubbed here; tests/test_torch_lint.py runs the real child), and
    # --no-hlo without --lint is ignored, as in JAX
    (["run", "SPEC", "--dir", "D", "--lint"], "A15"),
    (["run", "SPEC", "--dir", "D", "--no-hlo"], "A15"),
    # A14.4 came with the observatory: the history gate runs, against the
    # committed store or the store named
    (["gate", "D", "--history"], "A14.4"),
    (["gate", "D", "--history", "store.jsonl"], "A14.4"),
])
def test_unported_flags_are_refused_by_name(tmp_path, capsys, monkeypatch, argv, item):
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(_two_job_spec().to_json())
    argv = [str(spec_path) if a == "SPEC" else str(tmp_path / "d") if a == "D"
            else str(tmp_path / a) if a.endswith(".jsonl") else a for a in argv]
    if item == "A14.4":
        from tpu_matmul_bench_torch.obs import history as hist

        executor.run_campaign(_two_job_spec(), tmp_path / "d", env={},
                              launch=_launch_by_job(), sleep=lambda s: None)
        # an earlier run of the same jobs (its manifests differ) is the
        # store's round 1; this campaign's own ledgers, round 2, are no
        # baseline of it
        prior = tmp_path / "prior"
        prior.mkdir()
        for ledger in sorted((tmp_path / "d" / "jobs").glob("*.jsonl")):
            head, rest = ledger.read_text().split("\n", 1)
            (prior / ledger.name).write_text(
                json.dumps({**json.loads(head), "created_unix": 1.0}) + "\n" + rest)
        store = hist.HistoryStore.load(str(tmp_path / "store.jsonl"))
        assert hist.ingest(sorted(prior.glob("*.jsonl")), store)[0]
        assert hist.ingest(sorted((tmp_path / "d" / "jobs").glob("*.jsonl")), store)[0]
        if argv[-1] == "--history":  # the committed store: every job is new
            with pytest.raises(SystemExit) as e:
                cli.main(argv)
            assert e.value.code == 2
            assert capsys.readouterr().out.count("(no baseline row)") == 2
            return
        assert cli.main(argv) == 0
        out = capsys.readouterr().out
        assert "gate: PASS (3 compared" in out and "no baseline row" not in out, out
        return
    gated = []
    monkeypatch.setattr(cli, "pre_campaign_lint",
                        lambda spec, no_hlo=False: gated.append(
                            (spec, no_hlo, (tmp_path / "d").exists())))
    assert cli.main(argv + ["--dry-run"]) == 0
    # the gate ran (with --lint) before the plan was touched
    assert gated == ([(str(spec_path), False, False)] if "--lint" in argv else [])
    assert "not ported" not in capsys.readouterr().err
