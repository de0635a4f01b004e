"""The perf observatory's program on the CPU: `python -m
tpu_matmul_bench_torch obs {status,selftest,ingest,history,detect,report}`
against the JAX package's `obs` program (the same flags, exit codes and
reports on the same inputs), the exporter's HTTP surface, the committed
store's selftest and regeneration, and `obs selftest --device cpu` (once a
module). The port's selftest serves under `--matmul-impl cuda`, so its
bucket carries the kernels' cost books; without a card and without
`--device cpu` it stops with exit 2."""

import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from tpu_matmul_bench.obs import cli as jax_cli
from tpu_matmul_bench.obs import export as jax_export
from tpu_matmul_bench.obs import registry as jax_registry
from tpu_matmul_bench_torch.__main__ import main as port_main
from tpu_matmul_bench_torch.obs import cli, export, history, registry, regen

REPO = Path(__file__).resolve().parent.parent


def _run(main, argv, capsys) -> tuple[int, str, str]:
    """A program's main in process: (exit code, stdout, stderr)."""
    try:
        rc = main(argv) or 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    out = capsys.readouterr()
    return rc, out.out, out.err


# --------------------------------------------------------------- selftest

@pytest.fixture(scope="module")
def selftest(tmp_path_factory):
    """One `obs selftest --device cpu` run for the module: its exit code,
    report and working directory."""
    work = tmp_path_factory.mktemp("selftest")
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        try:
            rc = port_main(["obs", "selftest", "--device", "cpu", "--dir", str(work)]) or 0
        except SystemExit as e:
            rc = e.code
    return rc, buf.getvalue(), work


def test_selftest_on_the_cpu_exits_0(selftest):
    rc, out, _ = selftest
    assert rc == 0, out
    assert out.strip().splitlines()[-1].startswith("obs selftest ok: snapshot emitted")


def test_selftest_ledger_carries_the_kernels_cost_books(selftest):
    _, _, work = selftest
    lines = [json.loads(line) for line in (work / "serve.jsonl").read_text().splitlines()]
    (rec,) = [d for d in lines if d.get("benchmark") == "serve"]
    books = rec["extras"]["cost_analysis"]
    # 96³ requests pad to the grid's first point; float32 on K1's simt route
    assert list(books) == ["128x128x128/float32/cuda"]
    block = books["128x128x128/float32/cuda"]
    assert block["flops_ratio"] == 1.0 and block["agrees"]
    assert block["flops"] == block["hand_model_flops"] == 2.0 * 128 ** 3
    assert rec["extras"]["serve"]["requests"] > 0
    assert any(d.get("record_type") == "serve_span" for d in lines)


def test_selftest_snapshots_reconcile(selftest):
    _, _, work = selftest
    snaps = export.read_snapshots(work / "obs" / export.SNAPSHOT_NAME)
    assert snaps and snaps[-1]["counters"]["serve_requests_total"] > 0
    assert export.latest_snapshot(work) == snaps[-1]


def test_selftest_ledger_ingests_as_the_jax_packages(selftest, tmp_path):
    from tpu_matmul_bench.obs import history as jax_hist

    _, _, work = selftest
    port = history.points_from_source(work / "serve.jsonl", root=str(work))
    assert port == jax_hist.points_from_source(work / "serve.jsonl", root=str(work))
    assert {p["labels"]["kind"] for p in port} == {"serve", "serve_tail"}


def test_selftest_without_a_card_exits_2(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, _, err = _run(cli.main, ["selftest"], capsys)
    assert rc == 2 and "pass --device cpu" in err


def test_selftest_flags_are_jaxs_and_the_device():
    def flags(parser, command):
        sub = next(a for a in parser._actions if a.dest == "command").choices[command]
        return {a.dest: a.default for a in sub._actions if a.dest != "help"}

    port, ref = cli.build_parser(), jax_cli.build_parser()
    for command in ("status", "ingest", "history", "detect", "report"):
        assert flags(port, command) == flags(ref, command), command
    assert flags(port, "selftest") == {**flags(ref, "selftest"), "device": "cuda"}


# ----------------------------------------------------------------- status

def _snapshot_file(path: Path, torn: bool) -> None:
    reg = registry.MetricsRegistry()
    reg.counter("serve_requests_total").inc(3)
    reg.histogram("serve_latency_ms").observe(1.5)
    lines = [json.dumps({**export.snapshot_record(reg, run_id="r1", seq=seq),
                         "ts_unix": 1.0}, sort_keys=True) for seq in (1, 2)]
    text = "\n".join(lines) + "\n"
    if torn:
        text += lines[0][:40]
    path.write_text(text)


@pytest.mark.parametrize("torn", [False, True])
@pytest.mark.parametrize("as_json", [False, True])
def test_status_on_a_snapshot_file_is_jaxs(tmp_path, capsys, torn, as_json):
    obs_dir = tmp_path / "camp" / "obs"
    obs_dir.mkdir(parents=True)
    _snapshot_file(obs_dir / export.SNAPSHOT_NAME, torn)
    argv = ["status", str(tmp_path / "camp")] + (["--json"] if as_json else [])
    port, ref = _run(cli.main, argv, capsys), _run(jax_cli.main, argv, capsys)
    assert port[0] == ref[0] == 0
    if as_json:
        assert port[1] == ref[1]
        assert json.loads(port[1])["seq"] == 2
    else:  # the age column reads the wall clock
        strip = [line for line in port[1].splitlines() if "age=" not in line]
        assert strip == [line for line in ref[1].splitlines() if "age=" not in line]
        assert "serve_requests_total" in port[1]


def test_status_without_snapshots_exits_2(tmp_path, capsys):
    port = _run(cli.main, ["status", str(tmp_path)], capsys)
    ref = _run(jax_cli.main, ["status", str(tmp_path)], capsys)
    assert port[0] == ref[0] == 2
    (tmp_path / export.SNAPSHOT_NAME).write_text("")
    assert _run(cli.main, ["status", str(tmp_path)], capsys)[0] == 2


def test_status_follow_stops_after_its_timeout(tmp_path, capsys):
    _snapshot_file(tmp_path / export.SNAPSHOT_NAME, torn=True)
    rc, out, _ = _run(cli.main, ["status", str(tmp_path), "--follow", "--json",
                                 "--interval", "0.01", "--timeout", "0.05"], capsys)
    assert rc == 0 and [json.loads(line)["seq"] for line in out.splitlines()] == [2]


# ------------------------------------------------------------- HTTP surface

def _get(port: int, path: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _probe(exporter_cls, registry_cls, out_dir: Path) -> dict:
    reg = registry_cls()
    reg.counter("serve_requests_total").inc(2)
    exporter = exporter_cls(out_dir, registry=reg, run_id="r")
    port = exporter.start_http(0)
    try:
        got = {"before": _get(port, "/readyz")}
        exporter.write_once()
        for path in ("/metrics", "/healthz", "/readyz", "/nope", "/metrics?x=1"):
            got[path] = _get(port, path)
        assert exporter.start_http(0) == port  # one server an exporter
    finally:
        exporter.stop()
    return got


def test_http_endpoints_on_an_ephemeral_port_are_jaxs(tmp_path):
    port = _probe(export.SnapshotExporter, registry.MetricsRegistry, tmp_path / "p")
    ref = _probe(jax_export.SnapshotExporter, jax_registry.MetricsRegistry, tmp_path / "j")
    assert {k: v[0] for k, v in port.items()} == {k: v[0] for k, v in ref.items()} == {
        "before": 503, "/metrics": 200, "/healthz": 200, "/readyz": 200, "/nope": 404,
        "/metrics?x=1": 200}
    assert port["before"][1] == ref["before"][1] == "not ready: no snapshot flushed yet\n"
    assert port["/metrics"][1] == (tmp_path / "p" / export.PROM_NAME).read_text()
    assert "serve_requests_total 2" in port["/metrics"][1]
    assert port["/healthz"][1] == "ok\n" and port["/readyz"][1].startswith("ready: flushed")


def test_readiness_fails_a_stale_exporter(tmp_path, monkeypatch):
    exporter = export.SnapshotExporter(tmp_path, registry=registry.MetricsRegistry())
    exporter.write_once()
    assert exporter.readiness()[0]
    later = export.time.time() + export.READY_MIN_AGE_S + 1
    monkeypatch.setattr(export.time, "time", lambda: later)
    ready, reason = exporter.readiness()
    assert not ready and "exceeds" in reason and "thread dead" in reason


def test_find_snapshot_file_is_jaxs(tmp_path):
    for where in (tmp_path, tmp_path / "obs"):
        where.mkdir(exist_ok=True)
        (where / export.SNAPSHOT_NAME).write_text("")
        for arg in (tmp_path, tmp_path / "obs", where / export.SNAPSHOT_NAME):
            assert export.find_snapshot_file(arg) == jax_export.find_snapshot_file(arg)
    assert export.find_snapshot_file(tmp_path / "none") is None


# --------------------------------------------------- ingest, history, detect

def _ledger(path: Path, created: float, tflops: float, p99: float) -> None:
    rows = [{"record_type": "manifest", "schema_version": 2, "created_unix": created,
             "device_kind": "cpu", "config": {"timing": "fused", "matmul_impl": "cuda"}},
            {"benchmark": "matmul", "mode": "single", "size": 256, "dtype": "bfloat16",
             "world": 1, "device_kind": "cpu", "tflops_per_device": tflops,
             "avg_time_s": 0.001},
            {"benchmark": "serve", "mode": "serve", "size": 128, "dtype": "bfloat16",
             "world": 1, "device_kind": "cpu", "tflops_per_device": 1.0,
             "avg_time_s": 1.0, "extras": {"serve": {"p99_ms": p99}}}]
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


def _three_rounds(root: Path) -> list[Path]:
    paths = []
    for i, (tflops, p99) in enumerate([(100.0, 4.0), (101.0, 4.1), (70.0, 4.0)]):
        d = root / f"round{i + 1}"
        d.mkdir()
        _ledger(d / "run.jsonl", float(i), tflops, p99)
        paths.append(d)
    return paths


def test_ingest_history_detect_report_are_jaxs(tmp_path, capsys):
    rounds = _three_rounds(tmp_path)
    stores = {"port": tmp_path / "port.jsonl", "jax": tmp_path / "jax.jsonl"}
    mains = {"port": cli.main, "jax": jax_cli.main}
    got = {}
    for name, main in mains.items():
        store = str(stores[name])
        runs = [_run(main, ["ingest", str(d), "--store", store], capsys) for d in rounds]
        runs.append(_run(main, ["ingest", str(rounds[0]), "--store", store, "--dry-run"],
                         capsys))
        runs.append(_run(main, ["history", "--store", store], capsys))
        runs.append(_run(main, ["detect", "--store", store, "--spec",
                                str(REPO / "specs" / "torch" / "history.toml")], capsys))
        runs.append(_run(main, ["detect", "--store", store, "--threshold-pct", "50"],
                         capsys))
        runs.append(_run(main, ["report", "--store", store], capsys))
        got[name] = [(rc, out.replace(store, "STORE"), err) for rc, out, err in runs]
    assert stores["port"].read_bytes() == stores["jax"].read_bytes()
    assert got["port"] == got["jax"]
    rcs = [rc for rc, _, _ in got["port"]]
    assert rcs == [0, 0, 0, 0, 0, 1, 0, 0]  # the 30% fall is HIST-001 (exit 1)
    assert "would append 0 point(s)" in got["port"][3][1]
    assert "HIST-001" in got["port"][5][1]


def test_detect_json_out_writes_a_findings_ledger(tmp_path, capsys):
    rounds = _three_rounds(tmp_path)
    store = str(tmp_path / "h.jsonl")
    for d in rounds:
        _run(cli.main, ["ingest", str(d), "--store", store], capsys)
    out = tmp_path / "findings.jsonl"
    rc, _, _ = _run(cli.main, ["detect", "--store", store, "--json-out", str(out),
                               "--fail-on", "warn"], capsys)
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert rc == 1
    assert lines[0]["record_type"] == "manifest" and lines[0]["device_kind"] == "cpu"
    assert [d["rule"] for d in lines[1:-1]] == ["HIST-001"]
    assert lines[-1] == {"record_type": "lint_summary", "info": 0, "warn": 0, "error": 1}


def test_a_bad_spec_exits_2(tmp_path, capsys):
    bad = tmp_path / "bad.toml"
    bad.write_text("[history]\nbogus = 1\n")
    for command in ("detect", "report"):
        port = _run(cli.main, [command, "--spec", str(bad)], capsys)
        ref = _run(jax_cli.main, [command, "--spec", str(bad)], capsys)
        assert port[0] == ref[0] == 2 and "bad spec" in port[2]


# ---------------------------------------------------------- committed store

def test_history_selftest_on_the_committed_store(capsys):
    rc, out, err = _run(port_main, ["obs", "history", "selftest"], capsys)
    assert rc == 0, err
    store = history.HistoryStore.load()
    assert out.startswith(f"obs history selftest ok: {len(store)} point(s)")
    assert store.max_seq() >= 1 and not store.validate()
    assert {p["backend"] for p in store.points()} == {"h100"}


def test_history_selftest_fails_on_an_empty_store(tmp_path, capsys):
    rc, _, err = _run(cli.main, ["history", "selftest", "--store",
                                 str(tmp_path / "none.jsonl")], capsys)
    assert rc == 1 and "store is empty or missing" in err


def test_committed_store_regenerates_byte_for_byte():
    proc = subprocess.run([sys.executable, "-m", "tpu_matmul_bench_torch.obs.regen",
                           "--check"], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "is current" in proc.stdout


def test_regen_check_flags_a_stale_store(tmp_path, monkeypatch, capsys):
    stale = tmp_path / "history.jsonl"
    stale.write_bytes((REPO / history.HISTORY_RELPATH).read_bytes()[:-1])
    monkeypatch.setattr(history, "HISTORY_RELPATH", str(stale))
    assert regen.main(["--check"]) == 1
    assert "STALE" in capsys.readouterr().err
