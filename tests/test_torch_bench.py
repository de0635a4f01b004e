"""The port's headline entry (`tpu_matmul_bench_torch/bench.py`): the JSON-line
contract of the root `bench.py` (tests/test_bench_harness.py), carried to
the port through fake children (`BENCH_CHILD_CMD`).

The real ladder needs the card; these tests pin the parent: result
collection, best-of selection, the ceiling, retries, signals, the line's
schema with `impl`, `by_impl` and `device_kind`, and that the parent never
imports torch. One case runs the port's own matmul program on the CPU as
the child.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tpu_matmul_bench_torch.utils.metrics import theoretical_peak_tflops

REPO = Path(__file__).resolve().parent.parent
BENCH = REPO / "tpu_matmul_bench_torch" / "bench.py"
KEYS = {"metric", "value", "unit", "vs_baseline", "backend", "attempts", "impl",
        "by_impl", "device_kind"}


def _load_bench():
    """A fresh copy of the module: its best-so-far state is module-level."""
    spec = importlib.util.spec_from_file_location("port_bench", BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_entry(env_extra, timeout=120, **kw):
    return subprocess.run([sys.executable, "-m", "tpu_matmul_bench_torch.bench"],
                          env={**os.environ, **env_extra}, capture_output=True,
                          text=True, timeout=timeout, cwd=str(REPO), **kw)


def _lines(text):
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def _record(v, **extra):
    return json.dumps({"mode": "single", "tflops_per_device": v, **extra}) + "\n"


class _Proc:
    def __init__(self, rc):
        self.returncode = rc

    def wait(self, timeout=None):
        return self.returncode

    def poll(self):
        return self.returncode


class _OkProc(_Proc):
    """A child that wrote one record of `value` to its --json-out file (or
    the path the fake argv carries last)."""

    def __init__(self, args, value, **extra):
        super().__init__(0)
        out = args[args.index("--json-out") + 1] if "--json-out" in args else args[-1]
        with open(out, "w") as f:
            f.write(_record(value, **extra))


class _HungProc(_Proc):
    def __init__(self):
        super().__init__(None)

    def wait(self, timeout=None):
        raise subprocess.TimeoutExpired("x", timeout)


# ------------------------------------------------------------ collection


def test_collect_reads_only_valid_attempts(tmp_path):
    bench = _load_bench()
    good = tmp_path / "a.jsonl"
    good.write_text(_record(650.1, device_kind="NVIDIA H100 80GB HBM3")
                    + '{"half-written rec')  # a partial trailing line
    bad = tmp_path / "b.jsonl"
    bad.write_text("not json\n")
    vals = bench._collect([(str(good), "cuda"), (str(bad), "torch"),
                           (str(tmp_path / "c.jsonl"), "auto")])
    assert vals == [(650.1, "cuda", "NVIDIA H100 80GB HBM3")]


def test_collect_names_the_impl_auto_resolved_to(tmp_path):
    bench = _load_bench()
    f = tmp_path / "a.jsonl"
    f.write_text(_record(660.0, extras={"matmul_impl_resolved": "torch"}))
    assert bench._collect([(str(f), "auto")]) == [(660.0, "torch", None)]


def test_ceiling_is_the_h100_bf16_peak():
    assert _load_bench().MAX_PLAUSIBLE_TFLOPS == theoretical_peak_tflops(
        "NVIDIA H100 80GB HBM3", "bfloat16")


def test_collect_rejects_implausible_records(tmp_path, capsys):
    bench = _load_bench()
    f = tmp_path / "a.jsonl"
    f.write_text(_record(990.0) + _record(700.0, peak_efficiency_pct=101.0)
                 + _record(650.0, peak_efficiency_pct=65.7))
    assert [v for v, _, _ in bench._collect([(str(f), "cuda")])] == [650.0]
    assert capsys.readouterr().err.count("rejecting implausible") == 2


# ---------------------------------------------------------------- the line


def test_emit_schema(capfd):
    bench = _load_bench()
    bench._best = 655.41
    bench._best_from.update(impl="torch", device_kind="NVIDIA H100 80GB HBM3")
    bench._by_impl.update(torch=655.41, cuda=630.0)
    bench._health["attempts"] = 4
    bench._emit()
    rec = json.loads(capfd.readouterr().out.strip())
    assert rec == {
        "metric": "bf16_matmul_16k_tflops_per_chip",
        "value": 655.41,
        "unit": "TFLOPS",
        "vs_baseline": round(655.41 / 140.0, 4),
        "backend": "ok",
        "attempts": 4,
        "impl": "torch",
        "by_impl": {"cuda": 630.0, "torch": 655.41},
        "device_kind": "NVIDIA H100 80GB HBM3",
    }


def test_best_names_its_impl_and_keeps_each_impls_best(monkeypatch, capfd):
    bench = _load_bench()
    values = iter([600.0, 660.0, 655.0, 640.0])  # auto x8, auto, torch, cuda
    monkeypatch.setattr(bench.subprocess, "Popen", lambda args, **kw: _OkProc(
        args, next(values), extras={"matmul_impl_resolved": "torch"}
        if args[args.index("--matmul-impl") + 1] == "auto" else {}))
    bench._run_attempts(deadline=time.time() + 30)
    bench._emit()
    rec = _lines(capfd.readouterr().out)[-1]
    assert rec["impl"] == "torch" and rec["value"] == 660.0
    assert rec["by_impl"] == {"torch": 660.0, "cuda": 640.0}


def test_dead_backend_line_self_describes(monkeypatch, capfd):
    bench = _load_bench()
    monkeypatch.setattr(bench, "RETRY_BACKOFF_S", 0.0)
    monkeypatch.setattr(bench.subprocess, "Popen", lambda args, **kw: _Proc(1))
    bench._run_attempts(deadline=time.time() + 30)
    bench._emit()
    rec = _lines(capfd.readouterr().out)[-1]
    assert rec["value"] == 0.0
    assert rec["backend"] == "unavailable"
    assert rec["last_rc"] == 1
    assert rec["attempts"] == bench.MAX_SPAWNS
    assert KEYS <= rec.keys()


def test_a_failed_rung_shows_beside_a_value(monkeypatch, capfd):
    # the cuda rung fails after the others landed: the line keeps the best
    # value, and its backend and `failed` say that a rung failed
    bench = _load_bench()

    def popen(args, **kw):
        impl = args[args.index("--matmul-impl") + 1]
        return _Proc(1) if impl == "cuda" else _OkProc(args, 650.0)

    monkeypatch.setattr(bench.subprocess, "Popen", popen)
    bench._run_attempts(deadline=time.time() + 30)
    bench._emit()
    rec = _lines(capfd.readouterr().out)[-1]
    assert rec["value"] == 650.0 and rec["backend"] == "partial"
    assert rec["failed"] == ["cuda"] and "cuda" not in rec["by_impl"]


def test_failed_build_is_unavailable_and_runs_no_rung(monkeypatch, capfd):
    from tpu_matmul_bench_torch.ops import _build

    bench = _load_bench()
    monkeypatch.delenv("BENCH_CHILD_CMD", raising=False)

    def broken(*names):
        raise _build.KernelBuildError("nvcc failed on csrc/matmul.cu")

    monkeypatch.setattr(_build, "build", broken)
    monkeypatch.setattr(bench.subprocess, "Popen", lambda *a, **k: pytest.fail("spawned"))
    assert bench._build_kernels() is False
    out = capfd.readouterr()
    rec = _lines(out.out)[-1]
    assert rec["backend"] == "unavailable" and rec["value"] == 0.0
    assert "nvcc failed" in out.err


def test_build_runs_before_the_first_rung(monkeypatch):
    from tpu_matmul_bench_torch.ops import _build

    bench = _load_bench()
    monkeypatch.delenv("BENCH_CHILD_CMD", raising=False)
    built = []
    monkeypatch.setattr(_build, "build", lambda *names: built.append(names) or {})
    assert bench._build_kernels() is True and built == [()]  # every source


def test_always_emits_json_last_line():
    # the budget is spent at start: no attempt runs, yet a parseable line
    # ends stdout, and every stdout line is JSON
    out = _run_entry({"BENCH_TIMEOUT_S": "30", "BENCH_CHILD_CMD": json.dumps(["false"])})
    lines = _lines(out.stdout)
    assert lines and lines[0]["value"] == 0.0  # the provisional line first
    assert lines[-1]["metric"] == "bf16_matmul_16k_tflops_per_chip"
    assert lines[-1]["value"] == 0.0 and KEYS <= lines[-1].keys()


def _start_sleeping_entry():
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_matmul_bench_torch.bench"],
        env={**os.environ, "BENCH_TIMEOUT_S": "300",
             "BENCH_CHILD_CMD": json.dumps(["sleep", "30"])},
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=str(REPO),
        start_new_session=True)


@pytest.mark.parametrize("sig, min_lines", [(signal.SIGKILL, 1), (signal.SIGTERM, 2)])
def test_a_signal_leaves_a_json_last_line(sig, min_lines):
    # SIGKILL: the provisional line is already out; SIGTERM: the handler
    # emits the best line too
    proc = _start_sleeping_entry()
    try:
        first = proc.stdout.readline()  # the provisional line: handlers are in
        proc.send_signal(sig)
        rest, _ = proc.communicate(timeout=60)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # the entry and its sleeping child
        except ProcessLookupError:
            pass
    lines = _lines(first + rest)
    assert len(lines) >= min_lines
    assert lines[-1]["metric"] == "bf16_matmul_16k_tflops_per_chip"


def test_incremental_emit_on_improvement(monkeypatch, capfd):
    bench = _load_bench()
    values = iter([600.0, 645.5, 620.0, 630.1])
    monkeypatch.setattr(bench.subprocess, "Popen",
                        lambda args, **kw: _OkProc(args, next(values)))
    bench._run_attempts(deadline=time.time() + 30)
    assert [r["value"] for r in _lines(capfd.readouterr().out)] == [600.0, 645.5]
    assert bench._best == 645.5


def test_fast_failures_retry_until_spawn_cap(monkeypatch):
    bench = _load_bench()
    spawned = []
    monkeypatch.setattr(bench, "RETRY_BACKOFF_S", 0.0)
    monkeypatch.setattr(bench.subprocess, "Popen",
                        lambda args, **kw: (spawned.append(args), _Proc(1))[1])
    bench._run_attempts(deadline=time.time() + 30)
    assert len(spawned) == bench.MAX_SPAWNS
    assert bench._best == 0.0


def test_result_stops_retries_after_the_ladder(monkeypatch):
    bench = _load_bench()
    spawned = []
    monkeypatch.setattr(bench.subprocess, "Popen",
                        lambda args, **kw: (spawned.append(args), _OkProc(args, 640.0))[1])
    bench._run_attempts(deadline=time.time() + 30)
    assert len(spawned) == len(bench.ATTEMPTS)
    assert bench._best == 640.0


def test_slow_state_does_not_carry_stale_rc(monkeypatch, capfd):
    bench = _load_bench()
    calls = []

    def popen(args, **kw):
        calls.append(args)
        return _Proc(1) if len(calls) == 1 else _HungProc()

    monkeypatch.setattr(bench, "RETRY_BACKOFF_S", 0.0)
    monkeypatch.setattr(bench, "SOFT_DEADLINE_S", 0.5)
    monkeypatch.setattr(bench, "QUICK_SOFT_DEADLINE_S", 0.5)
    monkeypatch.setattr(bench, "STRAGGLER_GRACE_S", 0.0)
    monkeypatch.setattr(bench, "POLL_S", 0.1)
    monkeypatch.setattr(bench.subprocess, "Popen", popen)
    bench._run_attempts(deadline=time.time() + 4)
    bench._emit()
    rec = _lines(capfd.readouterr().out)[-1]
    assert rec["backend"] == "slow"
    assert "last_rc" not in rec


def test_first_nonzero_emit_requires_only_quick_rung(monkeypatch, capfd):
    bench = _load_bench()
    spawned = []

    def popen(args, **kw):
        spawned.append(args)
        return _OkProc(args, 610.3) if len(spawned) == 1 else _HungProc()

    monkeypatch.setattr(bench, "SOFT_DEADLINE_S", 0.2)
    monkeypatch.setattr(bench, "QUICK_SOFT_DEADLINE_S", 0.2)
    monkeypatch.setattr(bench, "STRAGGLER_GRACE_S", 0.0)
    monkeypatch.setattr(bench, "POLL_S", 0.1)
    monkeypatch.setattr(bench.subprocess, "Popen", popen)
    bench._run_attempts(deadline=time.time() + 3)
    first = spawned[0]
    assert first[first.index("--iterations") + 1] == str(bench.QUICK_ITERATIONS)
    assert bench.QUICK_ITERATIONS < bench.FULL_ITERATIONS
    assert first[first.index("--matmul-impl") + 1] == "auto"
    lines = _lines(capfd.readouterr().out)
    assert lines and lines[0]["value"] == 610.3


def test_ladder_runs_the_port_matmul_program_fused(monkeypatch):
    # each rung is the port's own program (never the JAX package's) under
    # the fused protocol; the full rungs keep the reference's 50 after 10,
    # over `auto`, the library and the kernel
    bench = _load_bench()
    spawned = []
    monkeypatch.setattr(bench.subprocess, "Popen",
                        lambda args, **kw: (spawned.append((args, kw)),
                                            _OkProc(args, 640.0))[1])
    bench._run_attempts(deadline=time.time() + 30)
    assert len(spawned) == len(bench.ATTEMPTS)
    for args, kw in spawned:
        assert args[1:4] == ["-m", "tpu_matmul_bench_torch", "matmul"]
        assert not any("tpu_matmul_bench." in a for a in args)
        assert args[args.index("--timing") + 1] == "fused"
        assert args[args.index("--sizes") + 1] == "16384"
        assert args[args.index("--dtype") + 1] == "bfloat16"
        assert kw["cwd"] == str(REPO)
    full = [args for args, _ in spawned[1:]]
    for args in full:
        assert args[args.index("--iterations") + 1] == "50"
        assert args[args.index("--warmup") + 1] == "10"
    assert [args[args.index("--matmul-impl") + 1] for args in full] == ["auto", "torch", "cuda"]


def test_grace_drain_collects_late_result():
    # a child that lands its record after the budget is still collected
    writer = ("import json,sys,time; time.sleep(4); open(sys.argv[1],'w').write("
              "json.dumps({'mode':'single','tflops_per_device':611.5})+'\\n')")
    out = _run_entry({"BENCH_TIMEOUT_S": "31", "BENCH_HARD_CAP_S": "120",
                      "BENCH_CHILD_CMD": json.dumps([sys.executable, "-c", writer, "{out}"])},
                     timeout=180)
    assert _lines(out.stdout)[-1]["value"] == 611.5, out.stdout


def test_artifact_dir_keeps_attempt_jsonls(tmp_path):
    adir = tmp_path / "bench_artifacts"
    fake = json.dumps([sys.executable, "-c",
                       "import sys; open(sys.argv[1], 'w').write("
                       "'{\"tflops_per_device\": 623.0}\\n')", "{out}"])
    out = _run_entry({"BENCH_TIMEOUT_S": "90", "BENCH_ARTIFACT_DIR": str(adir),
                      "BENCH_CHILD_CMD": fake})
    assert _lines(out.stdout)[-1]["value"] == 623.0
    assert sorted(p.name for p in adir.glob("attempt_*.jsonl")) == [
        "attempt_0_auto.jsonl", "attempt_1_auto.jsonl", "attempt_2_torch.jsonl",
        "attempt_3_cuda.jsonl"]


def test_no_line_points_at_a_tpu_artifact(monkeypatch, capfd):
    # the JAX entry's 0.0 line names its newest committed TPU headline;
    # those are TPU numbers, and the port carries none
    bench = _load_bench()
    assert not hasattr(bench, "_last_known_good")
    bench._health.update(backend="unavailable", attempts=2, last_rc=1)
    bench._emit()
    text = capfd.readouterr().out
    assert "last_known_good" not in text and "measurements/" not in text
    assert "measurements" not in BENCH.read_text()


def test_parent_never_imports_torch(tmp_path):
    # import the entry and drive its parent through a whole ladder of fake
    # children, then look: torch must not be in the process
    fake = json.dumps([sys.executable, "-c",
                       "import sys; open(sys.argv[1], 'w').write("
                       "'{\"tflops_per_device\": 640.0}\\n')", "{out}"])
    prog = ("import os, sys, time\n"
            "import tpu_matmul_bench_torch.bench as b\n"
            "b.POLL_S = 0.1\n"
            "assert b._build_kernels()\n"
            "b._run_attempts(time.time() + 60)\n"
            "b._emit()\n"
            "assert b._best == 640.0, b._best\n"
            "assert 'torch' not in sys.modules, 'the parent imported torch'\n"
            "from tpu_matmul_bench_torch.ops import _build\n"
            "assert 'torch' not in sys.modules, '_build imported torch'\n"
            "print('clean', file=sys.stderr)\n")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=120, cwd=str(REPO),
                         env={**os.environ, "BENCH_CHILD_CMD": fake})
    assert out.returncode == 0 and "clean" in out.stderr, out.stderr


def test_end_to_end_with_the_port_program_on_the_cpu(tmp_path):
    # the real port CLI as each rung's child, at --sizes 64 on the CPU, the
    # rung's impl passed through: the line names torch (auto resolves to
    # it) and the kernel's plain version side by side
    child = [sys.executable, "-m", "tpu_matmul_bench_torch", "matmul", "--device", "cpu",
             "--sizes", "64", "--dtype", "bfloat16", "--iterations", "2", "--warmup", "1",
             "--timing", "fused", "--matmul-impl", "{impl}", "--json-out", "{out}"]
    out = _run_entry({"BENCH_TIMEOUT_S": "200", "BENCH_CHILD_CMD": json.dumps(child),
                      "BENCH_ARTIFACT_DIR": str(tmp_path)}, timeout=300)
    rec = _lines(out.stdout)[-1]
    # "ok": a value above 0 landed (a CPU's TFLOPS at 64³ rounds to 0.0)
    assert rec["backend"] == "ok", out.stderr[-2000:]
    assert set(rec["by_impl"]) == {"torch", "cuda"} and rec["impl"] in rec["by_impl"]
    assert rec["device_kind"] == "cpu" and rec["attempts"] == 4
