"""The port's device doctor (`benchmarks/doctor.py`, `doctor`), its phases
and exit codes as the JAX package's `tests/test_doctor.py` pins them, with
`--device cpu`; and its refusal without a card, in-process and through
`python -m tpu_matmul_bench_torch doctor`'s hard-exit path."""

import json
import os
import subprocess
import sys

import pytest
from torch_port_util import single_torch_thread  # noqa: F401

from tpu_matmul_bench_torch.benchmarks import doctor
from tpu_matmul_bench_torch.utils import timing

pytestmark = pytest.mark.usefixtures("single_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ["importing torch + initializing the device", "measuring sync round-trip latency",
          "running + validating a 128x128 bf16 matmul",
          "launch path: dispatch vs fused protocol x3"]


def test_healthy_on_cpu_with_its_phases_in_order(tmp_path, capsys):
    out = tmp_path / "doc.json"
    report = doctor.main(["--device", "cpu", "--size", "128", "--iterations", "3",
                          "--json-out", str(out)])
    assert report["healthy"] is True and report["link"] == "ok"
    assert report["platform"] == "cpu" and report["device_kind"] == "cpu"
    assert report["dispatch_per_op_ms"] > 0 and report["fused_per_op_ms"] > 0
    assert report["matmul_max_rel_err"] <= 3e-2
    assert json.loads(out.read_text()) == report
    lines = capsys.readouterr().out.splitlines()
    announced = [line[len("[doctor] "):-len(" ...")] for line in lines if line.endswith(" ...")]
    assert announced == PHASES
    assert lines[-1] == "[doctor] verdict: HEALTHY"


def test_degraded_exits_3(monkeypatch):
    def fake(avg_s):
        return lambda *a, **k: timing.Timing(total_s=avg_s * 3, iterations=3)

    monkeypatch.setattr(timing, "time_jitted", fake(0.100))
    monkeypatch.setattr(timing, "time_fused", fake(0.001))
    with pytest.raises(SystemExit) as e:
        doctor.main(["--device", "cpu", "--size", "128", "--iterations", "3"])
    assert e.value.code == 3


def test_small_ratio_or_small_gap_is_not_degraded(monkeypatch):
    # the ratio alone (0.3 ms over 0.1) or the gap alone (30 over 25 ms)
    # is no verdict: both must exceed their bounds
    for disp, fused in ((0.0003, 0.0001), (0.030, 0.025)):
        monkeypatch.setattr(timing, "time_jitted",
                            lambda *a, d=disp, **k: timing.Timing(d * 3, 3))
        monkeypatch.setattr(timing, "time_fused",
                            lambda *a, f=fused, **k: timing.Timing(f * 3, 3))
        assert doctor.main(["--device", "cpu", "--size", "64", "--iterations", "3"])["healthy"]


def test_numerics_failure_exits_1(monkeypatch, capsys):
    from tpu_matmul_bench_torch.parallel import modes

    monkeypatch.setattr(modes, "corner_validation",
                        lambda *a, **k: {"validation": "FAILED",
                                         "validation_max_rel_err": 0.5})
    with pytest.raises(SystemExit) as e:
        doctor.main(["--device", "cpu", "--size", "64", "--json-out", "-"])
    assert e.value.code == 1
    rec = json.loads([x for x in capsys.readouterr().out.splitlines() if x.startswith("{")][-1])
    assert rec["link"] == "numerics-failed" and rec["matmul_max_rel_err"] == 0.5


def test_dead_device_reports_the_error(monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(doctor, "run_doctor", boom)
    with pytest.raises(SystemExit) as e:
        doctor.main(["--json-out", "-"])
    assert e.value.code == 1
    rec = json.loads([x for x in capsys.readouterr().out.splitlines() if x.startswith("{")][-1])
    assert rec["link"] == "dead" and "launch failure" in rec["error"]


def test_no_card_fails_with_the_reason(capsys):
    with pytest.raises(SystemExit) as e:
        doctor.main(["--json-out", "-"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    rec = json.loads([x for x in out.splitlines() if x.startswith("{")][-1])
    assert rec["link"] == "dead" and "no CUDA device" in rec["error"]
    assert "--device cpu" in rec["error"]  # it says how to ask for the CPU
    assert "dispatch_per_op_ms" not in rec  # and never carried on there


@pytest.mark.parametrize("argv, code", [([], 1), (["--device", "cpu", "--size", "64",
                                                    "--iterations", "2"], 0)])
def test_process_entry_hard_exit_codes(argv, code):
    proc = subprocess.run([sys.executable, "-m", "tpu_matmul_bench_torch", "doctor", *argv],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == code, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1].startswith("[doctor] verdict:")
