"""`--profile-dir` through `torch.profiler` (`utils/profiling.py`) and the
trace reader `chip_smoke.py` uses on the card.

On the CPU the trace holds host operations only; the reader is held to a
made-up trace of device events instead. The JAX package pins the same
manifest cross-reference (`tests/test_telemetry.py`).
"""

import json

import pytest
import torch
from torch_port_util import single_torch_thread  # noqa: F401 — a fixture

from tpu_matmul_bench_torch import __main__ as port_main
from tpu_matmul_bench_torch.parallel import mesh
from tpu_matmul_bench_torch.utils import profiling, telemetry, timing

pytestmark = pytest.mark.usefixtures("single_torch_thread")

ARGV = ["--sizes", "64", "--iterations", "2", "--warmup", "1", "--dtype", "float32",
        "--device", "cpu", "--num-devices", "4"]


@pytest.fixture
def ranks4(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "4")


@pytest.mark.parametrize("program,mode", [("scaling", "batch_parallel"),
                                          ("distributed", "model_parallel"),
                                          ("overlap", "cuda_ring_hbm")])
def test_profile_dir_writes_a_trace_the_manifest_names(ranks4, tmp_path, program, mode):
    prof, out = tmp_path / "prof", tmp_path / "out.jsonl"
    (rec,) = port_main.main([program, "--mode", mode, *ARGV, "--profile-dir", str(prof),
                             "--json-out", str(out)])
    manifest = json.loads(out.read_text().splitlines()[0])
    assert manifest["artifacts"] == {"profiler_trace_dir": str(prof)}
    assert manifest["config"]["mode"] == mode
    (trace,) = prof.glob("*.json")
    events = profiling.load_events(str(trace))
    assert any(e["name"] == profiling.MEASURE_REGION for e in events)
    summary = profiling.device_summary(str(trace))
    assert summary["windows"] >= 1
    assert summary["device_events"] == 0 and summary["busy_share"] is None  # the CPU
    assert "profiler_trace_dir" not in telemetry.artifacts()  # this run's only


def test_no_profile_dir_no_trace_and_no_artifact(ranks4, tmp_path):
    out = tmp_path / "out.jsonl"
    port_main.main(["scaling", *ARGV, "--json-out", str(out)])
    assert "artifacts" not in json.loads(out.read_text().splitlines()[0])
    with profiling.maybe_trace(None) as path:
        assert path is None


def test_matmul_and_tune_offer_no_profile_dir(tmp_path):
    # they do now, as the JAX package's matmul does: the campaign's card
    # jobs trace K1 and K1b through it; the trace is written and the
    # ledger's manifest names its directory
    small = ["--device", "cpu", "--iterations", "1", "--warmup", "1"]
    for program, argv in (("matmul", ["--sizes", "32"]),
                          ("tune", ["--sizes", "64", "--candidates", "64,128,32",
                                    "--confirm-top", "0"])):
        prof, out = tmp_path / program, tmp_path / f"{program}.jsonl"
        port_main.main([program, *argv, *small, "--profile-dir", str(prof),
                        "--json-out", str(out)])
        assert len(list(prof.glob("trace-*.json"))) == 1
        manifest = json.loads(out.read_text().splitlines()[0])
        assert manifest["artifacts"]["profiler_trace_dir"] == str(prof)


def test_trace_of_a_card_with_no_device_event_raises(tmp_path):
    # the CPU build drops the CUDA activity: as a card whose kernels the
    # profiler cannot see, the trace must not pass for an idle card
    with pytest.raises(RuntimeError, match="recorded no CUDA activity"):
        with pytest.warns(UserWarning):
            with profiling.maybe_trace(str(tmp_path), cuda=True):
                torch.ones(4) @ torch.ones(4)
    assert "profiler_trace_dir" not in telemetry.artifacts()


def test_timed_windows_are_measure_ranges(tmp_path):
    with profiling.maybe_trace(str(tmp_path)) as path:
        timing.time_jitted(lambda x: x @ x, (torch.ones(8, 8),), iterations=3, warmup=1)
        timing.time_variants(lambda x: x + 1, lambda x: x * 2, (torch.ones(8),),
                             iterations=2, warmup=1)
    windows = [e for e in profiling.load_events(path)
               if e["name"] == profiling.MEASURE_REGION]
    # one, then two variants over three rounds (more where a short loop re-scales)
    assert len(windows) >= 1 + 2 * 3


def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "pid": 0, "tid": 0, **e} for e in events]}))
    return str(path)


def test_device_summary_reads_busy_and_idle_inside_the_windows(tmp_path):
    path = _trace(tmp_path, [
        {"cat": "user_annotation", "name": profiling.MEASURE_REGION, "ts": 100, "dur": 100},
        {"cat": "kernel", "name": "void gemm<1>(int)", "ts": 110, "dur": 30},
        {"cat": "kernel", "name": "void gemm<1>(int)", "ts": 130, "dur": 20},  # overlaps
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 170, "dur": 10},
        {"cat": "kernel", "name": "void ring_fused_wgmma<2>()", "ts": 20, "dur": 40},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 105, "dur": 50},  # the host
        {"cat": "gpu_user_annotation", "name": profiling.MEASURE_REGION, "ts": 100,
         "dur": 100},
    ])
    s = profiling.device_summary(path)
    assert (s["device_events"], s["kernel_launches"], s["windows"]) == (4, 3, 1)
    assert s["device_us"] == 90.0  # kernels only: 30 + 20 + 40
    assert s["kernels"][0] == {"name": "void gemm<1>(int)", "device_us": 50.0, "count": 2}
    # the window runs 110..180: busy 110..150 and 170..180
    assert s["window_us"] == 70.0 and s["busy_us"] == 50.0
    assert s["busy_share"] == pytest.approx(50 / 70)
    assert s["idle_share"] == pytest.approx(20 / 70)
    assert profiling.kernel_time_us(path, "ring_fused") == {
        "count": 1, "device_us": 40.0, "us_per_launch": 40.0}
    assert profiling.kernel_time_us(path, "no_such")["us_per_launch"] is None


def test_trace_paths_are_new_each_time(tmp_path):
    assert profiling.trace_path(str(tmp_path)) != profiling.trace_path(str(tmp_path))
