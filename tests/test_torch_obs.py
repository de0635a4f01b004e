"""The observability bus on the CPU (`obs/registry.py`, `obs/context.py`,
`obs/export.py`, and the telemetry and errors it serves) against the JAX
package's: the same instrument calls give the same snapshot and the same
Prometheus text; the run context, the exporter's files, a retrospective
span, a ledger's raw lines and the failure taxonomy."""

import json
import threading

import pytest
import torch

from tpu_matmul_bench.obs import context as jax_context
from tpu_matmul_bench.obs import export as jax_export
from tpu_matmul_bench.obs import registry as jax_registry
from tpu_matmul_bench.utils import errors as jax_errors
from tpu_matmul_bench_torch.obs import context, export, registry
from tpu_matmul_bench_torch.utils import errors, reporting, telemetry


def _exercise(reg) -> None:
    """One fixed sequence of instrument calls, split across instruments
    that share series (as two serve windows in one process do)."""
    c1, c2 = reg.counter("serve_requests_total"), reg.counter("serve_requests_total")
    c1.inc()
    c2.inc(4)
    reg.counter("serve_cache_events", event="hit").inc(2.5)
    g1, g2 = reg.gauge("serve_queue_depth"), reg.gauge("serve_queue_depth")
    g1.set(7)
    g2.set(3)
    g1.set(5)
    h1 = reg.histogram("serve_latency_ms", bucket="128x128x128/bfloat16/cuda")
    h2 = reg.histogram("serve_latency_ms", bucket="128x128x128/bfloat16/cuda", window=4)
    for i in range(30):
        h1.observe(0.5 + (i * 37 % 11) * 0.25, trace_id=f"run-r{i:06d}")
        h2.observe(1.0 + i * 0.1, trace_id=f"run-r{100 + i:06d}" if i % 2 else None)
    reg.histogram("serve_wait_ms", tenant="a").observe(0.125)
    reg.histogram("empty_ms")


@pytest.mark.parametrize("exemplars", [False, True])
def test_snapshot_and_prometheus_text_are_jaxs(exemplars):
    port, ref = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    _exercise(port)
    _exercise(ref)
    snap = port.snapshot()
    assert snap == ref.snapshot()
    assert export.prometheus_text(snap, exemplars=exemplars) == \
        jax_export.prometheus_text(snap, exemplars=exemplars)
    hist = snap["histograms"]['serve_latency_ms{bucket="128x128x128/bfloat16/cuda"}']
    assert len(hist["exemplars"]) == registry.EXEMPLAR_LIMIT == 8
    assert registry.series_key("x", {"b": 1, "a": "y"}) == \
        jax_registry.series_key("x", {"b": 1, "a": "y"}) == 'x{a="y",b="1"}'
    with pytest.raises(ValueError, match="window"):
        port.histogram("bad", window=0)


def test_registry_is_thread_safe():
    reg = registry.MetricsRegistry()
    counter, hist = reg.counter("n"), reg.histogram("h", window=10_000)

    def work():
        for i in range(2000):
            counter.inc()
            hist.observe(i)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    snap = reg.snapshot()
    assert snap["counters"]["n"] == 16000 and snap["histograms"]["h"]["count"] == 16000


def test_reset_swaps_the_process_registry():
    old = registry.get_registry()
    fresh = registry.reset_registry()
    assert registry.get_registry() is fresh is not old
    fresh.counter("a").inc()
    assert "a" not in old.snapshot()["counters"]


def test_run_context_is_jaxs(monkeypatch):
    monkeypatch.setenv("TPU_BENCH_RUN_ID", "pinned0001")
    monkeypatch.setenv("TPU_BENCH_PARENT_RUN_ID", "parent0002")
    for mod in (context, jax_context):
        mod.reset_context()
    try:
        block = context.trace_block()
        assert block == jax_context.trace_block()
        assert block["run_id"] == "pinned0001" and block["parent_run_id"] == "parent0002"
        env = context.child_env({"TPU_BENCH_RUN_ID": "x", "PATH": "/bin"})
        assert env == jax_context.child_env({"TPU_BENCH_RUN_ID": "x", "PATH": "/bin"})
        # the manifest and the flight recorder's trace ids name this run
        assert telemetry.build_manifest(device="cpu")["trace"] == block
        from tpu_matmul_bench_torch.serve.trace import mint_trace_id

        assert mint_trace_id(12) == "pinned0001-r000012"
    finally:
        for mod in (context, jax_context):
            mod.reset_context()


def test_trace_merge_is_jaxs(tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps({"traceEvents": [{"name": "x", "ph": "X", "ts": 1, "dur": 2},
                                             {"name": "m", "ph": "M"}]}))
    b.write_text(json.dumps({"name": "y", "ph": "X", "ts": 3, "dur": 1}) + "\n{torn")
    sources = [("a", a, 10.0), ("b", b, 20.5), ("none", tmp_path / "none.json", 0.0)]
    assert context.merge_chrome_traces(sources) == jax_context.merge_chrome_traces(sources)


def test_exporter_writes_snapshots_and_prometheus_text(tmp_path):
    reg = registry.MetricsRegistry()
    _exercise(reg)
    out = tmp_path / "obs"
    with export.SnapshotExporter(out, registry=reg, run_id="r1", interval_s=0.01,
                                 exemplars=True) as ex:
        reg.counter("late").inc()
    snaps = export.read_snapshots(out / export.SNAPSHOT_NAME)
    assert snaps and ex.snapshots_written == len(snaps)
    assert [s["seq"] for s in snaps] == list(range(1, len(snaps) + 1))
    last = snaps[-1]
    assert last["run_id"] == "r1" and last["counters"]["late"] == 1
    prom = (out / export.PROM_NAME).read_text()
    assert prom == jax_export.prometheus_text(last, exemplars=True)
    # a torn tail from a killed writer is repaired before the next append
    with open(out / export.SNAPSHOT_NAME, "a") as fh:
        fh.write('{"record_type": "obs_sna')
    ex.write_once()
    assert len(export.read_snapshots(out / export.SNAPSHOT_NAME)) == len(snaps) + 1


def test_emit_span_lands_in_the_session_timeline(tmp_path):
    path = tmp_path / "trace.json"
    telemetry.emit_span("outside", 0.0, 1.0)  # no session: a no-op
    assert telemetry.current_tracker() is None
    with telemetry.session(str(path)) as tracker:
        assert telemetry.current_tracker() is tracker
        t0 = tracker.epoch
        telemetry.emit_span("serve:request", t0 + 0.5, t0 + 0.75, depth=1, rid=3, trace=None)
        telemetry.emit_span("early", t0 - 1.0, t0 - 0.5)
    events = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]}
    assert events["serve:request"]["dur"] == pytest.approx(250000.0)
    assert events["serve:request"]["args"] == {"rid": 3}
    assert events["early"]["ts"] == 0.0


def test_raw_ledger_lines_are_fsynced_json(tmp_path):
    path = tmp_path / "l.jsonl"
    with reporting.JsonWriter(str(path), manifest={"record_type": "manifest"}) as w:
        w.write_raw({"record_type": "serve_batch", "seq": 1, "b": [1, 2]})
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines == [{"record_type": "manifest"},
                     {"b": [1, 2], "record_type": "serve_batch", "seq": 1}]
    manifest = telemetry.build_manifest(device="cpu", extra={"serve_config": {"a": 1},
                                                             "backend": "tpu"})
    assert manifest["serve_config"] == {"a": 1} and manifest["backend"] == "cpu"


CASES = [RuntimeError("ADMISSION_QUEUE_FULL: depth 1"), TimeoutError("t"),
         ConnectionResetError("c"), OSError(28, "No space left on device"),
         RuntimeError("Connection reset by peer"), RuntimeError("DEADLINE_EXCEEDED: x"),
         ValueError("bad shape"), RuntimeError("CUDA out of memory"), "Read timeout",
         "BREAKER_OPEN: bucket b circuit open", "plain text"]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_classify_is_jaxs(case):
    assert errors.classify(case) == jax_errors.classify(case)
    assert errors.is_overload_error(case) == jax_errors.is_overload_error(case)


def test_sheds_and_the_cards_oom_classify():
    shed = errors.QueueOverflowError(3, 4)
    breaker = errors.BreakerOpenError(3, 4, bucket="8x8x8/int8")
    assert str(shed) == str(jax_errors.QueueOverflowError(3, 4))
    assert str(breaker) == str(jax_errors.BreakerOpenError(3, 4, bucket="8x8x8/int8"))
    assert isinstance(breaker, errors.QueueOverflowError) and breaker.bucket == "8x8x8/int8"
    assert errors.classify(shed) == errors.classify(breaker) == errors.OVERLOAD
    # the card's OOM is transient, as JAX's RESOURCE_EXHAUSTED is
    assert errors.classify(torch.cuda.OutOfMemoryError("CUDA error")) == errors.TRANSIENT
