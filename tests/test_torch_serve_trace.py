"""The flight recorder on the CPU (`serve/trace.py`) against the JAX
package's: the span-coverage audit over the port's own package and over
seeded-violation trees, the terminal records, the span-record contract,
and `serve explain`'s rendering of the same records."""

import copy
import json
from pathlib import Path

import pytest

from tpu_matmul_bench.serve import queue as jax_queue
from tpu_matmul_bench.serve import trace as jax_trace
from tpu_matmul_bench_torch.serve import queue, service, trace


def _findings(findings) -> list[tuple]:
    return [(f.rule, f.where, f.message, f.severity) for f in findings]


def test_the_ports_tree_audits_clean():
    assert trace.trace_findings() == []


# seeded violations: a shed with no emission, an unknown state, a state
# emitted twice in one file, a non-literal state, an unbounded reservoir,
# a limit out of range
VIOLATIONS = {
    "sheds.py": (
        "def submit(self, req):\n"
        "    if full:\n"
        "        raise QueueOverflowError(1, 1)\n"
        "    if self.recorder:\n"
        "        self.recorder.terminal(req, 'shed_breaker')\n"
        "    raise BreakerOpenError(1, 1)\n"),
    "states.py": (
        "def f(recorder, req, state):\n"
        "    recorder.terminal(req, 'vanished')\n"
        "    recorder.terminal(req, 'complete')\n"
        "    recorder.terminal(req, 'complete')\n"
        "    recorder.terminal(\n"
        "        req, 'failed')\n"
        "    recorder.terminal(req, state)\n"),
    "reservoir.py": "class H:\n    def __init__(self):\n        self.exemplars = []\n",
    "limits.py": "EXEMPLAR_LIMIT = 500\n",
}


@pytest.mark.parametrize("names", [list(VIOLATIONS), ["sheds.py"], ["reservoir.py"]])
def test_seeded_violations_give_jaxs_findings(tmp_path, names):
    for name in names:
        (tmp_path / name).write_text(VIOLATIONS[name])
    got = _findings(trace.trace_findings(tmp_path))
    assert got == _findings(jax_trace.trace_findings(tmp_path))
    assert got, "the seeded tree fires nothing"


def _req(mod_queue, rid: int, **kw):
    req = mod_queue.Request(rid=rid, m=100, k=200, n=300, dtype="int8", trace=f"t-r{rid}",
                            **kw)
    req.bucket = (128, 256, 512)
    return req


def test_terminal_records_are_jaxs(monkeypatch):
    class Clock:
        @staticmethod
        def perf_counter():
            return 50.0

    out = []
    for mod_queue, mod_trace in ((queue, trace), (jax_queue, jax_trace)):
        monkeypatch.setattr(mod_trace, "time", Clock)
        rec = mod_trace.FlightRecorder()
        done = _req(mod_queue, 1, tenant="a", submitted_at=40.0, dispatched_at=41.0)
        rec.terminal(done, "complete", wall_ms=10.0,
                     spans=mod_trace.request_spans(done, 42.0, 42.5, 50.0, cache_hit=False,
                                                   cache_source="compile",
                                                   cold_compile_ms=0.4))
        rec.terminal(done, "failed", wall_ms=9.0, error="transient",
                     spans=mod_trace.failure_spans(done, 42.0, 49.0))
        rec.terminal(_req(mod_queue, 2, submitted_at=45.0), "evicted", displaced_by="b")
        rec.terminal(_req(mod_queue, 3), "shed_overflow", depth=4)
        rec.terminal(_req(mod_queue, 4, group=2), "shed_slo", slo_ms=5.0)
        with pytest.raises(ValueError, match="unknown terminal state"):
            rec.terminal(done, "lost")
        out.append((rec.emitted, rec.drain(), rec.drain()))
    assert out[0] == out[1]
    assert [d["state"] for d in out[0][1]] == ["complete", "failed", "evicted",
                                               "shed_overflow", "shed_slo"]


GOOD = {"record_type": "serve_span", "trace": "r-1", "rid": 1, "tenant": "a",
        "bucket": "128x128x128/bfloat16", "state": "complete", "wall_ms": 4.0,
        "spans": [{"name": "queue_wait", "ms": 1.0}, {"name": "batch_wait", "ms": 0.5},
                  {"name": "cache", "ms": 0.5, "hit": True}, {"name": "execute", "ms": 2.0}]}


def _variants() -> list[dict]:
    out = [GOOD]
    for key, value in (("record_type", "serve_batch"), ("rid", "1"), ("state", "gone"),
                       ("wall_ms", -1.0), ("wall_ms", 8.0), ("trace", ""), ("detail", {}),
                       ("replica_group", -1), ("replica_group", 3), ("spans", [])):
        d = copy.deepcopy(GOOD)
        d[key] = value
        out.append(d)
    d = copy.deepcopy(GOOD)
    d["spans"][2] = {"name": "cache", "ms": 0.5, "hit": 1, "cold_compile_ms": -2}
    out.append(d)
    d = copy.deepcopy(GOOD)
    d["spans"] = d["spans"][:2] + [{"name": "compile", "ms": 2.5}]
    out.append(d)
    d = copy.deepcopy(GOOD)
    d.update(state="shed_slo", spans=[], wall_ms=0.0, detail="x")
    out.append(d)
    return out


@pytest.mark.parametrize("record", _variants(), ids=lambda d: str(len(json.dumps(d))))
def test_span_record_contract_is_jaxs(record):
    assert trace.validate_serve_span_record(record) == \
        jax_trace.validate_serve_span_record(record)
    assert trace.reconciles(record) == jax_trace.reconciles(record)


@pytest.mark.parametrize("kw", [{"slowest": 3}, {"slowest": 0}, {"trace_id": "r-1"},
                                {"trace_id": "absent"}])
def test_explain_renders_jaxs_lines(kw):
    records = [dict(d, trace=f"r-{i}", rid=i) for i, d in enumerate(_variants())
               if isinstance(d.get("wall_ms"), float)]
    assert trace.render_explain(records, **kw) == jax_trace.render_explain(records, **kw)
    assert trace.render_explain([], slowest=3) == jax_trace.render_explain([], slowest=3)


def test_a_torn_ledger_reads_as_jaxs(tmp_path):
    path = tmp_path / "torn.jsonl"
    lines = [json.dumps({"record_type": "manifest", "trace": {"run_id": "x"}}),
             json.dumps(GOOD), "[1, 2]", json.dumps({"record_type": "serve_batch"}),
             json.dumps(dict(GOOD, rid=2))[:40]]
    path.write_text("\n".join(lines))
    assert trace.read_trace_records(path) == jax_trace.read_trace_records(path)
    assert trace.read_trace_records(tmp_path / "none")[0] is None


def test_serve_batch_contract_is_jaxs():
    from tpu_matmul_bench.serve.service import (
        validate_serve_batch_record as jax_validate,
    )

    good = {"record_type": "serve_batch", "seq": 1, "bucket": "b", "n": 2, "failed": 1,
            "batch_ms": 0.5}
    for d in (good, dict(good, seq=0), dict(good, failed=3), dict(good, n=True),
              dict(good, record_type="x"), {k: v for k, v in good.items() if k != "bucket"}):
        assert service.validate_serve_batch_record(d) == jax_validate(d)


def test_audit_reads_the_package_it_serves():
    root = Path(trace.__file__).resolve().parent.parent
    assert root.name == "tpu_matmul_bench_torch"
    emitting = {p.name for p in root.rglob("*.py") if "recorder.terminal(" in p.read_text()}
    assert {"queue.py", "scheduler.py", "service.py"} <= emitting
