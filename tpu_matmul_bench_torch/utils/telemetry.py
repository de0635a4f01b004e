"""Run-ledger telemetry: span timeline + provenance manifest.

Port of `tpu_matmul_bench/utils/telemetry.py`:

1. **Spans**: nested phase timers (`compile`, `warmup`, `measure`,
   `sync-calibrate`, per-size) recorded by a `SpanTracker` and written as
   Chrome-trace JSON (``--trace-out trace.json``, loadable in Perfetto)
   plus a stdout phase summary. With no session entered, `span()` is a
   free null context.
2. **Provenance manifest**: one header record per JSONL file with the
   schema-v2 keys of the JAX package's manifest, so the repo's ledger
   readers (`scripts/digest_jsonl.py`) read port ledgers unchanged. Its
   jax/jaxlib version fields become `torch_version` and `cuda_version`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time
from typing import Any, Iterator

import torch

SCHEMA_VERSION = 2
MANIFEST_RECORD_TYPE = "manifest"

# first-vs-last-quartile slope above which a sample distribution is
# flagged as warmup drift
WARMUP_DRIFT_THRESHOLD_PCT = 10.0


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One closed span, in seconds relative to the tracker's epoch."""

    name: str
    start_s: float
    dur_s: float
    depth: int  # nesting depth at open time (0 = top level)
    args: dict[str, Any]


def _chrome_event(e: SpanEvent) -> dict[str, Any]:
    """One Chrome-trace complete ("X") event, µs timestamps."""
    return {
        "name": e.name,
        "ph": "X",
        "ts": round(e.start_s * 1e6, 3),
        "dur": round(e.dur_s * 1e6, 3),
        "pid": os.getpid(),
        "tid": 1,
        **({"args": e.args} if e.args else {}),
    }


class _SpanSink:
    """Incremental span flush: every closed span lands in the trace file
    as one fsynced JSON line at once, so a killed process still leaves its
    finished phases on disk. A clean exit rewrites the file as complete
    Chrome-trace JSON (`write_trace`)."""

    def __init__(self, path: str) -> None:
        self._path = path
        self._fh: Any = None
        self._disabled = False

    def write(self, event: dict[str, Any]) -> None:
        if self._disabled:
            return
        try:
            if self._fh is None:
                from tpu_matmul_bench_torch.utils.reporting import (
                    is_reporting_process,
                )

                if not is_reporting_process():
                    self._disabled = True
                    return
                self._fh = open(self._path, "w")
            self._fh.write(json.dumps(event, sort_keys=True) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except (OSError, ValueError, AttributeError,
                io.UnsupportedOperation):
            self._disabled = True  # a broken sink must not fail the run

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


class SpanTracker:
    """Collects nested phase spans for one benchmark run, whose Chrome
    trace goes to `path`."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.epoch = time.perf_counter()
        self.events: list[SpanEvent] = []
        self._depth = 0
        self._sink: _SpanSink | None = None

    def attach_sink(self, sink: _SpanSink) -> None:
        self._sink = sink

    def close_sink(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None

    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Iterator[dict[str, Any]]:
        """Time a phase. Yields the (mutable) args dict so callers can
        attach values only known at close time."""
        meta = {k: v for k, v in args.items() if v is not None}
        start = time.perf_counter() - self.epoch
        self._depth += 1
        try:
            yield meta
        finally:
            self._depth -= 1
            event = SpanEvent(
                name=name,
                start_s=start,
                dur_s=time.perf_counter() - self.epoch - start,
                depth=self._depth,
                args=dict(meta),
            )
            self.events.append(event)
            if self._sink is not None:
                self._sink.write(_chrome_event(event))

    def emit(self, name: str, start_pc: float, end_pc: float, *,
             depth: int = 0, **args: Any) -> None:
        """Record a span retrospectively from absolute `time.perf_counter`
        timestamps (the serve flight recorder's request phases are measured
        first and attributed later, so they cannot be wrapped in a live
        `span()`). Lands in the same timeline: clamped to this tracker's
        epoch, flushed through the sink like any other closed span."""
        event = SpanEvent(
            name=name,
            start_s=max(start_pc - self.epoch, 0.0),
            dur_s=max(end_pc - start_pc, 0.0),
            depth=depth,
            args={k: v for k, v in args.items() if v is not None},
        )
        self.events.append(event)
        if self._sink is not None:
            self._sink.write(_chrome_event(event))

    def to_chrome_trace(self) -> dict[str, Any]:
        events = sorted(self.events, key=lambda e: (e.start_s, -e.dur_s))
        return {
            "displayTimeUnit": "ms",
            "traceEvents": [_chrome_event(e) for e in events],
        }

    def summary_lines(self) -> list[str]:
        """Stdout phase summary: total/count per span name, largest first."""
        agg: dict[str, tuple[float, int]] = {}
        for e in self.events:
            total, count = agg.get(e.name, (0.0, 0))
            agg[e.name] = (total + e.dur_s, count + 1)
        if not agg:
            return ["[telemetry] no spans recorded"]
        wall = max((e.start_s + e.dur_s) for e in self.events)
        lines = ["[telemetry] phase summary "
                 f"(wall {wall:.3f} s):"]
        width = max(len(n) for n in agg)
        for name, (total, count) in sorted(
                agg.items(), key=lambda kv: -kv[1][0]):
            pct = 100.0 * total / wall if wall > 0 else 0.0
            lines.append(f"  {name:<{width}}  {total:9.3f} s "
                         f"({pct:5.1f}%)  x{count}")
        return lines


_TRACKER: SpanTracker | None = None
# sibling artifacts of the run in progress (kind -> path), named in the
# manifest: the profiler's trace directory while `--profile-dir` traces
_ARTIFACTS: dict[str, str] = {}


def note_artifact(kind: str, path: str) -> None:
    """Register a sibling artifact (the profiler's trace directory) so the
    manifest cross-references it."""
    _ARTIFACTS[kind] = path


def forget_artifact(kind: str) -> None:
    """Drop an artifact note when its run ends, so that a later run in the
    same process does not name it (the JAX package keeps its notes for the
    whole process)."""
    _ARTIFACTS.pop(kind, None)


def artifacts() -> dict[str, str]:
    return dict(_ARTIFACTS)


def current_tracker() -> SpanTracker | None:
    return _TRACKER


@contextlib.contextmanager
def _null_span(meta: dict[str, Any]) -> Iterator[dict[str, Any]]:
    yield meta


def span(name: str, **args: Any):
    """Records into the installed tracker, or is a free null context when
    telemetry is off. Yields the args dict."""
    tracker = _TRACKER
    if tracker is None:
        return _null_span(dict(args))
    return tracker.span(name, **args)


def emit_span(name: str, start_pc: float, end_pc: float, *,
              depth: int = 0, **args: Any) -> None:
    """Module-level retrospective span (see SpanTracker.emit): a no-op when
    no tracker session is installed, so per-request attribution costs
    nothing outside `--trace-out` runs."""
    tracker = _TRACKER
    if tracker is not None:
        tracker.emit(name, start_pc, end_pc, depth=depth, **args)


@contextlib.contextmanager
def session(trace_out: str | None) -> Iterator[SpanTracker | None]:
    """Install a span tracker for one benchmark run; on exit write the
    Chrome trace to `trace_out` ('-' = stdout) and print the phase
    summary. No-op when `trace_out` is falsy; a nested session keeps the
    outer tracker."""
    global _TRACKER
    if not trace_out or _TRACKER is not None:
        yield _TRACKER
        return
    tracker = SpanTracker(trace_out)
    if trace_out != "-":
        tracker.attach_sink(_SpanSink(trace_out))
    _TRACKER = tracker
    try:
        yield tracker
    finally:
        _TRACKER = None
        tracker.close_sink()
        write_trace(tracker, trace_out)


def write_trace(tracker: SpanTracker, path: str) -> None:
    """Serialize the tracker to Chrome-trace JSON at `path` ('-' =
    stdout) and print the phase summary (reporting process only)."""
    from tpu_matmul_bench_torch.utils.reporting import (
        is_reporting_process,
        report,
    )

    if not is_reporting_process():
        return
    payload = json.dumps(tracker.to_chrome_trace(), sort_keys=True)
    if path == "-":
        print(payload, flush=True)
    else:
        with open(path, "w") as fh:
            fh.write(payload + "\n")
        report(f"[telemetry] chrome trace written to {path} "
               "(load in Perfetto or chrome://tracing)")
    report(*tracker.summary_lines())


def git_sha() -> str | None:
    """HEAD of the repo containing this package, or None outside git."""
    try:
        out = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.abspath(__file__)),
             "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=10, check=False)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def build_manifest(config: Any = None, *, device: str | None = None,
                   extra: dict[str, Any] | None = None) -> dict[str, Any]:
    """The provenance header record for a JSONL file.

    `config` is a BenchConfig (duck-typed to avoid an import cycle); its
    `device`, or else `device`, names the backend described. With neither
    the manifest describes the card when there is one. `extra` merges
    program-specific top-level keys (the serve harness's load
    configuration); the reserved keys win. The `trace` block is the run
    context's (obs/context.py): this run's id, and the spawning run's when
    TPU_BENCH_PARENT_RUN_ID names one.
    """
    from tpu_matmul_bench_torch.obs import context as obs_context

    device = getattr(config, "device", None) or device or (
        "cuda" if torch.cuda.is_available() else "cpu")
    on_card = device == "cuda"
    manifest: dict[str, Any] = {
        "record_type": MANIFEST_RECORD_TYPE,
        "schema_version": SCHEMA_VERSION,
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "created_unix": round(time.time(), 3),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": device,
        "device_kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 1,
        "process_count": (torch.distributed.get_world_size()
                          if torch.distributed.is_available()
                          and torch.distributed.is_initialized() else 1),
        "argv": list(sys.argv),
        "git_sha": git_sha(),
        "trace": obs_context.trace_block(),
    }
    if config is not None:
        manifest["mesh_shape"] = [config.num_devices or 1]
        manifest["config"] = {
            "dtype": config.dtype_name,
            "precision": config.precision,
            "timing": config.timing,
            "matmul_impl": config.matmul_impl,
            "mode": config.mode,
            "iterations": config.iterations,
            "warmup": config.warmup,
            "seed": config.seed,
        }
    for key, value in (extra or {}).items():
        manifest.setdefault(key, value)
    noted = artifacts()
    if _TRACKER is not None:
        # the run's chrome trace, cross-referenced from its ledger
        noted["chrome_trace"] = _TRACKER.path
    if noted:
        manifest["artifacts"] = noted
    return manifest


def is_manifest(record: Any) -> bool:
    """True for the JSONL header record."""
    return (isinstance(record, dict)
            and record.get("record_type") == MANIFEST_RECORD_TYPE)
