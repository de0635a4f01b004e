"""Periodic snapshot exporter: JSONL snapshots + Prometheus exposition.

Port of `tpu_matmul_bench/obs/export.py`, on the port's registry, run
context and torn-tail repair.

An instrumented entrypoint (serve bench/selftest with ``--obs-dir``, a
campaign run) attaches a `SnapshotExporter` to the process-global
registry. A daemon thread wakes every ``interval_s`` and writes:

- ``<dir>/obs_snapshot.jsonl`` — one appended, fsynced JSON line per
  tick (``record_type: "obs_snapshot"``, the run_id, a sequence number,
  and the full registry aggregate). Append + fsync is the same
  durability discipline as the campaign journal: a SIGKILL loses at
  most the in-flight line, and `obs status` can tail a *live* run's
  file while the run is still writing it.
- ``<dir>/metrics.prom`` — the latest snapshot in Prometheus text
  exposition format (counters/gauges as-is, histograms as summaries
  with quantile labels), atomically replaced each tick so a scraper
  never reads a torn file.

The exporter is also usable one-shot (`write_once`) — `obs selftest`
and the tests drive it that way for determinism.

`start_http` optionally serves the scrape surface over loopback HTTP:
``/metrics`` (the prom text), ``/healthz`` (liveness: the process can
answer), and ``/readyz`` (readiness: the snapshot thread is alive AND
the last flush is younger than ``ready_max_age_s`` — a wedged exporter
must fail its probe even though the process still answers).
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from pathlib import Path
from typing import Any

from tpu_matmul_bench_torch.obs import context as obs_context
from tpu_matmul_bench_torch.obs.registry import MetricsRegistry, get_registry
from tpu_matmul_bench_torch.utils.durable import repair_torn_tail

SNAPSHOT_NAME = "obs_snapshot.jsonl"
PROM_NAME = "metrics.prom"
OBS_SNAPSHOT_RECORD_TYPE = "obs_snapshot"

DEFAULT_INTERVAL_S = 0.25

HEALTHZ_PATH = "/healthz"
READYZ_PATH = "/readyz"
METRICS_PATH = "/metrics"
#: readiness flush-age bound = max(this floor, factor × interval) — a
#: tick or two may slip under load without flapping the probe
READY_MIN_AGE_S = 2.0
READY_AGE_FACTOR = 10.0

def snapshot_record(registry: MetricsRegistry | None = None, *,
                    run_id: str | None = None, seq: int = 0) -> dict[str, Any]:
    reg = registry if registry is not None else get_registry()
    return {
        "record_type": OBS_SNAPSHOT_RECORD_TYPE,
        "run_id": run_id or obs_context.current().run_id,
        "seq": seq,
        "ts_unix": round(time.time(), 3),
        **reg.snapshot(),
    }


def prometheus_text(snap: dict[str, Any], *, exemplars: bool = False) -> str:
    """Text exposition of one snapshot. Histograms render as Prometheus
    *summaries*: pre-computed quantiles as ``{quantile="0.5"}`` labels
    plus ``_count``/``_sum`` series (windowed quantiles can't be
    re-aggregated server-side, which is exactly a summary's contract).

    With ``exemplars=True``, tail quantile lines (p95/p99) carry an
    OpenMetrics exemplar suffix — ``# {trace_id="..."} <value>`` — naming
    the flight-recorder trace closest to that quantile from above, so a
    scraped tail is one hop from `serve explain --trace`. Off by
    default: the exemplar syntax predates some parsers."""
    lines: list[str] = []
    typed: set[str] = set()

    def emit(series: str, kind: str, value: Any,
             extra_label: str | None = None,
             exemplar: tuple[str, float] | None = None) -> None:
        name = series.split("{", 1)[0]
        if name not in typed:
            lines.append(f"# TYPE {name} {kind}")
            typed.add(name)
        if extra_label:
            if "{" in series:
                series = series[:-1] + "," + extra_label + "}"
            else:
                series = series + "{" + extra_label + "}"
        suffix = ""
        if exemplar is not None:
            suffix = f' # {{trace_id="{exemplar[0]}"}} {exemplar[1]}'
        lines.append(f"{series} {value}{suffix}")

    def _tail_exemplar(summary: dict[str, Any],
                       quantile_value: Any) -> tuple[str, float] | None:
        """The retained exemplar nearest the quantile from above (the
        reservoir keeps the K largest, so anything >= a tail quantile
        that survived the bound is an honest witness for it)."""
        exs = summary.get("exemplars") or []
        at_or_above = [e for e in exs if e["value"] >= quantile_value]
        if not at_or_above:
            return None
        pick = min(at_or_above, key=lambda e: e["value"])
        return str(pick["trace_id"]), float(pick["value"])

    for series, value in (snap.get("counters") or {}).items():
        emit(series, "counter", value)
    for series, value in (snap.get("gauges") or {}).items():
        emit(series, "gauge", value)
    for series, summary in (snap.get("histograms") or {}).items():
        name, labels = series, ""
        if "{" in series:
            name, labels = series.split("{", 1)
            labels = "{" + labels
        for qlabel, q in (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99")):
            if qlabel in summary:
                ex = _tail_exemplar(summary, summary[qlabel]) \
                    if exemplars and qlabel in ("p95", "p99") else None
                emit(series, "summary", summary[qlabel],
                     extra_label=f'quantile="{q}"', exemplar=ex)
        emit(name + "_count" + labels, "summary", summary.get("count", 0))
        emit(name + "_sum" + labels, "summary", summary.get("sum", 0.0))
    return "\n".join(lines) + "\n"


def _fsync_best_effort(fh: Any) -> None:
    try:
        os.fsync(fh.fileno())
    except (AttributeError, OSError, ValueError, io.UnsupportedOperation):
        pass  # captured/odd streams: flush is the best we can do


class SnapshotExporter:
    """Periodic writer of the registry aggregate (see module docstring)."""

    def __init__(self, out_dir: str | Path, *,
                 registry: MetricsRegistry | None = None,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 run_id: str | None = None,
                 seq_start: int = 0,
                 exemplars: bool = False) -> None:
        self.out_dir = Path(out_dir)
        self.snapshot_path = self.out_dir / SNAPSHOT_NAME
        self.prom_path = self.out_dir / PROM_NAME
        self._registry = registry
        self._interval_s = max(float(interval_s), 0.01)
        self._run_id = run_id
        # OpenMetrics exemplar annotation on exported tail quantiles
        self._exemplars = bool(exemplars)
        # seq_start lets a resumed process continue an existing snapshot
        # file with monotonic seq numbers (faults/workloads.py) instead
        # of restarting at 1
        self._seq = int(seq_start)
        self._stop = threading.Event()
        # guards the state the exporter loop writes and the http
        # thread's readiness probe reads: _seq, _last_flush_unix, and
        # the _thread handle. Held only around field access — the fsync
        # and file replace run outside it.
        self._state_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._last_flush_unix: float | None = None
        self._http: Any = None
        self._http_thread: threading.Thread | None = None

    @property
    def snapshots_written(self) -> int:
        with self._state_lock:
            return self._seq

    def write_once(self) -> dict[str, Any]:
        """One snapshot tick: append the JSONL line (fsynced), replace
        the Prometheus file atomically. Returns the snapshot record."""
        self.out_dir.mkdir(parents=True, exist_ok=True)
        with self._state_lock:
            self._seq += 1
            seq = self._seq
        snap = snapshot_record(self._registry, run_id=self._run_id,
                               seq=seq)
        repair_torn_tail(self.snapshot_path)
        with open(self.snapshot_path, "a") as fh:
            fh.write(json.dumps(snap, sort_keys=True) + "\n")
            fh.flush()
            _fsync_best_effort(fh)
        tmp = self.prom_path.with_suffix(".prom.tmp")
        tmp.write_text(prometheus_text(snap, exemplars=self._exemplars))
        os.replace(tmp, self.prom_path)
        with self._state_lock:
            self._last_flush_unix = time.time()
        return snap

    def _loop(self) -> None:
        while not self._stop.wait(self._interval_s):
            self.write_once()

    def start(self) -> "SnapshotExporter":
        with self._state_lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._loop, name="obs-exporter", daemon=True)
                self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the ticker and write one final snapshot — a run shorter
        than the interval still lands its end-state (OBS-002's bar is
        >= 1 snapshot per instrumented run)."""
        self._stop.set()
        with self._state_lock:
            t = self._thread
        if t is not None:
            # join OUTSIDE the state lock: the loop's write_once takes
            # it to stamp the flush, so holding it here would deadlock
            t.join(timeout=5.0)
        with self._state_lock:
            self._thread = None
        self.write_once()
        self.stop_http()

    def __enter__(self) -> "SnapshotExporter":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # ------------------------------------------------------ health probes

    def readiness(self) -> tuple[bool, str]:
        """(ready?, reason). Ready = the snapshot thread is alive and the
        last flush is recent; one-shot callers (write_once without
        start()) count as ready while their flushes stay fresh — probes
        measure the data path, not the threading choice."""
        with self._state_lock:
            t = self._thread
            last = self._last_flush_unix
        alive = t is not None and t.is_alive()
        if last is None:
            return False, "no snapshot flushed yet"
        age = time.time() - last
        bound = max(READY_MIN_AGE_S, READY_AGE_FACTOR * self._interval_s)
        if age > bound:
            state = "thread alive" if alive else "thread dead"
            return False, (f"last flush {age:.1f}s ago exceeds the "
                           f"{bound:.1f}s bound ({state})")
        if not alive and t is not None:
            return False, "snapshot thread died"
        return True, f"flushed {age:.1f}s ago"

    def start_http(self, port: int = 0,
                   host: str = "127.0.0.1") -> int:
        """Serve /metrics, /healthz, /readyz on loopback; returns the
        bound port (port=0 picks a free one)."""
        if self._http is not None:
            return int(self._http.server_address[1])
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, body: str,
                       ctype: str = "text/plain; charset=utf-8") -> None:
                payload = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                if path == HEALTHZ_PATH:
                    self._reply(200, "ok\n")
                elif path == READYZ_PATH:
                    ready, reason = exporter.readiness()
                    self._reply(200 if ready else 503,
                                ("ready: " if ready else "not ready: ")
                                + reason + "\n")
                elif path == METRICS_PATH:
                    try:
                        text = exporter.prom_path.read_text()
                    except OSError:
                        text = prometheus_text(
                            snapshot_record(
                                exporter._registry,
                                run_id=exporter._run_id,
                                seq=exporter.snapshots_written),
                            exemplars=exporter._exemplars)
                    self._reply(200, text,
                                ctype="text/plain; version=0.0.4")
                else:
                    self._reply(404, "not found\n")

            def log_message(self, *args: Any) -> None:
                pass  # probes are high-frequency; stderr stays quiet

        self._http = ThreadingHTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, name="obs-http", daemon=True)
        self._http_thread.start()
        return int(self._http.server_address[1])

    def stop_http(self) -> None:
        if self._http is None:
            return
        self._http.shutdown()
        self._http.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=5.0)
            self._http_thread = None
        self._http = None


def read_snapshots(path: str | Path) -> list[dict[str, Any]]:
    """All snapshot records in a file, oldest first; torn lines (the
    exporter may be mid-write — tailing a live run is the point) are
    skipped."""
    try:
        lines = Path(path).read_text().splitlines()
    except OSError:
        return []
    out = []
    for line in lines:
        try:
            d = json.loads(line)
        except ValueError:
            continue
        if isinstance(d, dict) \
                and d.get("record_type") == OBS_SNAPSHOT_RECORD_TYPE:
            out.append(d)
    return out


def find_snapshot_file(path: str | Path) -> Path | None:
    """Resolve a user-given path to the snapshot file: the file itself,
    a directory holding one, or a campaign/serve dir with an ``obs/``
    subdirectory."""
    p = Path(path)
    if p.is_file():
        return p
    for candidate in (p / SNAPSHOT_NAME, p / "obs" / SNAPSHOT_NAME):
        if candidate.is_file():
            return candidate
    return None


def latest_snapshot(path: str | Path) -> dict[str, Any] | None:
    f = find_snapshot_file(path)
    if f is None:
        return None
    snaps = read_snapshots(f)
    return snaps[-1] if snaps else None
