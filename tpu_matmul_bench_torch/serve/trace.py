"""Per-request flight recorder: causal serve-path tracing + forensics.

Port of `tpu_matmul_bench/serve/trace.py` (stdlib only). The audit scans
the port's own package; `serve explain` renders a ledger that either
package wrote, the same way.

The serve harness's aggregate percentiles (extras["serve"]) answer "how
slow is p99"; this module answers "where did THIS p99 request's latency
go". Every `Request` carries a trace id parented under the run context
(obs/context.py), and every request reaches exactly one terminal state:

- ``complete`` / ``failed`` — emitted by the worker after the request's
  batch, carrying the causal span chain queue_wait → batch_wait →
  cache → execute whose components are contiguous wall-clock intervals
  (admission → dispatch → per-request start → cache acquisition →
  post-sync completion), so they sum to the measured wall latency by
  construction;
- ``shed_overflow`` / ``shed_breaker`` / ``shed_slo`` / ``evicted`` —
  emitted at the scheduler's shed/breaker/eviction decision points, so a
  refused request is traceable, not just counted.

Terminal records ride the ledger's fsynced `serve_batch` stream as
``serve_span`` lines (schema-v2, crash-tolerant: a SIGKILLed run leaves
complete span lines behind), and `serve explain` renders any trace's
critical-path decomposition from the ledger alone.

The static audit (`trace_findings`, lint rules TRACE-001/002/003)
certifies the coverage contract at review time: every shed/breaker
raise site has an adjacent recorder emission, every terminal state has
exactly one emission site per admission path, and the obs bus's
exemplar reservoir (the trace-id retention behind tail quantiles) is
bounded.

stdlib-only at import (no torch): `serve explain` must work on a machine
that can read a ledger but not serve one.
"""

from __future__ import annotations

import json
import re
import threading
import time
from pathlib import Path
from typing import Any, Sequence

from tpu_matmul_bench_torch.analysis.findings import Finding
from tpu_matmul_bench_torch.obs import context as obs_context

#: streamed terminal record type (rides the serve_batch channel)
SERVE_SPAN_RECORD_TYPE = "serve_span"

#: every way a request's life can end; the static audit holds the tree
#: to exactly one emission site per state per admission path
TERMINAL_STATES = (
    "complete",
    "failed",
    "shed_overflow",
    "shed_breaker",
    "shed_slo",
    "evicted",
)

#: the causal span chain of a completed request, in path order
SPAN_NAMES = ("queue_wait", "batch_wait", "cache", "execute")

#: explain's reconciliation gate: span components must sum to the
#: measured wall latency within this (they are contiguous intervals of
#: one clock, so real slack means the decomposition lost a phase)
RECONCILE_TOLERANCE_PCT = 5.0

#: absolute reconciliation floor — µs-scale rounding on a sub-ms
#: request must not read as a lost phase
RECONCILE_FLOOR_MS = 0.01


def mint_trace_id(rid: int) -> str:
    """This request's flight-recorder id: the run context's id (which a
    campaign parent chains via TPU_BENCH_PARENT_RUN_ID) plus the rid —
    unique within the run, greppable across a campaign's ledgers."""
    return f"{obs_context.current().run_id}-r{rid:06d}"


def request_spans(
    req: Any,
    t0: float,
    t_entry: float,
    done: float,
    *,
    cache_hit: bool,
    cache_source: str | None = None,
    cold_compile_ms: float | None = None,
    deserialize_ms: float | None = None,
) -> list[dict[str, Any]]:
    """The completed request's span chain from its boundary timestamps
    (all `time.perf_counter`): admission (`req.submitted_at`) → batch
    dispatch (`req.dispatched_at`) → per-request start (`t0`) → cache
    acquisition return (`t_entry`) → post-sync completion (`done`).
    Contiguous by construction, so the chain partitions the measured
    wall latency."""
    cache_span: dict[str, Any] = {
        "name": "cache",
        "ms": round(max(t_entry - t0, 0.0) * 1e3, 4),
        "hit": bool(cache_hit),
    }
    if cache_source is not None:
        cache_span["source"] = cache_source
    if cold_compile_ms is not None:
        cache_span["cold_compile_ms"] = round(cold_compile_ms, 4)
    if deserialize_ms is not None:
        cache_span["deserialize_ms"] = round(deserialize_ms, 4)
    return [
        {"name": "queue_wait",
         "ms": round(max(req.dispatched_at - req.submitted_at, 0.0) * 1e3,
                     4)},
        {"name": "batch_wait",
         "ms": round(max(t0 - req.dispatched_at, 0.0) * 1e3, 4)},
        cache_span,
        {"name": "execute", "ms": round(max(done - t_entry, 0.0) * 1e3, 4)},
    ]


def failure_spans(req: Any, t0: float,
                  t_fail: float) -> list[dict[str, Any]]:
    """The failed request's span chain: queue wait → batch wait →
    whatever ran before the exception, attributed to `execute` (there
    is no cache boundary to split on — the failure may have been the
    compile itself). Lives here, not in the worker loop, so the span
    schema has exactly one owning module."""
    return [
        {"name": "queue_wait",
         "ms": round(max(req.dispatched_at - req.submitted_at, 0.0) * 1e3,
                     4)},
        {"name": "batch_wait",
         "ms": round(max(t0 - req.dispatched_at, 0.0) * 1e3, 4)},
        {"name": "execute", "ms": round(max(t_fail - t0, 0.0) * 1e3, 4)},
    ]


class FlightRecorder:
    """Collects terminal trace events from any serve-harness thread.

    Producers (and the scheduler running on their stack) call
    `terminal` for sheds/evictions; the worker calls it for completions
    and failures, then flushes `drain()`ed records onto the ledger
    stream between batches — so the JsonWriter stays single-threaded
    while shed events from submit-side threads still reach the ledger
    in causal order relative to their batch neighborhood."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending: list[dict[str, Any]] = []
        self._emitted = 0

    @property
    def emitted(self) -> int:
        with self._lock:
            return self._emitted

    def terminal(self, req: Any, state: str, *,
                 spans: Sequence[dict[str, Any]] | None = None,
                 wall_ms: float | None = None,
                 **detail: Any) -> dict[str, Any]:
        """Record the request's (single) terminal event. For sheds the
        span chain is derived here: an evicted request spent its whole
        life in queue_wait; a door shed never held queue time at all."""
        if state not in TERMINAL_STATES:
            raise ValueError(f"unknown terminal state {state!r}")
        if spans is None:
            if state == "evicted" and req.submitted_at:
                wait_ms = round(
                    max(time.perf_counter() - req.submitted_at, 0.0) * 1e3,
                    4)
                spans = [{"name": "queue_wait", "ms": wait_ms}]
                if wall_ms is None:
                    wall_ms = wait_ms
            else:
                spans = []
        record: dict[str, Any] = {
            "record_type": SERVE_SPAN_RECORD_TYPE,
            "trace": req.trace or mint_trace_id(req.rid),
            "rid": int(req.rid),
            "tenant": str(req.tenant),
            "bucket": _bucket_str(req),
            "state": state,
            "wall_ms": round(wall_ms if wall_ms is not None else 0.0, 4),
            "spans": [dict(s) for s in spans],
        }
        # pod serving (serve/pod.py) stamps the replica group at
        # placement time; the label rides every terminal record so
        # `serve explain --slowest N` can attribute tail latency to the
        # group that served (or refused) the request
        group = getattr(req, "group", None)
        if group is not None:
            record["replica_group"] = int(group)
        if detail:
            record["detail"] = {k: v for k, v in sorted(detail.items())}
        with self._lock:
            self._pending.append(record)
            self._emitted += 1
        return record

    def drain(self) -> list[dict[str, Any]]:
        """All buffered terminal records, in emission order. Called by
        the worker (the only ledger-writing thread) between batches and
        once after the queue drains."""
        with self._lock:
            out, self._pending = self._pending, []
        return out


def _bucket_str(req: Any) -> str:
    if req.bucket is None:
        return ""
    m, k, n = req.bucket
    return f"{m}x{k}x{n}/{req.dtype}"


# ---------------------------------------------------------------------------
# record contract (faults/audit.py holds SIGKILLed ledgers to this)


def validate_serve_span_record(d: dict[str, Any]) -> list[str]:
    """Schema contract for one streamed `serve_span` terminal line.
    Empty list = valid. A `complete` record must carry the full span
    chain and reconcile against its own wall latency — the crash
    certifier runs this on every complete line a killed run left."""
    problems: list[str] = []
    if d.get("record_type") != SERVE_SPAN_RECORD_TYPE:
        return [f"record_type is {d.get('record_type')!r}, "
                f"not {SERVE_SPAN_RECORD_TYPE!r}"]
    for key, kind in (("trace", str), ("rid", int), ("tenant", str),
                      ("bucket", str), ("state", str),
                      ("wall_ms", (int, float)), ("spans", list)):
        v = d.get(key)
        if not isinstance(v, kind) or isinstance(v, bool):
            problems.append(
                f"serve_span lacks a well-typed {key!r} (got {v!r})")
    if problems:
        return problems
    if not d["trace"]:
        problems.append("serve_span trace id is empty")
    if d["state"] not in TERMINAL_STATES:
        problems.append(f"serve_span state {d['state']!r} not in "
                        f"{TERMINAL_STATES}")
    if d["wall_ms"] < 0:
        problems.append(f"serve_span wall_ms {d['wall_ms']} negative")
    if "replica_group" in d and (
            not isinstance(d["replica_group"], int)
            or isinstance(d["replica_group"], bool)
            or d["replica_group"] < 0):
        problems.append(
            f"serve_span replica_group {d['replica_group']!r} is not a "
            "non-negative integer")
    if "detail" in d and not isinstance(d["detail"], str):
        problems.append(
            f"serve_span detail {d['detail']!r} is not a string")
    names: list[str] = []
    for s in d["spans"]:
        if not isinstance(s, dict) or not isinstance(s.get("name"), str) \
                or isinstance(s.get("ms"), bool) \
                or not isinstance(s.get("ms"), (int, float)) \
                or s["ms"] < 0:
            problems.append(f"malformed span entry {s!r}")
            continue
        if s["name"] not in SPAN_NAMES:
            problems.append(f"span name {s['name']!r} not in {SPAN_NAMES}")
        names.append(s["name"])
        # the cache span's provenance keys: hit flag, acquisition
        # source, and the cold-path timing split — optional, but never
        # malformed (the explain renderer prices tails from them)
        if s["name"] == "cache":
            if "hit" in s and not isinstance(s["hit"], bool):
                problems.append(
                    f"cache span hit {s['hit']!r} is not a bool")
            if "source" in s and not isinstance(s["source"], str):
                problems.append(
                    f"cache span source {s['source']!r} is not a string")
            for tkey in ("cold_compile_ms", "deserialize_ms"):
                if tkey in s and (isinstance(s[tkey], bool)
                                  or not isinstance(s[tkey], (int, float))
                                  or s[tkey] < 0):
                    problems.append(
                        f"cache span {tkey} {s[tkey]!r} is not a "
                        "non-negative number")
    if d["state"] == "complete" and not problems:
        if names != list(SPAN_NAMES):
            problems.append(
                f"complete record's span chain is {names}, "
                f"want {list(SPAN_NAMES)}")
        else:
            ok, _delta_pct = reconciles(d)
            if not ok:
                total = sum(s["ms"] for s in d["spans"])
                problems.append(
                    f"span components sum to {total:.4f} ms but wall_ms "
                    f"is {d['wall_ms']} (> {RECONCILE_TOLERANCE_PCT}% "
                    "apart)")
    return problems


def reconciles(d: dict[str, Any]) -> tuple[bool, float]:
    """(ok, delta_pct): do the record's span components sum to its
    measured wall latency within the tolerance?"""
    total = sum(float(s.get("ms", 0.0)) for s in d.get("spans", []))
    wall = float(d.get("wall_ms", 0.0))
    delta = abs(total - wall)
    pct = 100.0 * delta / wall if wall > 0 else 0.0
    ok = delta <= max(wall * RECONCILE_TOLERANCE_PCT / 100.0,
                      RECONCILE_FLOOR_MS)
    return ok, round(pct, 2)


# ---------------------------------------------------------------------------
# tail attribution (read by obs/history.py's serve_tail series)

#: the tail the attribution report distills: requests at or above this
#: wall-latency quantile
TAIL_QUANTILE = 0.95

#: attribution components, in causal-path order; the `cache` span maps
#: onto `compile` (a tail request's cache phase is its capture, or its
#: kernel library's import — warm lookups are ~µs)
TAIL_COMPONENTS = ("queue_wait", "batch_wait", "compile", "execute")

_COMPONENT_BY_SPAN = {"queue_wait": "queue_wait",
                      "batch_wait": "batch_wait",
                      "cache": "compile",
                      "execute": "execute"}


def tail_attribution(records: Sequence[dict[str, Any]], *,
                     quantile: float = TAIL_QUANTILE,
                     ) -> dict[str, Any] | None:
    """Where the p95+ tail's latency went: per-component share of the
    tail requests' summed wall time. Deterministic from the span
    records alone, so history points derived from committed ledgers are
    reproducible byte-for-byte. None when no complete records exist."""
    completes = [d for d in records
                 if d.get("state") == "complete"
                 and isinstance(d.get("wall_ms"), (int, float))]
    if not completes:
        return None
    walls = sorted(float(d["wall_ms"]) for d in completes)
    n = len(walls)
    pos = quantile * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    threshold = walls[lo] * (1 - frac) + walls[hi] * frac
    tail = [d for d in completes if float(d["wall_ms"]) >= threshold]
    comp = {c: 0.0 for c in TAIL_COMPONENTS}
    wall_sum = 0.0
    for d in tail:
        wall_sum += float(d["wall_ms"])
        for s in d.get("spans", []):
            c = _COMPONENT_BY_SPAN.get(s.get("name"))
            if c is not None:
                comp[c] += float(s.get("ms", 0.0))
    return {
        "quantile": quantile,
        "threshold_ms": round(threshold, 4),
        "tail_count": len(tail),
        "total_count": n,
        "wall_ms_sum": round(wall_sum, 4),
        "shares": {c: round(100.0 * v / wall_sum, 2) if wall_sum > 0
                   else 0.0 for c, v in comp.items()},
    }


# ---------------------------------------------------------------------------
# ledger reading + `serve explain`


def read_trace_records(
    path: str | Path,
) -> tuple[dict[str, Any] | None, list[dict[str, Any]], list[str]]:
    """(manifest, serve_span records, problems) from a ledger — torn-
    tolerant: an unparseable (truncated / garbled) line is noted and
    skipped, complete lines before and after it are kept. `explain` on
    a SIGKILLed run degrades to the traces that made it to disk."""
    p = Path(path)
    manifest: dict[str, Any] | None = None
    records: list[dict[str, Any]] = []
    problems: list[str] = []
    try:
        data = p.read_bytes()
    except OSError as e:
        return None, [], [f"cannot read {p}: {e}"]
    for i, raw in enumerate(data.split(b"\n"), 1):
        if not raw.strip():
            continue
        try:
            d = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            problems.append(f"line {i}: not a complete JSON record "
                            "(torn tail?) — skipped")
            continue
        if not isinstance(d, dict):
            continue
        if manifest is None and d.get("record_type") == "manifest":
            manifest = d
        elif d.get("record_type") == SERVE_SPAN_RECORD_TYPE:
            records.append(d)
    return manifest, records, problems


def render_explain(
    records: list[dict[str, Any]],
    *,
    trace_id: str | None = None,
    slowest: int = 3,
) -> tuple[list[str], int]:
    """(lines, exit code) for `serve explain`: the critical-path
    decomposition of the chosen traces, slowest first. Exit is nonzero
    when a requested trace is missing or any shown complete trace fails
    reconciliation — explain is also the reconciliation gate."""
    lines: list[str] = []
    rc = 0
    if trace_id is not None:
        chosen = [d for d in records if d.get("trace") == trace_id]
        if not chosen:
            return [f"explain: no trace {trace_id!r} in the ledger "
                    f"({len(records)} span record(s) present)"], 1
    else:
        chosen = sorted(records,
                        key=lambda d: -float(d.get("wall_ms", 0.0)))
        chosen = chosen[: max(slowest, 1)]
        if not chosen:
            return ["explain: no serve_span records in the ledger "
                    "(run serve bench/selftest with --json-out on a "
                    "flight-recorder build)"], 1
    for d in chosen:
        wall = float(d.get("wall_ms", 0.0))
        head = (f"trace {d.get('trace')}  rid={d.get('rid')}  "
                f"tenant={d.get('tenant')}  bucket={d.get('bucket')}  "
                f"state={d.get('state')}  wall {wall:.3f} ms")
        if "replica_group" in d:
            head += f"  group=g{d['replica_group']}"
        lines.append(head)
        spans = d.get("spans") or []
        if not spans:
            detail = d.get("detail")
            lines.append("  (no admitted time"
                         + (f"; {json.dumps(detail, sort_keys=True)}"
                            if detail else "") + ")")
            continue
        width = max(len(str(s.get("name", ""))) for s in spans)
        for s in spans:
            ms = float(s.get("ms", 0.0))
            share = 100.0 * ms / wall if wall > 0 else 0.0
            bar = "#" * int(round(share / 5))
            attrs = {k: v for k, v in s.items() if k not in ("name", "ms")}
            lines.append(
                f"  {s.get('name', '?'):<{width}}  {ms:10.3f} ms "
                f"{share:5.1f}%  {bar}"
                + (f"  {json.dumps(attrs, sort_keys=True)}"
                   if attrs else ""))
        if d.get("state") == "complete":
            ok, pct = reconciles(d)
            total = sum(float(s.get("ms", 0.0)) for s in spans)
            lines.append(
                f"  reconciliation: components {total:.3f} ms vs wall "
                f"{wall:.3f} ms (delta {pct}%) "
                + ("ok" if ok
                   else f"FAIL (> {RECONCILE_TOLERANCE_PCT}%)"))
            if not ok:
                rc = 1
    return lines, rc


def run_explain(ledger: str, *, trace_id: str | None = None,
                slowest: int = 3) -> int:
    """The `serve explain` CLI entry (no torch needed)."""
    manifest, records, problems = read_trace_records(ledger)
    for p in problems:
        print(f"explain: warning: {p}")
    if manifest is not None:
        cfg = manifest.get("serve_config") or {}
        run = (manifest.get("trace") or {}).get("run_id", "?")
        print(f"ledger {ledger}  run {run}  "
              f"scheduler={cfg.get('scheduler', '?')} "
              f"mix={cfg.get('mix', '?')} "
              f"load={cfg.get('load_mode', '?')}")
    lines, rc = render_explain(records, trace_id=trace_id, slowest=slowest)
    print("\n".join(lines))
    return rc


# ---------------------------------------------------------------------------
# static span-coverage audit: TRACE-001 / TRACE-002 / TRACE-003


#: a scheduler decision that refuses a request — each must emit the
#: refused request's terminal trace event within the preceding lines
_SHED_SITE_RE = re.compile(
    r"raise\s+(?:QueueOverflowError|BreakerOpenError)\(")

#: a flight-recorder emission call site
_EMIT_RE = re.compile(r"recorder\.terminal\(")

#: a terminal emission with its state literal (the state is always a
#: string literal at the call site — within the call's first two lines
#: — so coverage stays statically checkable; that contract is itself
#: part of what the audit enforces)
_TERMINAL_RE = re.compile(
    r"recorder\.terminal\(\s*[A-Za-z_][\w.\[\]]*\s*,\s*['\"]([a-z_]+)['\"]")

#: an exemplar reservoir declaration: a list/deque store that retains
#: trace ids (plumbing like `obs_exemplars=args.obs_exemplars` or an
#: `exemplars=False` kwarg is not a reservoir)
_EXEMPLAR_DECL_RE = re.compile(
    r"exemplars\s*(?::[^=]+)?=\s*(?:\[|(?:collections\.)?deque\()")

#: how far above a shed raise the audit looks for its emission
_EMIT_WINDOW = 6

#: sanity bound on the exemplar reservoir: big enough to name a tail,
#: small enough that snapshots stay cheap
_EXEMPLAR_LIMIT_MAX = 64


def _code_lines(path: Path):
    """(lineno, source-with-line-comments-stripped) pairs, as the JAX
    package's fault audit reads a file. The stripper is crude (a '#' inside
    a string literal truncates the line): that can only hide a violation
    spelled inside a string, which is not a call site anyway."""
    try:
        text = path.read_text(errors="replace")
    except OSError:
        return
    for lineno, line in enumerate(text.splitlines(), 1):
        if "#" in line:
            line = line.split("#", 1)[0]
        yield lineno, line


def trace_findings(root: str | Path | None = None) -> list[Finding]:
    """TRACE-001/002/003 over the tree (package root by default; tests
    inject seeded-violation fixture trees):

    - TRACE-001: a scheduler shed/breaker raise site with no
      flight-recorder emission in the preceding `_EMIT_WINDOW` code
      lines — a refused request would vanish from the trace record.
    - TRACE-002: terminal-state emission sites must use the known state
      vocabulary, at most once per state per file (each admission path
      emits each of its terminal states at exactly one site), and — on
      the real tree — cover every state in TERMINAL_STATES.
    - TRACE-003: any file declaring an exemplar reservoir must bound it
      via EXEMPLAR_LIMIT, and the limit itself must be a small positive
      literal.
    """
    real_tree = root is None
    base = Path(root) if root is not None \
        else Path(__file__).resolve().parent.parent
    findings: list[Finding] = []
    state_sites: dict[str, list[str]] = {}
    limit_defined = False
    for path in sorted(base.rglob("*.py")):
        rel = path.as_posix()[len(base.as_posix()) + 1:]
        pairs = list(_code_lines(path))
        lines = [ln for _, ln in pairs]
        per_file_states: dict[str, int] = {}
        has_exemplar_decl = False
        refs_limit = False
        for i, (lineno, line) in enumerate(pairs):
            if _SHED_SITE_RE.search(line):
                lookback = lines[max(i - _EMIT_WINDOW, 0): i]
                if not any(_EMIT_RE.search(prev) for prev in lookback):
                    findings.append(Finding(
                        rule="TRACE-001", where=f"{rel}:{lineno}",
                        message="shed/breaker raise with no adjacent "
                               "flight-recorder terminal emission — the "
                               "refused request leaves no trace"))
            m = None
            if _EMIT_RE.search(line):
                # the call may wrap: join the continuation line so
                # `recorder.terminal(\n    req, "state", ...)` still
                # yields its state literal
                window = line if _TERMINAL_RE.search(line) else (
                    line + " " + (lines[i + 1] if i + 1 < len(lines)
                                  else ""))
                m = _TERMINAL_RE.search(window)
                if m is None:
                    findings.append(Finding(
                        rule="TRACE-002", where=f"{rel}:{lineno}",
                        message="terminal emission whose state is not a "
                                "string literal at the call site — span "
                                "coverage must stay statically "
                                "auditable"))
            if m:
                state = m.group(1)
                if state not in TERMINAL_STATES:
                    findings.append(Finding(
                        rule="TRACE-002", where=f"{rel}:{lineno}",
                        message=f"terminal emission uses unknown state "
                               f"{state!r} (vocabulary: "
                               f"{', '.join(TERMINAL_STATES)})"))
                else:
                    per_file_states[state] = \
                        per_file_states.get(state, 0) + 1
                    if per_file_states[state] > 1:
                        findings.append(Finding(
                            rule="TRACE-002", where=f"{rel}:{lineno}",
                            message=f"terminal state {state!r} emitted at "
                                   "more than one site in this file — a "
                                   "request could get two terminal "
                                   "spans"))
                    state_sites.setdefault(state, []).append(
                        f"{rel}:{lineno}")
            if _EXEMPLAR_DECL_RE.search(line):
                has_exemplar_decl = True
            if "EXEMPLAR_LIMIT" in line:
                refs_limit = True
                lm = re.search(r"EXEMPLAR_LIMIT\s*=\s*(\d+)\s*$", line)
                if lm:
                    limit_defined = True
                    val = int(lm.group(1))
                    if not 1 <= val <= _EXEMPLAR_LIMIT_MAX:
                        findings.append(Finding(
                            rule="TRACE-003", where=f"{rel}:{lineno}",
                            message=f"EXEMPLAR_LIMIT {val} outside "
                                   f"[1, {_EXEMPLAR_LIMIT_MAX}]"))
        if has_exemplar_decl and not refs_limit:
            findings.append(Finding(
                rule="TRACE-003", where=rel,
                message="exemplar reservoir declared without an "
                       "EXEMPLAR_LIMIT bound — trace-id retention must "
                       "be bounded"))
    if real_tree:
        missing = [s for s in TERMINAL_STATES if s not in state_sites]
        if missing:
            findings.append(Finding(
                rule="TRACE-002", where="serve",
                message="terminal state(s) with no emission site: "
                       + ", ".join(missing)))
        if not limit_defined:
            findings.append(Finding(
                rule="TRACE-003", where="obs/registry.py",
                message="no EXEMPLAR_LIMIT literal found — the exemplar "
                       "reservoir bound is gone"))
    return sorted(findings, key=lambda f: (f.rule, f.where))
