"""Run-context propagation: run ids across process trees + trace merging.

A copy of `tpu_matmul_bench/obs/context.py` (stdlib only): the port
imports nothing of the JAX package.

Every entrypoint gets a `RunContext` minted lazily on first use: a fresh
``run_id`` for this process and the spawning run's id as
``parent_run_id`` when the environment carries one. The campaign
executor exports its own run_id to children via ``TPU_BENCH_PARENT_RUN_ID``
(`child_env`), and `utils.telemetry.build_manifest` stamps
`trace_block()` into every schema-v2 manifest — so each job ledger in a
campaign directory names the campaign run that produced it, and a
resumed campaign's jobs name the resume's run.

The second half is the timeline merger: each campaign child writes its
own Chrome trace (incrementally fsynced — see `telemetry.session`), and
`merge_chrome_traces` folds those per-job files into one Perfetto
timeline: one pid per job, events offset to the campaign clock, with
``process_name`` metadata so the viewer labels rows by job id. It reads
both complete Chrome-trace JSON and the event-per-line partial form a
SIGKILLed child leaves behind — partial jobs still show their finished
phases.

stdlib-only by design: imported from `utils.telemetry` (which must stay
importable without the rest of obs) and from the backend-free campaign
parent.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import uuid
from pathlib import Path
from typing import Any, Mapping, Sequence

ENV_RUN_ID = "TPU_BENCH_RUN_ID"
ENV_PARENT_RUN_ID = "TPU_BENCH_PARENT_RUN_ID"


@dataclasses.dataclass(frozen=True)
class RunContext:
    """This process's identity in a run tree."""

    run_id: str
    parent_run_id: str | None
    pid: int


_CURRENT: RunContext | None = None
_LOCK = threading.Lock()


def mint_run_id() -> str:
    return uuid.uuid4().hex[:12]


def current() -> RunContext:
    """The process's run context, minted once. ``TPU_BENCH_RUN_ID`` in
    the environment pins the run_id (a spawner that wants the child to
    *be* a specific run, e.g. tests); ``TPU_BENCH_PARENT_RUN_ID`` names
    the spawning run (what `child_env` sets for campaign children)."""
    global _CURRENT
    with _LOCK:
        if _CURRENT is None:
            _CURRENT = RunContext(
                run_id=os.environ.get(ENV_RUN_ID) or mint_run_id(),
                parent_run_id=os.environ.get(ENV_PARENT_RUN_ID) or None,
                pid=os.getpid(),
            )
        return _CURRENT


def reset_context() -> None:
    """Forget the cached context (test hygiene; a fork would also want
    this, but campaign children are fresh interpreters)."""
    global _CURRENT
    with _LOCK:
        _CURRENT = None


def child_env(env: Mapping[str, str] | None = None) -> dict[str, str]:
    """Environment for a spawned child run: this run becomes the child's
    parent, and any pinned run_id is dropped so the child mints its own
    (two children sharing one run_id would be indistinguishable in the
    merged timeline)."""
    out = dict(os.environ if env is None else env)
    out[ENV_PARENT_RUN_ID] = current().run_id
    out.pop(ENV_RUN_ID, None)
    return out


def trace_block() -> dict[str, Any]:
    """The manifest's ``trace`` block (additive, schema v2)."""
    ctx = current()
    block: dict[str, Any] = {"run_id": ctx.run_id, "pid": ctx.pid}
    if ctx.parent_run_id:
        block["parent_run_id"] = ctx.parent_run_id
    return block


def load_trace_events(path: str | Path) -> list[dict[str, Any]]:
    """Events from a Chrome trace file — complete JSON
    (``{"traceEvents": [...]}``, a clean exit) or event-per-line JSONL
    (the incremental partial a killed process leaves). A torn final
    line is skipped, not fatal: partial traces are evidence."""
    try:
        text = Path(path).read_text()
    except OSError:
        return []
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if isinstance(events, list):
            return [e for e in events if isinstance(e, dict)]
        # a one-event partial parses as a bare dict, not a JSONL stream
        return [doc] if "ph" in doc else []
    if isinstance(doc, list):
        return [e for e in doc if isinstance(e, dict)]
    events = []
    for line in text.splitlines():
        try:
            e = json.loads(line)
        except ValueError:
            continue
        if isinstance(e, dict) and "ph" in e:
            events.append(e)
    return events


def merge_chrome_traces(
    sources: Sequence[tuple[str, str | Path, float]],
) -> dict[str, Any]:
    """One Perfetto timeline from per-job traces.

    `sources` is ``(label, path, offset_us)`` per job: events keep their
    in-job timestamps shifted by the job's start offset on the shared
    campaign clock, and each job gets its own pid (labeled via a
    ``process_name`` metadata event) so rows group by job, not by the
    children's real — meaningless across hosts — os pids."""
    merged: list[dict[str, Any]] = []
    for i, (label, path, offset_us) in enumerate(sources, start=1):
        events = load_trace_events(path)
        if not events:
            continue
        merged.append({"name": "process_name", "ph": "M", "pid": i,
                       "args": {"name": label}})
        for e in events:
            if e.get("ph") == "M":
                continue  # per-job metadata is superseded by ours
            out = dict(e)
            out["pid"] = i
            out["ts"] = round(float(e.get("ts", 0.0)) + offset_us, 3)
            merged.append(out)
    return {"displayTimeUnit": "ms", "traceEvents": merged}
