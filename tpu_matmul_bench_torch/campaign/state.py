"""Crash-safe campaign job journal (JSONL, append-only, fsync-per-line).

Port of `tpu_matmul_bench/campaign/state.py` (stdlib; copied): the same
event lines, byte for byte, so either package reads the other's journal.

A measurement round that loses its machine mid-sweep must resume where
it stopped; this journal is what makes that possible. Every job status transition is one appended JSON line —
pending → running(attempt) → done | failed | skipped — flushed AND
fsynced before the executor proceeds (same durability contract as
`reporting.JsonWriter`), so a SIGKILLed campaign loses at most the
in-flight job: its last journaled state is `running`, which resume
treats as unfinished and re-runs.

Readers tolerate a truncated final line (the half-written record of the
very kill the journal exists to survive) and unknown keys, so the format
can grow without orphaning old campaign dirs.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import time
from pathlib import Path
from typing import Any, IO

from tpu_matmul_bench_torch.utils.durable import repair_torn_tail

JOURNAL_NAME = "journal.jsonl"

PENDING = "pending"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
SKIPPED = "skipped"

STATUSES = (PENDING, RUNNING, DONE, FAILED, SKIPPED)


@dataclasses.dataclass(frozen=True)
class JobEvent:
    """One journaled status transition."""

    fingerprint: str
    job_id: str
    status: str
    attempt: int = 0
    rc: int | None = None
    detail: str = ""
    ts: float = 0.0

    def to_json(self) -> str:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if v not in (None, "", 0) or k in ("fingerprint", "job_id",
                                                "status", "ts")}
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "JobEvent":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


class Journal:
    """Append-only writer over the campaign's journal.jsonl."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        # a crash mid-append can leave a torn (newline-less) final line;
        # appending after it would splice the next event onto the torn
        # half-record — truncate back to the last complete line first
        repair_torn_tail(self.path)
        self._fh: IO[str] = open(self.path, "a")

    def record(self, fingerprint: str, job_id: str, status: str, *,
               attempt: int = 0, rc: int | None = None,
               detail: str = "") -> JobEvent:
        if status not in STATUSES:
            raise ValueError(f"unknown journal status {status!r}")
        ev = JobEvent(fingerprint=fingerprint, job_id=job_id, status=status,
                      attempt=attempt, rc=rc, detail=detail,
                      ts=round(time.time(), 3))
        self._fh.write(ev.to_json() + "\n")
        self._fh.flush()
        try:
            os.fsync(self._fh.fileno())
        except (AttributeError, OSError, ValueError,
                io.UnsupportedOperation):
            pass  # captured/odd streams: flush is the best we can do
        return ev

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def load_events(campaign_dir: str | Path) -> list[JobEvent]:
    """All journal events, oldest first. Missing journal → empty (a fresh
    campaign dir). Unparseable lines — including the torn final line a
    kill can leave — are skipped, not fatal: the journal is evidence."""
    path = Path(campaign_dir) / JOURNAL_NAME
    if not path.exists():
        return []
    events: list[JobEvent] = []
    for line in path.read_text().splitlines():
        try:
            d = json.loads(line)
        except ValueError:
            continue
        if isinstance(d, dict) and {"fingerprint", "status"} <= d.keys():
            events.append(JobEvent.from_dict(d))
    return events


def latest_status(events: list[JobEvent]) -> dict[str, JobEvent]:
    """Fingerprint → its most recent event (journal order = time order)."""
    latest: dict[str, JobEvent] = {}
    for ev in events:
        latest[ev.fingerprint] = ev
    return latest


def finished_fingerprints(events: list[JobEvent]) -> set[str]:
    """Fingerprints that ever reached `done`. A job never un-completes,
    so membership here — not the latest event — is the resume criterion:
    a later `skipped` note must not make a completed job look unfinished."""
    return {ev.fingerprint for ev in events if ev.status == DONE}
