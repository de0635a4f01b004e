"""Campaign executor: each job is a child process of a program CLI.

Port of `tpu_matmul_bench/campaign/executor.py`. Each job runs as
`python -m tpu_matmul_bench_torch <program> ...` with a per-job timeout
(the supervisor's deadline and, where a job opts in, its heartbeat
watchdog), bounded exponential-backoff retries, transport-error
classification via `utils/errors.py` (a dropped transport gets the long
backoff; retrying instantly re-fails), and a journaled status transition
per attempt so `--resume` re-runs only unfinished fingerprints.

Each job's `--json-out` schema-v2 ledger lands at
``<campaign_dir>/jobs/<job_id>.jsonl`` and its merged stdout+stderr at
``jobs/<job_id>.log``. Success requires BOTH rc == 0 AND at least one
measurement record in the ledger: a clean exit with an empty ledger reads
as a failure here, not a completed job.

The campaign parent never initializes CUDA: the children own the card
(the same reason `compare --isolate` keeps its parent off the device).
What the children share is the kernel build directory
(`ops/_build.BUILD_DIR`, `build/kernels/` in the checkout, each library
written atomically): the first child that needs a kernel builds it, and
every later child, a retry included, loads it without running nvcc.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, Mapping

from tpu_matmul_bench_torch.campaign import state
from tpu_matmul_bench_torch.campaign.spec import CampaignSpec, Job
from tpu_matmul_bench_torch.faults.retry import (  # noqa: F401  (re-exports)
    BACKOFF_CAP_S,
    TRANSPORT_MIN_BACKOFF_S,
    RetryPolicy,
)
from tpu_matmul_bench_torch.faults.supervisor import LaunchResult, supervised_run
from tpu_matmul_bench_torch.obs import context as obs_context
from tpu_matmul_bench_torch.obs.registry import get_registry
from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils import errors as _errors
from tpu_matmul_bench_torch.utils.errors import is_transport_message

JOBS_SUBDIR = "jobs"
SPEC_COPY_NAME = "spec.json"
OBS_SUBDIR = "obs"
MERGED_TRACE_NAME = "trace.json"

# how many trailing log bytes the failure classifier reads
_LOG_TAIL_BYTES = 64 * 1024


@dataclasses.dataclass
class JobOutcome:
    job: Job
    status: str  # state.DONE / state.FAILED / state.SKIPPED
    attempts: int
    ledger: Path
    detail: str = ""


def job_paths(campaign_dir: str | Path, job: Job) -> tuple[Path, Path]:
    """(ledger, log) paths for a job inside the campaign directory."""
    jobs = Path(campaign_dir) / JOBS_SUBDIR
    return jobs / f"{job.job_id}.jsonl", jobs / f"{job.job_id}.log"


def job_trace_path(campaign_dir: str | Path, job: Job) -> Path:
    """The per-job Chrome trace the child writes (incrementally fsynced
    via telemetry's span sink) and the campaign merger reads."""
    return Path(campaign_dir) / JOBS_SUBDIR / f"{job.job_id}.trace.json"


def job_command(job: Job, campaign_dir: str | Path,
                ledger: Path) -> list[str]:
    """The child argv: the program CLI with the per-job ledger and trace
    injected. `{dir}` placeholders resolve here — after fingerprinting."""
    argv = [a.replace("{dir}", str(campaign_dir)) for a in job.argv]
    return [sys.executable, "-m", "tpu_matmul_bench_torch", job.program,
            *argv, "--json-out", str(ledger),
            "--trace-out", str(job_trace_path(campaign_dir, job))]


def _default_launch(cmd: list[str], *, log: Path, timeout_s: float,
                    env: Mapping[str, str] | None,
                    heartbeat_timeout_s: float | None = None) -> LaunchResult:
    """Production launch: the supervisor owns the child — deadline AND
    heartbeat-stall escalation (SIGTERM, grace, SIGKILL to the process
    group), with the ladder recorded in the job log.

    The heartbeat file lives under ``<campaign>/.state/hb/`` (scratch
    state, gitignored) rather than as a ``.log.hb`` sibling — campaign
    job dirs are committed, and liveness signals are not artifacts."""
    return supervised_run(
        cmd, log_path=log, timeout_s=timeout_s or None,
        env=dict(env) if env is not None else None,
        heartbeat_timeout_s=heartbeat_timeout_s,
        heartbeat=log.parent.parent / ".state" / "hb" / f"{log.name}.hb")


def ledger_measurement_count(ledger: Path) -> int:
    """Measurement records in a job ledger (manifest header excluded)."""
    if not ledger.exists():
        return 0
    n = 0
    for line in ledger.read_text().splitlines():
        try:
            d = json.loads(line)
        except ValueError:
            continue
        if isinstance(d, dict) and not telemetry.is_manifest(d) \
                and "benchmark" in d:
            n += 1
    return n


def _classify_failure(result: LaunchResult, log: Path) -> str:
    """'timeout' | 'transport' | 'error' — drives the backoff policy."""
    if result.timed_out:
        return "timeout"
    if result.error:
        return "error"
    try:
        with open(log, "rb") as fh:
            fh.seek(0, 2)
            fh.seek(max(0, fh.tell() - _LOG_TAIL_BYTES))
            tail = fh.read().decode(errors="replace")
    except OSError:
        tail = ""
    if is_transport_message(tail):
        return "transport"
    # non-transport transients (OOM, ENOSPC, injected chaos) retry on
    # the plain exponential — no re-rendezvous floor
    return "transient" if _errors.classify(tail) == _errors.TRANSIENT \
        else "error"


def backoff_delay(job: Job, attempt: int, kind: str) -> float:
    """Exponential backoff before attempt N+1: base · 2^(N−1), capped;
    transport failures take at least the transport floor. The
    schedule itself lives in faults/retry.py (the unified policy)."""
    return RetryPolicy(base_s=job.backoff_s).delay(attempt, kind)


def _campaign_env(env: Mapping[str, str] | None) -> dict[str, str] | None:
    """The children's environment: the campaign's run context
    (`TPU_BENCH_PARENT_RUN_ID`, so each job manifest's `trace` block names
    the campaign run that produced it), and the repo root on PYTHONPATH so
    `python -m tpu_matmul_bench_torch` resolves in the child from any
    working directory (the package runs uninstalled from the checkout).
    The kernel build directory needs no variable: it sits at a fixed place
    in the checkout the children import (`ops/_build.BUILD_DIR`)."""
    import os

    out = dict(os.environ if env is None else env)
    out = obs_context.child_env(out)
    pkg_root = str(Path(__file__).resolve().parents[2])
    parts = out.get("PYTHONPATH", "").split(os.pathsep)
    if pkg_root not in parts:
        out["PYTHONPATH"] = os.pathsep.join([pkg_root] + [p for p in parts if p])
    return out


def prepare_campaign_dir(spec: CampaignSpec, campaign_dir: str | Path, *,
                         resume: bool) -> Path:
    """Create the directory layout and persist the canonical spec copy.
    A fresh `run` refuses a directory that already has a journal (that is
    what `--resume`/`resume` are for — never silently restart a half-done
    campaign); `resume` reuses the persisted spec copy byte-for-byte."""
    d = Path(campaign_dir)
    journal = d / state.JOURNAL_NAME
    if journal.exists() and not resume:
        raise RuntimeError(
            f"{d} already holds a campaign journal; use "
            f"`campaign resume {d}` (or run --resume) to continue it")
    (d / JOBS_SUBDIR).mkdir(parents=True, exist_ok=True)
    spec_copy = d / SPEC_COPY_NAME
    if not spec_copy.exists():
        spec_copy.write_text(spec.to_json() + "\n")
    return d


def run_campaign(
    spec: CampaignSpec,
    campaign_dir: str | Path,
    *,
    resume: bool = False,
    env: Mapping[str, str] | None = None,
    launch: Callable[..., LaunchResult] | None = None,
    sleep: Callable[[float], Any] = time.sleep,
) -> list[JobOutcome]:
    """Run every unfinished job in the plan, journaling each transition.

    `launch` and `sleep` are injectable for tests (fault injection,
    backoff assertions); production uses subprocess + time.sleep.
    """
    d = prepare_campaign_dir(spec, campaign_dir, resume=resume)
    launch = launch or _default_launch
    env = _campaign_env(env)
    done_fps = state.finished_fingerprints(state.load_events(d))
    outcomes: list[JobOutcome] = []

    reg = get_registry()
    jobs_done = {s: reg.counter("campaign_jobs_total", status=s)
                 for s in (state.DONE, state.FAILED, state.SKIPPED)}
    retries = reg.counter("campaign_job_retries_total")

    from tpu_matmul_bench_torch.obs.export import SnapshotExporter

    with state.Journal(d / state.JOURNAL_NAME) as journal, \
            SnapshotExporter(d / OBS_SUBDIR):
        # roster first: a kill during job 1 must still leave the full
        # plan visible to `status` (pending = journaled, not implicit)
        for job in spec.jobs:
            if job.fingerprint not in done_fps:
                journal.record(job.fingerprint, job.job_id, state.PENDING)

        for job in spec.jobs:
            ledger, log = job_paths(d, job)
            if job.fingerprint in done_fps:
                journal.record(job.fingerprint, job.job_id, state.SKIPPED,
                               detail="resume: already done")
                jobs_done[state.SKIPPED].inc()
                outcomes.append(JobOutcome(job, state.SKIPPED, 0, ledger,
                                           "already done"))
                continue
            outcome = _run_one(job, d, ledger, log, journal,
                               launch=launch, env=env, sleep=sleep,
                               retries_counter=retries)
            jobs_done[outcome.status].inc()
            outcomes.append(outcome)
    merge_campaign_trace(d)
    return outcomes


def merge_campaign_trace(campaign_dir: str | Path) -> Path | None:
    """Merge every job's Chrome trace into one campaign-level timeline.

    Jobs run sequentially, each with its own µs-zero clock; the journal's
    last RUNNING timestamp per job is the wall-clock anchor that places
    each job's spans on a shared axis (offset from the earliest start).
    A killed child's trace is the incrementally-fsynced JSONL form —
    `merge_chrome_traces` reads it as-is, so partial jobs still appear.
    Returns the merged trace path, or None when no job wrote a trace.
    """
    d = Path(campaign_dir)
    starts: dict[str, float] = {}  # job_id -> last RUNNING wall ts
    for ev in state.load_events(d):
        if ev.status == state.RUNNING:
            starts[ev.job_id] = ev.ts
    sources = []
    for job_id, ts in sorted(starts.items(), key=lambda kv: kv[1]):
        path = d / JOBS_SUBDIR / f"{job_id}.trace.json"
        if path.exists():
            sources.append((job_id, path, ts))
    if not sources:
        return None
    epoch = min(ts for _, _, ts in sources)
    merged = obs_context.merge_chrome_traces(
        [(job_id, path, (ts - epoch) * 1e6)
         for job_id, path, ts in sources])
    out = d / MERGED_TRACE_NAME
    out.write_text(json.dumps(merged) + "\n")
    return out


def _run_one(job: Job, d: Path, ledger: Path, log: Path,
             journal: state.Journal, *, launch, env, sleep,
             retries_counter=None) -> JobOutcome:
    cmd = job_command(job, d, ledger)
    max_attempts = job.retries + 1
    detail = ""
    for attempt in range(1, max_attempts + 1):
        journal.record(job.fingerprint, job.job_id, state.RUNNING,
                       attempt=attempt)
        with telemetry.span(f"job:{job.job_id}", attempt=attempt,
                            program=job.program):
            # a retried job's ledger must not splice two half-runs: the
            # child reopens --json-out in "w" mode, but a timeout-killed
            # attempt may have left a partial file a later VALID attempt
            # would sit after — unlink so the ledger is one run's output
            ledger.unlink(missing_ok=True)
            # the heartbeat kwarg rides only when the job opts in, so
            # injected test launchers keep the historical 4-arg protocol
            extra = {}
            if getattr(job, "heartbeat_s", 0):
                extra["heartbeat_timeout_s"] = job.heartbeat_s
            result = launch(cmd, log=log, timeout_s=job.timeout_s, env=env,
                            **extra)
        if result.rc == 0:
            n = ledger_measurement_count(ledger)
            if n > 0:
                journal.record(job.fingerprint, job.job_id, state.DONE,
                               attempt=attempt, rc=0,
                               detail=f"{n} records")
                return JobOutcome(job, state.DONE, attempt, ledger)
            # rc==0 with no results: a clean exit that measured nothing
            kind = "error"
            detail = "rc=0 but ledger has no measurement records"
        else:
            kind = _classify_failure(result, log)
            detail = result.error or kind
        if attempt < max_attempts:
            delay = backoff_delay(job, attempt, kind)
            journal.record(job.fingerprint, job.job_id, state.RUNNING,
                           attempt=attempt, rc=result.rc,
                           detail=f"retry in {delay:.0f}s: {detail}")
            if retries_counter is not None:
                retries_counter.inc()
            sleep(delay)
    journal.record(job.fingerprint, job.job_id, state.FAILED,
                   attempt=max_attempts, rc=result.rc, detail=detail)
    return JobOutcome(job, state.FAILED, max_attempts, ledger, detail)
