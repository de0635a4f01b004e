"""Supervised child execution: heartbeat watchdog + signal escalation.

Port of `tpu_matmul_bench/faults/supervisor.py` (stdlib; copied, since the
port imports nothing of the JAX package). Every subprocess the port
launches for real work routes through
`supervised_run` (lint FAULT-001 enforces this statically). It owns the
two failure modes a plain `subprocess.run(timeout=...)` cannot
distinguish or survive cleanly:

- **Deadline**: the child exceeded its wall-clock budget.
- **Stall**: the child is alive but not making progress. Progress is a
  heartbeat file the child touches at every telemetry span open
  (`faults/plan.py` wires `TPU_BENCH_HEARTBEAT_FILE` into the span
  hook), so "stalled" means "no phase boundary crossed for
  `heartbeat_timeout_s`" — a hung collective or a straggler sleeping in
  a fault plan trips it long before the deadline would.

Either trigger walks the escalation ladder: SIGTERM to the child's
process group (it runs in its own session, so grandchildren die too),
a grace period for atexit/span flush, then SIGKILL. The ladder taken is
recorded in the returned `LaunchResult.escalation` and appended to the
job log, so a campaign journal can show *how* a job died, not just that
it did.
"""

from __future__ import annotations

import dataclasses
import os
import shlex
import signal
import subprocess
import time
from pathlib import Path

from tpu_matmul_bench_torch.faults import plan as fault_plan

DEFAULT_TERM_GRACE_S = 5.0
_POLL_S = 0.05

# FAULT-001 allowlist: package-relative files whose subprocess use is
# sanctioned OUTSIDE the supervisor, each with the reason it is exempt.
# Everything else must call supervised_run (or appear here with a
# justification a reviewer can veto).
SPAWN_ALLOWLIST = {
    "faults/supervisor.py":
        "the supervisor itself — every managed spawn bottoms out here",
    "campaign/cli.py":
        "pre-campaign lint gate: short-lived `lint` child that inherits "
        "stdio so the operator sees findings; no workload, self-bounded",
    "utils/telemetry.py":
        "one-shot `git rev-parse` provenance probe with its own 10 s "
        "timeout; runs at manifest build, never inside a workload",
    "benchmarks/compare_benchmarks.py":
        "interactive comparison program predating the campaign executor: "
        "`--isolate` rows stream their report to the console with a "
        "per-row deadline, and a short backend probe child keeps the "
        "parent off the card; foreground only",
    "multihost.py":
        "the multi-process launcher (torchrun's role): the processes of "
        "one process group, process 0 in the foreground, the others "
        "reaped with TERM then KILL when it fails; a launcher, not a "
        "workload",
    "ops/_build.py":
        "the kernel build: one nvcc a unit of a source, all started "
        "together and awaited, then one link a source, plus the demangler "
        "over ptxas's kernel names; a compiler, not a workload",
    "bench.py":
        "the headline entry's ladder: each `matmul` attempt a child with "
        "a soft deadline, killed on overrun; the root bench.py's "
        "JSON-line contract",
    "tune/head_to_head.py":
        "the head-to-head's children (torch, cuda, cuda, torch a "
        "problem), each bounded by CHILD_TIMEOUT_S; an offline "
        "measurement script, run by hand on the card",
}


@dataclasses.dataclass
class LaunchResult:
    """What happened to a launched child (moved here from
    campaign/executor.py, which re-exports it).

    rc is the exit status (negative = died by signal), or None when the
    supervisor killed it (timeout/stall) or the spawn itself failed.
    `escalation` records the ladder taken: "" (exited on its own),
    "SIGTERM" (died within grace), or "SIGTERM+SIGKILL".
    """

    rc: int | None
    timed_out: bool = False
    error: str = ""
    escalation: str = ""


def heartbeat_path(log_path: str | os.PathLike[str]) -> Path:
    """Default heartbeat file paired with a job log (jobs/x.log ->
    x.log.hb). Callers that keep their logs under version control
    should pass `supervised_run(..., heartbeat=...)` pointing at
    scratch state instead — heartbeats are runtime liveness signals,
    not artifacts."""
    p = Path(log_path)
    return p.with_name(p.name + ".hb")


def _signal_group(proc: subprocess.Popen, sig: int) -> None:
    try:
        os.killpg(os.getpgid(proc.pid), sig)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            pass


def supervised_run(
    cmd,
    *,
    log_path: str | os.PathLike[str],
    timeout_s: float | None = None,
    env: dict | None = None,
    heartbeat_timeout_s: float | None = None,
    heartbeat: str | os.PathLike[str] | None = None,
    term_grace_s: float = DEFAULT_TERM_GRACE_S,
) -> LaunchResult:
    """Run `cmd` under supervision, appending its output to `log_path`.

    The child gets its own session (process group) and a heartbeat file
    injected via TPU_BENCH_HEARTBEAT_FILE; the supervisor touches it at
    spawn so the stall clock starts at launch, covering children that
    die before their first span. Returns a LaunchResult mirroring the
    historical executor contract: rc=None + timed_out=True for any
    supervisor-initiated kill (deadline or stall), rc=None + error for
    a failed spawn.
    """
    log = Path(log_path)
    log.parent.mkdir(parents=True, exist_ok=True)
    hb = Path(heartbeat) if heartbeat is not None else heartbeat_path(log)
    hb.parent.mkdir(parents=True, exist_ok=True)
    run_env = dict(os.environ if env is None else env)
    run_env[fault_plan.HEARTBEAT_ENV] = str(hb)
    with open(log, "a") as fh:
        fh.write(f"+ {shlex.join(str(c) for c in cmd)}\n")
        fh.flush()
        hb.touch()
        try:
            proc = subprocess.Popen(
                [str(c) for c in cmd],
                stdout=fh,
                stderr=subprocess.STDOUT,
                env=run_env,
                start_new_session=True,
            )
        except OSError as e:
            fh.write(f"! supervisor: spawn failed: {e}\n")
            return LaunchResult(rc=None, error=f"spawn failed: {e}")

        start = time.monotonic()
        why = ""
        while True:
            rc = proc.poll()
            if rc is not None:
                return LaunchResult(rc=rc)
            now = time.monotonic()
            if timeout_s is not None and now - start > timeout_s:
                why = f"deadline {timeout_s:g}s exceeded"
                break
            if heartbeat_timeout_s:
                try:
                    age = time.time() - os.stat(hb).st_mtime
                except OSError:
                    age = now - start
                if age > heartbeat_timeout_s:
                    why = (f"heartbeat stale for {age:.1f}s "
                           f"(limit {heartbeat_timeout_s:g}s)")
                    break
            time.sleep(_POLL_S)

        # Escalation ladder: TERM the group, grace, KILL the group.
        fh.write(f"! supervisor: {why}; sending SIGTERM\n")
        fh.flush()
        escalation = "SIGTERM"
        _signal_group(proc, signal.SIGTERM)
        try:
            proc.wait(timeout=term_grace_s)
        except subprocess.TimeoutExpired:
            escalation = "SIGTERM+SIGKILL"
            fh.write("! supervisor: grace expired; sending SIGKILL\n")
            fh.flush()
            _signal_group(proc, signal.SIGKILL)
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass
        return LaunchResult(
            rc=None, timed_out=True, error=why, escalation=escalation)
