"""Crash-consistency certification + the FAULT-001/002 static audits.

Port of `tpu_matmul_bench/faults/audit.py`: the same chaos matrix
(`specs/chaos.toml`), cells, verdicts and verdict ledger, over the port's
workloads and writers, with children spawned as `python -m
tpu_matmul_bench_torch`. The serve cell runs `serve selftest` on the card
unless the audit is asked for the CPU (`device="cpu"`).

The certifier's contract: for every fault class in the
committed chaos matrix (`specs/chaos.toml`), run the target subsystem's
workload **fault-free** and **faulted-then-resumed**, and the durable
artifacts must converge to semantically identical final state — no
duplicated units, no lost units, no torn tail, and every intermediate
(post-crash, pre-resume) artifact readable by the repo's own
torn-tolerant readers. A durability story that only survives the crashes
its unit tests thought of is a story; this runs the crashes.

Two static audits ride along (the `lint` program's `faults` group runs
them too):

- **FAULT-001** — a subprocess spawn site outside
  `faults/supervisor.supervised_run` and not on its `SPAWN_ALLOWLIST`.
  An unsupervised child escapes the heartbeat watchdog and the
  SIGTERM→grace→SIGKILL escalation ladder.
- **FAULT-002** — a durable-writer fsync site not registered in
  `WRITER_REGISTRY` below. The certifier can only certify artifacts it
  knows exist; an unregistered fsync site is a durability claim nobody
  is testing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import time
from pathlib import Path
from typing import Any, Callable

from tpu_matmul_bench_torch.faults.plan import (
    FAULT_PLAN_ENV,
    FAULT_SCOPE_ENV,
    HEARTBEAT_ENV,
    FaultPlan,
    FaultPlanError,
    FaultSpec,
)
from tpu_matmul_bench_torch.faults.supervisor import SPAWN_ALLOWLIST, supervised_run
from tpu_matmul_bench_torch.faults.workloads import (
    DEFAULT_UNITS,
    LEDGER_SPAN,
    OBS_PROGRESS_GAUGE,
    OBS_SPAN,
    TUNE_SPAN,
    obs_progress,
)

AUDIT_RECORD_TYPE = "fault_audit"
AUDIT_LEDGER_NAME = "fault_audit.jsonl"

#: FAULT-002 registry: every package file that fsyncs a durable artifact,
#: with the artifact it owns. The certifier's extractors cover exactly
#: these writers; registering here without an extractor is reviewable in
#: one place. Keys are package-relative paths.
WRITER_REGISTRY: dict[str, str] = {
    "campaign/state.py":
        "campaign job journal (journal.jsonl): status transitions, "
        "certified by the campaign chaos cells",
    "tune/db.py":
        "tuning DB (tune_db.jsonl): measured/analytic cells, certified "
        "by the tune chaos cells",
    "tune/artifacts.py":
        "kernel-library store (build/artifacts): content-addressed "
        "libraries + fsync'd exec_artifact manifest; torn tails "
        "tolerated on load, libraries digest-verified on read",
    "obs/export.py":
        "obs snapshot stream (obs_snapshot.jsonl), certified by the obs "
        "chaos cells",
    "obs/history.py":
        "perf-observatory metric-history store "
        "(measurements/torch/history.jsonl): fingerprint-keyed time-series "
        "points, append-only last-wins, torn-tail fuzzed in test_faults",
    "utils/reporting.py":
        "schema-v2 measurement ledgers (JsonWriter), certified by the "
        "ledger and serve chaos cells",
    "utils/telemetry.py":
        "incremental Chrome-trace span sink: best-effort evidence, "
        "readable-after-kill is its whole contract",
    "utils/durable.py":
        "repair_torn_tail's truncation fsync — the repair half of every "
        "writer above",
    "faults/audit.py":
        "the certifier's own verdict ledger (fault_audit.jsonl)",
}

# Spawn sites: any callable that creates a child process. The pattern is
# built so its own source text does not trip the scan (escapes between
# the module and attribute names).
_SPAWN_RE = re.compile(
    r"\b(?:subprocess\s*\.\s*(?:run|Popen|call|check_call|check_output)"
    r"|os\s*\.\s*(?:system|popen|spawn\w*|exec[lv]\w*|posix_spawn\w*))"
    r"\s*\(")
_FSYNC_RE = re.compile(r"\bos\s*\.\s*fsync\s*\(")


def _package_root() -> Path:
    return Path(__file__).resolve().parents[1]


def _code_lines(path: Path):
    """(lineno, source-with-line-comments-stripped) pairs. The stripper
    is crude (a '#' inside a string literal truncates the line) — that
    can only hide a violation spelled inside a string, which is not a
    call site anyway."""
    try:
        text = path.read_text(errors="replace")
    except OSError:
        return
    for lineno, line in enumerate(text.splitlines(), 1):
        if "#" in line:
            line = line.split("#", 1)[0]
        yield lineno, line


def static_findings(root: str | Path | None = None, *,
                    spawn_allowlist: dict[str, str] | None = None,
                    writer_registry: dict[str, str] | None = None):
    """FAULT-001/002 findings over every .py under `root` (default: the
    installed package). `root`/allowlist/registry are injectable so
    tests can pin the rule IDs against seeded-violation fixtures."""
    from tpu_matmul_bench_torch.analysis.findings import Finding

    base = Path(root) if root is not None else _package_root()
    allow = SPAWN_ALLOWLIST if spawn_allowlist is None else spawn_allowlist
    registry = WRITER_REGISTRY if writer_registry is None else writer_registry
    findings: list[Finding] = []
    fsync_files: set[str] = set()
    for path in sorted(base.rglob("*.py")):
        rel = path.relative_to(base).as_posix()
        for lineno, line in _code_lines(path):
            if _SPAWN_RE.search(line) and rel not in allow:
                findings.append(Finding(
                    rule="FAULT-001",
                    where=f"{rel}:{lineno}",
                    message=(
                        "unsupervised subprocess spawn: route it through "
                        "faults/supervisor.supervised_run or add the file "
                        "to SPAWN_ALLOWLIST with a reason"),
                    details={"line": line.strip()[:160]}))
            if _FSYNC_RE.search(line):
                fsync_files.add(rel)
                if rel not in registry:
                    findings.append(Finding(
                        rule="FAULT-002",
                        where=f"{rel}:{lineno}",
                        message=(
                            "unregistered durable writer: this fsync site "
                            "is not in faults/audit.WRITER_REGISTRY, so no "
                            "chaos cell certifies its crash consistency"),
                        details={"line": line.strip()[:160]}))
    # the registry must not rot either: an entry whose file no longer
    # fsyncs (or no longer exists) claims certification coverage for a
    # writer that is gone
    for rel, reason in sorted(registry.items()):
        if rel not in fsync_files:
            findings.append(Finding(
                rule="FAULT-002",
                where=rel,
                message=(
                    "stale WRITER_REGISTRY entry: file no longer contains "
                    "an fsync site (or was removed) — drop the entry or "
                    "restore the writer"),
                details={"registered_reason": reason}))
    return findings


# ---------------------------------------------------------------------------
# chaos matrix spec (specs/chaos.toml)

SUBSYSTEMS = ("campaign", "ledger", "tune", "obs", "serve")

#: default injection phase per subsystem — the span its workload emits
DEFAULT_PHASE = {
    "campaign": LEDGER_SPAN,  # campaign cells run the ledger workload
    "ledger": LEDGER_SPAN,
    "tune": TUNE_SPAN,
    "obs": OBS_SPAN,
    "serve": "serve:batch",
}

_CELL_KEYS = {"fault", "subsystem", "phase", "occurrence", "delay_ms",
              "glob", "errclass", "retries", "timeout_s", "heartbeat_s",
              "units"}


@dataclasses.dataclass(frozen=True)
class ChaosCell:
    """One certification cell: a fault class aimed at one subsystem."""

    fault: str
    subsystem: str
    phase: str = ""  # default: the subsystem's workload span
    occurrence: int = 1
    delay_ms: float = 0.0
    glob: str = ""
    errclass: str = "runtime"
    retries: int = 1  # campaign cells: retry budget under the fault
    timeout_s: float = 180.0
    heartbeat_s: float = 0.0  # >0 arms the supervisor's stall watchdog
    units: int = DEFAULT_UNITS

    @property
    def span(self) -> str:
        return self.phase or DEFAULT_PHASE[self.subsystem]

    def label(self, idx: int) -> str:
        return f"{idx:02d}_{self.fault}_{self.subsystem}"

    def fault_spec(self) -> FaultSpec:
        spec = FaultSpec(kind=self.fault, phase=self.span,
                         occurrence=self.occurrence, delay_ms=self.delay_ms,
                         glob=self.glob, errclass=self.errclass)
        spec.validate()
        return spec

    def validate(self) -> None:
        if self.subsystem not in SUBSYSTEMS:
            raise FaultPlanError(
                f"unknown subsystem {self.subsystem!r} "
                f"(want one of {SUBSYSTEMS})")
        if self.retries < 0 or self.timeout_s <= 0 or self.units < 2:
            raise FaultPlanError(
                f"bad cell policy: retries={self.retries} "
                f"timeout_s={self.timeout_s} units={self.units} "
                "(units >= 2 so a mid-run fault leaves partial state)")
        if self.fault == "hang" and self.heartbeat_s <= 0 \
                and self.subsystem == "campaign":
            raise FaultPlanError(
                "a campaign hang cell needs heartbeat_s > 0 — without the "
                "stall watchdog the cell just burns its whole deadline")
        self.fault_spec()


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    seed: int
    cells: tuple[ChaosCell, ...]


def _cell_from_fields(fields: dict, where: str) -> ChaosCell:
    unknown = set(fields) - _CELL_KEYS
    if unknown:
        raise FaultPlanError(f"{where}: unknown keys {sorted(unknown)}")
    for key in ("fault", "subsystem"):
        if key not in fields:
            raise FaultPlanError(f"{where}: missing {key!r}")
    try:
        cell = ChaosCell(
            fault=str(fields["fault"]),
            subsystem=str(fields["subsystem"]),
            phase=str(fields.get("phase", "")),
            occurrence=int(fields.get("occurrence", 1)),
            delay_ms=float(fields.get("delay_ms", 0.0)),
            glob=str(fields.get("glob", "")),
            errclass=str(fields.get("errclass", "runtime")),
            retries=int(fields.get("retries", 1)),
            timeout_s=float(fields.get("timeout_s", 180.0)),
            heartbeat_s=float(fields.get("heartbeat_s", 0.0)),
            units=int(fields.get("units", DEFAULT_UNITS)),
        )
    except (TypeError, ValueError) as e:
        raise FaultPlanError(f"{where}: {e}") from e
    cell.validate()
    return cell


def chaos_from_dict(data: dict, where: str = "<chaos>") -> ChaosSpec:
    chaos = data.get("chaos")
    if not isinstance(chaos, dict):
        raise FaultPlanError(f"{where}: want a [chaos] root table")
    unknown = set(chaos) - {"seed", "cell"}
    if unknown:
        raise FaultPlanError(f"{where}: unknown [chaos] keys "
                             f"{sorted(unknown)}")
    raw = chaos.get("cell")
    if not isinstance(raw, list) or not raw:
        raise FaultPlanError(f"{where}: want a non-empty [[chaos.cell]] "
                             "array")
    cells = tuple(
        _cell_from_fields(dict(c), f"{where}:chaos.cell[{i}]")
        for i, c in enumerate(raw))
    return ChaosSpec(seed=int(chaos.get("seed", 0)), cells=cells)


def load_chaos_spec(path: str | Path) -> ChaosSpec:
    from tpu_matmul_bench_torch.campaign.spec import _parse_toml

    return chaos_from_dict(_parse_toml(Path(path).read_text()),
                           where=str(path))


def lint_chaos_data(data: dict, where: str):
    """Lint route for `[chaos]`-rooted specs (analysis/spec_lint.py
    dispatches here): structural errors become SPEC-001/SPEC-002 findings
    instead of a certifier-time crash."""
    from tpu_matmul_bench_torch.analysis.findings import Finding

    findings: list[Finding] = []
    chaos = data.get("chaos")
    if not isinstance(chaos, dict):
        return [Finding(rule="SPEC-001", where=where,
                        message="[chaos] root is not a table")]
    unknown = set(chaos) - {"seed", "cell"}
    for key in sorted(unknown):
        findings.append(Finding(
            rule="SPEC-002", where=f"{where}:chaos",
            message=f"unknown key {key!r} in [chaos]"))
    raw = chaos.get("cell")
    if not isinstance(raw, list) or not raw:
        findings.append(Finding(
            rule="SPEC-001", where=where,
            message="want a non-empty [[chaos.cell]] array"))
        return findings
    for i, entry in enumerate(raw):
        cell_where = f"{where}:chaos.cell[{i}]"
        if not isinstance(entry, dict):
            findings.append(Finding(rule="SPEC-001", where=cell_where,
                                    message="cell entry is not a table"))
            continue
        for key in sorted(set(entry) - _CELL_KEYS):
            findings.append(Finding(
                rule="SPEC-002", where=cell_where,
                message=f"unknown key {key!r} in [[chaos.cell]]"))
        try:
            _cell_from_fields(
                {k: v for k, v in entry.items() if k in _CELL_KEYS},
                cell_where)
        except FaultPlanError as e:
            findings.append(Finding(rule="SPEC-001", where=cell_where,
                                    message=str(e)))
    return findings


# ---------------------------------------------------------------------------
# the certifier

def _noop_sleep(_s: float) -> None:
    return None


def _base_env() -> dict[str, str]:
    """Child env for certification runs: fault vars scrubbed (each run
    decides its own) and the repo root on PYTHONPATH (the port runs
    uninstalled from the checkout). The children share the kernel build
    directory, which sits at a fixed place in that checkout."""
    env = dict(os.environ)
    for var in (FAULT_PLAN_ENV, FAULT_SCOPE_ENV, HEARTBEAT_ENV):
        env.pop(var, None)
    pkg_root = str(_package_root().parent)
    parts = env.get("PYTHONPATH", "").split(os.pathsep)
    if pkg_root not in parts:
        env["PYTHONPATH"] = os.pathsep.join(
            [pkg_root] + [p for p in parts if p])
    return env


def _fault_env(cell: ChaosCell, seed: int, scope: Path) -> dict[str, str]:
    env = _base_env()
    plan = FaultPlan(specs=(cell.fault_spec(),), seed=seed)
    env[FAULT_PLAN_ENV] = plan.to_inline()
    env[FAULT_SCOPE_ENV] = str(scope)
    return env


def _read_jsonl(path: Path) -> list[dict]:
    out: list[dict] = []
    try:
        lines = path.read_text().splitlines()
    except OSError:
        return out
    for line in lines:
        try:
            d = json.loads(line)
        except ValueError:
            continue
        if isinstance(d, dict):
            out.append(d)
    return out


def _scan_torn_tolerant(path: Path, *, expect_manifest: bool,
                        problems: list[str],
                        validate_line: Callable[[dict], list[str]]
                        | None = None) -> None:
    """The intermediate-artifact contract: after a crash, every COMPLETE
    line (newline-terminated) must parse as a JSON object and pass its
    schema check; only the final, newline-less line may be torn."""
    name = path.name
    try:
        data = path.read_bytes()
    except OSError as e:
        problems.append(f"{name}: unreadable after fault: {e}")
        return
    if not data:
        problems.append(f"{name}: empty after fault (manifest lost)")
        return
    body = data[:-1] if data.endswith(b"\n") else data
    lines = body.split(b"\n")
    complete = lines if data.endswith(b"\n") else lines[:-1]
    for i, raw in enumerate(complete):
        try:
            d = json.loads(raw)
        except ValueError:
            problems.append(
                f"{name}: complete line {i + 1} unparseable after fault "
                "(torn mid-file, not at the tail)")
            continue
        if not isinstance(d, dict):
            problems.append(f"{name}: complete line {i + 1} not an object")
            continue
        if i == 0 and expect_manifest:
            from tpu_matmul_bench_torch.utils import telemetry
            if not telemetry.is_manifest(d):
                problems.append(f"{name}: first line is not a manifest")
        elif validate_line is not None:
            problems.extend(f"{name}: line {i + 1}: {p}"
                            for p in validate_line(d))


def _validate_serve_line(d: dict) -> list[str]:
    from tpu_matmul_bench_torch.serve.service import (
        SERVE_BATCH_RECORD_TYPE,
        validate_serve_batch_record,
    )
    from tpu_matmul_bench_torch.serve.trace import (
        SERVE_SPAN_RECORD_TYPE,
        validate_serve_span_record,
    )

    if d.get("record_type") == SERVE_BATCH_RECORD_TYPE:
        return validate_serve_batch_record(d)
    if d.get("record_type") == SERVE_SPAN_RECORD_TYPE:
        # per-request terminal span lines ride the same fsynced channel:
        # every complete line a killed run left behind must be schema-
        # valid AND reconcile against its own recorded wall latency
        return validate_serve_span_record(d)
    return []


# -- per-subsystem state extractors: "semantically identical final
# -- state" means these return equal values for clean and resumed runs

_LEDGER_STABLE_KEYS = ("benchmark", "mode", "size", "dtype", "world",
                       "iterations", "warmup", "avg_time_s", "extras")


def _ledger_state(path: Path, units: int,
                  problems: list[str]) -> dict[int, Any]:
    recs: dict[int, Any] = {}
    for d in _read_jsonl(path):
        if d.get("benchmark") != "faults-ledger":
            continue
        idx = (d.get("extras") or {}).get("fault_idx")
        if not isinstance(idx, int):
            problems.append(f"{path.name}: measurement without fault_idx")
            continue
        if idx in recs:
            problems.append(
                f"{path.name}: duplicate record for unit {idx} — the "
                "resume re-wrote a durable unit")
        recs[idx] = {k: d.get(k) for k in _LEDGER_STABLE_KEYS}
    missing = set(range(units)) - set(recs)
    if missing:
        problems.append(f"{path.name}: lost units {sorted(missing)}")
    return recs


def _tune_state(path: Path, units: int,
                problems: list[str]) -> dict[str, Any]:
    from tpu_matmul_bench_torch.tune.db import TuningDB

    db = TuningDB.load(str(path))
    problems.extend(f"{path.name}: post-resume parse error: {p}"
                    for p in db.parse_errors)
    cells = {c.program_digest: (c.m, c.k, c.n, c.dtype, c.impl,
                                c.artifact, c.detail)
             for c in db.cells()}
    want = {f"chaos-{i}" for i in range(units)}
    missing = want - set(cells)
    if missing:
        problems.append(f"{path.name}: lost cells {sorted(missing)}")
    return cells


def _obs_state(out_dir: Path, units: int,
               problems: list[str]) -> dict[str, Any]:
    from tpu_matmul_bench_torch.obs.export import SNAPSHOT_NAME, read_snapshots

    path = out_dir / SNAPSHOT_NAME
    seqs: list[int] = []
    values: list[int] = []
    for snap in read_snapshots(path):
        seqs.append(int(snap.get("seq", 0)))
        v = (snap.get("gauges") or {}).get(OBS_PROGRESS_GAUGE)
        if isinstance(v, (int, float)):
            values.append(int(v))
    if len(seqs) != len(set(seqs)):
        problems.append(f"{path.name}: duplicate snapshot seq numbers")
    if set(values) != set(range(1, units + 1)):
        problems.append(
            f"{path.name}: progress values {sorted(set(values))} != "
            f"1..{units}")
    return {"seqs": sorted(seqs), "values": sorted(set(values))}


def _serve_state(path: Path, problems: list[str]) -> dict[str, Any]:
    from tpu_matmul_bench_torch.serve.service import SELFTEST_REQUESTS

    recs = [d for d in _read_jsonl(path) if d.get("benchmark") == "serve"]
    if len(recs) != 1:
        problems.append(
            f"{path.name}: want exactly 1 serve measurement record, "
            f"got {len(recs)}")
        return {"records": len(recs)}
    serve = (recs[0].get("extras") or {}).get("serve") or {}
    if serve.get("requests") != SELFTEST_REQUESTS:
        problems.append(
            f"{path.name}: serve record covers {serve.get('requests')} "
            f"requests, selftest serves {SELFTEST_REQUESTS}")
    return {"records": 1, "requests": serve.get("requests"),
            "shed": serve.get("shed", 0)}


# -- cell runners

def _direct_cmd(cell: ChaosCell, workdir: Path,
                device: str = "cuda") -> list[str]:
    py = sys.executable
    mod = [py, "-m", "tpu_matmul_bench_torch"]
    n = str(cell.units)
    if cell.subsystem == "ledger":
        return mod + ["faults", "run", "--workload", "ledger",
                      "--records", n,
                      "--json-out", str(workdir / "ledger.jsonl")]
    if cell.subsystem == "tune":
        return mod + ["faults", "run", "--workload", "tune", "--cells", n,
                      "--db", str(workdir / "tune_db.jsonl")]
    if cell.subsystem == "obs":
        return mod + ["faults", "run", "--workload", "obs",
                      "--snapshots", n, "--obs-dir", str(workdir)]
    if cell.subsystem == "serve":
        return mod + ["serve", "selftest", "--append", "--device", device,
                      "--json-out", str(workdir / "serve.jsonl")]
    raise FaultPlanError(f"no direct runner for {cell.subsystem!r}")


def _direct_artifact(cell: ChaosCell, workdir: Path) -> Path:
    from tpu_matmul_bench_torch.obs.export import SNAPSHOT_NAME

    return {
        "ledger": workdir / "ledger.jsonl",
        "tune": workdir / "tune_db.jsonl",
        "obs": workdir / SNAPSHOT_NAME,
        "serve": workdir / "serve.jsonl",
    }[cell.subsystem]


def _direct_state(cell: ChaosCell, workdir: Path,
                  problems: list[str]) -> Any:
    if cell.subsystem == "ledger":
        return _ledger_state(_direct_artifact(cell, workdir), cell.units,
                             problems)
    if cell.subsystem == "tune":
        return _tune_state(_direct_artifact(cell, workdir), cell.units,
                           problems)
    if cell.subsystem == "obs":
        return _obs_state(workdir, cell.units, problems)
    return _serve_state(_direct_artifact(cell, workdir), problems)


def _run_direct_cell(cell: ChaosCell, seed: int, cell_dir: Path,
                     result: dict, device: str = "cuda") -> None:
    clean_dir = cell_dir / "clean"
    faulted_dir = cell_dir / "faulted"
    clean_dir.mkdir(parents=True, exist_ok=True)
    faulted_dir.mkdir(parents=True, exist_ok=True)
    problems: list[str] = result["problems"]
    hb = cell.heartbeat_s or None

    res = supervised_run(
        _direct_cmd(cell, clean_dir, device), log_path=clean_dir / "run.log",
        timeout_s=cell.timeout_s, env=_base_env(), heartbeat_timeout_s=hb)
    if res.rc != 0:
        problems.append(
            f"clean run failed (rc={res.rc} error={res.error!r}) — the "
            "workload is broken independent of the fault")
        return

    res = supervised_run(
        _direct_cmd(cell, faulted_dir, device), log_path=faulted_dir / "run.log",
        timeout_s=cell.timeout_s,
        env=_fault_env(cell, seed, faulted_dir), heartbeat_timeout_s=hb)
    if res.rc == 0 and not res.timed_out:
        problems.append(
            "fault did not fire: faulted run exited 0 (is the phase "
            f"{cell.span!r} ever emitted by this workload?)")
        return
    result["escalation"] = res.escalation

    # post-crash, pre-resume: the artifact must already be readable by
    # the repo's torn-tolerant readers (only the tail may be torn)
    artifact = _direct_artifact(cell, faulted_dir)
    if artifact.exists():
        expect_manifest = cell.subsystem in ("ledger", "serve")
        _scan_torn_tolerant(
            artifact, expect_manifest=expect_manifest, problems=problems,
            validate_line=_validate_serve_line
            if cell.subsystem == "serve" else None)

    t0 = time.monotonic()
    res = supervised_run(
        _direct_cmd(cell, faulted_dir, device), log_path=faulted_dir / "resume.log",
        timeout_s=cell.timeout_s, env=_base_env(), heartbeat_timeout_s=hb)
    result["recovery_s"] = round(time.monotonic() - t0, 3)
    if res.rc != 0:
        problems.append(
            f"resume failed (rc={res.rc} error={res.error!r}): the "
            "subsystem could not recover from its own crash artifacts")
        return

    clean_state = _direct_state(cell, clean_dir, problems)
    resumed_state = _direct_state(cell, faulted_dir, problems)
    if clean_state != resumed_state:
        problems.append(
            f"state divergence: clean={clean_state!r} vs "
            f"resumed={resumed_state!r}")


def _campaign_spec(cell: ChaosCell):
    from tpu_matmul_bench_torch.campaign.spec import spec_from_dict

    return spec_from_dict({
        "campaign": {"name": f"chaos-{cell.fault}"},
        "job": [{
            "id": "chaos",
            "program": "faults",
            "flags": ["run", "--workload", "ledger",
                      "--records", str(cell.units)],
            "timeout_s": cell.timeout_s,
            "retries": cell.retries,
            "backoff_s": 0.01,
            "heartbeat_s": cell.heartbeat_s,
        }],
    })


def _campaign_state(campaign_dir: Path, units: int,
                    problems: list[str]) -> dict[str, Any]:
    from tpu_matmul_bench_torch.campaign import state as cstate

    latest = cstate.latest_status(cstate.load_events(campaign_dir))
    statuses = sorted((ev.job_id, ev.status) for ev in latest.values())
    ledgers: dict[str, Any] = {}
    for path in sorted((campaign_dir / "jobs").glob("*.jsonl")):
        ledgers[path.name] = _ledger_state(path, units, problems)
    return {"statuses": statuses, "ledgers": ledgers}


def _run_campaign_cell(cell: ChaosCell, seed: int, cell_dir: Path,
                       result: dict) -> None:
    """Campaign cells certify the executor end to end: the fault lands in
    the CHILD (the fault env rides the injected `env=`, never this
    process), the supervisor/retry machinery burns the budget
    deterministically (occurrence counters reset per attempt), and
    `resume` must converge the journal + job ledger to the clean run's
    state. Backoffs are computed but not slept (`sleep` injected away)."""
    from tpu_matmul_bench_torch.campaign import state as cstate
    from tpu_matmul_bench_torch.campaign.executor import run_campaign

    clean_dir = cell_dir / "clean"
    faulted_dir = cell_dir / "faulted"
    problems: list[str] = result["problems"]
    spec = _campaign_spec(cell)

    outcomes = run_campaign(spec, clean_dir, env=_base_env(),
                            sleep=_noop_sleep)
    if any(o.status != cstate.DONE for o in outcomes):
        problems.append(
            "clean campaign did not complete: "
            + ", ".join(f"{o.job.job_id}={o.status}" for o in outcomes))
        return

    outcomes = run_campaign(spec, faulted_dir,
                            env=_fault_env(cell, seed, faulted_dir),
                            sleep=_noop_sleep)
    failed = [o for o in outcomes if o.status == cstate.FAILED]
    if not failed:
        problems.append(
            "fault did not fire: faulted campaign completed "
            f"(plan {cell.fault_spec().to_inline()!r})")
        return
    result["attempts"] = failed[0].attempts
    if failed[0].attempts != cell.retries + 1:
        problems.append(
            f"retry budget: expected {cell.retries + 1} attempts "
            f"(fault re-fires every restart), saw {failed[0].attempts}")

    # the journal itself is a certified artifact: readable mid-crash
    _scan_torn_tolerant(faulted_dir / cstate.JOURNAL_NAME,
                        expect_manifest=False, problems=problems)

    t0 = time.monotonic()
    outcomes = run_campaign(spec, faulted_dir, resume=True, env=_base_env(),
                            sleep=_noop_sleep)
    result["recovery_s"] = round(time.monotonic() - t0, 3)
    bad = [o for o in outcomes
           if o.status not in (cstate.DONE, cstate.SKIPPED)]
    if bad:
        problems.append(
            "resume did not converge: "
            + ", ".join(f"{o.job.job_id}={o.status}" for o in bad))
        return

    clean_state = _campaign_state(clean_dir, cell.units, problems)
    resumed_state = _campaign_state(faulted_dir, cell.units, problems)
    if clean_state != resumed_state:
        problems.append(
            f"state divergence: clean={clean_state!r} vs "
            f"resumed={resumed_state!r}")


def run_cell(cell: ChaosCell, idx: int, seed: int,
             out_dir: Path, device: str = "cuda") -> dict[str, Any]:
    result: dict[str, Any] = {
        "record_type": AUDIT_RECORD_TYPE,
        "cell": cell.label(idx),
        "fault": cell.fault_spec().to_inline(),
        "subsystem": cell.subsystem,
        "attempts": 1,
        "recovery_s": 0.0,
        "escalation": "",
        "problems": [],
    }
    cell_dir = out_dir / cell.label(idx)
    cell_dir.mkdir(parents=True, exist_ok=True)
    try:
        if cell.subsystem == "campaign":
            _run_campaign_cell(cell, seed, cell_dir, result)
        else:
            _run_direct_cell(cell, seed, cell_dir, result, device)
    except Exception as e:  # a crashed certifier is a FAIL, not a crash
        result["problems"].append(f"certifier error: {e!r}")
    result["status"] = "PASS" if not result["problems"] else "FAIL"
    return result


def append_audit_record(path: str | Path, rec: dict[str, Any]) -> None:
    """Durable verdict append: repair-then-fsync, the same contract every
    certified writer obeys (this file is in WRITER_REGISTRY for it)."""
    from tpu_matmul_bench_torch.utils.durable import repair_torn_tail

    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    repair_torn_tail(p)
    with open(p, "a") as fh:
        fh.write(json.dumps(rec, sort_keys=True) + "\n")
        fh.flush()
        os.fsync(fh.fileno())


def smoke_cells(spec: ChaosSpec) -> list[tuple[int, ChaosCell]]:
    """The CI smoke subset: the first cell of each direct, child-cheap
    subsystem (no campaign retry ladders, no serve backend spin-up)."""
    picked: list[tuple[int, ChaosCell]] = []
    seen: set[str] = set()
    for idx, cell in enumerate(spec.cells):
        if cell.subsystem in ("ledger", "tune", "obs") \
                and cell.subsystem not in seen:
            seen.add(cell.subsystem)
            picked.append((idx, cell))
    return picked


def run_audit(spec_path: str | Path, out_dir: str | Path, *,
              smoke: bool = False, device: str = "cuda",
              log: Callable[[str], Any] = print) -> tuple[list[dict], bool]:
    """Run the chaos matrix; returns (cell results, all-passed). Verdicts
    are appended to `<out_dir>/fault_audit.jsonl` as they land, so a
    killed audit leaves a readable partial verdict ledger — the certifier
    eats its own durability cooking. `device` is where the serve cells'
    `serve selftest` runs (the card, unless the CPU is asked for)."""
    spec = load_chaos_spec(spec_path)
    cells = smoke_cells(spec) if smoke else list(enumerate(spec.cells))
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    audit_path = out / AUDIT_LEDGER_NAME
    results: list[dict] = []
    for idx, cell in cells:
        t0 = time.monotonic()
        res = run_cell(cell, idx, spec.seed, out, device)
        res["wall_s"] = round(time.monotonic() - t0, 3)
        append_audit_record(audit_path, res)
        results.append(res)
        tail = "" if res["status"] == "PASS" else \
            f" — {res['problems'][0]}"
        log(f"[{res['status']}] {res['cell']} "
            f"({res['fault']}, {res['wall_s']:.1f}s, "
            f"recovery {res['recovery_s']:.1f}s){tail}")
        for p in res["problems"][1:]:
            log(f"         {p}")
    ok = all(r["status"] == "PASS" for r in results)
    log(f"fault audit: {sum(r['status'] == 'PASS' for r in results)}/"
        f"{len(results)} cells PASS"
        + ("" if ok else " — CERTIFICATION FAILED"))
    return results, ok
