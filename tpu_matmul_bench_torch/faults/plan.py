"""Deterministic, seeded fault plans injected at telemetry span
boundaries.

Port of `tpu_matmul_bench/faults/plan.py` (stdlib; copied, since the port
imports nothing of the JAX package). A fault plan is a schedule of faults
keyed to the phase spans the port already emits (`utils/telemetry.py`):
every `telemetry.span(name)` open consults the plan (when the
`TPU_BENCH_FAULT_PLAN` env var is set) and fires any fault whose phase
glob matches `name` on its Nth match. The span names ARE the injection
vocabulary — campaign children emit `w:record`, tune fills emit `w:cell`,
the serve worker emits `serve:batch`, the executor parent emits
`job:<id>` — so faults land at exactly the instrumented phase boundaries,
deterministically.

Inline grammar (the env var value, `;`- or `,`-separated)::

    <kind>[:<arg>]@<phase-glob>[#<occurrence>]

    kill9@w:record#2              SIGKILL self on the 2nd w:record span
    hang:60000@w:record           sleep 60 s on the 1st w:record span
    torn-write:*.jsonl@w:cell#3   truncate matching files mid-record,
                                  then SIGKILL (scope: TPU_BENCH_FAULT_SCOPE
                                  or the cwd, searched recursively)
    transient-exc:transport@w:record   raise a transport-shaped error
    disk-full@w:snapshot#2        raise OSError(ENOSPC)

Alternatively the env var may name a `.toml`/`.json` file::

    seed = 7
    [[fault]]
    kind = "kill9"
    phase = "w:record"
    occurrence = 2

Occurrence counters are per-process: a restarted child re-counts from
zero, so a plan that kills attempt 1 also kills attempt 2 — which is
what makes `faults audit` retry-budget exhaustion deterministic. The
seed feeds any randomized policy downstream (retry jitter); injection
itself is fully deterministic.

Separately from fault firing, every span open touches the file named by
`TPU_BENCH_HEARTBEAT_FILE` when set — that is the liveness signal
`faults/supervisor.py` watches, so a hung child (fault-injected or real)
goes heartbeat-stale at the same granularity faults are injected.
"""

from __future__ import annotations

import dataclasses
import errno
import fnmatch
import json
import os
import signal
import sys
import time
from pathlib import Path

FAULT_PLAN_ENV = "TPU_BENCH_FAULT_PLAN"
FAULT_SCOPE_ENV = "TPU_BENCH_FAULT_SCOPE"
HEARTBEAT_ENV = "TPU_BENCH_HEARTBEAT_FILE"

KINDS = ("kill9", "hang", "torn-write", "transient-exc", "disk-full")
ERRCLASSES = ("transport", "oom", "overload", "runtime")


class FaultPlanError(ValueError):
    """A fault plan that cannot be parsed or validated. Raised loudly:
    injection is opt-in, so a malformed plan is operator error, never
    something to paper over."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire `kind` on the `occurrence`-th span
    whose name matches the `phase` glob (fnmatch, case-sensitive)."""

    kind: str
    phase: str = "*"
    occurrence: int = 1
    delay_ms: float = 0.0  # hang only
    glob: str = ""  # torn-write only
    errclass: str = "runtime"  # transient-exc only

    def validate(self) -> None:
        if self.kind not in KINDS:
            raise FaultPlanError(
                f"unknown fault kind {self.kind!r} (want one of {KINDS})")
        if self.occurrence < 1:
            raise FaultPlanError(
                f"{self.kind}: occurrence must be >= 1, got {self.occurrence}")
        if not self.phase:
            raise FaultPlanError(f"{self.kind}: empty phase glob")
        if self.kind == "hang" and self.delay_ms <= 0:
            raise FaultPlanError("hang needs a positive delay, e.g. hang:500")
        if self.kind == "torn-write" and not self.glob:
            raise FaultPlanError(
                "torn-write needs a file glob, e.g. torn-write:*.jsonl")
        if self.kind == "transient-exc" and self.errclass not in ERRCLASSES:
            raise FaultPlanError(
                f"transient-exc: unknown errclass {self.errclass!r} "
                f"(want one of {ERRCLASSES})")

    def to_inline(self) -> str:
        arg = ""
        if self.kind == "hang":
            arg = f":{self.delay_ms:g}"
        elif self.kind == "torn-write":
            arg = f":{self.glob}"
        elif self.kind == "transient-exc":
            arg = f":{self.errclass}"
        occ = f"#{self.occurrence}" if self.occurrence != 1 else ""
        return f"{self.kind}{arg}@{self.phase}{occ}"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    specs: tuple[FaultSpec, ...]
    seed: int = 0

    def to_inline(self) -> str:
        return ";".join(s.to_inline() for s in self.specs)


def _spec_from_fields(fields: dict) -> FaultSpec:
    known = {"kind", "phase", "occurrence", "delay_ms", "glob", "errclass"}
    unknown = set(fields) - known
    if unknown:
        raise FaultPlanError(f"unknown fault fields {sorted(unknown)}")
    if "kind" not in fields:
        raise FaultPlanError("fault entry missing 'kind'")
    spec = FaultSpec(
        kind=str(fields["kind"]),
        phase=str(fields.get("phase", "*")),
        occurrence=int(fields.get("occurrence", 1)),
        delay_ms=float(fields.get("delay_ms", 0.0)),
        glob=str(fields.get("glob", "")),
        errclass=str(fields.get("errclass", "runtime")),
    )
    spec.validate()
    return spec


def parse_inline(text: str, seed: int = 0) -> FaultPlan:
    specs = []
    for part in text.replace(",", ";").split(";"):
        part = part.strip()
        if not part:
            continue
        if "@" not in part:
            raise FaultPlanError(
                f"bad fault {part!r}: want <kind>[:<arg>]@<phase>[#<occ>]")
        head, _, where = part.partition("@")
        kind, _, arg = head.partition(":")
        phase, _, occ = where.partition("#")
        fields: dict = {"kind": kind.strip(), "phase": phase.strip() or "*"}
        if occ.strip():
            try:
                fields["occurrence"] = int(occ)
            except ValueError:
                raise FaultPlanError(f"bad occurrence {occ!r} in {part!r}")
        arg = arg.strip()
        if arg:
            if fields["kind"] == "hang":
                try:
                    fields["delay_ms"] = float(arg)
                except ValueError:
                    raise FaultPlanError(f"bad hang delay {arg!r}")
            elif fields["kind"] == "torn-write":
                fields["glob"] = arg
            elif fields["kind"] == "transient-exc":
                fields["errclass"] = arg
            else:
                raise FaultPlanError(
                    f"{fields['kind']} takes no argument, got {arg!r}")
        specs.append(_spec_from_fields(fields))
    if not specs:
        raise FaultPlanError(f"empty fault plan {text!r}")
    return FaultPlan(specs=tuple(specs), seed=seed)


def parse_plan(value: str) -> FaultPlan:
    """Parse the `TPU_BENCH_FAULT_PLAN` value: either an inline schedule
    or a path to a TOML/JSON plan file."""
    value = value.strip()
    if value.endswith((".toml", ".json")) and os.path.exists(value):
        if value.endswith(".toml"):
            from tpu_matmul_bench_torch.campaign.spec import _parse_toml

            data = _parse_toml(Path(value).read_text())
        else:
            with open(value) as fh:
                data = json.load(fh)
        if not isinstance(data, dict):
            raise FaultPlanError(f"{value}: plan file must be a table")
        faults = data.get("fault", [])
        if not isinstance(faults, list) or not faults:
            raise FaultPlanError(f"{value}: want a [[fault]] array")
        specs = tuple(_spec_from_fields(dict(f)) for f in faults)
        return FaultPlan(specs=specs, seed=int(data.get("seed", 0)))
    return parse_inline(value)


# ---------------------------------------------------------------------------
# runtime: the active plan consulted by telemetry.span()


def _die() -> None:
    sys.stdout.flush()
    sys.stderr.flush()
    os.kill(os.getpid(), signal.SIGKILL)


def _make_exc(errclass: str) -> BaseException:
    if errclass == "transport":
        return ConnectionResetError("Connection reset by peer [injected fault]")
    if errclass == "oom":
        return RuntimeError("RESOURCE_EXHAUSTED: out of memory [injected fault]")
    if errclass == "overload":
        from tpu_matmul_bench_torch.utils.errors import QueueOverflowError

        return QueueOverflowError(0, 0)
    return RuntimeError("injected transient fault")


def tear_file(path: str | os.PathLike[str]) -> bool:
    """Truncate `path` mid-way through its final line — the on-disk
    shape of a crash landing inside a record write. Deterministic: keeps
    the first half of the last line, drops the trailing newline."""
    p = Path(path)
    try:
        data = p.read_bytes()
    except OSError:
        return False
    if not data:
        return False
    body = data[:-1] if data.endswith(b"\n") else data
    nl = body.rfind(b"\n")
    last = body[nl + 1:]
    if not last:
        return False
    torn = body[: nl + 1] + last[: max(1, len(last) // 2)]
    p.write_bytes(torn)
    return True


def _fire(spec: FaultSpec) -> None:
    if spec.kind == "hang":
        time.sleep(spec.delay_ms / 1e3)
        return
    if spec.kind == "transient-exc":
        raise _make_exc(spec.errclass)
    if spec.kind == "disk-full":
        raise OSError(errno.ENOSPC, "No space left on device [injected fault]")
    if spec.kind == "torn-write":
        base = Path(os.environ.get(FAULT_SCOPE_ENV) or os.getcwd())
        for p in sorted(base.rglob(spec.glob)):
            if p.is_file():
                tear_file(p)
        _die()
    if spec.kind == "kill9":
        _die()


class ActivePlan:
    """A parsed plan plus per-process occurrence counters."""

    def __init__(self, plan: FaultPlan, key: str = "") -> None:
        self.plan = plan
        self.key = key
        self.hits = [0] * len(plan.specs)
        self.fired = [0] * len(plan.specs)

    def on_span(self, name: str) -> None:
        for i, spec in enumerate(self.plan.specs):
            if fnmatch.fnmatchcase(name, spec.phase):
                self.hits[i] += 1
                if self.hits[i] == spec.occurrence:
                    self.fired[i] += 1
                    _fire(spec)


_ACTIVE: ActivePlan | None = None


def reset_active_plan() -> None:
    """Forget the cached plan and its occurrence counters (tests)."""
    global _ACTIVE
    _ACTIVE = None


def on_span(name: str) -> None:
    """The telemetry hook: touch the heartbeat file and fire any fault
    scheduled for this span. Called by `utils.telemetry.span()` only
    when one of the fault env vars is set, so the fault-free hot path
    pays two dict lookups and nothing else."""
    hb = os.environ.get(HEARTBEAT_ENV)
    if hb:
        try:
            os.utime(hb, None)
        except OSError:
            try:
                open(hb, "a").close()
            except OSError:
                pass
    raw = os.environ.get(FAULT_PLAN_ENV)
    if not raw:
        return
    global _ACTIVE
    if _ACTIVE is None or _ACTIVE.key != raw:
        _ACTIVE = ActivePlan(parse_plan(raw), key=raw)
    _ACTIVE.on_span(name)
