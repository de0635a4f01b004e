"""Declarative campaign specs: a sweep grid → a deterministic job plan.

Port of `tpu_matmul_bench/campaign/spec.py` (stdlib; copied, since the
port imports nothing of the JAX package). The job plan, the sweep
expansion and the fingerprint are the JAX package's, bit for bit: the
same spec gives the same jobs and the same fingerprints in both packages.
Only the program registry differs: `_known_programs` reads the port's
`__main__._PROGRAMS`.

The paper's deliverable is a *matrix* of measurements (sizes × modes ×
dtypes × device counts), but every multi-row run so far has been a
hand-written bash step list (`scripts/measure_r4*.sh`, `measure_r5*.sh`).
A campaign spec is that step list as data: TOML (or the same structure as
JSON) naming explicit jobs and/or sweep grids over the existing
per-program CLIs. `load_spec` parses and validates it; `expand` turns it
into an ordered list of `Job`s, each with a **config fingerprint** — a
stable hash of (program, argv) that identifies the measurement
independently of where or when it runs. Resume, the result store, and
the regression gate all key on fingerprints, so a re-run of the same
spec in a fresh directory lines up job-for-job.

Spec shape (TOML shown; JSON uses the same keys)::

    [campaign]
    name = "round6"

    [defaults]               # every job inherits these
    timeout_s = 1800
    retries = 2
    backoff_s = 30.0
    flags = ["--timing", "fused"]

    [[job]]                  # an explicit step, ≙ one measure_r5 step
    id = "headline"
    program = "matmul"
    flags = ["--sizes", "16384", "--repeats", "3"]

    [[sweep]]                # a grid: one job per point of the product
    program = "matmul"
    sizes = [4096, 8192]
    dtypes = ["bfloat16", "int8"]
    num_devices = [1, 8]
    flags = ["--iterations", "20"]

Flags may contain the literal ``{dir}`` placeholder, substituted with
the campaign directory at launch time only — the *placeholder* form is
what's fingerprinted, so artifacts that land inside the campaign dir
(e.g. compare's ``--markdown-out {dir}/compare.md``) don't make the
fingerprint dir-dependent.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Iterable

# the grid axes a [[sweep]] may declare, in expansion order (outer → inner),
# with the per-program flag each value becomes
_SWEEP_AXES: tuple[tuple[str, str], ...] = (
    ("sizes", "--sizes"),
    ("modes", "--mode"),
    ("dtypes", "--dtype"),
    ("num_devices", "--num-devices"),
)

_DEFAULT_TIMEOUT_S = 1800.0
_DEFAULT_RETRIES = 2
_DEFAULT_BACKOFF_S = 30.0


class CampaignSpecError(ValueError):
    """A malformed campaign spec (bad TOML/JSON, unknown program,
    duplicate job ids, unknown keys)."""


def _known_programs() -> dict[str, str]:
    # the campaign drives the port's per-program CLIs; the registry in
    # __main__ is the single source of truth for what exists. A campaign
    # cannot be its own job — no recursive campaigns.
    from tpu_matmul_bench_torch.__main__ import _PROGRAMS

    return {k: v for k, v in _PROGRAMS.items() if k != "campaign"}


@dataclasses.dataclass(frozen=True)
class Job:
    """One campaign job: a single child-process run of a program CLI.

    `argv` excludes `--json-out` (the executor injects the per-job ledger
    path) and may contain the `{dir}` placeholder. `timeout_s`/`retries`/
    `backoff_s` are execution policy, deliberately OUTSIDE the
    fingerprint: retrying harder must not change what measurement this is.
    """

    job_id: str
    program: str
    argv: tuple[str, ...]
    timeout_s: float = _DEFAULT_TIMEOUT_S
    retries: int = _DEFAULT_RETRIES
    backoff_s: float = _DEFAULT_BACKOFF_S
    # liveness deadline: supervisor kills a child whose heartbeat file
    # (touched at every telemetry span) goes stale this long. 0 = off —
    # a hung collective then only dies at timeout_s. Execution policy,
    # outside the fingerprint like the rest.
    heartbeat_s: float = 0.0

    @property
    def fingerprint(self) -> str:
        return job_fingerprint(self.program, self.argv)

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.job_id,
            "program": self.program,
            "flags": list(self.argv),
            "timeout_s": self.timeout_s,
            "retries": self.retries,
            "backoff_s": self.backoff_s,
            "heartbeat_s": self.heartbeat_s,
        }


def job_fingerprint(program: str, argv: Iterable[str]) -> str:
    """16-hex-char digest of the measurement identity (program + argv,
    order-preserving — flag order can change program behavior, so it is
    part of the identity). Stable across processes, hosts, and campaign
    directories; changing THIS function orphans every journaled campaign,
    so treat its output as a persisted format."""
    payload = json.dumps(
        {"program": program, "argv": list(argv)},
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """A parsed, validated, expanded campaign: an ordered job plan."""

    name: str
    jobs: tuple[Job, ...]

    def by_fingerprint(self) -> dict[str, Job]:
        return {j.fingerprint: j for j in self.jobs}

    def to_json(self) -> str:
        """Canonical JSON form, copied into the campaign directory so
        `resume`/`status`/`gate` never need the original spec file."""
        return json.dumps(
            {"campaign": {"name": self.name},
             "job": [j.to_dict() for j in self.jobs]},
            indent=2, sort_keys=True)


def _parse_toml(text: str) -> dict[str, Any]:
    try:
        import tomllib  # Python 3.11+
    except ModuleNotFoundError:  # 3.10: the container ships tomli
        try:
            import tomli as tomllib  # type: ignore[no-redef]
        except ModuleNotFoundError as e:
            raise CampaignSpecError(
                "no TOML parser available (need tomllib or tomli); "
                "write the spec as JSON instead") from e
    try:
        return tomllib.loads(text)
    except Exception as e:  # toml parsers raise their own error types
        raise CampaignSpecError(f"bad TOML: {e}") from e


def load_spec(path: str | Path) -> CampaignSpec:
    """Parse + validate + expand a spec file (.toml, or JSON otherwise)."""
    p = Path(path)
    try:
        text = p.read_text()
    except OSError as e:
        raise CampaignSpecError(f"cannot read spec {p}: {e}") from e
    if p.suffix == ".toml":
        data = _parse_toml(text)
    else:
        try:
            data = json.loads(text)
        except ValueError as e:
            raise CampaignSpecError(f"bad JSON in {p}: {e}") from e
    return spec_from_dict(data)


def _require_str_list(v: Any, where: str) -> list[str]:
    if not isinstance(v, list) or not all(isinstance(s, str) for s in v):
        raise CampaignSpecError(f"{where} must be a list of strings, got {v!r}")
    return list(v)


def _job_policy(entry: dict[str, Any], defaults: dict[str, Any],
                where: str) -> dict[str, float | int]:
    def num(key: str, fallback: float, cast=float):
        v = entry.get(key, defaults.get(key, fallback))
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            raise CampaignSpecError(f"{where}.{key} must be a number >= 0")
        return cast(v)

    return {
        "timeout_s": num("timeout_s", _DEFAULT_TIMEOUT_S),
        "retries": num("retries", _DEFAULT_RETRIES, cast=int),
        "backoff_s": num("backoff_s", _DEFAULT_BACKOFF_S),
        "heartbeat_s": num("heartbeat_s", 0.0),
    }


def spec_from_dict(data: dict[str, Any]) -> CampaignSpec:
    """Expand a parsed spec dict into the deterministic job plan. Job
    order is the listed order; sweeps expand in axis-major product order
    (sizes, then modes, dtypes, num_devices) — the plan is a pure
    function of the spec text."""
    if not isinstance(data, dict):
        raise CampaignSpecError(f"spec root must be a table, got {type(data)}")
    unknown = set(data) - {"campaign", "defaults", "job", "sweep"}
    if unknown:
        raise CampaignSpecError(f"unknown top-level spec keys: {sorted(unknown)}")
    meta = data.get("campaign", {})
    name = meta.get("name", "campaign")
    defaults = data.get("defaults", {})
    default_flags = _require_str_list(defaults.get("flags", []),
                                      "defaults.flags")
    programs = _known_programs()

    jobs: list[Job] = []
    seen_ids: set[str] = set()

    def add(job_id: str, program: str, flags: list[str],
            policy: dict[str, Any], where: str) -> None:
        if program not in programs:
            raise CampaignSpecError(
                f"{where}: unknown program {program!r} "
                f"(choose from {', '.join(programs)})")
        if "--json-out" in flags:
            raise CampaignSpecError(
                f"{where}: --json-out is injected by the executor; "
                "remove it from the spec")
        if job_id in seen_ids:
            raise CampaignSpecError(f"duplicate job id {job_id!r}")
        seen_ids.add(job_id)
        jobs.append(Job(job_id=job_id, program=program,
                        argv=tuple(default_flags + flags), **policy))

    for i, entry in enumerate(data.get("job", [])):
        where = f"job[{i}]"
        if not isinstance(entry, dict) or "program" not in entry:
            raise CampaignSpecError(f"{where} needs a 'program' key")
        program = entry["program"]
        job_id = entry.get("id") or f"{program}_{i}"
        flags = _require_str_list(entry.get("flags", []), f"{where}.flags")
        add(job_id, program, flags, _job_policy(entry, defaults, where), where)

    for i, entry in enumerate(data.get("sweep", [])):
        where = f"sweep[{i}]"
        if not isinstance(entry, dict) or "program" not in entry:
            raise CampaignSpecError(f"{where} needs a 'program' key")
        program = entry["program"]
        prefix = entry.get("id_prefix") or program
        flags = _require_str_list(entry.get("flags", []), f"{where}.flags")
        policy = _job_policy(entry, defaults, where)
        axes = [(key, flag, entry[key]) for key, flag in _SWEEP_AXES
                if key in entry]
        for key, _flag, values in axes:
            if not isinstance(values, list) or not values:
                raise CampaignSpecError(
                    f"{where}.{key} must be a non-empty list")
        # axis-major product, outermost axis first (deterministic order)
        points: list[list[tuple[str, str, Any]]] = [[]]
        for key, flag, values in axes:
            points = [pt + [(key, flag, v)] for pt in points for v in values]
        for pt in points:
            suffix = "_".join(_axis_tag(key, v) for key, _f, v in pt)
            job_id = f"{prefix}_{suffix}" if suffix else prefix
            grid_flags = [s for _k, flag, v in pt for s in (flag, str(v))]
            add(job_id, program, grid_flags + flags, policy, where)

    if not jobs:
        raise CampaignSpecError("spec declares no jobs (need [[job]] or "
                                "[[sweep]] entries)")
    return CampaignSpec(name=name, jobs=tuple(jobs))


def _axis_tag(key: str, value: Any) -> str:
    if key == "sizes":
        return f"s{value}"
    if key == "num_devices":
        return f"d{value}"
    return str(value)
