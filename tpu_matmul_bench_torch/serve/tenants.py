"""Tenant model: who is sending traffic, what they're owed, what they get.

A copy of `tpu_matmul_bench/serve/tenants.py` (stdlib only).

A production service doesn't see "requests" — it sees *tenants*: traffic
classes with different shapes, different latency contracts, and different
ideas about how much of the machine they deserve. This module is the
declarative half of the multi-tenant scheduler (serve/scheduler.py is the
mechanism): a `TenantSpec` names a tenant's

- **weight** — its share of device time under weighted-fair scheduling
  (a weight-4 tenant gets 4× the padded-FLOPs throughput of a weight-1
  tenant when both have backlog);
- **priority** — its preemption class (0 is most urgent; a class-0
  tenant's batch dispatches before any backlogged class-1 batch, bounded
  by the scheduler's starvation guard);
- **slo_ms** — its p99 latency budget. The budget drives *selective
  shedding* (the scheduler sheds a tenant whose own backlog has already
  blown its budget, instead of shedding everyone) and the ledger's
  per-tenant SLO-attainment rows;
- a **traffic profile** for the load generator: its request mix, its
  share of offered load, a diurnal ramp amplitude, and seeded bursts.

Definitions load from TOML ``[tenants.<id>]`` blocks or from a compact
inline CLI form. stdlib-only: the loadgen imports this without torch.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Mapping

DEFAULT_TENANT_ID = "default"


class TenantSpecError(ValueError):
    """A malformed tenant definition (bad bounds, duplicate ids, bad mix)."""


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: scheduling contract + load profile."""

    tenant_id: str
    weight: float = 1.0         # weighted-fair share (> 0)
    priority: int = 0           # preemption class, 0 = most urgent
    slo_ms: float | None = None  # p99 budget; None = no latency contract
    mix: str | None = None      # request mix; None = the run's global mix
    share: float | None = None  # offered-load weight; None = `weight`
    ramp: float = 0.0           # diurnal amplitude, 0 = flat rate
    burst_x: float = 1.0        # burst rate multiplier (1 = no bursts)
    burst_every_s: float = 0.0  # burst period (0 = no bursts)
    burst_for_s: float = 0.0    # burst length within each period

    @property
    def load_share(self) -> float:
        return self.share if self.share is not None else self.weight


DEFAULT_TENANTS = (TenantSpec(DEFAULT_TENANT_ID),)


def _norm_id(tenant_id: str) -> str:
    """Canonical tenant identity: ids differing only by case/whitespace
    would collide in dashboards and ledger keys, so they're one tenant."""
    return tenant_id.strip().lower()


def _check_number(tid: str, key: str, value: Any, *, lo: float,
                  allow_eq: bool = False) -> float:
    if not isinstance(value, (int, float)) or isinstance(value, bool):
        raise TenantSpecError(
            f"tenant {tid!r}: {key} must be a number, got {value!r}")
    if value < lo or (not allow_eq and value == lo):
        op = ">=" if allow_eq else ">"
        raise TenantSpecError(
            f"tenant {tid!r}: {key} must be {op} {lo:g}, got {value!r}")
    return float(value)


def tenant_from_dict(tenant_id: str,
                     table: Mapping[str, Any]) -> TenantSpec:
    """One ``[tenants.<id>]`` table → a validated TenantSpec. Unknown
    keys are ignored, as the JAX package's runtime ignores them."""
    tid = tenant_id.strip()
    if not tid:
        raise TenantSpecError(f"empty tenant id {tenant_id!r}")
    if not isinstance(table, Mapping):
        raise TenantSpecError(
            f"tenant {tid!r} must be a table, got {type(table).__name__}")
    kwargs: dict[str, Any] = {"tenant_id": tid}
    if "weight" in table:
        kwargs["weight"] = _check_number(tid, "weight", table["weight"], lo=0)
    if "priority" in table:
        prio = table["priority"]
        if not isinstance(prio, int) or isinstance(prio, bool) or prio < 0:
            raise TenantSpecError(
                f"tenant {tid!r}: priority must be an integer >= 0, "
                f"got {prio!r}")
        kwargs["priority"] = prio
    if table.get("slo_ms") is not None:
        kwargs["slo_ms"] = _check_number(tid, "slo_ms", table["slo_ms"], lo=0)
    if table.get("mix") is not None:
        mix = table["mix"]
        if not isinstance(mix, str):
            raise TenantSpecError(
                f"tenant {tid!r}: mix must be a string, got {mix!r}")
        from tpu_matmul_bench_torch.serve.loadgen import parse_mix

        try:
            parse_mix(mix)
        except ValueError as e:
            raise TenantSpecError(f"tenant {tid!r}: bad mix: {e}") from e
        kwargs["mix"] = mix
    if table.get("share") is not None:
        kwargs["share"] = _check_number(tid, "share", table["share"], lo=0)
    if "ramp" in table:
        ramp = _check_number(tid, "ramp", table["ramp"], lo=0, allow_eq=True)
        if ramp >= 1.0:
            raise TenantSpecError(
                f"tenant {tid!r}: ramp must be in [0, 1) (the rate "
                f"multiplier 1 + ramp*sin must stay positive), got {ramp:g}")
        kwargs["ramp"] = ramp
    if "burst_x" in table:
        kwargs["burst_x"] = _check_number(
            tid, "burst_x", table["burst_x"], lo=1.0, allow_eq=True)
    for key in ("burst_every_s", "burst_for_s"):
        if key in table:
            kwargs[key] = _check_number(tid, key, table[key], lo=0,
                                        allow_eq=True)
    spec = TenantSpec(**kwargs)
    if spec.burst_x > 1.0 and spec.burst_every_s <= 0:
        raise TenantSpecError(
            f"tenant {tid!r}: burst_x = {spec.burst_x:g} needs "
            "burst_every_s > 0 (a burst with no period never fires)")
    if spec.burst_for_s > spec.burst_every_s:
        raise TenantSpecError(
            f"tenant {tid!r}: burst_for_s ({spec.burst_for_s:g}) exceeds "
            f"burst_every_s ({spec.burst_every_s:g})")
    return spec


def tenants_from_dict(data: Mapping[str, Any]) -> tuple[TenantSpec, ...]:
    """A parsed ``{"tenants": {...}}`` root → ordered TenantSpecs,
    rejecting duplicates after id canonicalization."""
    table = data.get("tenants")
    if not isinstance(table, Mapping) or not table:
        raise TenantSpecError(
            "tenant file needs a non-empty [tenants.<id>] table")
    specs: list[TenantSpec] = []
    seen: dict[str, str] = {}
    for tid, entry in table.items():
        spec = tenant_from_dict(str(tid), entry)
        norm = _norm_id(spec.tenant_id)
        if norm in seen:
            raise TenantSpecError(
                f"duplicate tenant id {spec.tenant_id!r} (collides with "
                f"{seen[norm]!r} after case/whitespace normalization)")
        seen[norm] = spec.tenant_id
        specs.append(spec)
    return tuple(specs)


def load_tenants(path: str | Path) -> tuple[TenantSpec, ...]:
    """Load ``[tenants.*]`` blocks from a TOML file."""
    import tomllib

    p = Path(path)
    try:
        text = p.read_text()
    except OSError as e:
        raise TenantSpecError(f"cannot read tenant file {p}: {e}") from e
    try:
        data = tomllib.loads(text)
    except tomllib.TOMLDecodeError as e:
        raise TenantSpecError(f"bad TOML in {p}: bad TOML: {e}") from e
    return tenants_from_dict(data)


def parse_tenants_arg(spec: str | None) -> tuple[TenantSpec, ...]:
    """The serve CLI's ``--tenants`` value: a TOML path (``*.toml``), or
    the compact inline form ``id=weight[/priority[/slo_ms]],...`` —
    e.g. ``interactive=4/0/250,bulk=1/1``. None → the single default
    tenant."""
    if spec is None:
        return DEFAULT_TENANTS
    spec = spec.strip()
    if spec.endswith(".toml"):
        return load_tenants(spec)
    specs: list[TenantSpec] = []
    seen: dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        tid, eq, policy = part.partition("=")
        table: dict[str, Any] = {}
        if eq:
            fields = policy.split("/")
            if len(fields) > 3 or not fields[0]:
                raise TenantSpecError(
                    f"bad inline tenant {part!r} (want "
                    "id=weight[/priority[/slo_ms]])")
            try:
                table["weight"] = float(fields[0])
                if len(fields) > 1:
                    table["priority"] = int(fields[1])
                if len(fields) > 2:
                    table["slo_ms"] = float(fields[2])
            except ValueError as e:
                raise TenantSpecError(
                    f"bad inline tenant {part!r}: {e}") from e
        t = tenant_from_dict(tid, table)
        norm = _norm_id(t.tenant_id)
        if norm in seen:
            raise TenantSpecError(
                f"duplicate tenant id {t.tenant_id!r} (collides with "
                f"{seen[norm]!r})")
        seen[norm] = t.tenant_id
        specs.append(t)
    if not specs:
        raise TenantSpecError(f"empty tenant spec {spec!r}")
    return tuple(specs)
