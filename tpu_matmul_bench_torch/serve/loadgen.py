"""Load generators: declarative request mixes, deterministic under a seed.

A copy of `tpu_matmul_bench/serve/loadgen.py` (stdlib only): the same
(mix, qps, duration, seed) gives the JAX package's request stream.

Two canonical load shapes (the serving-benchmark pair T3's request-driven
framing implies):

- **open loop** — arrivals are a Poisson process at a target QPS,
  independent of service completions. This is how real traffic behaves:
  users do not wait for each other, so a slow server accumulates queue
  depth and its tail latency explodes. The honest regime for SLO
  measurement.
- **closed loop** — a fixed number of concurrent clients, each issuing
  its next request only after the previous completes. Measures best-case
  pipeline latency and saturation throughput, but *hides* queueing
  collapse (the arrival rate politely slows with the server), which is
  why open loop is the default.

The mix spec is declarative: weighted (M, K, N) shapes plus a dtype,
written on the CLI as ``MxKxN:weight,...`` (bare ``N`` means the square
NxNxN; ``:weight`` defaults to 1). Everything is driven by one
`random.Random(seed)`, so two runs with the same spec and seed produce
byte-identical schedules — the property the regression gate and the
resume story lean on.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Iterator, Sequence

from tpu_matmul_bench_torch.serve.queue import Request
from tpu_matmul_bench_torch.serve.tenants import TenantSpec


@dataclasses.dataclass(frozen=True)
class MixEntry:
    """One weighted shape class in a request mix."""

    m: int
    k: int
    n: int
    weight: float = 1.0

    @property
    def label(self) -> str:
        return f"{self.m}x{self.k}x{self.n}"


DEFAULT_MIX = "256,512:0.5"


def parse_mix(spec: str) -> tuple[MixEntry, ...]:
    """``MxKxN:weight,...`` → mix entries. Bare ``N`` is the square
    NxNxN; a missing ``:weight`` is 1. Raises ValueError on nonsense."""
    entries: list[MixEntry] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        shape_s, _, weight_s = part.partition(":")
        weight = 1.0
        if weight_s:
            weight = float(weight_s)
            if weight <= 0:
                raise ValueError(f"mix weight must be > 0 in {part!r}")
        dims = [int(d) for d in shape_s.lower().split("x")]
        if len(dims) == 1:
            dims = dims * 3
        if len(dims) != 3 or any(d < 1 for d in dims):
            raise ValueError(
                f"bad mix shape {shape_s!r} (want N or MxKxN, dims >= 1)")
        entries.append(MixEntry(*dims, weight=weight))
    if not entries:
        raise ValueError(f"empty request mix {spec!r}")
    return tuple(entries)


def _shape_stream(mix: Sequence[MixEntry],
                  rng: random.Random) -> Iterator[MixEntry]:
    weights = [e.weight for e in mix]
    while True:
        yield rng.choices(mix, weights=weights, k=1)[0]


def open_loop_schedule(
    mix: Sequence[MixEntry],
    *,
    qps: float,
    duration_s: float,
    dtype: str,
    seed: int = 0,
) -> list[Request]:
    """Poisson arrivals at `qps` for `duration_s`: exponential
    inter-arrival gaps, shapes drawn by weight — all from one seeded
    RNG, so the schedule is a pure function of (mix, qps, duration,
    seed)."""
    if qps <= 0 or duration_s <= 0:
        raise ValueError(f"need qps > 0 and duration > 0, got "
                         f"qps={qps} duration={duration_s}")
    rng = random.Random(seed)
    shapes = _shape_stream(mix, rng)
    schedule: list[Request] = []
    t = rng.expovariate(qps)
    rid = 0
    while t < duration_s:
        e = next(shapes)
        schedule.append(Request(rid=rid, m=e.m, k=e.k, n=e.n,
                                dtype=dtype, arrival_s=t))
        rid += 1
        t += rng.expovariate(qps)
    return schedule


def _tenant_rng(seed: int, tenant_id: str) -> random.Random:
    """One RNG per tenant, derived from (seed, tenant id). String
    seeding hashes through sha512 (stable across processes/platforms),
    so each tenant's stream is byte-deterministic AND independent of
    every other tenant — adding a tenant to a profile never perturbs
    the existing tenants' schedules."""
    return random.Random(f"{seed}:{tenant_id}")


def _rate_factor(spec: TenantSpec, t: float, duration_s: float,
                 burst_phase: float) -> float:
    """The tenant's instantaneous rate multiplier at offset `t`: the
    diurnal ramp (one sine cycle over the window — a day compressed to
    the load window) times the burst multiplier when `t` falls inside a
    seeded burst interval."""
    f = 1.0
    if spec.ramp > 0:
        f *= 1.0 + spec.ramp * math.sin(2 * math.pi * t / duration_s)
    if spec.burst_x > 1.0 and spec.burst_every_s > 0:
        if ((t - burst_phase) % spec.burst_every_s) < spec.burst_for_s:
            f *= spec.burst_x
    return f


def tenant_open_loop_schedule(
    tenants: Sequence[TenantSpec],
    *,
    qps: float,
    duration_s: float,
    dtype: str,
    seed: int = 0,
    default_mix: str = DEFAULT_MIX,
) -> list[Request]:
    """Mixed-tenant Poisson arrivals: total offered load `qps` divides
    by `load_share`; each tenant's stream is an independent seeded
    inhomogeneous Poisson process (thinning against its ramp/burst
    profile) over its own mix. The merged schedule is a pure function
    of (tenants, qps, duration, seed) — per-tenant subsequences don't
    change when other tenants are added or edited; only the merged
    `rid` numbering does."""
    if qps <= 0 or duration_s <= 0:
        raise ValueError(f"need qps > 0 and duration > 0, got "
                         f"qps={qps} duration={duration_s}")
    if not tenants:
        raise ValueError("need at least one tenant")
    total_share = sum(t.load_share for t in tenants)
    if total_share <= 0:
        raise ValueError("tenant load shares sum to 0 — no traffic")
    merged: list[tuple[float, str, int, MixEntry]] = []
    for spec in tenants:
        base = qps * spec.load_share / total_share
        if base <= 0:
            continue
        rng = _tenant_rng(seed, spec.tenant_id)
        mix = parse_mix(spec.mix or default_mix)
        shapes = _shape_stream(mix, rng)
        burst_phase = rng.uniform(0, spec.burst_every_s) \
            if spec.burst_every_s > 0 else 0.0
        # thinning: draw homogeneous arrivals at the profile's peak
        # rate, keep each with probability factor(t)/peak — a standard
        # exact simulation of the inhomogeneous process, deterministic
        # under the tenant's rng
        peak = (1.0 + spec.ramp) * max(spec.burst_x, 1.0)
        t = rng.expovariate(base * peak)
        seq = 0
        while t < duration_s:
            keep = rng.random() < _rate_factor(
                spec, t, duration_s, burst_phase) / peak
            e = next(shapes)  # drawn even when thinned: keeps the shape
            if keep:          # stream aligned with the arrival stream
                merged.append((t, spec.tenant_id, seq, e))
                seq += 1
            t += rng.expovariate(base * peak)
    merged.sort(key=lambda item: (item[0], item[1], item[2]))
    return [Request(rid=rid, m=e.m, k=e.k, n=e.n, dtype=dtype,
                    arrival_s=t, tenant=tid)
            for rid, (t, tid, _seq, e) in enumerate(merged)]


def tenant_closed_loop_shapes(
    tenants: Sequence[TenantSpec],
    *,
    dtype: str,
    seed: int = 0,
    default_mix: str = DEFAULT_MIX,
) -> Iterator[Request]:
    """Endless deterministic mixed-tenant stream for closed-loop
    clients: each request's tenant is drawn by load share, its shape
    from that tenant's mix (ramp/burst profiles don't apply — closed
    loops have no clock)."""
    specs = list(tenants)
    shares = [t.load_share for t in specs]
    if not specs or sum(shares) <= 0:
        raise ValueError("need at least one tenant with load share > 0")
    rng = random.Random(seed)
    streams = {t.tenant_id: _shape_stream(parse_mix(t.mix or default_mix),
                                          _tenant_rng(seed, t.tenant_id))
               for t in specs}
    rid = 0
    while True:
        spec = rng.choices(specs, weights=shares, k=1)[0]
        e = next(streams[spec.tenant_id])
        yield Request(rid=rid, m=e.m, k=e.k, n=e.n, dtype=dtype,
                      tenant=spec.tenant_id)
        rid += 1


def closed_loop_shapes(
    mix: Sequence[MixEntry],
    *,
    dtype: str,
    seed: int = 0,
) -> Iterator[Request]:
    """Endless deterministic request stream for closed-loop clients —
    arrival times are completion-driven, so only the shape sequence is
    part of the schedule identity."""
    rng = random.Random(seed)
    shapes = _shape_stream(mix, rng)
    rid = 0
    while True:
        e = next(shapes)
        yield Request(rid=rid, m=e.m, k=e.k, n=e.n, dtype=dtype)
        rid += 1
