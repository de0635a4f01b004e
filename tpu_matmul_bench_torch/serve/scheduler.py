"""Multi-tenant continuous-batching scheduler (the AdmissionQueue grown up).

A copy of `tpu_matmul_bench/serve/scheduler.py` on the port's registry.

The fixed-window `AdmissionQueue` (serve/queue.py) has three production
gaps this module closes:

1. **One global FIFO.** A burst from a bulk tenant lands ahead of every
   interactive request and inflates everyone's p99. Here each tenant has
   its own stream, and dispatch order comes from **start-time fair
   queueing**: every tenant carries a virtual-time tag advanced by
   `padded_flops / weight` per dispatched batch, and the backlogged
   tenant with the smallest tag goes next — so over any backlogged
   interval, device time divides by weight no matter who bursts.
   Priority classes sit above the fair share: a backlogged class-0
   tenant preempts class-1 work *at bucket granularity* (the in-flight
   batch finishes; the next dispatch is re-decided), bounded by a
   **starvation guard** — any tenant whose head request has waited
   longer than `starvation_ms` jumps the class order, so bulk traffic is
   delayed, never starved.

2. **Fixed micro-batch windows.** The window trades latency for batch
   size *while the device idles*. Continuous batching never waits: a
   batch forms from whatever is queued the moment worker capacity frees
   — everything that arrived during the previous batch's execution is
   already here to pack, so the device stays busy and nobody pays a
   window they didn't need. The batch fills from the chosen tenant's
   same-bucket run, then tops up with same-bucket requests from other
   tenants (each charged to its own tenant's tag), so heterogeneous
   streams still share one padded executable dispatch.

3. **Indiscriminate shed-on-overflow.** A full queue is always *some*
   tenant's fault. On overflow the scheduler sheds the most over-share
   tenant's newest request — evicting it if the submitter is within its
   own share — so a well-behaved tenant's traffic is admitted while the
   violator's overflow is refused. Tenants with an `slo_ms` budget also
   shed *early*: when a tenant's own backlog already implies a queue
   wait beyond its budget, admitting more of its traffic only converts
   future SLO misses into wasted device time.

Thread model matches the queue it replaces: producers call `submit`, one
worker calls `take_batch` / `note_service`, one condition variable
guards all state.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Sequence

from tpu_matmul_bench_torch.obs.registry import get_registry
from tpu_matmul_bench_torch.serve.queue import (
    DEFAULT_MAX_BATCH,
    DEFAULT_MAX_DEPTH,
    Request,
    ShapeGrid,
)
from tpu_matmul_bench_torch.serve.tenants import DEFAULT_TENANTS, TenantSpec
from tpu_matmul_bench_torch.utils.errors import BreakerOpenError, QueueOverflowError

DEFAULT_STARVATION_MS = 100.0

# Circuit breaker policy (DESIGN §17): a bucket whose dispatches fail
# this many times in a row stops admitting new work for the cooldown,
# then lets exactly one probe through (half-open); the probe's outcome
# closes or re-opens it. Failures here are *executable* failures — a
# poisoned compile cache entry, a wedged device — where re-admitting
# traffic just converts queue capacity into guaranteed errors.
DEFAULT_BREAKER_THRESHOLD = 3
DEFAULT_BREAKER_COOLDOWN_S = 5.0

# EWMA smoothing for the per-request service-time estimate that prices
# SLO shedding; one batch's jitter shouldn't whipsaw admission decisions
_SERVICE_EWMA_ALPHA = 0.2


class _TenantState:
    """One tenant's live scheduling state."""

    __slots__ = ("spec", "queue", "tag", "submitted", "shed")

    def __init__(self, spec: TenantSpec) -> None:
        self.spec = spec
        self.queue: collections.deque[Request] = collections.deque()
        self.tag = 0.0  # virtual finish time (SFQ)
        self.submitted = 0
        self.shed = 0


def _padded_flops(req: Request) -> float:
    bm, bk, bn = req.bucket  # type: ignore[misc]  # stamped at submit
    return 2.0 * bm * bk * bn


def _bucket_label(bucket, dtype: str) -> str:
    m, k, n = bucket
    return f"{m}x{k}x{n}/{dtype}"


class _Breaker:
    """Per-(bucket, dtype) circuit state. closed → open after N
    consecutive failures; open → half-open after the cooldown; the
    single half-open probe closes (success) or re-opens (failure) it."""

    __slots__ = ("state", "fails", "opened_at", "probing", "opens")

    def __init__(self) -> None:
        self.state = "closed"
        self.fails = 0
        self.opened_at = 0.0
        self.probing = False
        self.opens = 0


class ContinuousScheduler:
    """Weighted-fair, priority-classed, continuously-batching admission.

    Drop-in for `AdmissionQueue` in the serving worker loop: `submit`,
    `take_batch`, `close`, `stats`, and the counter properties share the
    queue's contract. `take_batch` never waits on a window — it blocks
    only while there is *no* work at all.
    """

    def __init__(
        self,
        grid: ShapeGrid | None = None,
        *,
        tenants: Sequence[TenantSpec] = DEFAULT_TENANTS,
        max_depth: int = DEFAULT_MAX_DEPTH,
        max_batch: int = DEFAULT_MAX_BATCH,
        starvation_ms: float = DEFAULT_STARVATION_MS,
        breaker_threshold: int = DEFAULT_BREAKER_THRESHOLD,
        breaker_cooldown_s: float = DEFAULT_BREAKER_COOLDOWN_S,
        clock=time.monotonic,
        recorder: Any = None,
    ) -> None:
        if max_depth < 1 or max_batch < 1 or starvation_ms <= 0:
            raise ValueError(
                f"bad scheduler policy: depth={max_depth} "
                f"batch={max_batch} starvation={starvation_ms}")
        if breaker_threshold < 1 or breaker_cooldown_s <= 0:
            raise ValueError(
                f"bad breaker policy: threshold={breaker_threshold} "
                f"cooldown={breaker_cooldown_s}")
        if not tenants:
            raise ValueError("scheduler needs at least one tenant")
        self.grid = grid or ShapeGrid()
        self.max_depth = max_depth
        self.max_batch = max_batch
        # flight recorder (serve/trace.py): every shed/breaker/eviction
        # decision emits a terminal trace event so refused requests stay
        # attributable per-trace, not just countable (None no-ops)
        self.recorder = recorder
        self.starvation_s = starvation_ms / 1e3
        self._tenants: dict[str, _TenantState] = {
            t.tenant_id: _TenantState(t) for t in tenants}
        if len(self._tenants) != len(tenants):
            raise ValueError("duplicate tenant ids in scheduler config")
        self._total_weight = sum(t.weight for t in tenants)
        self._cond = threading.Condition()
        self._closed = False
        self._depth = 0
        self._rejected = 0  # rejected at submit (≠ evicted-after-admit)
        self._vtime = 0.0  # global virtual time (SFQ)
        self._service_ewma_s = 0.0  # per-request service estimate
        # same series names as AdmissionQueue so obs dashboards and the
        # selftest reconciliation read either admission path unchanged,
        # plus the scheduler-only counters the PR-7 bus grows here
        reg = get_registry()
        self._m_submitted = reg.counter("serve_queue_submitted_total")
        self._m_shed = reg.counter("serve_queue_shed_total")
        self._m_depth = reg.gauge("serve_queue_depth")
        self._m_preempt = reg.counter("serve_preemptions_total")
        self._m_starved = reg.counter("serve_starvation_promotions_total")
        self._m_evicted = reg.counter("serve_evictions_total")
        self._m_slo_shed = reg.counter("serve_slo_sheds_total")
        self._m_tenant_depth = {
            tid: reg.gauge("serve_tenant_depth", tenant=tid)
            for tid in self._tenants}
        self._m_tenant_shed = {
            tid: reg.counter("serve_tenant_shed_total", tenant=tid)
            for tid in self._tenants}
        # circuit breakers: per-(bucket, dtype) failure gates fed by the
        # worker's note_result; sheds carry the distinct breaker_open
        # reason on the obs bus (DESIGN §17)
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self._clock = clock  # injectable for deterministic tests
        self._breakers: dict[tuple, _Breaker] = {}
        self._m_breaker_opened = reg.counter("serve_breaker_opens_total")
        self._m_breaker_shed = reg.counter(
            "serve_breaker_sheds_total", reason="breaker_open")
        self._m_breaker_recovered = reg.counter(
            "serve_breaker_recoveries_total")
        self._m_breaker_open_gauge = reg.gauge("serve_breaker_open_buckets")

    # -- compat view (AdmissionQueue contract)
    @property
    def submitted(self) -> int:
        return int(self._m_submitted.value)

    @property
    def shed(self) -> int:
        return int(self._m_shed.value)

    @property
    def depth(self) -> int:
        with self._cond:
            return self._depth

    @property
    def offered(self) -> int:
        """Distinct submission attempts: admitted + rejected-at-submit.
        Evicted requests were admitted once, so they are NOT re-counted
        (shed ≥ shed-at-submit when evictions happened)."""
        with self._cond:
            return self.submitted + self._rejected

    # ------------------------------------------------------------ submit

    def _shed_locked(self, state: _TenantState, counter=None) -> None:
        state.shed += 1
        self._m_shed.inc()
        self._m_tenant_shed[state.spec.tenant_id].inc()
        if counter is not None:
            counter.inc()

    def _slo_wait_estimate_s(self, state: _TenantState) -> float:
        """Expected queue wait for this tenant's NEXT request: its own
        backlog drains at roughly its weighted share of the worker, so
        wait ≈ backlog × service_time / share. An estimate — the point
        is refusing traffic that is overwhelmingly likely to miss its
        budget, not billing-grade queueing theory."""
        if self._service_ewma_s <= 0 or not state.queue:
            return 0.0
        share = state.spec.weight / self._total_weight
        return len(state.queue) * self._service_ewma_s / max(share, 1e-9)

    def _overflow_victim_locked(self,
                                submitter: _TenantState) -> _TenantState:
        """The tenant whose overflow caused the full queue: largest
        backlog relative to its fair share. Ties (including a solo
        tenant) resolve to the submitter — self-inflicted overflow is
        shed at the door like the plain queue."""
        def over_share(st: _TenantState) -> float:
            return len(st.queue) * self._total_weight / max(
                st.spec.weight, 1e-9)

        victim = max(
            (st for st in self._tenants.values() if st.queue),
            key=over_share, default=submitter)
        if over_share(victim) <= over_share(submitter):
            return submitter
        return victim

    def submit(self, req: Request) -> Request:
        """Admit a request, or raise `QueueOverflowError` when it (or the
        overflow-violating tenant's tail, in its stead) is shed."""
        state = self._tenants.get(req.tenant)
        if state is None:
            raise ValueError(
                f"unknown tenant {req.tenant!r} (configured: "
                f"{sorted(self._tenants)})")
        req.bucket = self.grid.bucket(req.m, req.k, req.n)
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed to new submissions")
            # circuit breaker: a tripped bucket sheds at the door with
            # its own reason — except the single half-open probe, which
            # is admitted to test whether the bucket recovered
            br = self._breakers.get((req.bucket, req.dtype))
            if br is not None and br.state != "closed":
                now = self._clock()
                if br.state == "open" \
                        and now - br.opened_at >= self.breaker_cooldown_s:
                    br.state = "half-open"
                if br.state == "half-open" and not br.probing:
                    br.probing = True  # this request is the probe
                else:
                    self._shed_locked(state, self._m_breaker_shed)
                    self._rejected += 1
                    if self.recorder:
                        self.recorder.terminal(
                            req, "shed_breaker",
                            bucket=_bucket_label(req.bucket, req.dtype))
                    raise BreakerOpenError(
                        self._depth, self.max_depth,
                        bucket=_bucket_label(req.bucket, req.dtype))
            # SLO shedding: this tenant's own backlog already implies a
            # wait past its p99 budget — admitting more of its traffic
            # manufactures SLO misses. Other tenants are untouched.
            slo = state.spec.slo_ms
            if slo is not None \
                    and self._slo_wait_estimate_s(state) * 1e3 > slo:
                self._shed_locked(state, self._m_slo_shed)
                self._rejected += 1
                if self.recorder:
                    self.recorder.terminal(req, "shed_slo", slo_ms=slo)
                raise QueueOverflowError(len(state.queue), self.max_depth)
            if self._depth >= self.max_depth:
                victim = self._overflow_victim_locked(state)
                if victim is state:
                    self._shed_locked(state)
                    self._rejected += 1
                    if self.recorder:
                        self.recorder.terminal(req, "shed_overflow",
                                               depth=self._depth)
                    raise QueueOverflowError(self._depth, self.max_depth)
                # selective shedding: evict the violator's NEWEST request
                # (its oldest is closest to dispatch — evicting it would
                # maximize wasted wait) and admit the in-share submitter
                evicted = victim.queue.pop()
                self._shed_locked(victim, self._m_evicted)
                if self.recorder:
                    self.recorder.terminal(evicted, "evicted",
                                           displaced_by=req.tenant)
                self._m_tenant_depth[victim.spec.tenant_id].set(
                    len(victim.queue))
                self._depth -= 1
            req.submitted_at = time.perf_counter()
            state.queue.append(req)
            state.submitted += 1
            self._depth += 1
            self._m_submitted.inc()
            self._m_depth.set(self._depth)
            self._m_tenant_depth[req.tenant].set(len(state.queue))
            self._cond.notify()
        return req

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # ------------------------------------------------------------ dispatch

    def _choose_locked(self, now: float) -> _TenantState:
        """Next tenant to dispatch: starving tenants first (aging guard),
        else the best priority class present, min virtual tag within."""
        backlogged = [st for st in self._tenants.values() if st.queue]
        starving = [st for st in backlogged
                    if now - st.queue[0].submitted_at > self.starvation_s]
        if starving:
            pool = starving
            best_class = min(st.spec.priority for st in backlogged)
            if any(st.spec.priority > best_class for st in starving):
                # the guard promoted a tenant past a better class — the
                # bound that keeps priority preemption starvation-free
                self._m_starved.inc()
        else:
            best_class = min(st.spec.priority for st in backlogged)
            pool = [st for st in backlogged
                    if st.spec.priority == best_class]
            chosen_head = min(st.queue[0].submitted_at for st in pool)
            if any(st.spec.priority > best_class
                   and st.queue[0].submitted_at < chosen_head
                   for st in backlogged):
                # bucket-granularity preemption: lower-class work that
                # arrived earlier waits for this class's batch
                self._m_preempt.inc()
        return min(pool, key=lambda st: (max(st.tag, self._vtime),
                                         st.queue[0].submitted_at,
                                         st.spec.tenant_id))

    def _collect_locked(self, chosen: _TenantState) -> list[Request]:
        """The batch: the chosen tenant's same-bucket run (FIFO, gaps
        skipped), topped up with same-bucket requests from other tenants
        in tag order — one padded executable dispatch either way."""
        head = chosen.queue[0]
        key = (head.bucket, head.dtype)
        batch = [r for r in chosen.queue
                 if (r.bucket, r.dtype) == key][: self.max_batch]
        if len(batch) < self.max_batch:
            others = sorted(
                (st for st in self._tenants.values()
                 if st is not chosen and st.queue),
                key=lambda st: (max(st.tag, self._vtime),
                                st.spec.tenant_id))
            for st in others:
                for r in st.queue:
                    if len(batch) >= self.max_batch:
                        break
                    if (r.bucket, r.dtype) == key:
                        batch.append(r)
        return batch

    def _charge_locked(self, batch: list[Request]) -> None:
        """Advance SFQ virtual time: each tenant in the batch pays its
        own padded FLOPs over its weight."""
        start = min(max(self._tenants[r.tenant].tag, self._vtime)
                    for r in batch)
        self._vtime = max(self._vtime, start)
        by_tenant: dict[str, float] = {}
        for r in batch:
            by_tenant[r.tenant] = by_tenant.get(r.tenant, 0.0) \
                + _padded_flops(r)
        for tid, cost in by_tenant.items():
            st = self._tenants[tid]
            st.tag = max(st.tag, self._vtime) + cost / max(
                st.spec.weight, 1e-9)

    def take_batch(self) -> list[Request] | None:
        """The next batch the moment work exists — no window wait — or
        None when closed and drained. All requests share one (bucket,
        dtype): one executable dispatch."""
        with self._cond:
            while True:
                while self._depth == 0:
                    if self._closed:
                        return None
                    self._cond.wait()
                now = time.perf_counter()
                chosen = self._choose_locked(now)
                batch = self._collect_locked(chosen)
                self._charge_locked(batch)
                picked = set(id(r) for r in batch)
                for r in batch:
                    st = self._tenants[r.tenant]
                    st.queue = collections.deque(
                        x for x in st.queue if id(x) not in picked)
                    self._m_tenant_depth[r.tenant].set(len(st.queue))
                self._depth -= len(batch)
                self._m_depth.set(self._depth)
                dispatch = time.perf_counter()
                for r in batch:
                    r.dispatched_at = dispatch
                return batch

    def _open_breakers_locked(self) -> int:
        return sum(1 for b in self._breakers.values()
                   if b.state != "closed")

    def note_result(self, bucket, dtype: str, ok: bool) -> None:
        """Worker feedback per dispatched request: success closes (and
        counts a recovery for a half-open probe); failure counts toward
        the consecutive-failure threshold, trips the breaker at N, and
        re-opens a half-open bucket whose probe failed."""
        key = (tuple(bucket), dtype)
        with self._cond:
            br = self._breakers.get(key)
            if ok:
                if br is None:
                    return
                if br.state != "closed":
                    self._m_breaker_recovered.inc()
                br.state = "closed"
                br.fails = 0
                br.probing = False
            else:
                if br is None:
                    br = self._breakers[key] = _Breaker()
                br.fails += 1
                now = self._clock()
                if br.state == "half-open":
                    # the probe failed: re-open, restart the cooldown
                    br.state = "open"
                    br.opened_at = now
                    br.probing = False
                    br.opens += 1
                    self._m_breaker_opened.inc()
                elif br.state == "closed" \
                        and br.fails >= self.breaker_threshold:
                    br.state = "open"
                    br.opened_at = now
                    br.opens += 1
                    self._m_breaker_opened.inc()
            self._m_breaker_open_gauge.set(self._open_breakers_locked())

    def note_service(self, service_s: float, n_requests: int) -> None:
        """Worker feedback: measured service time for `n_requests`, EWMA'd
        into the per-request estimate that prices SLO shedding."""
        if n_requests < 1 or service_s < 0:
            return
        per_req = service_s / n_requests
        with self._cond:
            if self._service_ewma_s == 0.0:
                self._service_ewma_s = per_req
            else:
                self._service_ewma_s += _SERVICE_EWMA_ALPHA * (
                    per_req - self._service_ewma_s)

    # ----------------------------------------------------- explorer guards

    def tenant_in_slo_debt(self, tenant: str) -> bool:
        """True when this tenant's backlog already implies a wait past
        its p99 budget — exactly the predicate SLO shedding prices with.
        The online explorer (tune/online.py) consults this before
        routing a request through a runner-up impl: a tenant fighting
        for its SLO never donates shadow traffic."""
        state = self._tenants.get(tenant)
        if state is None or state.spec.slo_ms is None:
            return False
        with self._cond:
            return self._slo_wait_estimate_s(state) * 1e3 \
                > state.spec.slo_ms

    def breaker_open(self, bucket, dtype: str) -> bool:
        """True when this bucket's circuit breaker is not closed (open
        OR half-open: a recovering bucket gets its single probe, not
        extra experimental traffic). The explorer's second guard."""
        with self._cond:
            br = self._breakers.get((tuple(bucket), dtype))
            return br is not None and br.state != "closed"

    # ------------------------------------------------------------ stats

    @property
    def preemptions(self) -> int:
        return int(self._m_preempt.value)

    @property
    def starvation_promotions(self) -> int:
        return int(self._m_starved.value)

    def stats(self) -> dict[str, Any]:
        with self._cond:
            breakers = {
                _bucket_label(bucket, dtype): {
                    "state": br.state,
                    "consecutive_fails": br.fails,
                    "opens": br.opens,
                }
                for (bucket, dtype), br in sorted(self._breakers.items())
            }
            return {
                "scheduler": "continuous",
                "submitted": self.submitted,
                "shed": self.shed,
                "breaker_sheds": int(self._m_breaker_shed.value),
                "breakers": breakers,
                "max_depth": self.max_depth,
                "max_batch": self.max_batch,
                "starvation_ms": round(self.starvation_s * 1e3, 3),
                "preemptions": self.preemptions,
                "starvation_promotions": self.starvation_promotions,
                "evictions": int(self._m_evicted.value),
                "slo_sheds": int(self._m_slo_shed.value),
                "service_est_ms": round(self._service_ewma_s * 1e3, 4),
                "tenants": {
                    tid: {
                        "weight": st.spec.weight,
                        "priority": st.spec.priority,
                        "slo_ms": st.spec.slo_ms,
                        "submitted": st.submitted,
                        "shed": st.shed,
                    }
                    for tid, st in sorted(self._tenants.items())
                },
            }
