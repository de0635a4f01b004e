"""The serving worker loop: cache + queue + loadgen → schema-v2 ledger.

Port of `tpu_matmul_bench/serve/service.py`. One process, two threads: a
**producer** replaying the load schedule (sleeping to each request's
planned arrival, or acting as N closed-loop clients) into the admission
queue, and the **worker** (the main thread, the only thread that touches
the card) draining micro-batches, resolving each batch's bucket to a
captured executable (serve/cache.py), and running every request until its
executable's `wait` returns: a request is complete when its result is on
the card, not when its launch was enqueued. A config with a `--mesh`
routes `bench` and `ab` to the pod arm (serve/pod.py), which runs one
worker thread a replica group.

Request latency is wall clock from successful admission to post-sync
completion, so it includes queue wait, a cold compile when the request
is first of its bucket, and service time — exactly what a client would
observe. The shed count, cache counters, and the full latency
distribution (per-request samples reduced by `utils.timing.sample_stats`)
land in the record's extras, with the JAX package's keys, so the repo's
ledger readers read serve ledgers of either package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import time
from typing import Any, Iterator, Sequence

import numpy as np
import torch

from tpu_matmul_bench_torch.obs.registry import get_registry
from tpu_matmul_bench_torch.ops.matmul import matmul_2d, random_operands
from tpu_matmul_bench_torch.serve.cache import (
    DEFAULT_CAPACITY,
    ExecKey,
    ExecutableCache,
    Program,
)
from tpu_matmul_bench_torch.serve.loadgen import (
    DEFAULT_MIX,
    MixEntry,
    closed_loop_shapes,
    open_loop_schedule,
    parse_mix,
    tenant_closed_loop_shapes,
    tenant_open_loop_schedule,
)
from tpu_matmul_bench_torch.serve.queue import (
    DEFAULT_MAX_BATCH,
    DEFAULT_MAX_DEPTH,
    AdmissionQueue,
    Request,
    ShapeGrid,
)
from tpu_matmul_bench_torch.serve.scheduler import (
    DEFAULT_STARVATION_MS,
    ContinuousScheduler,
)
from tpu_matmul_bench_torch.serve.tenants import (
    DEFAULT_TENANTS,
    TenantSpec,
    parse_tenants_arg,
)
from tpu_matmul_bench_torch.serve.trace import (
    FlightRecorder,
    failure_spans,
    mint_trace_id,
    request_spans,
)
from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.errors import QueueOverflowError, classify
from tpu_matmul_bench_torch.utils.reporting import (
    BenchmarkRecord,
    JsonWriter,
    header,
    report,
)
from tpu_matmul_bench_torch.utils.timing import sample_stats

# per-batch progress lines streamed into the ledger while the run is
# live: a SIGKILL mid-serve leaves a manifest + complete serve_batch
# lines (each fsynced), so the partial ledger is schema-valid evidence
# instead of a truncated buffer. Measurement readers skip the type.
SERVE_BATCH_RECORD_TYPE = "serve_batch"

# within-run p99 stability estimate (first-half vs second-half p99) is
# capped before it widens the gate: a short window's halves can differ
# a lot under Poisson arrivals without saying anything about run-to-run
# drift, and an uncapped estimate would let a real regression hide
# inside a self-widened tolerance (campaign/gate.py uses 2x noise)
P99_NOISE_CAP_PCT = 15.0


@dataclasses.dataclass
class ServeConfig:
    """Parsed `serve` CLI configuration (see serve/cli.py for the flags)."""

    mix: str = DEFAULT_MIX
    dtype_name: str = "float32"
    qps: float = 50.0
    duration_s: float = 2.0
    concurrency: int | None = None  # None → open loop
    scheduler: str = "continuous"  # "fixed" (AdmissionQueue) | "continuous"
    tenants: str | None = None  # --tenants value (TOML path / inline / None)
    starvation_ms: float = DEFAULT_STARVATION_MS
    window_ms: float = 2.0
    max_depth: int = DEFAULT_MAX_DEPTH
    max_batch: int = DEFAULT_MAX_BATCH
    grid: tuple[int, ...] | None = None
    cache_capacity: int = DEFAULT_CAPACITY
    seed: int = 0
    matmul_impl: str = "auto"  # "auto" | "torch" | "cuda"
    device: str = "cuda"  # "cuda" | "cpu"
    num_devices: int | None = None
    json_out: str | None = None
    append_ledger: bool = False
    trace_out: str | None = None
    prewarm: bool = False
    obs_dir: str | None = None  # snapshot exporter output (obs/export.py)
    # annotate exported /metrics histogram lines with OpenMetrics
    # exemplars (`# {trace_id="..."} v`) — off by default: not every
    # scraper tolerates the exemplar syntax
    obs_exemplars: bool = False
    # online explorer (tune/online.py): fraction of requests eligible
    # for shadow-routing through the runner-up impl (0 = off), and the
    # tune DB measured winners are promoted into (None = no promotion)
    explore: float = 0.0
    explore_db: str | None = None
    # kernel-library store root (tune/artifacts.py); None = no store,
    # "" = the default store under build/
    artifacts: str | None = None
    # pod-scale serving (serve/pod.py): a `dcn:R,ici:C` factorized mesh
    # spec routes bench/ab through the replica-group arm; None = one card
    mesh: str | None = None
    replica_groups: int = 1
    # per-link wire formats of the group programs' gathers
    comm_quant: str | None = None

    @property
    def mix_entries(self) -> tuple[MixEntry, ...]:
        return parse_mix(self.mix)

    @property
    def load_mode(self) -> str:
        return "closed" if self.concurrency else "open"

    @property
    def tenant_specs(self) -> tuple[TenantSpec, ...]:
        return parse_tenants_arg(self.tenants)


@dataclasses.dataclass
class Sample:
    """One completed request's measured split."""

    rid: int
    bucket: str
    latency_s: float  # admission → post-sync completion (client view)
    service_s: float  # dispatch → post-sync (executable alone)
    cold: bool  # this request triggered the bucket's compile
    tenant: str = "default"  # traffic class the request belonged to
    wait_s: float = 0.0  # admission → batch dispatch (pure queueing)


class _OperandPool:
    """Per-bucket operands on the serving device, generated once and
    reused: serving measures dispatch and latency, not the movement of
    fresh payloads, so every request of a bucket shares one (A, B) pair,
    and each bucket's executables are captured over it."""

    def __init__(self, seed: int, device: torch.device | str = "cpu") -> None:
        self._seed = seed
        self.device = torch.device(device)
        self._pool: dict[tuple[int, int, int, str], tuple[Any, ...]] = {}

    def get(self, key: ExecKey) -> tuple[Any, ...]:
        pk = (key.m, key.k, key.n, key.dtype)
        ops = self._pool.get(pk)
        if ops is None:
            dtype = getattr(torch, key.dtype)
            (a,) = random_operands(self._seed, (key.m, key.k), dtype,
                                   device=self.device, count=1)
            (b,) = random_operands(self._seed + 1, (key.k, key.n), dtype,
                                   device=self.device, count=1)
            ops = (a, b)
            self._pool[pk] = ops
        return ops


def _resolve_key_impl(key: ExecKey,
                      device_kind: str) -> tuple[str, tuple | None]:
    """(impl, blocks) a key builds: explicit impls run the default tile;
    `auto` resolves the route once per executable (tuning-DB cell first,
    the table as the fallback), so the captured product carries the DB
    winner's tile, not just its impl name."""
    impl, blocks = key.impl, None
    if impl == "auto":
        from tpu_matmul_bench_torch.ops.impl_select import select_impl

        choice = select_impl(key.m, key.n, key.k, device_kind, key.dtype)
        impl, blocks = choice.impl, choice.blocks
    return impl, blocks


def _artifact_meta_fn(device_kind: str, on_card: bool):
    """The ExecKey → ArtifactMeta resolver of a cache with a store: the
    identity is the RESOLVED program (impl + tile), digested as the tuning
    DB digests its cells, so torch or kernel-source drift changes the key
    and a stale library can only miss. A `torch` key, and any key on the
    CPU (where the wrappers run their plain versions and load no library),
    has nothing to store: None."""
    from tpu_matmul_bench_torch.tune.artifacts import ArtifactMeta

    def meta(key: ExecKey):
        impl, blocks = _resolve_key_impl(key, device_kind)
        if impl != "cuda" or not on_card:
            return None
        return ArtifactMeta.build(
            key.m, key.k, key.n, key.dtype, impl=impl, blocks=blocks,
            device_kind=device_kind, mesh_shape=key.mesh_shape,
            mesh_spec=key.mesh_spec)

    return meta


def _make_cache(config: ServeConfig, device_kind: str,
                pool: _OperandPool) -> ExecutableCache:
    def build(key: ExecKey) -> Program:
        impl, blocks = _resolve_key_impl(key, device_kind)
        return Program(matmul_2d(impl, blocks, device_kind), impl, blocks)

    store = meta = None
    if config.artifacts is not None:  # "" = the default store
        from tpu_matmul_bench_torch.tune.artifacts import ArtifactStore

        store = ArtifactStore.load(config.artifacts or None)
        meta = _artifact_meta_fn(device_kind, pool.device.type == "cuda")
    return ExecutableCache(build, capacity=config.cache_capacity,
                           operands=pool.get, artifacts=store,
                           artifact_meta=meta)


def _make_explorer(config: ServeConfig, device_kind: str, q):
    """The online explorer for this run (`--explore`), bound to the
    admission path's SLO-debt/breaker guards, or None when off."""
    if not config.explore:
        return None
    from tpu_matmul_bench_torch.tune.online import OnlineExplorer

    db = None
    if config.explore_db:
        from tpu_matmul_bench_torch.tune.db import TuningDB

        db = TuningDB.load(config.explore_db)
    explorer = OnlineExplorer(epsilon=config.explore,
                              device_kind=device_kind, db=db,
                              seed=config.seed,
                              configured_impl=config.matmul_impl)
    explorer.bind(q)
    return explorer


def _worker_drain(
    q: AdmissionQueue,
    cache: ExecutableCache,
    pool: _OperandPool,
    samples: list[Sample],
    *,
    impl: str,
    mesh_shape: tuple[int, ...],
    mesh_spec: str = "",
    on_complete=None,
    stream: JsonWriter | None = None,
    explorer=None,
) -> None:
    """Drain the queue to exhaustion (producer closes it). Runs on the
    main thread, the only thread in the harness that touches the card (a
    pod runs one drain thread a replica group, each replaying its group's
    executables on the group's stream). With an
    `explorer` (tune/online.py) each request may be shadow-routed
    through the bucket's runner-up impl — a separate executable under
    its own ExecKey — and every completion's warm service time feeds
    the explorer's per-arm evidence."""
    reg = get_registry()
    m_requests = reg.counter("serve_requests_total")
    m_failures = reg.counter("serve_request_failures_total")
    latency_hists: dict[str, Any] = {}
    wait_hists: dict[str, Any] = {}
    # continuous scheduler only: measured service time feeds its EWMA
    # estimate that prices per-tenant SLO shedding
    note_service = getattr(q, "note_service", None)
    # fixed queue predates breakers; only schedulers that grow
    # note_result get failure feedback (and hence circuit breaking)
    note_result = getattr(q, "note_result", None)
    # flight recorder (serve/trace.py): both admission paths carry one;
    # the worker is the only thread that flushes its terminal records
    # onto the ledger stream (between batches + once after the drain)
    recorder = getattr(q, "recorder", None)
    batch_seq = 0
    while (batch := q.take_batch()) is not None:
        batch_seq += 1
        m, k, n = batch[0].bucket
        key = ExecKey(m=m, k=k, n=n, dtype=batch[0].dtype, impl=impl,
                      mesh_shape=mesh_shape, mesh_spec=mesh_spec)
        a, b = pool.get(key)
        hist = latency_hists.get(key.label)
        if hist is None:
            hist = latency_hists[key.label] = reg.histogram(
                "serve_latency_ms", bucket=key.label)
        batch_t0 = time.perf_counter()
        failed = 0
        with telemetry.span("serve:batch", seq=batch_seq,
                            bucket=key.label, n=len(batch)):
            for req in batch:
                use_key = key
                explored = False
                if explorer is not None:
                    alt = explorer.consider(key, req.tenant)
                    if alt is not None:
                        # shadow-route: same bucket, same operands,
                        # the runner-up impl's own executable
                        use_key = dataclasses.replace(key, impl=alt)
                        explored = True
                # per-request residency check: the bucket's first
                # request of each executable pays the cold compile (the
                # capture) inside its own latency
                was_cached = use_key in cache
                t0 = time.perf_counter()
                try:
                    entry = cache.get(use_key)
                    # cache-acquisition boundary: t0→t_entry is the
                    # request's cache span (a cold request's capture lives
                    # here), t_entry→done its replay and wait
                    t_entry = time.perf_counter()
                    entry.compiled(a, b)
                    entry.compiled.wait()
                except Exception as e:  # noqa: BLE001 — fault boundary
                    # a failed request must not take the worker down:
                    # count it, feed the breaker, release the client
                    # slot, and keep draining (the breaker — not this
                    # loop — decides when a bucket stops admitting)
                    failed += 1
                    m_failures.inc()
                    if note_result is not None:
                        note_result(req.bucket, req.dtype, ok=False)
                    report(f"serve: request {req.rid} ({use_key.label}) "
                           f"failed [{classify(e)}]: {e}",
                           file=sys.stderr)
                    if recorder is not None:
                        t_fail = time.perf_counter()
                        recorder.terminal(
                            req, "failed",
                            spans=failure_spans(req, t0, t_fail),
                            wall_ms=round(max(
                                t_fail - req.submitted_at, 0.0) * 1e3, 4),
                            error=classify(e))
                    if on_complete is not None:
                        on_complete(req)
                    continue
                done = time.perf_counter()
                wait_s = max(req.dispatched_at - req.submitted_at, 0.0)
                samples.append(Sample(
                    rid=req.rid, bucket=use_key.label,
                    latency_s=done - req.submitted_at,
                    service_s=done - t0,
                    cold=not was_cached,
                    tenant=req.tenant,
                    wait_s=wait_s))
                if explorer is not None:
                    explorer.observe(key, done - t0, cold=not was_cached,
                                     explored=explored)
                m_requests.inc()
                if note_result is not None:
                    note_result(req.bucket, req.dtype, ok=True)
                if recorder is not None:
                    recorder.terminal(
                        req, "complete",
                        spans=request_spans(
                            req, t0, t_entry, done,
                            cache_hit=was_cached,
                            cache_source=None if was_cached
                            else entry.source,
                            cold_compile_ms=entry.cold_compile_s * 1e3
                            if not was_cached
                            and entry.source == "compile" else None,
                            deserialize_ms=entry.deserialize_s * 1e3
                            if not was_cached
                            and entry.source == "artifact" else None),
                        wall_ms=round((done - req.submitted_at) * 1e3, 4))
                    # the same request on the Perfetto timeline: one
                    # admission→completion event carrying its trace id,
                    # so sheds and batches line up against individual
                    # requests
                    telemetry.emit_span(
                        "serve:request", req.submitted_at, done, depth=1,
                        trace=req.trace, rid=req.rid, bucket=use_key.label)
                hist.observe((done - req.submitted_at) * 1e3,
                             trace_id=req.trace or None)
                whist = wait_hists.get(req.tenant)
                if whist is None:
                    whist = wait_hists[req.tenant] = reg.histogram(
                        "serve_wait_ms", tenant=req.tenant)
                whist.observe(wait_s * 1e3, trace_id=req.trace or None)
                if on_complete is not None:
                    on_complete(req)
        if stream is not None:
            stream.write_raw({
                "record_type": SERVE_BATCH_RECORD_TYPE,
                "seq": batch_seq,
                "bucket": key.label,
                "n": len(batch),
                "failed": failed,
                "batch_ms": round(
                    (time.perf_counter() - batch_t0) * 1e3, 3),
            })
            if recorder is not None:
                # terminal span records ride the same fsynced channel,
                # flushed in batch neighborhoods so submit-side sheds
                # land near the batches they raced with
                for span_rec in recorder.drain():
                    stream.write_raw(span_rec)
        if note_service is not None:
            note_service(time.perf_counter() - batch_t0, len(batch))
    if recorder is not None:
        # sheds that landed after the last batch was taken (or runs that
        # shed everything) still reach the ledger — and with no stream,
        # the buffer is emptied so it can't grow unbounded
        for span_rec in recorder.drain():
            if stream is not None:
                stream.write_raw(span_rec)


def _open_loop_producer(q: AdmissionQueue, schedule: Sequence[Request],
                        t0: float) -> None:
    for req in schedule:
        delay = t0 + req.arrival_s - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        # trace id minted BEFORE submit: a request shed at the door
        # still has an identity its terminal span can carry
        req.trace = mint_trace_id(req.rid)
        try:
            q.submit(req)
        except QueueOverflowError:
            pass  # counted by the queue; open-loop arrivals never block
    q.close()


def _closed_loop_producer(q: AdmissionQueue, requests: Iterator[Request],
                          t_end: float, sem: threading.Semaphore) -> None:
    for req in requests:
        remaining = t_end - time.perf_counter()
        if remaining <= 0 or not sem.acquire(timeout=remaining):
            break
        if time.perf_counter() >= t_end:
            sem.release()
            break
        req.trace = mint_trace_id(req.rid)
        try:
            q.submit(req)
        except QueueOverflowError:
            sem.release()
    q.close()


def _percentiles_ms(values_s: Sequence[float]) -> dict[str, float]:
    if not values_s:  # a fully-shed window still produces a ledger
        return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}
    arr = np.asarray(list(values_s), dtype=float) * 1e3
    return {
        "p50_ms": round(float(np.percentile(arr, 50)), 3),
        "p95_ms": round(float(np.percentile(arr, 95)), 3),
        "p99_ms": round(float(np.percentile(arr, 99)), 3),
        "max_ms": round(float(arr.max()), 3),
    }


def _p99_noise_pct(latencies_s: Sequence[float]) -> float:
    """First-half vs second-half p99 disagreement (capped): the within-run
    proxy for run-to-run p99 stability the gate widens its tolerance by."""
    n = len(latencies_s)
    if n < 8:
        return P99_NOISE_CAP_PCT  # too short to estimate: assume noisy
    arr = np.asarray(list(latencies_s), dtype=float)
    a = float(np.percentile(arr[: n // 2], 99))
    b = float(np.percentile(arr[n // 2:], 99))
    mid = (a + b) / 2 or 1e-12
    return round(min(100.0 * abs(a - b) / mid / 2, P99_NOISE_CAP_PCT), 2)


def _tenant_rows(
    samples: Sequence[Sample],
    qstats: dict[str, Any],
    tenants: Sequence[TenantSpec],
) -> tuple[dict[str, Any], int]:
    """Per-tenant ledger rows + the total count of SLO-attaining
    completions (the goodput numerator; no-SLO tenants attain by
    definition — every completion is good work)."""
    if qstats.get("scheduler") in ("continuous", "pod"):
        shed_by = {tid: t["shed"]
                   for tid, t in qstats.get("tenants", {}).items()}
    else:
        shed_by = qstats.get("shed_by_tenant", {})
    spec_by = {t.tenant_id: t for t in tenants}
    by: dict[str, list[Sample]] = {}
    for s in samples:
        by.setdefault(s.tenant, []).append(s)
    rows: dict[str, Any] = {}
    good_total = 0
    for tid in sorted(set(by) | set(spec_by)):
        ss = by.get(tid, [])
        spec = spec_by.get(tid)
        slo = spec.slo_ms if spec else None
        good = sum(1 for s in ss
                   if slo is None or s.latency_s * 1e3 <= slo)
        good_total += good
        shed = int(shed_by.get(tid, 0))
        done = len(ss)
        row: dict[str, Any] = {
            "requests": done,
            "shed": shed,
            "shed_rate_pct": round(100.0 * shed / (done + shed), 2)
            if done + shed else 0.0,
            **_percentiles_ms([s.latency_s for s in ss]),
            "wait_p50_ms": _percentiles_ms(
                [s.wait_s for s in ss])["p50_ms"],
            "wait_p99_ms": _percentiles_ms(
                [s.wait_s for s in ss])["p99_ms"],
            "slo_ms": slo,
            "slo_attainment_pct": round(100.0 * good / done, 2)
            if done else 100.0,
        }
        if spec is not None:
            row["weight"] = spec.weight
            row["priority"] = spec.priority
        rows[tid] = row
    return rows, good_total


def serve_stats(
    samples: Sequence[Sample],
    q: AdmissionQueue,
    cache: ExecutableCache,
    *,
    load_mode: str,
    offered_qps: float | None,
    wall_s: float,
    requested_flops: float,
    executed_flops: float,
    tenants: Sequence[TenantSpec] = DEFAULT_TENANTS,
    bucket_flops: dict[str, tuple[float, float]] | None = None,
    matmul_impl: str = "auto",
    device_kind: str = "",
    explore: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """The ledger's `extras["serve"]` block — every serving headline in
    one self-describing dict, the JAX package's keys (its campaign gate
    reads p99_ms + p99_noise_pct, goodput_qps + slo_attainment_pct for
    the SLO rows). `matmul_impl` +
    `device_kind` price each bucket's `impl_source` (the routing-tier
    provenance: db / table / online / artifact / flag); `explore` is the
    explorer's summary block, attached verbatim."""
    lat = [s.latency_s for s in samples]
    submitted = q.submitted + q.shed  # offered = admitted + shed
    qstats = q.stats()
    tenant_rows, good = _tenant_rows(samples, qstats, tenants)
    cache_stats = cache.stats()
    stats: dict[str, Any] = {
        "load_mode": load_mode,
        "scheduler": qstats.get("scheduler", "fixed"),
        "requests": len(samples),
        "shed": q.shed,
        "shed_rate_pct": round(100.0 * q.shed / submitted, 2)
        if submitted else 0.0,
        "achieved_qps": round(len(samples) / wall_s, 2) if wall_s > 0 else 0.0,
        # goodput: completions WITHIN their tenant's SLO per second —
        # the A/B's "≥ equal goodput" criterion; a scheduler that trades
        # throughput for missed budgets loses here even if QPS holds
        "goodput_qps": round(good / wall_s, 2) if wall_s > 0 else 0.0,
        "slo_attainment_pct": round(100.0 * good / len(samples), 2)
        if samples else 100.0,
        "wall_s": round(wall_s, 4),
        **_percentiles_ms(lat),
        "service_p50_ms": _percentiles_ms(
            [s.service_s for s in samples])["p50_ms"],
        "wait_p99_ms": _percentiles_ms([s.wait_s for s in samples])["p99_ms"],
        "p99_noise_pct": _p99_noise_pct(lat),
        "cold_requests": sum(s.cold for s in samples),
        "padding_overhead_pct": round(
            100.0 * (executed_flops - requested_flops) / requested_flops, 2)
        if requested_flops else 0.0,
        "queue": qstats,
        "cache": cache_stats,
        "buckets": _bucket_breakdown(
            samples, bucket_flops,
            sources=_impl_sources(samples, cache_stats, matmul_impl,
                                  device_kind,
                                  explore_active=explore is not None)),
        "tenants": tenant_rows,
    }
    if explore is not None:
        stats["explore"] = explore
    if offered_qps is not None:
        stats["offered_qps"] = round(offered_qps, 2)
    return stats


def _impl_sources(samples: Sequence[Sample], cache_stats: dict[str, Any],
                  matmul_impl: str, device_kind: str, *,
                  explore_active: bool) -> dict[str, str]:
    """Per-bucket routing-tier provenance for the ledger:

    - ``artifact`` — the bucket's executable was built on a kernel library
      imported from the tune/artifacts store (acquisition provenance wins:
      nothing was built in this process);
    - ``online``  — a shadow-routed explorer bucket, or an incumbent
      resolved from a ``measured-online`` DB cell;
    - ``db`` / ``table`` — the tuning-DB cell vs baked-table tiers;
    - ``flag``    — an explicit --matmul-impl pinned the impl.
    """
    by_entry = cache_stats.get("by_entry", {})
    out: dict[str, str] = {}
    for label in {s.bucket for s in samples}:
        if by_entry.get(label, {}).get("source") == "artifact":
            out[label] = "artifact"
            continue
        impl_token = label.rsplit("/", 1)[1]
        if explore_active and impl_token != matmul_impl:
            out[label] = "online"  # the explorer's shadow executable
            continue
        if matmul_impl != "auto":
            out[label] = "flag"
            continue
        try:
            dims, dtype = label.split("/")[:2]
            m, k, n = (int(v) for v in dims.split("x"))
        except ValueError:
            out[label] = "table"
            continue
        from tpu_matmul_bench_torch.ops.impl_select import resolve_route

        choice, _cell = resolve_route(m, n, k, device_kind, dtype)
        out[label] = choice.source
    return out


def _bucket_breakdown(
    samples: Sequence[Sample],
    bucket_flops: dict[str, tuple[float, float]] | None = None,
    sources: dict[str, str] | None = None,
) -> dict[str, Any]:
    by: dict[str, list[float]] = {}
    for s in samples:
        by.setdefault(s.bucket, []).append(s.latency_s)
    out: dict[str, Any] = {}
    for label, lat in sorted(by.items()):
        row = {"count": len(lat), **_percentiles_ms(lat)}
        if sources and label in sources:
            row["impl_source"] = sources[label]
        req_exe = (bucket_flops or {}).get(label)
        if req_exe and req_exe[1] > 0:
            # padded-vs-requested efficiency: the share of this bucket's
            # executed FLOPs the clients actually asked for (100% = the
            # grid point fit exactly; low % = the grid is too coarse for
            # this traffic and the device burns time on padding)
            row["flops_efficiency_pct"] = round(
                100.0 * req_exe[0] / req_exe[1], 2)
        out[label] = row
    return out


def _serve_record(config: ServeConfig, stats: dict[str, Any],
                  samples: Sequence[Sample], device_kind: str, world: int,
                  *, mode: str, executed_flops: float,
                  wall_s: float, prewarmed: int) -> BenchmarkRecord:
    lat = [s.latency_s for s in samples]
    tflops_total = executed_flops / wall_s / 1e12 if wall_s > 0 else 0.0
    max_bucket = max((max(s.bucket.split("/")[0].split("x"), key=int)
                      for s in samples), key=int, default="0")
    rec = BenchmarkRecord(
        benchmark="serve",
        mode=mode,
        size=int(max_bucket),
        dtype=config.dtype_name,
        world=world,
        iterations=len(samples),
        warmup=prewarmed,
        avg_time_s=float(np.mean(lat)) if lat else 0.0,
        tflops_per_device=tflops_total / world if world else 0.0,
        tflops_total=tflops_total,
        device_kind=device_kind,
        # mean executed FLOPs per request: serve records are mixed-shape,
        # so the square-sweep derived metrics (roofline) must not engage
        flops_per_op=executed_flops / len(samples) if samples else 0.0,
        extras={
            "shape": config.mix if len(config.mix) <= 18
            else f"mix:{len(config.mix_entries)} shapes",
            "serve": stats,
            "samples": sample_stats(lat) if lat else None,
        },
    )
    if rec.extras["samples"] is None:
        del rec.extras["samples"]
    return rec


def _report_summary(stats: dict[str, Any]) -> None:
    cache = stats["cache"]
    lines = [
        "\nServing results:",
        f"  - Scheduler: {stats['scheduler']}",
        f"  - Requests completed: {stats['requests']} "
        f"({stats['achieved_qps']} QPS achieved"
        + (f", {stats['offered_qps']} offered" if "offered_qps" in stats
           else "") + ")",
        f"  - Latency p50/p95/p99/max: {stats['p50_ms']} / "
        f"{stats['p95_ms']} / {stats['p99_ms']} / {stats['max_ms']} ms",
        f"  - Goodput: {stats['goodput_qps']} QPS within SLO "
        f"({stats['slo_attainment_pct']}% attainment)",
        f"  - Shed: {stats['shed']} ({stats['shed_rate_pct']}%)",
        f"  - Cache: {cache['hits']} hits / {cache['misses']} misses "
        f"({cache['hit_rate_pct']}% hit rate, "
        f"{cache['evictions']} evictions)",
        *([f"  - Preload: {cache['preload']['count']} executable(s) "
           f"warm-started in {cache['preload']['total_ms']} ms"]
          if cache.get("preload", {}).get("count") else []),
        *([f"  - Explore: {stats['explore']['explored']} of "
           f"{stats['explore']['seen']} requests shadow-routed "
           f"({stats['explore']['explored_pct']}% ≤ "
           f"eps={stats['explore']['epsilon']:g}), blocked "
           f"{stats['explore']['blocked']}"]
          if stats.get("explore") else []),
        f"  - Padding overhead: {stats['padding_overhead_pct']}% extra FLOPs",
    ]
    for label, e in cache["by_entry"].items():
        lines.append(
            f"      {label}: cold compile {e['cold_compile_ms']} ms, "
            f"warm dispatch {e['warm_dispatch_ms']} ms, {e['hits']} hits")
    tenants = stats.get("tenants", {})
    if len(tenants) > 1:
        lines.append("  - Tenants:")
        for tid, row in tenants.items():
            slo = (f"slo {row['slo_ms']:g} ms, "
                   f"{row['slo_attainment_pct']}% attained"
                   if row["slo_ms"] is not None else "no slo")
            lines.append(
                f"      {tid}: {row['requests']} done / {row['shed']} "
                f"shed, p99 {row['p99_ms']} ms (wait {row['wait_p99_ms']} "
                f"ms), {slo}")
    report(*lines)


def _exporter(config: ServeConfig):
    """The obs snapshot exporter for this run (`--obs-dir`), or a null
    context when not requested. Lives alongside the telemetry session:
    enter starts the ticker thread, exit writes the final snapshot."""
    if not config.obs_dir:
        return contextlib.nullcontext()
    from tpu_matmul_bench_torch.obs.export import SnapshotExporter

    return SnapshotExporter(config.obs_dir, exemplars=config.obs_exemplars)


def _attach_cost_analysis(rec: BenchmarkRecord,
                          cache: ExecutableCache) -> None:
    """Additive ``extras["cost_analysis"]`` block: each `cuda`
    executable's launch in the kernels' cost books. Never touches
    ``extras["serve"]``, whose contract is the JAX package's."""
    blocks = cache.cost_analysis()
    if blocks:
        rec.extras["cost_analysis"] = blocks


def _make_admission(config: ServeConfig, grid: ShapeGrid,
                    tenants: Sequence[TenantSpec],
                    scheduler: str | None = None):
    """The admission path behind the A/B flag: the fixed-window
    `AdmissionQueue` or the continuous-batching `ContinuousScheduler`
    (both share the submit/take_batch/stats contract)."""
    which = scheduler or config.scheduler
    # every admission path carries a flight recorder: shed/eviction
    # terminal spans originate here, completion spans from the worker
    recorder = FlightRecorder()
    if which == "fixed":
        return AdmissionQueue(grid, max_depth=config.max_depth,
                              window_s=config.window_ms / 1e3,
                              max_batch=config.max_batch,
                              recorder=recorder)
    if which == "continuous":
        return ContinuousScheduler(grid, tenants=tenants,
                                   max_depth=config.max_depth,
                                   max_batch=config.max_batch,
                                   starvation_ms=config.starvation_ms,
                                   recorder=recorder)
    raise ValueError(f"unknown scheduler {which!r} "
                     "(want 'fixed' or 'continuous')")


def _mix_keys(config: ServeConfig, grid: ShapeGrid,
              tenants: Sequence[TenantSpec], world: int) -> set[ExecKey]:
    """The keys of every bucket the run's mixes can reach."""
    entries = list(config.mix_entries)
    for t in tenants:
        if t.mix:
            entries.extend(parse_mix(t.mix))
    return {ExecKey(*grid.bucket(e.m, e.k, e.n), dtype=config.dtype_name,
                    impl=config.matmul_impl, mesh_shape=(world,))
            for e in entries}


def _build_kernels(config: ServeConfig, grid: ShapeGrid,
                   tenants: Sequence[TenantSpec], world: int,
                   info) -> None:
    """Build the kernel library (nvcc, `csrc/matmul.cu`) before any load
    when the run can reach the kernel: under `cuda`, or under `auto` with
    a bucket routed to `cuda` or with the explorer on (its runner-up may be
    `cuda`). Minutes on a cold build directory, and never inside a
    request's latency. With an artifact store and `--prewarm` the preload
    acquires the library instead (imported from the store, or built there
    on a miss), so a warm start runs no nvcc. On the CPU the wrappers run
    their plain versions, and nothing is built."""
    if info.platform != "cuda" or (config.artifacts is not None
                                   and config.prewarm):
        return
    reaches = config.matmul_impl == "cuda" or (
        config.matmul_impl == "auto"
        and (bool(config.explore) or any(
            _resolve_key_impl(key, info.device_kind)[0] == "cuda"
            for key in _mix_keys(config, grid, tenants, world))))
    if not reaches:
        return
    from tpu_matmul_bench_torch.ops import _build

    t0 = time.perf_counter()
    _build.build("matmul")
    report(f"Kernel library (csrc/matmul.cu) ready in "
           f"{time.perf_counter() - t0:.1f} s")


def _devices(config: ServeConfig):
    from tpu_matmul_bench_torch.utils.device import (
        collect_device_info,
        device_banner,
        resolve_devices,
    )

    devices = resolve_devices(config.device, config.num_devices)
    info = collect_device_info(devices)
    report(device_banner(info))
    return devices, info


def _setup(config: ServeConfig,
           tenants: Sequence[TenantSpec] | None = None):
    """Device + plumbing shared by bench and selftest."""
    devices, info = _devices(config)
    grid = ShapeGrid(config.grid) if config.grid else ShapeGrid()
    if tenants is None:
        tenants = config.tenant_specs
    _build_kernels(config, grid, tenants, len(devices), info)
    pool = _OperandPool(config.seed, devices[0])
    cache = _make_cache(config, info.device_kind, pool)
    q = _make_admission(config, grid, tenants)
    explorer = _make_explorer(config, info.device_kind, q)
    return devices, info, pool, cache, q, tenants, explorer


def _prewarm(config: ServeConfig, grid: ShapeGrid, cache: ExecutableCache,
             world: int,
             tenants: Sequence[TenantSpec] = DEFAULT_TENANTS,
             device_kind: str = "") -> int:
    """Acquire every mix bucket's executable before load so the measured
    window is steady-state (a p99 that sometimes contains a cold capture
    measures the capture, not the serving path).
    Tenant-local mixes contribute their buckets too; with the explorer
    on, each bucket's runner-up executable is preloaded as well, so a
    shadow-routed request never pays the alternate's cold compile."""
    keys = _mix_keys(config, grid, tenants, world)
    if config.explore:
        from tpu_matmul_bench_torch.tune.online import _ALTERNATE

        for key in list(keys):
            impl, _blocks = _resolve_key_impl(key, device_kind)
            keys.add(dataclasses.replace(
                key, impl=_ALTERNATE.get(impl, "torch")))
    with telemetry.span("prewarm", buckets=len(keys)):
        return cache.warm_start(keys)


def _flops(
    samples: Sequence[Sample],
    schedule_shapes: dict[int, tuple[int, int, int]],
) -> tuple[float, float, dict[str, tuple[float, float]]]:
    """(requested, executed, per-bucket {label: (requested, executed)})
    FLOPs over the completed samples: requested at the asked shape,
    executed at the padded bucket shape. The per-bucket split is what
    prices each bucket's padding efficiency in `extras["serve"]`."""
    requested = executed = 0.0
    per_bucket: dict[str, list[float]] = {}
    for s in samples:
        bm, bk, bn = (int(d) for d in s.bucket.split("/")[0].split("x"))
        exe = 2.0 * bm * bk * bn
        rm, rk, rn = schedule_shapes.get(s.rid, (bm, bk, bn))
        req = 2.0 * rm * rk * rn
        requested += req
        executed += exe
        pb = per_bucket.setdefault(s.bucket, [0.0, 0.0])
        pb[0] += req
        pb[1] += exe
    return requested, executed, {
        label: (r, e) for label, (r, e) in per_bucket.items()}


def _bench_header(config: ServeConfig, scheduler: str,
                  tenants: Sequence[TenantSpec]) -> None:
    report(header(
        "Matmul Serving Benchmark (latency under load)",
        {
            "Load mode": config.load_mode
            + (f" (concurrency {config.concurrency})"
               if config.concurrency else f" ({config.qps} QPS Poisson)"),
            "Duration": f"{config.duration_s} s",
            "Request mix": config.mix,
            "Data type": config.dtype_name,
            "Scheduler": scheduler
            + (f" ({config.window_ms} ms window)" if scheduler == "fixed"
               else f" ({config.starvation_ms:g} ms starvation guard)"),
            "Tenants": ", ".join(t.tenant_id for t in tenants),
            "Queue depth": config.max_depth,
            "Matmul implementation": config.matmul_impl,
        },
    ))


def _run_load(
    config: ServeConfig,
    pool: _OperandPool,
    cache: ExecutableCache,
    q,
    tenants: Sequence[TenantSpec],
    world: int,
    stream: JsonWriter | None = None,
    explorer=None,
) -> tuple[list[Sample], float, dict[int, tuple[int, int, int]]]:
    """One producer+worker load run against an already-built admission
    path: (samples, wall_s, rid → requested shape)."""
    samples: list[Sample] = []
    schedule_shapes: dict[int, tuple[int, int, int]] = {}
    multi = config.tenants is not None
    with telemetry.span("load", mode=config.load_mode):
        t0 = time.perf_counter()
        if config.concurrency:
            requests = tenant_closed_loop_shapes(
                tenants, dtype=config.dtype_name, seed=config.seed,
                default_mix=config.mix) if multi else closed_loop_shapes(
                config.mix_entries, dtype=config.dtype_name,
                seed=config.seed)
            seen = _recording(requests, schedule_shapes)
            sem = threading.Semaphore(config.concurrency)
            producer = threading.Thread(
                target=_closed_loop_producer,
                args=(q, seen, t0 + config.duration_s, sem),
                daemon=True)
            producer.start()
            _worker_drain(q, cache, pool, samples,
                          impl=config.matmul_impl, mesh_shape=(world,),
                          on_complete=lambda _r: sem.release(),
                          stream=stream, explorer=explorer)
        else:
            schedule = tenant_open_loop_schedule(
                tenants, qps=config.qps, duration_s=config.duration_s,
                dtype=config.dtype_name, seed=config.seed,
                default_mix=config.mix) if multi else open_loop_schedule(
                config.mix_entries, qps=config.qps,
                duration_s=config.duration_s,
                dtype=config.dtype_name, seed=config.seed)
            schedule_shapes.update(
                {r.rid: (r.m, r.k, r.n) for r in schedule})
            producer = threading.Thread(
                target=_open_loop_producer, args=(q, schedule, t0),
                daemon=True)
            producer.start()
            _worker_drain(q, cache, pool, samples,
                          impl=config.matmul_impl, mesh_shape=(world,),
                          stream=stream, explorer=explorer)
        producer.join()
        wall_s = time.perf_counter() - t0
    return samples, wall_s, schedule_shapes


def _explore_block(config: ServeConfig, explorer) -> dict[str, Any] | None:
    """The explorer's ledger block, with promotion applied when a target
    DB and a citable ledger path are configured. Promotion is explicit
    opt-in (`--explore-db`): shadow evidence never mutates the committed
    DB as a side effect of serving."""
    if explorer is None:
        return None
    block = explorer.summary()
    if config.explore_db and config.json_out \
            and ".jsonl" in config.json_out:
        from tpu_matmul_bench_torch.tune.db import TuningDB

        db = TuningDB.load(config.explore_db)
        result = explorer.promote(db, ledger_ref=config.json_out)
        block["promoted"] = [
            f"{c.dtype}@{c.m}x{c.k}x{c.n}/{c.device_kind} -> {c.impl}"
            for c in result["promoted"]]
        block["skipped"] = result["skipped"]
        block["db"] = config.explore_db
    return block


def _ab_verdict(base: dict[str, Any], cand: dict[str, Any],
                base_name: str, cand_name: str) -> dict[str, Any]:
    """The noise-aware A/B verdict block: candidate vs baseline on p99
    and goodput, with the campaign gate's tolerance (`campaign/gate.py
    tolerance_pct` with no configured threshold): never under the drift
    floor, widened to 2x the noisier arm's within-run p99 noise. Key names
    embed the arm names."""
    from tpu_matmul_bench_torch.campaign.gate import tolerance_pct

    tol = tolerance_pct(0.0,
                        {"noise_pct": base["p99_noise_pct"]},
                        {"noise_pct": cand["p99_noise_pct"]})
    base_p99 = base["p99_ms"] or 1e-9
    p99_delta = 100.0 * (cand["p99_ms"] - base_p99) / base_p99
    base_good = base["goodput_qps"] or 1e-9
    good_delta = 100.0 * (cand["goodput_qps"] - base_good) / base_good
    verdict = {
        "baseline": base_name,
        "candidate": cand_name,
        f"p99_{base_name}_ms": base["p99_ms"],
        f"p99_{cand_name}_ms": cand["p99_ms"],
        "p99_delta_pct": round(p99_delta, 2),
        f"goodput_{base_name}_qps": base["goodput_qps"],
        f"goodput_{cand_name}_qps": cand["goodput_qps"],
        "goodput_delta_pct": round(good_delta, 2),
        f"slo_attainment_{base_name}_pct": base["slo_attainment_pct"],
        f"slo_attainment_{cand_name}_pct": cand["slo_attainment_pct"],
        "tolerance_pct": tol,
        "regressed": p99_delta > tol or good_delta < -tol,
    }
    report(
        f"\nA/B verdict ({base_name} → {cand_name}):",
        f"  - p99: {base['p99_ms']} → {cand['p99_ms']} ms "
        f"({p99_delta:+.1f}%)",
        f"  - goodput: {base['goodput_qps']} → "
        f"{cand['goodput_qps']} QPS ({good_delta:+.1f}%)",
        f"  - SLO attainment: {base['slo_attainment_pct']} → "
        f"{cand['slo_attainment_pct']} %",
        f"  - tolerance ±{tol}% (noise-aware) → "
        + ("REGRESSED" if verdict["regressed"] else "ok"),
    )
    return verdict


def run_bench(config: ServeConfig) -> list[BenchmarkRecord]:
    """The `serve bench` program: one load run → one ledger. A config
    carrying a pod mesh routes to the replica-group arm."""
    if config.mesh:
        from tpu_matmul_bench_torch.serve.pod import run_pod_bench

        return run_pod_bench(config)
    devices, info, pool, cache, q, tenants, explorer = _setup(config)
    world = len(devices)
    _bench_header(config, config.scheduler, tenants)
    # the ledger opens BEFORE load (manifest first, then per-batch
    # progress lines): a SIGKILL mid-run leaves a schema-valid partial
    # ledger — the crash-consistency bar faults/audit.py certifies
    with telemetry.session(config.trace_out), _exporter(config), \
            JsonWriter(config.json_out,
                       manifest=telemetry.build_manifest(
                           device=config.device,
                           extra={"serve_config": _config_manifest(config)}),
                       append=config.append_ledger) as writer:
        prewarmed = _prewarm(config, q.grid, cache, world, tenants,
                             info.device_kind) \
            if config.prewarm else 0
        samples, wall_s, schedule_shapes = _run_load(
            config, pool, cache, q, tenants, world, stream=writer,
            explorer=explorer)
        requested_f, executed_f, bucket_f = _flops(samples, schedule_shapes)
        stats = serve_stats(
            samples, q, cache, load_mode=config.load_mode,
            offered_qps=None if config.concurrency else config.qps,
            wall_s=wall_s, requested_flops=requested_f,
            executed_flops=executed_f, tenants=tenants,
            bucket_flops=bucket_f, matmul_impl=config.matmul_impl,
            device_kind=info.device_kind,
            explore=_explore_block(config, explorer))
        rec = _serve_record(config, stats, samples, info.device_kind, world,
                            mode=config.load_mode,
                            executed_flops=executed_f, wall_s=wall_s,
                            prewarmed=prewarmed)
        _attach_cost_analysis(rec, cache)
        _report_summary(stats)
        writer.write(rec)
    return [rec]


def run_ab(config: ServeConfig) -> list[BenchmarkRecord]:
    """The `serve ab` program: the SAME seeded offered load through the
    fixed-window queue, then through the continuous scheduler — two
    records in one ledger, with the noise-aware verdict on the
    continuous record's ``extras["ab"]``. Exits nonzero when continuous
    batching regresses p99 or goodput beyond the widened tolerance: the
    in-repo form of the scheduler's claim. A config carrying a pod mesh
    routes to the pod-vs-single-device A/B."""
    if config.mesh:
        from tpu_matmul_bench_torch.serve.pod import run_pod_ab

        return run_pod_ab(config)
    devices, info = _devices(config)
    world = len(devices)
    tenants = config.tenant_specs
    grid = ShapeGrid(config.grid) if config.grid else ShapeGrid()
    _build_kernels(config, grid, tenants, world, info)

    records: list[BenchmarkRecord] = []
    arm_stats: dict[str, dict[str, Any]] = {}
    with telemetry.session(config.trace_out), _exporter(config), \
            JsonWriter(config.json_out,
                       manifest=telemetry.build_manifest(
                           device=config.device,
                           extra={"serve_config": _config_manifest(
                               config, "ab")}),
                       append=config.append_ledger) as writer:
        for arm in ("fixed", "continuous"):
            _bench_header(config, arm, tenants)
            # fresh operand pool + cache + admission per arm: neither arm
            # inherits the other's compiled executables, so cold-compile
            # placement is identical and the comparison is pure policy
            pool = _OperandPool(config.seed, devices[0])
            cache = _make_cache(config, info.device_kind, pool)
            q = _make_admission(config, grid, tenants, scheduler=arm)
            explorer = _make_explorer(config, info.device_kind, q)
            prewarmed = _prewarm(config, grid, cache, world, tenants,
                                 info.device_kind) \
                if config.prewarm else 0
            samples, wall_s, shapes = _run_load(
                config, pool, cache, q, tenants, world, stream=writer,
                explorer=explorer)
            requested_f, executed_f, bucket_f = _flops(samples, shapes)
            stats = serve_stats(
                samples, q, cache, load_mode=config.load_mode,
                offered_qps=None if config.concurrency else config.qps,
                wall_s=wall_s, requested_flops=requested_f,
                executed_flops=executed_f, tenants=tenants,
                bucket_flops=bucket_f, matmul_impl=config.matmul_impl,
                device_kind=info.device_kind,
                explore=explorer.summary() if explorer else None)
            rec = _serve_record(config, stats, samples, info.device_kind,
                                world, mode=config.load_mode,
                                executed_flops=executed_f, wall_s=wall_s,
                                prewarmed=prewarmed)
            _attach_cost_analysis(rec, cache)
            _report_summary(stats)
            arm_stats[arm] = stats
            records.append(rec)

        verdict = _ab_verdict(arm_stats["fixed"], arm_stats["continuous"],
                              "fixed", "continuous")
        records[-1].extras["ab"] = verdict
        for rec in records:
            writer.write(rec)
    if verdict["regressed"]:
        raise SystemExit(1)
    return records


def _recording(requests: Iterator[Request],
               shapes: dict[int, tuple[int, int, int]]) -> Iterator[Request]:
    for req in requests:
        shapes[req.rid] = (req.m, req.k, req.n)
        yield req


def _config_manifest(config: ServeConfig,
                     load_mode: str | None = None) -> dict[str, Any]:
    return {
        "mix": config.mix,
        "dtype": config.dtype_name,
        "load_mode": load_mode or config.load_mode,
        "qps": config.qps,
        "duration_s": config.duration_s,
        "concurrency": config.concurrency,
        "scheduler": config.scheduler,
        "tenants": config.tenants,
        "starvation_ms": config.starvation_ms,
        "window_ms": config.window_ms,
        "max_depth": config.max_depth,
        "max_batch": config.max_batch,
        "seed": config.seed,
        "matmul_impl": config.matmul_impl,
        "prewarm": config.prewarm,
        "explore": config.explore,
        "explore_db": config.explore_db,
        "artifacts": config.artifacts,
        "mesh": config.mesh,
        "replica_groups": config.replica_groups,
        "comm_quant": config.comm_quant,
    }


SELFTEST_REQUESTS = 10

# Selftest traffic classes when --tenants is not given: two classes over
# the run's global mix (one shape → one executable, preserving the
# selftest's single-warm-start contract) with generous SLOs no sane CI
# box misses, exercising the per-tenant SLO-attainment rows end to end.
SELFTEST_TENANTS = (
    TenantSpec("interactive", weight=2.0, priority=0, slo_ms=5000.0),
    TenantSpec("bulk", weight=1.0, priority=1, slo_ms=5000.0),
)


def run_selftest(config: ServeConfig) -> list[BenchmarkRecord]:
    """No-load sanity pass: warm-start one entry's executable, serve
    SELFTEST_REQUESTS requests (round-robin over two traffic classes)
    synchronously, validate the ledger contract — including that the
    preloaded bucket recorded zero cold requests (the warm-start
    guarantee) and that the per-tenant
    SLO-attainment rows reconcile. Exits nonzero on any violated
    invariant — the CI hook that keeps the serving path honest without a
    load run."""
    tenants = config.tenant_specs if config.tenants else SELFTEST_TENANTS
    devices, info, pool, cache, q, tenants, _explorer = _setup(config,
                                                               tenants)
    world = len(devices)
    report(header("Serve selftest (no load)", {
        "Requests": SELFTEST_REQUESTS,
        "Request mix": config.mix,
        "Data type": config.dtype_name,
        "Scheduler": config.scheduler,
        "Tenants": ", ".join(t.tenant_id for t in tenants),
    }))
    e = config.mix_entries[0]
    key = ExecKey(*q.grid.bucket(e.m, e.k, e.n), dtype=config.dtype_name,
                  impl=config.matmul_impl, mesh_shape=(world,))
    samples: list[Sample] = []
    with telemetry.session(config.trace_out), _exporter(config), \
            JsonWriter(config.json_out,
                       manifest=telemetry.build_manifest(
                           device=config.device,
                           extra={"serve_config": _config_manifest(
                               config, "selftest")}),
                       append=config.append_ledger) as writer:
        with telemetry.span("warm-start", buckets=1):
            preloaded = cache.warm_start([key])
        t0 = time.perf_counter()
        for rid in range(SELFTEST_REQUESTS):
            q.submit(Request(rid=rid, m=e.m, k=e.k, n=e.n,
                             dtype=config.dtype_name,
                             tenant=tenants[rid % len(tenants)].tenant_id,
                             trace=mint_trace_id(rid)))
        q.close()
        _worker_drain(q, cache, pool, samples, impl=config.matmul_impl,
                      mesh_shape=(world,), stream=writer)
        wall_s = time.perf_counter() - t0
        requested_f, executed_f, bucket_f = _flops(samples, {})
        stats = serve_stats(samples, q, cache, load_mode="selftest",
                            offered_qps=None, wall_s=wall_s,
                            requested_flops=requested_f,
                            executed_flops=executed_f, tenants=tenants,
                            bucket_flops=bucket_f,
                            matmul_impl=config.matmul_impl,
                            device_kind=info.device_kind)
        rec = _serve_record(config, stats, samples, info.device_kind, world,
                            mode="selftest", executed_flops=executed_f,
                            wall_s=wall_s, prewarmed=preloaded)
        _attach_cost_analysis(rec, cache)
        _report_summary(stats)
        writer.write(rec)
    problems = validate_serve_record(rec)
    s = rec.extras["serve"]
    # the warm-start guarantee: the preload phase compiled the serving
    # bucket, so no request may have paid a cold compile
    if s["cold_requests"]:
        problems.append(
            f"warm-start failed: {s['cold_requests']} of {len(samples)} "
            "requests paid a cold compile after the preload phase")
    # the preload split contract: every preloaded executable was either
    # compiled or imported (and only imported when an artifact store was
    # configured), and the phase wall times sum to the total
    pre = s["cache"]["preload"]
    if pre["count"] != pre["compiled"] + pre["deserialized"]:
        problems.append(
            f"preload split does not reconcile: {pre['count']} preloaded "
            f"!= {pre['compiled']} compiled + {pre['deserialized']} "
            "deserialized")
    if config.artifacts is None and pre["deserialized"]:
        problems.append(
            f"{pre['deserialized']} executable(s) claim deserialization "
            "with no artifact store configured")
    if abs(pre["total_ms"]
           - (pre["compile_ms"] + pre["deserialize_ms"])) > 0.01:
        problems.append(
            f"preload wall time split does not sum: {pre['total_ms']} "
            f"!= {pre['compile_ms']} + {pre['deserialize_ms']} ms")
    # every served bucket row must carry its routing-tier provenance
    for label, row in s["buckets"].items():
        if "impl_source" not in row:
            problems.append(f"bucket {label} lacks impl_source — "
                            "routing provenance must be auditable")
    # the scheduler's stats contract: whichever admission path ran must
    # say which one it was, and the per-tenant SLO rows must cover every
    # configured tenant with a live attainment figure
    if s["queue"].get("scheduler") != config.scheduler:
        problems.append(
            f"queue stats claim scheduler "
            f"{s['queue'].get('scheduler')!r}, config says "
            f"{config.scheduler!r}")
    for t in tenants:
        row = s["tenants"].get(t.tenant_id)
        if row is None:
            problems.append(f"no ledger row for tenant {t.tenant_id!r}")
        elif t.slo_ms is not None and row["slo_attainment_pct"] < 100.0:
            problems.append(
                f"tenant {t.tenant_id!r} missed its {t.slo_ms:g} ms "
                f"selftest SLO ({row['slo_attainment_pct']}% attained) — "
                "either the box is pathologically slow or wait "
                "accounting broke")
    if problems:
        report(*[f"selftest FAILED: {p}" for p in problems],
               file=sys.stderr)
        raise SystemExit(1)
    report(f"selftest ok: {preloaded} executable warm-started, "
           f"{len(samples)} requests served cold-free across "
           f"{len(tenants)} tenants, ledger contract holds")
    return [rec]


def validate_serve_record(rec: BenchmarkRecord) -> list[str]:
    """The serve-ledger schema contract, as checkable invariants. Empty
    list = valid. Shared by `serve selftest` and the tests."""
    problems: list[str] = []
    s = rec.extras.get("serve")
    if not isinstance(s, dict):
        return ["extras['serve'] block missing"]
    for key in ("p50_ms", "p95_ms", "p99_ms", "max_ms", "shed_rate_pct",
                "achieved_qps", "requests", "cache", "queue", "scheduler",
                "goodput_qps", "slo_attainment_pct", "tenants"):
        if key not in s:
            problems.append(f"extras['serve'] lacks {key!r}")
    if problems:
        return problems
    if not (s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"] <= s["max_ms"]):
        problems.append(
            f"latency percentiles not monotone: {s['p50_ms']} / "
            f"{s['p95_ms']} / {s['p99_ms']} / {s['max_ms']}")
    cache = s["cache"]
    # every served request took exactly one cache access; prewarm adds
    # misses on top, so accesses >= requests always holds
    if cache["hits"] + cache["misses"] < s["requests"]:
        problems.append(
            f"cache accesses ({cache['hits']} + {cache['misses']}) don't "
            f"cover the {s['requests']} served requests")
    if rec.benchmark != "serve":
        problems.append(f"benchmark field is {rec.benchmark!r}, not 'serve'")
    if rec.iterations != s["requests"]:
        problems.append("iterations != completed requests")
    # per-tenant rows must reconcile with the headline totals: every
    # completion belongs to exactly one tenant, attainment is a
    # percentage, and goodput can't exceed raw throughput
    tenant_requests = sum(row.get("requests", 0)
                          for row in s["tenants"].values())
    if tenant_requests != s["requests"]:
        problems.append(
            f"tenant rows account for {tenant_requests} requests, "
            f"headline says {s['requests']}")
    for tid, row in s["tenants"].items():
        att = row.get("slo_attainment_pct")
        if att is None or not 0.0 <= att <= 100.0:
            problems.append(
                f"tenant {tid!r} slo_attainment_pct {att!r} not in [0, 100]")
    if s["goodput_qps"] > s["achieved_qps"] + 1e-9:
        problems.append(
            f"goodput_qps {s['goodput_qps']} exceeds achieved_qps "
            f"{s['achieved_qps']}")
    # full headline coverage — every key serve_stats writes
    # unconditionally must be present (the schema certifier's
    # SCHEMA-002 contract: the validator may not lag the producer)
    for key in ("load_mode", "shed", "wall_s", "service_p50_ms",
                "wait_p99_ms", "p99_noise_pct", "cold_requests",
                "padding_overhead_pct", "buckets"):
        if key not in s:
            problems.append(f"extras['serve'] lacks {key!r}")
    # mode-dependent extras: present only under open load / --explore,
    # but never malformed
    if "offered_qps" in s and not isinstance(s["offered_qps"],
                                             (int, float)):
        problems.append(f"offered_qps {s['offered_qps']!r} not numeric")
    if "explore" in s and not isinstance(s["explore"], dict):
        problems.append(f"explore block {s['explore']!r} not a dict")
    # per-tenant rows: the full _tenant_rows schema; weight/priority
    # travel together (both come from the same TenantSpec)
    for tid, row in s["tenants"].items():
        for key in ("requests", "shed", "shed_rate_pct", "p50_ms",
                    "p95_ms", "p99_ms", "max_ms", "wait_p50_ms",
                    "wait_p99_ms", "slo_ms", "slo_attainment_pct"):
            if key not in row:
                problems.append(f"tenant {tid!r} row lacks {key!r}")
        if ("weight" in row) != ("priority" in row):
            problems.append(
                f"tenant {tid!r} row carries weight/priority "
                "unpaired — both come from one TenantSpec")
    # per-bucket rows: count + percentiles always; impl_source from the
    # routing-tier vocabulary and a plausible padding efficiency when
    # present
    for label, row in (s.get("buckets") or {}).items():
        for key in ("count", "p50_ms", "p95_ms", "p99_ms", "max_ms"):
            if key not in row:
                problems.append(f"bucket {label!r} row lacks {key!r}")
        if not row.get("count"):
            problems.append(f"bucket {label!r} row has no requests")
        if "impl_source" in row and row["impl_source"] not in (
                "db", "table", "online", "artifact", "flag"):
            problems.append(f"bucket {label!r} impl_source "
                            f"{row['impl_source']!r} not a routing tier")
        if "flops_efficiency_pct" in row \
                and not 0 < row["flops_efficiency_pct"] <= 100.0 + 1e-9:
            problems.append(
                f"bucket {label!r} flops_efficiency_pct "
                f"{row['flops_efficiency_pct']!r} outside (0, 100]")
    # pod block (present iff the run was mesh-sharded): headlines plus
    # the per-group rows the pod SLO gate and _pod_points read
    if "pod" in s:
        pod = s["pod"]
        for key in ("mesh", "replica_groups", "groups",
                    "min_group_goodput_qps",
                    "worst_tenant_attainment_pct"):
            if key not in pod:
                problems.append(f"pod block lacks {key!r}")
        rows = pod.get("groups") or []
        if pod.get("replica_groups") != len(rows):
            problems.append(
                f"pod replica_groups {pod.get('replica_groups')!r} != "
                f"{len(rows)} group rows")
        for row in rows:
            for key in ("group", "placement", "mesh", "devices",
                        "requests", "shed", "achieved_qps",
                        "goodput_qps", "slo_attainment_pct", "p99_ms"):
                if key not in row:
                    problems.append(
                        f"pod group {row.get('group')!r} row lacks "
                        f"{key!r}")
        if rows and all("requests" in r for r in rows) \
                and sum(r["requests"] for r in rows) != s["requests"]:
            problems.append(
                f"pod group rows account for "
                f"{sum(r['requests'] for r in rows)} requests, headline "
                f"says {s['requests']} — a request crossed groups")
    return problems


def run_trace_selftest(config: ServeConfig) -> list[BenchmarkRecord]:
    """`serve trace selftest`: the flight recorder's end-to-end CI hook.
    Three certifications in one pass:

    1. **span coverage** — the TRACE-001/002/003 static audit over the
       real tree is clean (every shed site emits, terminal states are
       exactly-once, the exemplar reservoir is bounded);
    2. **reconciliation** — a seeded in-process serve run's ledger
       yields one terminal span record per offered request, every
       complete record's span chain sums to its measured wall latency,
       and `serve explain --slowest 3` renders and reconciles;
    3. **exemplar bound** — the run's tail histograms retain at most
       EXEMPLAR_LIMIT exemplars, and the slowest request's trace id is
       among them (the p99→trace bridge actually bridges).

    Exits nonzero on any violation."""
    import tempfile
    from pathlib import Path

    from tpu_matmul_bench_torch.obs.registry import EXEMPLAR_LIMIT, reset_registry
    from tpu_matmul_bench_torch.serve import trace as flight

    problems: list[str] = []
    findings = flight.trace_findings()
    problems.extend(
        f"static audit: {f.rule} at {f.where}: {f.message}"
        for f in findings)
    reg = reset_registry()
    with tempfile.TemporaryDirectory(prefix="serve-trace-") as td:
        ledger = str(Path(td) / "serve.jsonl")
        run_cfg = dataclasses.replace(
            config, mix="256", qps=80.0, duration_s=0.6, concurrency=None,
            tenants=None, json_out=ledger, append_ledger=False,
            trace_out=None, obs_dir=None, prewarm=True, explore=0.0,
            explore_db=None)
        report(header("Serve trace selftest (seeded run)", {
            "Request mix": run_cfg.mix,
            "Offered load": f"{run_cfg.qps} QPS x {run_cfg.duration_s} s",
            "Scheduler": run_cfg.scheduler,
        }))
        records = run_bench(run_cfg)
        manifest, span_recs, read_problems = \
            flight.read_trace_records(ledger)
        problems.extend(f"ledger read: {p}" for p in read_problems)
        if manifest is None:
            problems.append("ledger has no manifest line")
        for d in span_recs:
            problems.extend(
                f"trace {d.get('trace')}: {p}"
                for p in flight.validate_serve_span_record(d))
        serve = records[0].extras["serve"]
        by_state: dict[str, int] = {}
        for d in span_recs:
            by_state[d.get("state", "?")] = \
                by_state.get(d.get("state", "?"), 0) + 1
        if by_state.get("complete", 0) != serve["requests"]:
            problems.append(
                f"{by_state.get('complete', 0)} complete span records vs "
                f"{serve['requests']} completed requests — a request "
                "finished without (or with more than one) terminal span")
        shed_spans = sum(v for s, v in by_state.items()
                         if s.startswith("shed_") or s == "evicted")
        if shed_spans != serve["shed"]:
            problems.append(
                f"{shed_spans} shed/evicted span records vs "
                f"{serve['shed']} sheds counted — refusals are escaping "
                "the recorder")
        traces = [d["trace"] for d in span_recs if "trace" in d]
        if len(traces) != len(set(traces)):
            problems.append("duplicate trace ids across terminal records")
        lines, rc = flight.render_explain(span_recs, slowest=3)
        report(*lines)
        if rc != 0:
            problems.append(
                "explain --slowest 3 failed reconciliation (span "
                "components vs measured wall latency)")
        completes = [d for d in span_recs if d.get("state") == "complete"]
        slowest = max(completes, key=lambda d: d["wall_ms"], default=None)
        snap = reg.snapshot()
        lat_hists = {k: v for k, v in snap["histograms"].items()
                     if k.startswith("serve_latency_ms")}
        if not lat_hists:
            problems.append("no serve_latency_ms histogram in the "
                            "snapshot — exemplar path untestable")
        exemplar_traces: set[str] = set()
        for k, summary in lat_hists.items():
            exs = summary.get("exemplars", [])
            if len(exs) > EXEMPLAR_LIMIT:
                problems.append(
                    f"{k} retains {len(exs)} exemplars "
                    f"(> EXEMPLAR_LIMIT={EXEMPLAR_LIMIT})")
            exemplar_traces.update(e["trace_id"] for e in exs)
        if slowest is not None and slowest["trace"] not in exemplar_traces:
            problems.append(
                f"slowest trace {slowest['trace']} "
                f"({slowest['wall_ms']} ms) missing from the tail "
                "exemplars — the p99→trace bridge is broken")
    if problems:
        report(*[f"trace selftest FAILED: {p}" for p in problems],
               file=sys.stderr)
        raise SystemExit(1)
    report(f"trace selftest ok: span coverage audit clean, "
           f"{len(span_recs)} terminal span record(s) "
           f"({by_state.get('complete', 0)} complete) reconcile against "
           f"measured wall latency, exemplars bounded at "
           f"{EXEMPLAR_LIMIT} with the slowest trace retained")
    return records


def validate_serve_batch_record(d: dict[str, Any]) -> list[str]:
    """Schema contract for one streamed `serve_batch` progress line —
    what faults/audit.py holds a SIGKILL'd serve ledger's complete lines
    to. Empty list = valid."""
    problems: list[str] = []
    if d.get("record_type") != SERVE_BATCH_RECORD_TYPE:
        return [f"record_type is {d.get('record_type')!r}, "
                f"not {SERVE_BATCH_RECORD_TYPE!r}"]
    for key, kind in (("seq", int), ("bucket", str), ("n", int),
                      ("failed", int), ("batch_ms", (int, float))):
        v = d.get(key)
        if not isinstance(v, kind) or isinstance(v, bool):
            problems.append(f"serve_batch lacks a well-typed {key!r} "
                            f"(got {v!r})")
    if not problems:
        if d["seq"] < 1:
            problems.append(f"serve_batch seq {d['seq']} not positive")
        if not 0 <= d["failed"] <= d["n"]:
            problems.append(
                f"serve_batch failed {d['failed']} outside [0, {d['n']}]")
    return problems
