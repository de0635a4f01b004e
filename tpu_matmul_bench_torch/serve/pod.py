"""Pod-scale sharded serving: replica groups behind the scheduler.

Port of `tpu_matmul_bench/serve/pod.py`. A single device answers one bucket
at a time; a pod answers many. This module partitions a two-level
``dcn:R,ici:C`` world of ranks (parallel/mesh.py) into **replica groups**,
data-parallel copies of a model-parallel group (serve/placement.py owns
the partition math), and teaches the serving harness to place admitted
batches across them:

- `pod_group_program` is one group's program: each rank's product of its
  A-row × B-column tile through `ops/matmul.py matmul_2d` (K1 under
  `cuda`), the tiles stitched by per-link-format all-gathers
  (`parallel/collectives.py allgather_impl`), one downcast. The cache
  captures the whole program, every rank's product and every gather, in
  one CUDA graph (serve/cache.py), replayed on the group's own stream;
- `PodQueue` fronts one `ContinuousScheduler` a group, routing each
  request to the least-backlogged group whose breaker is closed, so a
  group's open breaker diverts its traffic, never sheds it;
- one drain thread a group (`_run_pod_load`) replays its executables;
- each group's executables key the cache and the artifact store
  (`tune/artifacts.py`, `--artifacts`) with the group's placement label;
- `pod_findings` certifies the layer (POD-001..003) from a call log of
  each group program's collectives (PyTorch runs eagerly: there is no
  jaxpr to trace), and `run_pod_selftest` is `serve pod selftest`.

The ranks are in one process. On one card they share it
(`TMB_RANKS_PER_CARD`, which the CLI sets to the mesh's world under
`--device cpu` only): the dcn and ici gathers copy within the card's
memory, not over NVLink or a network, and the link classes are labels.

`dcn:2,ici:4` in 2 groups makes each group's mesh `ici:4`
(`partition_spec`: one dcn row a group), so a `--comm-quant dcn=...`
spec touches no gather there: `specs/serve_pod.toml`'s
`pod_open_mixed_quant` job quantizes nothing, as in the JAX package. The
quantized gathers run where a group keeps a dcn axis, as `dcn:4,ici:2` in
2 groups (each group `dcn:2,ici:2`).

The ledger record stays the schema-v2 serve record
(`validate_serve_record` holds), plus a ``pod`` block: per-group goodput
and the pod's worst-tenant SLO attainment.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import threading
import time
from typing import Any, Callable, Sequence

import torch

from tpu_matmul_bench_torch.serve.placement import (
    ReplicaGroup,
    group_meshes,
    mesh_world,
    partition_problems,
    partition_spec,
)
from tpu_matmul_bench_torch.serve.queue import Request, ShapeGrid
from tpu_matmul_bench_torch.utils.reporting import header, report

# Factorizations the pod audit records group programs at: the same
# 8-rank world transposed two ways, so the rule set cannot pass by
# memorizing one mesh shape.
_POD_FACTORIZATIONS: tuple[tuple[str, int], ...] = (
    ("dcn:2,ici:4", 2),
    ("dcn:4,ici:2", 2),
)
# The one quantized per-link spec the audit records: outer (dcn) link
# quantized, inner (ici) exact, the JAX audit's choice. The inverse rides
# fp32 through the outer gather while the payload model prices the
# matmul's output bytes, so it stays out of scope here too.
_POD_QUANT = "dcn=fp8-block:32,ici=none"
_POD_AUDIT_SIZE = 256


# ---------------------------------------------------------------------------
# group program: sharded products + per-link-format gathers


def pod_operand_specs(mesh: Any) -> tuple[tuple, tuple]:
    """(A's spec, B's spec) of a group program: on a two-axis mesh A cut
    into rows over the outer axis and B into columns over the inner; on a
    one-axis mesh A replicated and B cut into columns."""
    axes = tuple(mesh.axis_names)
    if len(axes) == 2:
        return (axes[0], None), (None, axes[1])
    return (), (None, axes[0])


def pod_group_program(
    mesh: Any,
    impl: str = "torch",
    blocks: Any = None,
    device_kind: str = "",
    comm_quant: str | None = None,
) -> Callable[..., Any]:
    """The program of one replica group's mesh, `program(a, b)` over the
    operands cut by `pod_operand_specs` (a `Sharded` each).

    Two-axis mesh (outer, inner): each rank computes its [m/o, n/i] tile,
    then the tiles are stitched with an inner-axis gather (columns)
    followed by an outer-axis gather (rows). One-axis mesh: each rank
    computes [m, n/d], one gather. Gathers go through
    `allgather_impl(comm_quant, fuse_f32=True)`, so a quantized link
    dequantizes into fp32 and the program downcasts once. The output is
    the whole [m, n] on every rank of the group (JAX's `out_specs=P()`)."""
    from tpu_matmul_bench_torch.ops.matmul import matmul_2d
    from tpu_matmul_bench_torch.parallel.collectives import allgather_impl, over_axis
    from tpu_matmul_bench_torch.parallel.mesh import REPLICATED, Sharded, mesh_device_kind

    kind = device_kind or mesh_device_kind(mesh)
    mm = matmul_2d(impl, blocks, kind)
    ag = allgather_impl(comm_quant, fuse_f32=True)
    axes = tuple(mesh.axis_names)

    def gather(y: list, axis_name: str, dim: int) -> list:
        return over_axis(mesh, axis_name, y, lambda sub, g: ag(sub, g, axis=dim))

    def program(a, b):
        y = [mm(ar, br) for ar, br in zip(a, b)]  # each rank's tile
        out_dt = y[0].dtype
        if len(axes) == 2:
            o_ax, i_ax = axes
            y = gather(y, i_ax, 1)  # [m/o, n] a rank
            y = gather(y, o_ax, 0)  # [m, n]
        else:
            y = gather(y, axes[0], 1)
        return Sharded([yr.to(out_dt) for yr in y], REPLICATED, mesh.shape)

    return program


def _group_build(mesh: Any, device_kind: str,
                 comm_quant: str | None) -> Callable[[Any], Any]:
    """ExecutableCache build fn closing over one group's mesh."""
    from tpu_matmul_bench_torch.serve.cache import Program
    from tpu_matmul_bench_torch.serve.service import _resolve_key_impl
    from tpu_matmul_bench_torch.utils.metrics import is_integer_dtype

    def build(key: Any) -> Program:
        impl, blocks = _resolve_key_impl(key, device_kind)
        # wire formats are float-only: integer products take exact
        # gathers (the comms model prices them identically)
        quant = None if is_integer_dtype(key.dtype) else comm_quant
        return Program(pod_group_program(mesh, impl, blocks, device_kind, quant),
                       impl, blocks)

    return build


# ---------------------------------------------------------------------------
# per-group plumbing: sharded operands, locked stream/store, merged caches


class _GroupOperandPool:
    """Operand view cutting the base pool's tensors for a group's mesh.

    Reuses the base `_OperandPool`'s tensors (one generation a bucket
    across all groups, shared under `lock`) and cuts them with the group
    program's specs (`parallel/mesh.py shard_tensor`), memoised a bucket.
    Warm-start fills it from the main thread and the group's drain thread
    fills misses after the window opens, so the memo is guarded by its own
    lock; the cut itself runs outside both locks (racing fillers build
    twice and the first store wins).
    """

    def __init__(self, base: Any, mesh: Any, lock: threading.Lock) -> None:
        self._base = base
        self._mesh = mesh
        self._lock = lock
        self._cache_lock = threading.Lock()
        self._cache: dict[tuple[int, int, int, str], tuple[Any, ...]] = {}

    def get(self, key: Any) -> tuple[Any, ...]:
        from tpu_matmul_bench_torch.parallel.mesh import shard_tensor

        ck = (key.m, key.k, key.n, key.dtype)
        with self._cache_lock:
            got = self._cache.get(ck)
        if got is not None:
            return got
        with self._lock:
            a, b = self._base.get(key)
        spec_a, spec_b = pod_operand_specs(self._mesh)
        ops = (shard_tensor(a, spec_a, self._mesh),
               shard_tensor(b, spec_b, self._mesh))
        with self._cache_lock:
            return self._cache.setdefault(ck, ops)


class _LockedStream:
    """Serializes `write_raw` across group drain threads: JsonWriter has
    no lock of its own, and interleaved per-batch progress lines from G
    drains would corrupt the ledger."""

    def __init__(self, writer: Any) -> None:
        self._writer = writer
        self._lock = threading.Lock()

    def write_raw(self, obj: dict[str, Any]) -> None:
        with self._lock:
            self._writer.write_raw(obj)


class _LockedStore:
    """Serializes artifact-store access across the groups' warm-start and
    export paths (duck-typed: lookup/get_blob/put, what ExecutableCache
    touches)."""

    def __init__(self, store: Any) -> None:
        self._store = store
        self._lock = threading.Lock()

    def lookup(self, meta: Any) -> Any:
        with self._lock:
            return self._store.lookup(meta)

    def get_blob(self, rec: Any) -> Any:
        with self._lock:
            return self._store.get_blob(rec)

    def put(self, *args: Any, **kwargs: Any) -> Any:
        with self._lock:
            return self._store.put(*args, **kwargs)


class _MergedCaches:
    """Pod-wide cache view over one ExecutableCache a group.

    Presents the `serve_stats` cache contract (counter properties +
    `stats()` + `cost_analysis()`): scalars sum across groups; `by_entry`
    carries the unprefixed union first (what `_impl_sources` resolves
    sample labels against: group programs of one bucket share a label and
    a routing decision) plus ``g{i}:``-prefixed per-group rows.
    """

    def __init__(self, caches: Sequence[Any]) -> None:
        self._caches = list(caches)

    @property
    def hits(self) -> int:
        return sum(c.hits for c in self._caches)

    @property
    def misses(self) -> int:
        return sum(c.misses for c in self._caches)

    @property
    def evictions(self) -> int:
        return sum(c.evictions for c in self._caches)

    @property
    def preloaded(self) -> int:
        return sum(c.preloaded for c in self._caches)

    def stats(self) -> dict[str, Any]:
        per = [c.stats() for c in self._caches]
        out: dict[str, Any] = {
            "hits": sum(p["hits"] for p in per),
            "misses": sum(p["misses"] for p in per),
            "evictions": sum(p["evictions"] for p in per),
            "entries": sum(p["entries"] for p in per),
            "capacity": sum(p["capacity"] for p in per),
        }
        total = out["hits"] + out["misses"]
        out["hit_rate_pct"] = round(100.0 * out["hits"] / total, 2) \
            if total else 0.0
        pre: dict[str, Any] = {
            "count": 0, "total_ms": 0.0, "compiled": 0,
            "deserialized": 0, "compile_ms": 0.0, "deserialize_ms": 0.0}
        for p in per:
            for k in pre:
                pre[k] += p["preload"].get(k, 0)
        for k in ("total_ms", "compile_ms", "deserialize_ms"):
            pre[k] = round(pre[k], 3)
        out["preload"] = pre
        arts = [p["artifacts"] for p in per if "artifacts" in p]
        if arts:
            merged: dict[str, int] = {}
            for a in arts:
                for k, v in a.items():
                    merged[k] = merged.get(k, 0) + v
            out["artifacts"] = merged
        by_entry: dict[str, Any] = {}
        for i, p in enumerate(per):
            for label, row in p.get("by_entry", {}).items():
                by_entry.setdefault(label, row)  # unprefixed union
                by_entry[f"g{i}:{label}"] = row
        out["by_entry"] = by_entry
        return out

    def cost_analysis(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for i, c in enumerate(self._caches):
            for label, row in c.cost_analysis().items():
                out[f"g{i}:{label}"] = row
        return out


# ---------------------------------------------------------------------------
# placement front: one scheduler a group behind one submit() door


class PodQueue:
    """Routes admitted requests across per-group schedulers.

    Placement policy: least backlog among groups whose breaker for the
    request's (bucket, dtype) is CLOSED; ties break to the lowest group
    index. When every group's breaker is open, the request is delegated to
    the least-backlogged group, whose scheduler sheds it with its normal
    single terminal emission: PodQueue never retries after a shed (the
    scheduler already emitted the terminal trace record; a second attempt
    would duplicate trace ids). One poisoned group's open breaker
    therefore diverts, never sheds, the other groups' traffic.
    """

    def __init__(self, grid: ShapeGrid, groups: Sequence[ReplicaGroup],
                 scheds: Sequence[Any], recorder: Any = None) -> None:
        if not groups or len(groups) != len(scheds):
            raise ValueError(
                f"{len(groups)} group(s) but {len(scheds)} scheduler(s)")
        self.grid = grid
        self.groups = list(groups)
        self.scheds = list(scheds)
        # `_worker_drain` finds the recorder on its queue; the pod front
        # shares ONE recorder with every group scheduler, so terminal
        # records land in a single drained buffer
        self.recorder = recorder
        # serializes pick→stamp→enqueue: each group's depth read is locked
        # on its own, but without this lock two producers racing through
        # submit() both see the same backlogs and dogpile one group. Order:
        # _place_lock → scheduler._cond → recorder._lock (acyclic).
        self._place_lock = threading.Lock()

    @property
    def submitted(self) -> int:
        return sum(s.submitted for s in self.scheds)

    @property
    def shed(self) -> int:
        return sum(s.shed for s in self.scheds)

    @property
    def depth(self) -> int:
        return sum(s.depth for s in self.scheds)

    @property
    def offered(self) -> int:
        return sum(s.offered for s in self.scheds)

    def breaker_open(self, bucket: tuple[int, int, int],
                     dtype: str) -> bool:
        """Pod-level view: open only when EVERY group's breaker is."""
        return all(s.breaker_open(bucket, dtype) for s in self.scheds)

    def _pick_group(self, bucket: tuple[int, int, int], dtype: str) -> int:
        closed = [i for i, s in enumerate(self.scheds)
                  if not s.breaker_open(bucket, dtype)]
        pool = closed or list(range(len(self.scheds)))
        return min(pool, key=lambda i: (self.scheds[i].depth, i))

    def submit(self, req: Request) -> Request:
        bucket = self.grid.bucket(req.m, req.k, req.n)
        with self._place_lock:
            gi = self._pick_group(bucket, req.dtype)
            # stamped BEFORE submit: a shed terminal then carries the group
            # that refused, so `serve explain` attributes refusals too
            req.group = gi
            return self.scheds[gi].submit(req)

    def close(self) -> None:
        for s in self.scheds:
            s.close()

    def stats(self) -> dict[str, Any]:
        per = [s.stats() for s in self.scheds]
        breakers: dict[str, Any] = {}
        tenants: dict[str, dict[str, Any]] = {}
        for i, p in enumerate(per):
            for label, row in p.get("breakers", {}).items():
                breakers[f"g{i}:{label}"] = row
            for tid, row in p.get("tenants", {}).items():
                agg = tenants.setdefault(tid, {
                    "weight": row.get("weight"),
                    "priority": row.get("priority"),
                    "slo_ms": row.get("slo_ms"),
                    "submitted": 0, "shed": 0,
                })
                agg["submitted"] += row.get("submitted", 0)
                agg["shed"] += row.get("shed", 0)
        out: dict[str, Any] = {
            "scheduler": "pod",
            "replica_groups": len(self.scheds),
            "submitted": self.submitted,
            "shed": self.shed,
            "breaker_sheds": sum(p.get("breaker_sheds", 0) for p in per),
            "max_depth": per[0].get("max_depth"),
            "max_batch": per[0].get("max_batch"),
            "groups": {f"g{i}": p for i, p in enumerate(per)},
        }
        if breakers:
            out["breakers"] = breakers
        if tenants:
            out["tenants"] = {k: tenants[k] for k in sorted(tenants)}
        return out


# ---------------------------------------------------------------------------
# the pod serving arm


def _group_keys(config: Any, grid: ShapeGrid, group: ReplicaGroup,
                mesh: Any, tenants: Sequence[Any]) -> list[Any]:
    """Every ExecKey this run can dispatch on one group: the global mix
    plus each tenant-local mix, bucketed, keyed by the group's mesh."""
    from tpu_matmul_bench_torch.serve.cache import ExecKey
    from tpu_matmul_bench_torch.serve.loadgen import parse_mix

    entries = list(config.mix_entries)
    for t in tenants:
        if t.mix:
            entries.extend(parse_mix(t.mix))
    keys = {ExecKey(*grid.bucket(e.m, e.k, e.n), dtype=config.dtype_name,
                    impl=config.matmul_impl, mesh_shape=tuple(mesh.dims),
                    mesh_spec=group.placement)
            for e in entries}
    return sorted(keys, key=lambda kk: (kk.label, kk.mesh_spec))


def _make_group_cache(config: Any, info: Any, mesh: Any,
                      gpool: _GroupOperandPool, store: Any,
                      stream: Any, capture_lock: threading.Lock) -> Any:
    """One group's ExecutableCache: the group program's build, the
    placement-keyed artifact identity (as service._make_cache), the group's
    replay stream and the pod's shared capture lock."""
    from tpu_matmul_bench_torch.serve.cache import ExecutableCache
    from tpu_matmul_bench_torch.serve.service import _artifact_meta_fn

    return ExecutableCache(
        _group_build(mesh, info.device_kind, config.comm_quant),
        capacity=config.cache_capacity, operands=gpool.get,
        artifacts=store,
        artifact_meta=_artifact_meta_fn(info.device_kind, info.platform == "cuda")
        if store is not None else None,
        stream=stream, capture_lock=capture_lock)


def _group_caches(config: Any, info: Any, meshes: Sequence[Any], base_pool: Any,
                  store: Any) -> tuple[list[_GroupOperandPool], list[Any]]:
    """Each group's operand view on the shared base pool, and its cache.
    On the card each group replays on a stream of its own, and one lock
    serialises the groups' captures, taken in "thread_local" mode, so a
    drain thread may capture a miss while the others replay."""
    pool_lock, capture_lock = threading.Lock(), threading.Lock()
    gpools = [_GroupOperandPool(base_pool, mesh, pool_lock) for mesh in meshes]
    on_card = info.platform == "cuda"
    caches = [
        _make_group_cache(config, info, mesh, gpool, store,
                          torch.cuda.Stream(mesh.devices[0]) if on_card else None,
                          capture_lock)
        for mesh, gpool in zip(meshes, gpools)]
    return gpools, caches


def _run_pod_load(
    config: Any, q: PodQueue, meshes: Sequence[Any],
    caches: Sequence[Any], gpools: Sequence[_GroupOperandPool],
    tenants: Sequence[Any], stream: Any,
) -> tuple[list[list[Any]], float, dict[int, tuple[int, int, int]]]:
    """The pod counterpart of `_run_load`: one producer (open or closed
    loop) feeding the pod front, one `_worker_drain` thread a group. The
    producer runs on a side thread as usual; the main thread joins the
    group drains."""
    import tpu_matmul_bench_torch.serve.service as srv
    from tpu_matmul_bench_torch.serve.loadgen import (
        closed_loop_shapes,
        open_loop_schedule,
        tenant_closed_loop_shapes,
        tenant_open_loop_schedule,
    )
    from tpu_matmul_bench_torch.utils import telemetry

    samples_by_group: list[list[Any]] = [[] for _ in caches]
    schedule_shapes: dict[int, tuple[int, int, int]] = {}
    multi = config.tenants is not None
    with telemetry.span("load", mode=config.load_mode):
        t0 = time.perf_counter()
        sem = None
        if config.concurrency:
            requests = tenant_closed_loop_shapes(
                tenants, dtype=config.dtype_name, seed=config.seed,
                default_mix=config.mix) if multi else closed_loop_shapes(
                config.mix_entries, dtype=config.dtype_name,
                seed=config.seed)
            seen = srv._recording(requests, schedule_shapes)
            sem = threading.Semaphore(config.concurrency)
            producer = threading.Thread(
                target=srv._closed_loop_producer,
                args=(q, seen, t0 + config.duration_s, sem), daemon=True)
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
                target=srv._open_loop_producer, args=(q, schedule, t0),
                daemon=True)
        workers = []
        for gi, mesh in enumerate(meshes):
            on_complete = (lambda _r: sem.release()) if sem else None
            w = threading.Thread(
                target=srv._worker_drain,
                args=(q.scheds[gi], caches[gi], gpools[gi],
                      samples_by_group[gi]),
                kwargs=dict(
                    impl=config.matmul_impl,
                    mesh_shape=tuple(mesh.dims),
                    mesh_spec=q.groups[gi].placement,
                    on_complete=on_complete, stream=stream),
                name=f"pod-drain-g{gi}", daemon=True)
            w.start()
            workers.append(w)
        producer.start()
        producer.join()
        for w in workers:
            w.join()
        wall_s = time.perf_counter() - t0
    return samples_by_group, wall_s, schedule_shapes


def _pod_block(groups: Sequence[ReplicaGroup],
               samples_by_group: Sequence[Sequence[Any]],
               qstats: dict[str, Any], stats: dict[str, Any],
               tenants: Sequence[Any], wall_s: float) -> dict[str, Any]:
    """The ledger's ``extras["serve"]["pod"]`` block: per-group goodput
    rows plus the two pod headlines, `min_group_goodput_qps` (the weakest
    replica's useful throughput) and `worst_tenant_attainment_pct` (no
    tenant hides inside a pod average)."""
    import tpu_matmul_bench_torch.serve.service as srv

    slo_by = {t.tenant_id: t.slo_ms for t in tenants}
    rows = []
    for gi, group in enumerate(groups):
        samples = list(samples_by_group[gi])
        gstat = qstats["groups"][f"g{gi}"]
        good = sum(1 for s in samples
                   if slo_by.get(s.tenant) is None
                   or s.latency_s * 1e3 <= slo_by[s.tenant])
        rows.append({
            "group": f"g{gi}",
            "placement": group.placement,
            "mesh": group.mesh_spec,
            "devices": group.world,
            "requests": len(samples),
            "shed": gstat.get("shed", 0),
            "achieved_qps": round(len(samples) / wall_s, 2)
            if wall_s > 0 else 0.0,
            "goodput_qps": round(good / wall_s, 2) if wall_s > 0 else 0.0,
            "slo_attainment_pct": round(100.0 * good / len(samples), 2)
            if samples else 100.0,
            "p99_ms": srv._percentiles_ms(
                [s.latency_s for s in samples])["p99_ms"],
        })
    worst = min((row["slo_attainment_pct"]
                 for row in stats["tenants"].values()),
                default=stats["slo_attainment_pct"])
    return {
        "mesh": groups[0].parent_spec,
        "replica_groups": len(groups),
        "groups": rows,
        "min_group_goodput_qps": min(r["goodput_qps"] for r in rows),
        "worst_tenant_attainment_pct": worst,
    }


def _report_pod(pod: dict[str, Any]) -> None:
    lines = [
        f"  - Pod: {pod['replica_groups']} replica group(s) over "
        f"{pod['mesh']} — min-group goodput "
        f"{pod['min_group_goodput_qps']} QPS, worst-tenant SLO "
        f"{pod['worst_tenant_attainment_pct']}% attained",
    ]
    for r in pod["groups"]:
        lines.append(
            f"      {r['group']} [{r['mesh']} x{r['devices']}]: "
            f"{r['requests']} done / {r['shed']} shed, goodput "
            f"{r['goodput_qps']} QPS, slo {r['slo_attainment_pct']}%, "
            f"p99 {r['p99_ms']} ms")
    report(*lines)


def _pod_arm(config: Any, info: Any, devices: Sequence[Any],
             writer: Any) -> tuple[dict[str, Any], Any]:
    """One full pod serving run against an open ledger writer; returns
    (serve stats, ledger record). The record is NOT yet written: the
    caller owns write order (bench writes one, ab writes both arms)."""
    import tpu_matmul_bench_torch.serve.service as srv
    from tpu_matmul_bench_torch.serve.scheduler import ContinuousScheduler
    from tpu_matmul_bench_torch.serve.trace import FlightRecorder
    from tpu_matmul_bench_torch.tune.artifacts import ArtifactStore
    from tpu_matmul_bench_torch.utils import telemetry

    if config.scheduler == "fixed":
        raise ValueError(
            "pod serving requires the continuous scheduler: the "
            "fixed-window queue has no breaker/SLO state to place "
            "against (drop --scheduler fixed or drop --mesh)")
    if config.explore:
        raise ValueError(
            "pod serving does not compose with --explore yet: shadow "
            "routing would need per-group alternate executables")

    groups = partition_spec(config.mesh, config.replica_groups)
    world = mesh_world(config.mesh)
    problems = partition_problems(groups, world)
    if problems:  # unreachable via partition_spec; belt for callers
        raise ValueError("; ".join(problems))
    pairs = group_meshes(devices, config.mesh, config.replica_groups)
    meshes = [mesh for _, mesh in pairs]

    grid = ShapeGrid(config.grid) if config.grid else ShapeGrid()
    tenants = config.tenant_specs
    srv._build_kernels(config, grid, tenants, world, info)
    recorder = FlightRecorder()
    scheds = [
        ContinuousScheduler(grid, tenants=tenants,
                            max_depth=config.max_depth,
                            max_batch=config.max_batch,
                            starvation_ms=config.starvation_ms,
                            recorder=recorder)
        for _ in groups]
    q = PodQueue(grid, groups, scheds, recorder=recorder)

    store = None
    if config.artifacts is not None:
        store = _LockedStore(ArtifactStore.load(config.artifacts or None))
    gpools, caches = _group_caches(config, info, meshes,
                                   srv._OperandPool(config.seed, devices[0]), store)
    merged = _MergedCaches(caches)
    stream = _LockedStream(writer) if writer is not None else None

    prewarmed = 0
    if config.prewarm:
        with telemetry.span("prewarm", groups=len(groups)):
            for gi, (group, mesh) in enumerate(pairs):
                prewarmed += caches[gi].warm_start(
                    _group_keys(config, grid, group, mesh, tenants))

    samples_by_group, wall_s, schedule_shapes = _run_pod_load(
        config, q, meshes, caches, gpools, tenants, stream)

    samples = sorted((s for g in samples_by_group for s in g),
                     key=lambda s: s.rid)
    requested_f, executed_f, bucket_f = srv._flops(samples, schedule_shapes)
    stats = srv.serve_stats(
        samples, q, merged, load_mode=config.load_mode,
        offered_qps=None if config.concurrency else config.qps,
        wall_s=wall_s, requested_flops=requested_f,
        executed_flops=executed_f, tenants=tenants,
        bucket_flops=bucket_f, matmul_impl=config.matmul_impl,
        device_kind=info.device_kind)
    stats["pod"] = _pod_block(groups, samples_by_group, stats["queue"],
                              stats, tenants, wall_s)
    rec = srv._serve_record(config, stats, samples, info.device_kind, world,
                            mode=config.load_mode,
                            executed_flops=executed_f, wall_s=wall_s,
                            prewarmed=prewarmed)
    srv._attach_cost_analysis(rec, merged)
    srv._report_summary(stats)
    _report_pod(stats["pod"])
    return stats, rec


def _pod_devices(config: Any) -> tuple[list[Any], Any]:
    """The pod's ranks (exactly the mesh's world) + their info. On the
    card a mesh with more ranks than the cards hold raises, naming
    TMB_RANKS_PER_CARD: no ranks are piled onto a card unasked."""
    from tpu_matmul_bench_torch.utils.device import (
        collect_device_info,
        device_banner,
        resolve_devices,
    )

    world = mesh_world(config.mesh)
    try:
        devices = resolve_devices(config.device, world)
    except ValueError as e:
        raise ValueError(f"pod mesh {config.mesh!r} spans {world} ranks: {e}") from None
    info = collect_device_info(devices)
    report(device_banner(info))
    return devices, info


def _pod_header(config: Any, info: Any) -> None:
    groups = partition_spec(config.mesh, config.replica_groups)
    report(header(
        "Pod-Scale Matmul Serving (replica groups)",
        {
            "Pod mesh": f"{config.mesh} ({mesh_world(config.mesh)} ranks on "
                        f"{info.cards} device(s), {info.ranks_per_card} a device)",
            "Replica groups": f"{len(groups)} x {groups[0].mesh_spec}",
            "Comm quantization": config.comm_quant or "none (exact)",
            "Load mode": config.load_mode
            + (f" (concurrency {config.concurrency})"
               if config.concurrency else f" ({config.qps} QPS Poisson)"),
            "Duration": f"{config.duration_s} s",
            "Request mix": config.mix,
            "Data type": config.dtype_name,
            "Matmul implementation": config.matmul_impl,
        },
    ))


def _ledger(config: Any, load_mode: str | None = None):
    import tpu_matmul_bench_torch.serve.service as srv
    from tpu_matmul_bench_torch.utils import telemetry
    from tpu_matmul_bench_torch.utils.reporting import JsonWriter

    return JsonWriter(config.json_out,
                      manifest=telemetry.build_manifest(
                          device=config.device,
                          extra={"serve_config": srv._config_manifest(
                              config, load_mode)}),
                      append=config.append_ledger)


def run_pod_bench(config: Any) -> list[Any]:
    """The `serve bench --mesh ...` program: one pod load run → one
    schema-v2 serve ledger whose record carries the ``pod`` block."""
    import tpu_matmul_bench_torch.serve.service as srv
    from tpu_matmul_bench_torch.utils import telemetry

    devices, info = _pod_devices(config)
    _pod_header(config, info)
    with telemetry.session(config.trace_out), srv._exporter(config), \
            _ledger(config) as writer:
        _stats, rec = _pod_arm(config, info, devices, writer)
        writer.write(rec)
    return [rec]


def run_pod_ab(config: Any) -> list[Any]:
    """The `serve ab --mesh ...` program: the SAME seeded tenant stream
    through a single-device continuous arm, then through the pod: two
    records in one ledger, the noise-aware verdict (`serve ab`'s
    `_ab_verdict` block) on the pod record's ``extras["ab"]``. Exits 1 when
    the pod regresses p99 or goodput beyond the widened tolerance."""
    import tpu_matmul_bench_torch.serve.service as srv
    from tpu_matmul_bench_torch.utils import telemetry

    devices, info = _pod_devices(config)
    tenants = config.tenant_specs
    grid = ShapeGrid(config.grid) if config.grid else ShapeGrid()
    single_cfg = dataclasses.replace(config, mesh=None, replica_groups=1)

    records: list[Any] = []
    with telemetry.session(config.trace_out), srv._exporter(config), \
            _ledger(config, "ab") as writer:
        # arm 1: one device, the continuous scheduler, the single product's
        # executables: the throughput floor the pod must clear. A fresh
        # pool, cache and admission path, exactly as `serve ab`
        srv._build_kernels(single_cfg, grid, tenants, 1, info)
        srv._bench_header(single_cfg, "continuous", tenants)
        pool = srv._OperandPool(single_cfg.seed, devices[0])
        cache = srv._make_cache(single_cfg, info.device_kind, pool)
        q = srv._make_admission(single_cfg, grid, tenants,
                                scheduler="continuous")
        prewarmed = srv._prewarm(single_cfg, grid, cache, 1, tenants,
                                 info.device_kind) \
            if single_cfg.prewarm else 0
        samples, wall_s, shapes = srv._run_load(
            single_cfg, pool, cache, q, tenants, 1, stream=writer)
        requested_f, executed_f, bucket_f = srv._flops(samples, shapes)
        single = srv.serve_stats(
            samples, q, cache, load_mode=single_cfg.load_mode,
            offered_qps=None if single_cfg.concurrency else single_cfg.qps,
            wall_s=wall_s, requested_flops=requested_f,
            executed_flops=executed_f, tenants=tenants,
            bucket_flops=bucket_f, matmul_impl=single_cfg.matmul_impl,
            device_kind=info.device_kind)
        rec = srv._serve_record(single_cfg, single, samples,
                                info.device_kind, 1,
                                mode=single_cfg.load_mode,
                                executed_flops=executed_f, wall_s=wall_s,
                                prewarmed=prewarmed)
        srv._attach_cost_analysis(rec, cache)
        srv._report_summary(single)
        records.append(rec)
        del cache, pool

        # arm 2: the pod
        _pod_header(config, info)
        pod_stats, pod_rec = _pod_arm(config, info, devices, writer)
        verdict = srv._ab_verdict(single, pod_stats, "single", "pod")
        pod_rec.extras["ab"] = verdict
        records.append(pod_rec)
        for r in records:
            writer.write(r)
    if verdict["regressed"]:
        raise SystemExit(1)
    return records


# ---------------------------------------------------------------------------
# certification: POD-001..003 + the selftest


def pod_collective_scope_problems(
        log: Sequence[tuple[str, str, int]],
        allowed_axes: Sequence[str]) -> list[str]:
    """POD-003 as checkable problems: every collective a group program
    made (a recorded log of (kind, axis, payload bytes)) must run over one
    of the group's own mesh axes; any other axis means one group's request
    traffic rides another group's links."""
    allowed = set(allowed_axes)
    return [f"{kind} over axis {axis!r} escapes the group's axes "
            f"{sorted(allowed)}" for kind, axis, _ in log if axis not in allowed]


def pod_findings(devices: Sequence[Any]) -> list[Any]:
    """The POD-001/002/003 audit over 8 ranks (`devices`, one entry a
    rank).

    For each transposed factorization of the 8-rank world: check the
    replica-group partition covers the mesh disjointly (POD-001), run every
    group's program at the audit size under the exact and the pinned
    quantized per-link wire spec while its collectives are recorded
    (`train/audit.py record_collectives`), and diff the log against
    `comms_model.pod_expected_collectives`, once an axis group (POD-002);
    and ban any collective over an axis outside the group's own mesh
    (POD-003)."""
    from tpu_matmul_bench_torch.analysis.comms_model import pod_expected_collectives
    from tpu_matmul_bench_torch.analysis.findings import Finding
    from tpu_matmul_bench_torch.ops.matmul import random_operands
    from tpu_matmul_bench_torch.parallel.mesh import mesh_device_kind, shard_tensor
    from tpu_matmul_bench_torch.train.audit import record_collectives

    findings: list[Finding] = []
    world = max(mesh_world(spec) for spec, _g in _POD_FACTORIZATIONS)
    if len(devices) < world:
        findings.append(Finding(
            "POD-001", "pod:mesh",
            f"pod audit needs {world} ranks, got {len(devices)} — set "
            f"TMB_RANKS_PER_CARD to put {world} on one device",
            severity="warn"))
        return findings

    s = _POD_AUDIT_SIZE
    a, b = random_operands(0, (s, s), torch.bfloat16, device=devices[0])
    for spec, n_groups in _POD_FACTORIZATIONS:
        groups = partition_spec(spec, n_groups)
        for p in partition_problems(groups, mesh_world(spec)):
            findings.append(Finding("POD-001", f"pod:{spec}", p))
        for group, mesh in group_meshes(devices, spec, n_groups):
            where = f"pod:{group.placement}"
            kind = mesh_device_kind(mesh)
            spec_a, spec_b = pod_operand_specs(mesh)
            ops = shard_tensor(a, spec_a, mesh), shard_tensor(b, spec_b, mesh)
            for quant in (None, _POD_QUANT):
                program = pod_group_program(mesh, "torch", None, kind, quant)
                with record_collectives() as log:
                    program(*ops)
                want: collections.Counter = collections.Counter()
                for k, ax, nbytes in pod_expected_collectives(
                        group.mesh_spec, s, s, s, torch.bfloat16, quant):
                    want[(k, ax, nbytes)] += len(mesh.axis_groups(ax))
                got = collections.Counter(log)
                if got != want:
                    findings.append(Finding(
                        "POD-002", where,
                        f"recorded collective inventory under "
                        f"comm_quant={quant or 'none'} diverges from "
                        f"the comms model",
                        details={"observed": sorted(map(list, got.elements())),
                                 "expected": sorted(map(list, want.elements()))}))
                for p in pod_collective_scope_problems(log, mesh.axis_names):
                    findings.append(Finding(
                        "POD-003", where,
                        f"under comm_quant={quant or 'none'}: {p}"))
    return findings


def run_pod_selftest(config: Any) -> list[Any]:
    """`serve pod selftest`: the pod layer's end-to-end check. Three
    certifications in one pass:

    1. **audit**: POD-001..003 are clean (the partition covers disjointly,
       the recorded collectives match the comms model at both transposed
       factorizations, no cross-group collective in any group program);
    2. **warm-start + conservation**: a seeded pod run completes with
       `cold_requests == 0` after prewarm, the serve record validates, and
       every completed request landed in exactly one replica group
       (per-group counts sum to the headline);
    3. **attribution**: every complete flight-recorder span carries the
       `replica_group` that served it, per-group span counts reconcile with
       the pod block, and `serve explain --slowest 3` renders the group
       label.

    Exits nonzero on any violation."""
    import tempfile
    from pathlib import Path

    from tpu_matmul_bench_torch.serve import trace as flight
    from tpu_matmul_bench_torch.serve.service import validate_serve_record
    from tpu_matmul_bench_torch.utils.device import resolve_devices

    problems: list[str] = []
    try:
        audit_devices = resolve_devices(config.device, None)
    except ValueError as e:
        raise SystemExit(f"serve pod selftest: {e}") from None
    findings = pod_findings(audit_devices)
    problems.extend(
        f"audit: {f.rule} at {f.where}: {f.message}" for f in findings)
    with tempfile.TemporaryDirectory(prefix="serve-pod-") as td:
        ledger = str(Path(td) / "pod.jsonl")
        run_cfg = dataclasses.replace(
            config,
            mesh=config.mesh or "dcn:2,ici:4",
            replica_groups=config.replica_groups
            if config.replica_groups > 1 else 2,
            scheduler="continuous",
            mix="256", qps=80.0, duration_s=0.6, concurrency=None,
            tenants=None, json_out=ledger, append_ledger=False,
            trace_out=None, obs_dir=None, prewarm=True, explore=0.0,
            explore_db=None)
        report(header("Serve pod selftest (seeded run)", {
            "Pod mesh": run_cfg.mesh,
            "Replica groups": run_cfg.replica_groups,
            "Offered load": f"{run_cfg.qps} QPS x {run_cfg.duration_s} s",
        }))
        records = run_pod_bench(run_cfg)
        rec = records[0]
        problems.extend(f"serve record: {p}"
                        for p in validate_serve_record(rec))
        serve = rec.extras["serve"]
        if serve.get("scheduler") != "pod":
            problems.append(
                f"scheduler is {serve.get('scheduler')!r}, not 'pod'")
        if serve.get("cold_requests"):
            problems.append(
                f"warm-start failed: {serve['cold_requests']} request(s) "
                "paid a cold compile after the per-group prewarm")
        pod = serve.get("pod")
        if not isinstance(pod, dict):
            problems.append("serve record lacks the pod block")
            pod = {"groups": []}
        group_total = sum(r["requests"] for r in pod["groups"])
        if group_total != serve["requests"]:
            problems.append(
                f"conservation broken: per-group requests sum to "
                f"{group_total}, headline says {serve['requests']}")
        for key in ("min_group_goodput_qps", "worst_tenant_attainment_pct"):
            if key not in pod:
                problems.append(f"pod block lacks {key!r}")

        _manifest, span_recs, read_problems = \
            flight.read_trace_records(ledger)
        problems.extend(f"ledger read: {p}" for p in read_problems)
        for d in span_recs:
            problems.extend(
                f"trace {d.get('trace')}: {p}"
                for p in flight.validate_serve_span_record(d))
        completes = [d for d in span_recs if d.get("state") == "complete"]
        if len(completes) != serve["requests"]:
            problems.append(
                f"{len(completes)} complete span records vs "
                f"{serve['requests']} completed requests")
        unattributed = [d for d in completes if "replica_group" not in d]
        if unattributed:
            problems.append(
                f"{len(unattributed)} complete span record(s) lack the "
                "replica_group label — tail attribution is blind")
        by_group: dict[int, int] = {}
        for d in completes:
            g = d.get("replica_group")
            if isinstance(g, int):
                by_group[g] = by_group.get(g, 0) + 1
        for row in pod["groups"]:
            gi = int(row["group"][1:])
            if by_group.get(gi, 0) != row["requests"]:
                problems.append(
                    f"group {row['group']}: {by_group.get(gi, 0)} "
                    f"complete spans vs {row['requests']} ledger requests")
        traces = [d["trace"] for d in span_recs if "trace" in d]
        if len(traces) != len(set(traces)):
            problems.append("duplicate trace ids across terminal records")
        lines, rc = flight.render_explain(span_recs, slowest=3)
        report(*lines)
        if rc != 0:
            problems.append("explain --slowest 3 failed reconciliation")
        if completes and not any("group=g" in ln for ln in lines):
            problems.append(
                "explain output never names a replica group — the "
                "group=gN tail-attribution label is missing")
    if problems:
        report(*[f"pod selftest FAILED: {p}" for p in problems],
               file=sys.stderr)
        raise SystemExit(1)
    report(f"pod selftest ok: POD-001..003 clean at "
           f"{len(_POD_FACTORIZATIONS)} factorizations, "
           f"{serve['requests']} requests conserved across "
           f"{pod['replica_groups']} groups cold-free, "
           f"{len(completes)} spans group-attributed")
    return records
