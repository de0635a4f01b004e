"""Executable cache: one captured program a problem class, LRU-bounded.

Port of `tpu_matmul_bench/serve/cache.py`. An offline benchmark absorbs
its set-up in the warm-up and never sees it again; a service has no
warm-up: the first request of a new shape pays the set-up, its successors
want pure dispatch. The cache makes that split explicit.

**What an executable is.** In the JAX package it is an AOT-compiled
program: fixed shapes, a call dispatches with no retrace. Here it is a
**CUDA graph**, captured over the bucket's pooled operands (the service's
`_OperandPool`, or a pod group's `serve/pod.py _GroupOperandPool`): one
product into an output the entry owns, or a pod replica group's whole
program (every rank's product and every gather) into a replicated output
the graph's memory pool holds. `compiled(a, b)` replays the graph and
returns that output; `compiled.wait()` waits for it. The graph reads the
captured tensors, so given any others it raises; it never runs eagerly
instead. On the CPU, where there is no graph, the entry is the eager plain
call, checked against the key's shapes, with the same accounting.

- `cold_compile_s`, what the first request of a key pays: the build
  callable's route resolution (`auto` through the memoised
  `ops/impl_select.select_impl`), one eager call on a side stream (it
  loads the built kernel library, runs `tmb_init` and creates the
  library's handles and workspaces, which a capture cannot), the capture
  (the kernel's tensor maps are encoded then and baked into the graph),
  and a sync. Building the library with nvcc happens before any of this,
  in the service's set-up, or in the preload when an artifact store is
  attached: it never lands in a request.
- `warm_dispatch_s`: the second replay plus a wait, as the JAX package
  times the second dispatch.
- `cost`: a `cuda` entry's launches in the kernels' cost books
  (`obs/attribution.attribution_block`: route, tile, padded-tile flops
  and bytes, summed over a group's ranks); a `torch` entry carries none,
  as the `matmul` records do.

With an **artifact store** attached (`tune/artifacts.py`), `warm_start`
first imports each fresh `cuda` key's kernel library from the store
(digest checked, put into the build directory, loaded, then the capture:
no nvcc), and on a store miss builds and captures as before, then exports
the library, so the next process imports it. `source` is "artifact" or
"compile", and the preload time is split by phase (compile, deserialize).
A blob whose digest fails counts an `error` and the key is built from the
sources; its bytes are never loaded.

Replays from several threads (a pod's drain threads) each use the group's
own stream; a capture then runs under the caches' shared lock in
"thread_local" mode, so the other threads' replays go on.

A replay is one host call for the captured kernels, so a warm request pays
the graph launch and the wait, not the wrappers' route checks and
argument packing. Capacity is LRU-bounded: each entry pins its graph and
its output on the card.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Iterable

import torch

from tpu_matmul_bench_torch.obs.registry import get_registry
from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.metrics import matmul_out_dtype
from tpu_matmul_bench_torch.utils.reporting import report
from tpu_matmul_bench_torch.utils.timing import sync

DEFAULT_CAPACITY = 64

_CACHE_EVENTS = ("hit", "miss", "eviction", "preload")
_PRELOAD_PHASES = ("compile", "deserialize")
_ARTIFACT_EVENTS = ("hit", "miss", "export", "error")


@dataclasses.dataclass(frozen=True)
class ExecKey:
    """Identity of one cached executable: the padded problem class.

    `impl` is the matmul implementation the build callable resolves ("torch",
    "cuda", "auto"); `mesh_shape` the ranks' mesh (one card: (1,)).
    `mesh_spec` is the pod placement label (serve/placement.py) of a replica
    group's executable, so two groups of identical shape key distinct
    executables; empty on the single-device path.
    """

    m: int
    k: int
    n: int
    dtype: str
    impl: str
    mesh_shape: tuple[int, ...] = (1,)
    mesh_spec: str = ""

    @property
    def label(self) -> str:
        return f"{self.m}x{self.k}x{self.n}/{self.dtype}/{self.impl}"


@dataclasses.dataclass(frozen=True)
class Program:
    """What a key builds from: `fn(a, b)`, and the impl and tile request it
    resolved to ("torch" or "cuda"). A single product takes plain tensors
    and `out=`; a pod group's program takes its sharded operands (a
    `parallel/mesh.Sharded` each) and returns its replicated output."""

    fn: Callable[..., Any]
    impl: str
    blocks: tuple[int, int, int] | None = None


def _first(x: Any) -> torch.Tensor:
    """A plain operand, or a sharded operand's first shard."""
    return x if isinstance(x, torch.Tensor) else x[0]


def _shapes(x: Any) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) \
        else tuple(tuple(s.shape) for s in x)


class GraphExecutable:
    """One program captured in a CUDA graph over fixed operands. With a
    `stream` it replays there and `wait` waits for that stream alone;
    otherwise on the caller's current stream, and `wait` syncs the card."""

    def __init__(self, graph: torch.cuda.CUDAGraph, a: Any, b: Any, out: Any,
                 stream: torch.cuda.Stream | None = None) -> None:
        self._graph = graph
        self._a, self._b = a, b  # held: the graph reads their memory
        self.out = out
        self.stream = stream

    def __call__(self, a: Any, b: Any) -> Any:
        if a is not self._a or b is not self._b:
            raise ValueError(
                "a captured executable replays the operands it was captured "
                "over; it was given other tensors")
        with torch.cuda.stream(self.stream) if self.stream is not None \
                else contextlib.nullcontext():
            self._graph.replay()
        return self.out

    def wait(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()
        else:
            sync(self.out)


class EagerExecutable:
    """The CPU's entry: the eager product, held to the key's shapes and
    dtype as a compiled program would be."""

    def __init__(self, fn: Callable[..., Any], a: Any, b: Any) -> None:
        self._fn = fn
        self._spec = (_shapes(a), _shapes(b), _first(a).dtype, _first(a).device)

    def __call__(self, a: Any, b: Any) -> Any:
        spec = (_shapes(a), _shapes(b), _first(a).dtype, _first(a).device)
        if spec != self._spec:
            raise ValueError(f"executable built for {self._spec}, "
                             f"called with {spec}")
        return self._fn(a, b)

    def wait(self) -> None:
        """Nothing to wait for: the CPU's product returned done."""


def capture(fn: Callable[..., Any], a: Any, b: Any, *,
            stream: torch.cuda.Stream | None = None,
            thread_local: bool = False) -> GraphExecutable:
    """`fn(a, b)` captured into a CUDA graph. A single product (plain
    tensors) writes an output the entry allocates; a group program (sharded
    operands) allocates its own inside the capture, from the graph's pool.
    A first eager call on a side stream sets up what the callee creates
    lazily (the kernel library and its `tmb_init`, cuBLAS's handle and
    workspace), which a capture cannot; then the capture, then a sync.
    `stream` is where the graph replays; `thread_local` captures in that
    mode, so other threads' replays may run meanwhile (the caller
    serialises captures)."""
    device = _first(a).device
    plain = isinstance(a, torch.Tensor)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=matmul_out_dtype(a.dtype),
                      device=device) if plain else None
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        if plain:
            fn(a, b, out=out)
        else:
            fn(a, b)
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local" if thread_local
                          else "global"):
        if plain:
            fn(a, b, out=out)
        else:
            out = fn(a, b)
    torch.cuda.synchronize(device)
    return GraphExecutable(graph, a, b, out, stream)


@dataclasses.dataclass
class CacheEntry:
    """One executable plus its measured cost split."""

    key: ExecKey
    compiled: Callable[..., Any]
    cold_compile_s: float  # route + library + first call + capture wall time
    warm_dispatch_s: float  # one replay + sync of the executable
    hits: int = 0
    built_at: float = 0.0
    # the kernels' cost books for a `cuda` entry's launches
    # (obs/attribution.py); None for the library product
    cost: dict[str, Any] | None = None
    # how the executable got here: "compile" (built and captured in this
    # process) or "artifact" (its kernel library imported from the store)
    source: str = "compile"
    deserialize_s: float = 0.0  # digest check + install + load + capture


class ExecutableCache:
    """LRU cache of executables.

    ``build(key)`` returns the key's `Program`; ``operands(key)`` the
    concrete (A, B) the executable is captured over and its warm dispatch
    is measured on. On the card the entry is a `GraphExecutable`; on the
    CPU an `EagerExecutable`. ``artifacts`` (tune/artifacts.ArtifactStore,
    duck-typed: lookup/get_blob/put) and ``artifact_meta(key)`` (an
    ArtifactMeta, or None for a key with no library to store) attach the
    store; ``stream`` is where this cache's graphs replay, and
    ``capture_lock``, shared by caches whose graphs replay from several
    threads, serialises their captures (taken in "thread_local" mode).
    """

    def __init__(
        self,
        build: Callable[[ExecKey], Program],
        *,
        operands: Callable[[ExecKey], tuple[Any, Any]],
        capacity: int = DEFAULT_CAPACITY,
        artifacts: Any | None = None,
        artifact_meta: Callable[[ExecKey], Any] | None = None,
        stream: torch.cuda.Stream | None = None,
        capture_lock: threading.Lock | None = None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._build = build
        self._operands = operands
        self._capacity = capacity
        self._artifacts = artifacts
        self._artifact_meta = artifact_meta
        self._stream = stream
        self._capture_lock = capture_lock
        self._entries: collections.OrderedDict[ExecKey, CacheEntry] = (
            collections.OrderedDict())
        # counters live on the obs bus; each cache instance gets its own
        # instruments (snapshot() aggregates across instances, while the
        # properties below read only this cache's, so per-window ledger
        # stats stay per window)
        reg = get_registry()
        self._events = {e: reg.counter("serve_cache_events", event=e)
                        for e in _CACHE_EVENTS}
        self._preload_seconds = {
            p: reg.counter("serve_cache_preload_seconds", phase=p)
            for p in _PRELOAD_PHASES}
        self._preload_counts = dict.fromkeys(_PRELOAD_PHASES, 0)
        self._artifact_events = {
            e: reg.counter("serve_cache_artifact_events", event=e)
            for e in _ARTIFACT_EVENTS} if artifacts is not None else None

    @property
    def hits(self) -> int:
        return int(self._events["hit"].value)

    @property
    def misses(self) -> int:
        return int(self._events["miss"].value)

    @property
    def evictions(self) -> int:
        return int(self._events["eviction"].value)

    @property
    def preloaded(self) -> int:
        return int(self._events["preload"].value)

    @property
    def preload_s(self) -> float:
        return sum(c.value for c in self._preload_seconds.values())

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: ExecKey) -> bool:
        return key in self._entries

    def get(self, key: ExecKey) -> CacheEntry:
        """The entry for `key`, compiling on miss. Hits refresh LRU order."""
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self._events["hit"].inc()
            entry.hits += 1
            return entry
        self._events["miss"].inc()
        entry = self._compile(key)
        self._insert(key, entry)
        return entry

    def warm_start(self, keys: Iterable[ExecKey]) -> int:
        """Acquire every not-yet-resident key eagerly: the measured preload
        phase that turns first-request cold compiles into start-up cost.
        With an artifact store each key is first imported from the store;
        only store misses compile, and each fresh compile is exported back
        so the next process imports it. Either path is a counted miss, so
        accesses = preloads + served requests, and every later request for
        a preloaded key is a warm hit. Already-resident keys are skipped
        without touching a counter. Returns the number of executables
        acquired."""
        fresh = [k for k in dict.fromkeys(keys) if k not in self._entries]
        for key in sorted(fresh, key=lambda kk: kk.label):
            t0 = time.perf_counter()
            entry = self._import_artifact(key)
            if entry is not None:
                self._events["miss"].inc()
                self._insert(key, entry)
                self._preload_seconds["deserialize"].inc(
                    time.perf_counter() - t0)
                self._preload_counts["deserialize"] += 1
            else:
                self.get(key)
                self._preload_seconds["compile"].inc(time.perf_counter() - t0)
                self._preload_counts["compile"] += 1
                self._export_artifact(key)
        self._events["preload"].inc(len(fresh))
        return len(fresh)

    def _insert(self, key: ExecKey, entry: CacheEntry) -> None:
        self._entries[key] = entry
        while len(self._entries) > self._capacity:
            self._entries.popitem(last=False)
            self._events["eviction"].inc()

    def _import_artifact(self, key: ExecKey) -> CacheEntry | None:
        """`key`'s executable built on its library from the store, or None
        (no store, a key with no library, a store miss, or a blob whose
        digest fails: the caller then builds from the sources). A library
        that passes its digest but fails to load or launch raises."""
        if self._artifacts is None or self._artifact_meta is None:
            return None
        meta = self._artifact_meta(key)
        if meta is None:
            return None
        rec = self._artifacts.lookup(meta)
        if rec is None:
            self._artifact_events["miss"].inc()
            return None
        from tpu_matmul_bench_torch.tune.artifacts import install_library

        t0 = time.perf_counter()
        with telemetry.span(f"artifact-import:{key.label}"):
            blob = self._artifacts.get_blob(rec)
            if blob is None:  # digest mismatch or unreadable: rebuild
                self._artifact_events["error"].inc()
                report(f"artifact {rec.get('blob')} for {key.label} rejected "
                       "(digest); building from the sources")
                return None
            try:
                install_library(blob)
            except OSError as e:
                self._artifact_events["error"].inc()
                report(f"artifact install failed for {key.label}: {e}; "
                       "building from the sources")
                return None
            entry = self._compile(key)
        self._artifact_events["hit"].inc()
        entry.source = "artifact"
        entry.deserialize_s = time.perf_counter() - t0
        entry.cold_compile_s = 0.0
        return entry

    def _export_artifact(self, key: ExecKey) -> None:
        """Store the kernel library of a freshly compiled resident `cuda`
        entry, so the next process imports it instead of running nvcc."""
        if self._artifacts is None or self._artifact_meta is None:
            return
        entry = self._entries.get(key)
        if entry is None or entry.source != "compile":
            return
        meta = self._artifact_meta(key)
        if meta is None:
            return
        from tpu_matmul_bench_torch.tune.artifacts import pack_library

        try:
            self._artifacts.put(meta, pack_library())
        except OSError as e:
            # export is best-effort, as the JAX package's: serving does not
            # fail because the store could not persist
            self._artifact_events["error"].inc()
            report(f"artifact export failed for {key.label}: {e}")
            return
        self._artifact_events["export"].inc()

    def _compile(self, key: ExecKey) -> CacheEntry:
        a, b = self._operands(key)
        with telemetry.span(f"compile:{key.label}"):
            t0 = time.perf_counter()
            program = self._build(key)
            if _first(a).is_cuda:
                with self._capture_lock or contextlib.nullcontext():
                    compiled = capture(program.fn, a, b, stream=self._stream,
                                       thread_local=self._capture_lock is not None)
            else:
                compiled = EagerExecutable(program.fn, a, b)
            cold_s = time.perf_counter() - t0
        # the first replay of a fresh graph can still page in memory; the
        # second is the steady warm path
        compiled(a, b)
        compiled.wait()
        t0 = time.perf_counter()
        compiled(a, b)
        compiled.wait()
        warm_s = time.perf_counter() - t0
        cost = None
        if program.impl == "cuda":
            cost = _cost_books(_first(a), _first(b), program.blocks,
                               1 if isinstance(a, torch.Tensor) else len(a))
        return CacheEntry(key=key, compiled=compiled, cold_compile_s=cold_s,
                          warm_dispatch_s=warm_s, built_at=time.time(),
                          cost=cost)

    def stats(self) -> dict[str, Any]:
        """Ledger-ready counters + per-entry cost split (ms, rounded), the
        JAX package's keys."""
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "entries": len(self._entries),
            "capacity": self._capacity,
            "hit_rate_pct": round(100.0 * self.hits / total, 2)
            if total else 0.0,
            "preload": {
                "count": self.preloaded,
                "total_ms": round(self.preload_s * 1e3, 3),
                "compiled": self._preload_counts["compile"],
                "deserialized": self._preload_counts["deserialize"],
                "compile_ms": round(
                    self._preload_seconds["compile"].value * 1e3, 3),
                "deserialize_ms": round(
                    self._preload_seconds["deserialize"].value * 1e3, 3),
            },
            **({"artifacts": {
                f"{e}s" if e != "miss" else "misses":
                    int(c.value) for e, c in self._artifact_events.items()
            }} if self._artifact_events is not None else {}),
            "by_entry": {
                e.key.label: {
                    "cold_compile_ms": round(e.cold_compile_s * 1e3, 3),
                    "warm_dispatch_ms": round(e.warm_dispatch_s * 1e3, 3),
                    "hits": e.hits,
                    "source": e.source,
                    **({"deserialize_ms": round(e.deserialize_s * 1e3, 3)}
                       if e.source == "artifact" else {}),
                }
                for e in self._entries.values()
            },
        }

    def cost_analysis(self) -> dict[str, Any]:
        """Per-entry cost books, keyed by entry label: the ledger's
        additive ``cost_analysis`` block, apart from `stats()` so the
        ``extras["serve"]`` contract is JAX's."""
        return {e.key.label: dict(e.cost)
                for e in self._entries.values() if e.cost}


def _cost_books(a: torch.Tensor, b: torch.Tensor,
                blocks: tuple[int, int, int] | None, ranks: int) -> dict[str, Any]:
    """A `cuda` entry's launches in the cost books: the launch on (a, b),
    one a rank of a group program (every rank's product has that shape),
    so flops, bytes and the hand model sum over the ranks."""
    from tpu_matmul_bench_torch.obs.attribution import attribution_block
    from tpu_matmul_bench_torch.ops.cuda_matmul import launch_plan

    route, tile, splits = launch_plan(a, b, blocks)
    (m, k), n = a.shape, b.shape[1]
    block = attribution_block(route, m, n, k, tile, splits, a.dtype)
    if ranks > 1:
        for field in ("flops", "hand_model_flops", "bytes_accessed"):
            block[field] *= ranks
        block["ranks"] = ranks
    return block
