"""Executable cache: one captured product a problem class, LRU-bounded.

Port of `tpu_matmul_bench/serve/cache.py` (its artifact store waits for
ROADMAP A13's slice 16). An offline benchmark absorbs its set-up in the
warm-up and never sees it again; a service has no warm-up: the first
request of a new shape pays the set-up, its successors want pure dispatch.
The cache makes that split explicit.

**What an executable is.** In the JAX package it is an AOT-compiled
program: fixed shapes, a call dispatches with no retrace. Here it is a
**CUDA graph of one product**, captured over the bucket's pooled operands
(the service's `_OperandPool`) into an output the entry owns:
`compiled(a, b)` replays the graph and returns that output. The graph
reads the captured tensors, so given any others it raises; it never runs
eagerly instead. On the CPU, where there is no graph, the entry is the
eager plain call, checked against the key's shapes, with the same
accounting.

- `cold_compile_s`, what the first request of a key pays: the build
  callable's route resolution (`auto` through the memoised
  `ops/impl_select.select_impl`), one eager call on a side stream (it
  loads the built kernel library, runs `tmb_init` and creates the
  library's handles and workspaces, which a capture cannot), the capture
  (the kernel's tensor maps are encoded then and baked into the graph),
  and a sync. Building the library with nvcc happens before any of this,
  in the service's set-up: it never lands in a request.
- `warm_dispatch_s`: the second replay plus a sync, as the JAX package
  times the second dispatch.
- `cost`: a `cuda` entry's launch in the kernels' cost books
  (`obs/attribution.attribution_block`: route, tile, padded-tile flops
  and bytes); a `torch` entry carries none, as the `matmul` records do.

A replay is one host call for one kernel (a cuBLAS product may be a few),
so a warm request pays the graph launch and the sync, not the wrapper's
route checks and argument packing. Capacity is LRU-bounded: each entry
pins its graph and its output on the card.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Iterable

import torch

from tpu_matmul_bench_torch.obs.registry import get_registry
from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.metrics import matmul_out_dtype
from tpu_matmul_bench_torch.utils.timing import sync

DEFAULT_CAPACITY = 64

_CACHE_EVENTS = ("hit", "miss", "eviction", "preload")
# the JAX package splits preload time into compile and deserialize (its
# artifact store); with no store here every preload compiles, and the
# deserialize series stays 0 so the ledger keeps JAX's keys
_PRELOAD_PHASES = ("compile", "deserialize")


@dataclasses.dataclass(frozen=True)
class ExecKey:
    """Identity of one cached executable: the padded problem class.

    `impl` is the matmul implementation the build callable resolves ("torch",
    "cuda", "auto"); `mesh_shape` the device mesh (one card: (1,)).
    `mesh_spec` is the pod placement label of the JAX package's sharded
    executables, empty on the single-device path.
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
    """What a key builds from: the product `fn(a, b, out=None)`, and the
    impl and tile request it resolved to ("torch" or "cuda")."""

    fn: Callable[..., torch.Tensor]
    impl: str
    blocks: tuple[int, int, int] | None = None


class GraphExecutable:
    """One product captured in a CUDA graph over fixed operands."""

    def __init__(self, graph: torch.cuda.CUDAGraph, a: torch.Tensor,
                 b: torch.Tensor, out: torch.Tensor) -> None:
        self._graph = graph
        self._a, self._b = a, b  # held: the graph reads their memory
        self.out = out

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a is not self._a or b is not self._b:
            raise ValueError(
                "a captured executable replays the operands it was captured "
                "over; it was given other tensors")
        self._graph.replay()
        return self.out


class EagerExecutable:
    """The CPU's entry: the eager product, held to the key's shapes and
    dtype as a compiled program would be."""

    def __init__(self, fn: Callable[..., torch.Tensor],
                 a: torch.Tensor, b: torch.Tensor) -> None:
        self._fn = fn
        self._spec = (tuple(a.shape), tuple(b.shape), a.dtype, a.device)

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        spec = (tuple(a.shape), tuple(b.shape), a.dtype, a.device)
        if spec != self._spec:
            raise ValueError(f"executable built for {self._spec}, "
                             f"called with {spec}")
        return self._fn(a, b)


def capture(fn: Callable[..., torch.Tensor], a: torch.Tensor,
            b: torch.Tensor) -> GraphExecutable:
    """`fn(a, b)` captured into a CUDA graph writing an output of its own.
    A first eager call on a side stream sets up what the callee creates
    lazily (the kernel library and its `tmb_init`, cuBLAS's handle and
    workspace), which a capture cannot; then the capture, then a sync."""
    out = torch.empty((a.shape[0], b.shape[1]), dtype=matmul_out_dtype(a.dtype),
                      device=a.device)
    current = torch.cuda.current_stream(a.device)
    side = torch.cuda.Stream(a.device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn(a, b, out=out)
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(a, b, out=out)
    torch.cuda.synchronize(a.device)
    return GraphExecutable(graph, a, b, out)


@dataclasses.dataclass
class CacheEntry:
    """One executable plus its measured cost split."""

    key: ExecKey
    compiled: Callable[..., Any]
    cold_compile_s: float  # route + library + first call + capture wall time
    warm_dispatch_s: float  # one replay + sync of the executable
    hits: int = 0
    built_at: float = 0.0
    # the kernels' cost books for a `cuda` entry's launch
    # (obs/attribution.py); None for the library product
    cost: dict[str, Any] | None = None
    # how the executable got here; "compile" is the only way on the port
    # (the JAX package's "artifact" deserializes from its store)
    source: str = "compile"
    deserialize_s: float = 0.0


class ExecutableCache:
    """LRU cache of executables.

    ``build(key)`` returns the key's `Program`; ``operands(key)`` the
    concrete (A, B) the executable is captured over and its warm dispatch
    is measured on. On the card the entry is a `GraphExecutable`; on the
    CPU an `EagerExecutable`.
    """

    def __init__(
        self,
        build: Callable[[ExecKey], Program],
        *,
        operands: Callable[[ExecKey], tuple[torch.Tensor, torch.Tensor]],
        capacity: int = DEFAULT_CAPACITY,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._build = build
        self._operands = operands
        self._capacity = capacity
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
        Each acquisition is a counted miss, so accesses = preloads + served
        requests, and every later request for a preloaded key is a warm
        hit. Already-resident keys are skipped without touching a counter.
        Returns the number of executables acquired."""
        fresh = [k for k in dict.fromkeys(keys) if k not in self._entries]
        for key in sorted(fresh, key=lambda kk: kk.label):
            t0 = time.perf_counter()
            self.get(key)
            self._preload_seconds["compile"].inc(time.perf_counter() - t0)
            self._preload_counts["compile"] += 1
        self._events["preload"].inc(len(fresh))
        return len(fresh)

    def _insert(self, key: ExecKey, entry: CacheEntry) -> None:
        self._entries[key] = entry
        while len(self._entries) > self._capacity:
            self._entries.popitem(last=False)
            self._events["eviction"].inc()

    def _compile(self, key: ExecKey) -> CacheEntry:
        a, b = self._operands(key)
        with telemetry.span(f"compile:{key.label}"):
            t0 = time.perf_counter()
            program = self._build(key)
            compiled = capture(program.fn, a, b) if a.is_cuda \
                else EagerExecutable(program.fn, a, b)
            cold_s = time.perf_counter() - t0
        # the first replay of a fresh graph can still page in memory; the
        # second is the steady warm path
        sync(compiled(a, b))
        t0 = time.perf_counter()
        sync(compiled(a, b))
        warm_s = time.perf_counter() - t0
        cost = None
        if program.impl == "cuda":
            from tpu_matmul_bench_torch.obs.attribution import attribution_block
            from tpu_matmul_bench_torch.ops.cuda_matmul import launch_plan

            route, tile, splits = launch_plan(a, b, program.blocks)
            cost = attribution_block(route, key.m, key.n, key.k, tile, splits,
                                     a.dtype)
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
            "by_entry": {
                e.key.label: {
                    "cold_compile_ms": round(e.cold_compile_s * 1e3, 3),
                    "warm_dispatch_ms": round(e.warm_dispatch_s * 1e3, 3),
                    "hits": e.hits,
                    "source": e.source,
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
