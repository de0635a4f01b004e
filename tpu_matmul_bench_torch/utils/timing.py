"""Timing engine: CUDA events around launches, and CUDA-graph fused loops.

Port of `tpu_matmul_bench/utils/timing.py` (all but the per-leg timers,
which the scaling slice brings):

1. **Dispatch** (`time_jitted`): N launches between two
   `torch.cuda.Event(enable_timing=True)` marks on the current stream,
   after warmup — the reference's own protocol. The auto-scaling loop
   stretches the window until it is long against the cost of a
   synchronize.
2. **Fused** (`fuse_iterations`/`time_fused`): one `torch.cuda.CUDAGraph`
   captures K chained launches, so the host's launch rate cannot cap the
   measurement. Each launch's operands carry a bounded scalar from the
   previous output in element [0, ..., 0], which makes every launch depend
   on the one before.
3. **Interleaved variants** (`time_variants_n`, `time_variants`): several
   callables timed round-robin, median of `repeats` rounds each, under
   either protocol.

A call may return per-rank shards: `sync` waits for every card they lie
on. A program whose ranks run on their own streams joins the caller's
current stream before it returns (`ops/cuda_ring.py`), so the events on
that stream time all of it.

On the CPU the calls run synchronously, `time.perf_counter` stands in for
the events, and the fused protocol runs the same chained loop eagerly.

Across processes (`parallel/group.py`) every decision taken from a clock
(the auto-scaled call count) uses process 0's reading (`group.agree`, ≙
JAX `_agree`), so every process dispatches the same collectives. Another
process's shards (placeholders on the meta device) are neither synced nor
chained. A CUDA graph cannot hold a gloo exchange: on the card, a fused
program whose calls cross processes raises before the capture.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from tpu_matmul_bench_torch.parallel import group
from tpu_matmul_bench_torch.parallel.mesh import Sharded
from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.profiling import MEASURE_REGION


def _tensors(out: Any) -> list[torch.Tensor]:
    """Every tensor in `out`: a tensor, or a tuple/list of them, such as a
    list of per-rank shards (nested any depth); another process's shards
    (meta placeholders) left out."""
    if isinstance(out, torch.Tensor):
        return [] if out.device.type == "meta" else [out]
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _tensors(x)]
    return []


def _last_tensor(out: Any) -> torch.Tensor | None:
    """The last tensor in `out` (a tensor, or a tuple/list of them)."""
    leaves = _tensors(out)
    return leaves[-1] if leaves else None


def _on_card(out: Any) -> bool:
    leaf = _last_tensor(out)
    return leaf is not None and leaf.is_cuda


def sync(out: Any) -> None:
    """Wait until the devices have produced `out`: every card that one of
    its tensors lies on (per-rank shards may span several). A no-op for CPU
    results."""
    for device in dict.fromkeys(t.device for t in _tensors(out) if t.is_cuda):
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class Timing:
    """Result of a timed loop, in device seconds."""

    total_s: float
    iterations: int
    # measured cost of a synchronize on finished work, for reporting
    sync_overhead_s: float = 0.0
    # False when the timed window never cleared the synchronize cost
    reliable: bool = True
    # fused protocol only: how the loop was serialized — "operand" (each
    # launch's operands depend on the previous output) or "none" (nothing
    # to chain on). None for dispatch timings.
    chain: str | None = None

    @property
    def avg_s(self) -> float:
        return self.total_s / self.iterations


def _warm(call: Callable[[], Any], warmup: int) -> tuple[Any, float]:
    """Shared timed-loop preamble: run warmup (≥1), sync, and measure the
    cost of a synchronize. The first call, which builds the kernel or
    captures the graph, is the `compile` span; the other warmup calls are
    `warmup`; the synchronize measurement is `sync-calibrate`."""
    with telemetry.span("compile"):
        out = call()
        sync(out)
    rest = max(warmup, 1) - 1
    with telemetry.span("warmup", iterations=rest):
        for _ in range(rest):
            out = call()
        sync(out)
    with telemetry.span("sync-calibrate"):
        overhead = _measure_sync_overhead(out)
    return out, overhead


def _measure_sync_overhead(out: Any, samples: int = 3) -> float:
    """Fixed cost of `sync` on already-finished work."""
    best = float("inf")
    for _ in range(samples):
        t0 = time.perf_counter()
        sync(out)
        best = min(best, time.perf_counter() - t0)
    return best


def _timed_loop(call: Callable[[], Any], n: int, card: bool,
                overhead: float) -> tuple[Any, float]:
    """`n` calls and their device seconds. On the card: the time between
    two CUDA events on the current stream around the launches. On the CPU:
    the host clock to the end of a sync, less the sync's cost. Under
    `--profile-dir` the window is the trace's `MEASURE_REGION` range
    (`utils/profiling.py`)."""
    with torch.profiler.record_function(MEASURE_REGION):
        if card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                out = call()
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            out = call()
        sync(out)
        return out, time.perf_counter() - t0 - overhead


def time_jitted(
    fn: Callable[..., Any],
    args: Sequence[Any],
    *,
    iterations: int = 50,
    warmup: int = 10,
) -> Timing:
    """Whole-loop timing: N launches between two events, after warmup.

    The iteration count is scaled up until the window is at least five
    times the cost of a synchronize (capped at 256×), so very short loops
    are not read off the timer's noise. No result of an earlier call is
    held while a window runs: the loop then needs no more memory than the
    warm-up did, and the allocator does not grow inside the window.
    """
    out, overhead = _warm(lambda: fn(*args), warmup)
    overhead = group.agree(overhead)
    card = _on_card(out)
    del out
    factor = 1
    with telemetry.span("measure", protocol="dispatch") as meta:
        while True:
            n = iterations * factor
            device_total = group.agree(
                _timed_loop(lambda: fn(*args), n, card, overhead)[1])
            if device_total >= 5 * overhead or factor >= 256:
                break
            per_iter = max(device_total / n, 1e-9)
            need = int(5 * overhead / (per_iter * iterations)) + 1
            factor = min(max(need, factor * 2), 256)
        meta["iterations"] = n  # the auto-scaled count, known at close
    return Timing(
        total_s=max(device_total, 1e-12),
        iterations=n,
        sync_overhead_s=overhead,
        reliable=device_total >= 2 * overhead,
    )


def _chainable(x: Any) -> bool:
    return (isinstance(x, torch.Tensor) and x.ndim >= 1 and x.numel() >= 2
            and x.dtype != torch.bool and not x.is_complex()
            and x.device.type != "meta")


def _chain_targets(op: Any) -> list[torch.Tensor]:
    """The tensors that hold element [0, ..., 0] of operand `op`: the
    tensor itself; every copy of the block of a sharded operand that holds
    its global [0, ..., 0] (shard 0 alone when every rank holds a block of
    its own; every shard when replicated)."""
    if isinstance(op, Sharded):
        return [t for t in op.origin_shards() if _chainable(t)]
    return [op] if _chainable(op) else []


def _chain(ops: Sequence[Any], src: torch.Tensor) -> None:
    """Write a bounded scalar derived from `src` (the previous output)
    into element [0, ..., 0] of every chainable operand, in place."""
    patch = src.reshape(-1)[:1].float()
    bounded = torch.where(torch.isfinite(patch), patch.clamp(0.0, 1.0), 0.5)
    for op in ops:
        for t in _chain_targets(op):
            t.view(-1)[:1].copy_(bounded)


def _clone(x: Any) -> Any:
    """A copy of an operand the chain may write into: a tensor, or every
    shard of a sharded operand."""
    if isinstance(x, Sharded):
        return x.like([s.clone() for s in x])
    return x.clone() if isinstance(x, torch.Tensor) else x


def fuse_iterations(
    fn: Callable[..., Any], iterations: int,
    chain_state: dict | None = None, *, clone: bool = True,
) -> Callable[..., Any]:
    """A callable that runs `iterations` chained calls of `fn`.

    Between calls, a bounded scalar from the previous output is written into
    element [0, ..., 0] of each operand, so every call depends on the one
    before and none can be skipped or merged. For a sharded operand
    (`parallel/mesh.Sharded`) that element is the global array's, in
    every copy of the block that holds it (`Sharded.origin_shards`), as
    JAX's chain writes into a sharded array. The chain writes into the operands, so the loop
    runs on clones (every shard cloned), kept as long as the graph that
    reads them; the caller's tensors are not touched. `clone=False` chains
    into the operands it is given: the caller made them for it.

    On the card the first call captures the whole chain in one CUDA graph
    and every call replays it: one launch from the host for `iterations`
    kernels. On the CPU each call runs the chain eagerly.

    `chain_state` (optional dict) receives {"chain": "operand" | "none"}:
    how the loop was serialized, "operand" only when the output has a
    chainable tensor and some operand was written into.
    """
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1, got {iterations}")
    graph: torch.cuda.CUDAGraph | None = None
    result: Any = None
    captured_ops: list[Any] = []  # the operands the graph reads and writes

    def run_chain(ops: list[Any]) -> Any:
        out = fn(*ops)
        chained = (_chainable(_last_tensor(out))
                   and any(_chain_targets(op) for op in ops))
        if chain_state is not None:
            chain_state["chain"] = "operand" if chained else "none"
        for _ in range(iterations - 1):
            if chained:
                _chain(ops, _last_tensor(out))
            out = fn(*ops)
        return out

    def fused(*args: Any) -> Any:
        nonlocal graph, result
        if graph is not None:
            graph.replay()
            return result
        ops = [_clone(a) for a in args] if clone else list(args)
        if not _on_card(ops):
            return run_chain(ops)
        captured_ops[:] = ops
        # a first eager call on a side stream sets up whatever the callee
        # creates lazily (library handles, workspaces), which the capture
        # cannot; then capture the chain and run it once
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        crossings = group.CROSSINGS
        with torch.cuda.stream(side):
            fn(*ops)
        torch.cuda.current_stream().wait_stream(side)
        if group.CROSSINGS != crossings:
            raise RuntimeError(
                "--timing fused: this program exchanges data between "
                "processes, which a CUDA graph cannot capture; time it "
                "with --timing dispatch")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            result = run_chain(ops)
        graph.replay()
        return result

    return fused


def time_fused(
    fn: Callable[..., Any],
    args: Sequence[Any],
    *,
    iterations: int = 50,
    warmup: int = 10,  # noqa: ARG001 — one fused call runs a full K-call pass
) -> Timing:
    """Whole-loop timing of the fused chain (see fuse_iterations). The
    Timing's `iterations` counts `fn` calls, so `avg_s` is per call as in
    `time_jitted`."""
    k = max(int(iterations), 1)
    chain_state: dict = {}
    fused = fuse_iterations(fn, k, chain_state=chain_state)
    t = time_jitted(fused, args, iterations=1, warmup=1)
    return Timing(
        total_s=t.total_s,
        iterations=t.iterations * k,
        sync_overhead_s=t.sync_overhead_s,
        reliable=t.reliable,
        chain=chain_state.get("chain"),
    )


def choose_timer(timing: str) -> Callable[..., Timing]:
    """Timer for a --timing protocol name."""
    if timing not in ("dispatch", "fused"):
        raise ValueError(f"unknown timing protocol {timing!r}")
    return time_fused if timing == "fused" else time_jitted


def protocol_extras(timing: str, t: Timing) -> dict:
    """Record extras shared by every timed path: reliability + protocol."""
    extras: dict = {} if t.reliable else {"timing_reliable": False}
    if timing != "dispatch":
        extras["timing"] = timing
    if t.chain == "none":
        # the fused loop ran without the serializing operand chain
        extras["chain"] = "none"
    return extras


def effective_warmup(timing: str, iterations: int, warmup: int) -> int:
    """What actually warmed the program: the fused protocol runs one warm
    pass of the K-call chain, not `warmup` launches."""
    return iterations if timing == "fused" else warmup


def time_variants_n(
    fns: Sequence[Callable[..., Any]],
    args: Sequence[Any],
    *,
    iterations: int = 50,
    warmup: int = 10,
    repeats: int = 3,
    protocol: str = "dispatch",
) -> list[Timing]:
    """Time several variants interleaved, median-of-`repeats` each.

    Timing candidates one after another lets drift (clock ramps, a
    neighbour's load) bias whichever ran during it. Interleaving the
    variants round-robin spreads drift across all of them, and each
    variant's median by `avg_s` rejects a single slow round. Warmup runs
    only in the first round.

    With protocol="fused" each variant is wrapped by `fuse_iterations`
    first (one CUDA graph of `iterations` chained calls per variant, all
    chaining into one set of operand clones, which they take in turn); each
    round then times one replay per variant, and the returned Timings count
    individual calls, so `avg_s` stays per call under either protocol.
    """
    k = 1
    chain_states: list[dict] = [{} for _ in fns]
    if protocol == "fused":
        k = max(int(iterations), 1)
        args = [_clone(a) for a in args]
        fns = [fuse_iterations(fn, k, chain_state=st, clone=False)
               for fn, st in zip(fns, chain_states)]
        iterations = 1
        warmup = 1  # the first fused call captures and runs a full pass
    elif protocol != "dispatch":
        raise ValueError(f"unknown timing protocol {protocol!r}")
    rounds = [[time_jitted(fn, args, iterations=iterations,
                           warmup=warmup if r == 0 else 1) for fn in fns]
              for r in range(repeats)]
    out = []
    for i in range(len(fns)):
        ts = sorted((row[i] for row in rounds), key=lambda t: t.avg_s)
        med = ts[len(ts) // 2]
        if protocol == "fused":
            med = Timing(total_s=med.total_s, iterations=med.iterations * k,
                         sync_overhead_s=med.sync_overhead_s,
                         reliable=med.reliable,
                         chain=chain_states[i].get("chain"))
        out.append(med)
    return out


def time_variants(
    compute_fn: Callable[..., Any],
    full_fn: Callable[..., Any],
    args: Sequence[Any],
    *,
    iterations: int = 50,
    warmup: int = 10,
    repeats: int = 3,
    protocol: str = "dispatch",
) -> tuple[Timing, Timing, float]:
    """The compute leg and the full program, interleaved and median-of-
    `repeats` each (`time_variants_n`). Returns (compute, full, comm
    seconds), comm = max(full − compute, 0) per call; the overlap modes
    read the two as baseline and ring."""
    t_compute, t_full = time_variants_n(
        (compute_fn, full_fn), args, iterations=iterations, warmup=warmup,
        repeats=repeats, protocol=protocol)
    return t_compute, t_full, max(t_full.avg_s - t_compute.avg_s, 0.0)


def record_samples(
    fn: Callable[..., Any],
    args: Sequence[Any],
    *,
    iterations: int = 50,
    warmup: int = 1,
) -> list[float]:
    """Per-iteration device seconds, each iteration timed and synced on its
    own — the distribution the whole-loop protocols average away."""
    out, overhead = _warm(lambda: fn(*args), warmup)
    card = _on_card(out)
    del out  # as in time_jitted: no earlier result held while a call is timed
    samples: list[float] = []
    with telemetry.span("sample", iterations=iterations):
        for _ in range(iterations):
            seconds = _timed_loop(lambda: fn(*args), 1, card, overhead)[1]
            samples.append(max(seconds, 1e-9))
    return samples


def time_percentiles(
    fn: Callable[..., Any],
    args: Sequence[Any],
    *,
    iterations: int = 50,
    warmup: int = 10,
) -> dict[str, float]:
    """Per-iteration latency distribution (seconds): p50/p90/p99/min/max."""
    arr = np.asarray(record_samples(fn, args, iterations=iterations,
                                    warmup=warmup))
    return {
        "p50_s": float(np.percentile(arr, 50)),
        "p90_s": float(np.percentile(arr, 90)),
        "p99_s": float(np.percentile(arr, 99)),
        "min_s": float(arr.min()),
        "max_s": float(arr.max()),
    }


def latency_percentiles_ms(fn, operands, config) -> dict[str, float]:
    """--percentiles extras: per-iteration latency distribution in ms (the
    kernel is already built by the main timing loop, so warmup=1)."""
    pct = time_percentiles(fn, operands, iterations=config.iterations,
                           warmup=1)
    return {k.removesuffix("_s"): round(v * 1e3, 3) for k, v in pct.items()}


def sample_stats(samples_s: Sequence[float]) -> dict[str, Any]:
    """Distribution block for `extras["samples"]`: p50/p95/p99, stddev,
    and the warmup-drift flag (first quartile slower than the last by
    more than WARMUP_DRIFT_THRESHOLD_PCT)."""
    arr = np.asarray(list(samples_s), dtype=float)
    if arr.size == 0:
        raise ValueError("need at least one sample")
    ms = arr * 1e3
    q = max(arr.size // 4, 1)
    first, last = float(ms[:q].mean()), float(ms[-q:].mean())
    drift_pct = 100.0 * (first - last) / last if last > 0 else 0.0
    return {
        "n": int(arr.size),
        "mean_ms": round(float(ms.mean()), 4),
        "stddev_ms": round(float(ms.std()), 4),
        "p50_ms": round(float(np.percentile(ms, 50)), 4),
        "p95_ms": round(float(np.percentile(ms, 95)), 4),
        "p99_ms": round(float(np.percentile(ms, 99)), 4),
        "min_ms": round(float(ms.min()), 4),
        "max_ms": round(float(ms.max()), 4),
        "warmup_drift_pct": round(drift_pct, 2),
        "warmup_drift": bool(
            drift_pct > telemetry.WARMUP_DRIFT_THRESHOLD_PCT),
    }


def sample_extras(fn, operands, config) -> dict[str, Any]:
    """--samples extras: per-iteration times reduced to the distribution
    block (warmup=1: the main timing loop has already run)."""
    return sample_stats(record_samples(
        fn, operands, iterations=config.iterations, warmup=1))
