"""Raw collective micro-benchmarks over the world of ranks: bandwidth per op.

Port of `tpu_matmul_bench/parallel/collective_bench.py`, nccl-tests style:
each op is a program over the ranks (`parallel/collectives.py`) timed by the
shared engine, reporting algorithmic bandwidth (the op's conventional bytes
over the time) and bus bandwidth (algbw scaled by the op's ring traffic
factor, the convention for comparing a collective with a link's speed).

Ops: psum (all_reduce), all_gather, reduce_scatter, ppermute (one ring hop),
ppermute_bidir (both ring directions at once) and all_to_all. The payload
of each rank is an n×n tensor of the benchmark dtype (the same --sizes sweep
as the matmul programs). Ranks that share a card copy within its memory: a
one-card bandwidth is not a link's (records carry `cards` and
`ranks_per_card`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from tpu_matmul_bench_torch.parallel.collectives import (
    all_gather_over,
    all_to_all_over,
    ppermute,
    psum_over,
    psum_scatter_over,
)
from tpu_matmul_bench_torch.parallel.mesh import (
    ROWS,
    Mesh,
    Sharded,
    gather,
    ring_perm,
    ring_perm_rev,
    sharded_normal,
    world_size,
)
from tpu_matmul_bench_torch.parallel.modes import corner_validation
from tpu_matmul_bench_torch.utils.config import BenchConfig
from tpu_matmul_bench_torch.utils.metrics import bytes_per_element
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord
from tpu_matmul_bench_torch.utils.timing import (
    choose_timer,
    effective_warmup,
    protocol_extras,
)

Body = Callable[[Sharded], list[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class CollectiveSpec:
    """One collective op: its program over the ranks + the nccl-tests
    bandwidth convention.

    `conv_size(d, s)` is the op's conventional size for a per-rank input of
    `s` bytes, what algbw divides by (all_reduce, reduce_scatter and
    all_to_all: `s`; all_gather: the gathered output `d·s`).
    `bus_factor(d)` turns algbw into bus bandwidth: all_reduce 2(d−1)/d,
    all_gather, reduce_scatter and all_to_all (d−1)/d, one ring hop 1.
    `mem_factor(d)` is a rank's resident footprint in payload units
    (operand + result + one temp), for the pre-flight memory guard.
    """

    name: str
    body: Callable[[Mesh], Body]  # mesh -> the op over the ranks' shards
    conv_size: Callable[[int, int], float]
    bus_factor: Callable[[int], float]
    mem_factor: Callable[[int], float]
    # op splits the payload's leading dim across ranks → size % world == 0
    needs_divisible_size: bool = False


def _ppermute_body(mesh: Mesh) -> Body:
    return lambda xs: ppermute(mesh, xs, ring_perm(len(xs)))


def _ppermute_bidir_body(mesh: Mesh) -> Body:
    """The top half of each shard hops right while the bottom half hops
    left: both ring directions at once."""
    def body(xs: Sharded) -> list[torch.Tensor]:
        d, h = len(xs), xs[0].shape[0] // 2
        top = ppermute(mesh, [x[:h] for x in xs], ring_perm(d))
        bot = ppermute(mesh, [x[h:] for x in xs], ring_perm_rev(d))
        return [torch.cat([t, b], dim=0) for t, b in zip(top, bot)]

    return body


COLLECTIVES: dict[str, CollectiveSpec] = {
    "psum": CollectiveSpec(
        "psum", psum_over,
        lambda d, s: s,
        lambda d: 2.0 * (d - 1) / d,
        lambda d: 3.0,
    ),
    "all_gather": CollectiveSpec(
        "all_gather", all_gather_over,
        lambda d, s: d * s,
        lambda d: (d - 1) / d,
        lambda d: d + 2.0,
    ),
    "reduce_scatter": CollectiveSpec(
        "reduce_scatter", psum_scatter_over,
        lambda d, s: s,
        lambda d: (d - 1) / d,
        lambda d: 3.0,
        needs_divisible_size=True,
    ),
    "ppermute": CollectiveSpec(
        "ppermute", _ppermute_body,
        lambda d, s: s,
        lambda d: 1.0,
        lambda d: 3.0,
    ),
    # both ring directions at once: bus_factor 0.5 makes busbw the traffic
    # of one direction, comparable with a link's speed like the other ops
    "ppermute_bidir": CollectiveSpec(
        "ppermute_bidir", _ppermute_bidir_body,
        lambda d, s: s,
        lambda d: 0.5,
        lambda d: 3.0,
    ),
    "all_to_all": CollectiveSpec(
        "all_to_all", all_to_all_over,
        lambda d, s: s,
        lambda d: (d - 1) / d,
        lambda d: 3.0,
        needs_divisible_size=True,
    ),
}


def collective_setup(config: BenchConfig, mesh: Mesh, size: int, op: str
                     ) -> tuple[Callable[[Sharded], Sharded], Sharded, CollectiveSpec]:
    """The program and sharded operand of one op at one size: the global
    operand is [d·size, size] cut by rows, so every rank's shard is the
    [size, size] payload; the program's output is cut by rows too (JAX's
    out_specs P("x"))."""
    spec = COLLECTIVES[op]
    d = world_size(mesh)
    (x,) = sharded_normal(config.seed, (d * size, size), config.dtype, mesh, ROWS,
                          count=1)
    body = spec.body(mesh)
    return (lambda xs: Sharded(body(xs), ROWS)), x, spec


def _collective_reference(op: str, d: int, x: Any) -> np.ndarray:
    """Expected global output of one collective, computed with numpy from
    the global operand (shards = leading-dim blocks)."""
    xs = np.asarray(x, np.float64)
    shards = xs.reshape(d, -1, xs.shape[1])
    if op == "psum":
        return np.concatenate([shards.sum(axis=0)] * d)
    if op == "all_gather":
        return np.concatenate([xs] * d)
    if op == "reduce_scatter":
        return shards.sum(axis=0)  # row block j lands on rank j → global sum
    if op == "ppermute":
        return np.concatenate([shards[(j - 1) % d] for j in range(d)])
    if op == "ppermute_bidir":
        h = shards.shape[1] // 2
        return np.concatenate(
            [np.concatenate([shards[(j - 1) % d][:h], shards[(j + 1) % d][h:]])
             for j in range(d)])
    if op == "all_to_all":
        rows = shards.shape[1] // d
        blocks = shards.reshape(d, d, rows, xs.shape[1])  # [src, blk, r, c]
        return np.concatenate(
            [np.concatenate(list(blocks[:, j]), axis=0) for j in range(d)])
    raise ValueError(op)


def validate_collective(config: BenchConfig, mesh: Mesh, op: str) -> dict:
    """--validate for the bandwidth benchmark: run the op once on a small
    payload and compare the whole result with the numpy reference."""
    d = world_size(mesh)
    size_v = 8 * d  # small, divisible payload; semantics don't depend on size
    fn, x, _ = collective_setup(config, mesh, size_v, op)
    want = _collective_reference(op, d, gather(x, "cpu").double().numpy())
    return corner_validation(gather(fn(x), "cpu"), torch.from_numpy(want), config.dtype)


def run_collective_benchmark(config: BenchConfig, mesh: Mesh, size: int,
                             op: str) -> BenchmarkRecord:
    verdict = validate_collective(config, mesh, op) if config.validate else {}
    fn, x, spec = collective_setup(config, mesh, size, op)
    d = world_size(mesh)
    t = choose_timer(config.timing)(fn, (x,), iterations=config.iterations,
                                    warmup=config.warmup)
    payload = size * size * bytes_per_element(config.dtype)  # a rank's input bytes
    algbw = spec.conv_size(d, payload) / t.avg_s / 1e9
    return BenchmarkRecord(
        benchmark="collective",
        mode=op,
        size=size,
        dtype=config.dtype_name,
        world=d,
        iterations=t.iterations,
        warmup=effective_warmup(config.timing, config.iterations, config.warmup),
        avg_time_s=t.avg_s,
        tflops_per_device=0.0,  # not a FLOP benchmark
        tflops_total=0.0,
        bytes_per_device=payload,
        algbw_gbps=algbw,
        busbw_gbps=algbw * spec.bus_factor(d),
        comm_time_s=t.avg_s,
        extras={"bus_factor": round(spec.bus_factor(d), 4),
                **protocol_extras(config.timing, t), **verdict,
                "cards": mesh.card_count, "ranks_per_card": mesh.ranks_per_card},
    )
