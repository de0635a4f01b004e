"""Overlap suite: the reference's stream-overlap programs, the
collective-matmul rings and the ring kernels.

Port of `tpu_matmul_bench/parallel/overlap.py`, all twelve modes, with
`pallas_` → `cuda_`, over the world of ranks (`parallel/mesh.py`):

- `no_overlap`, `overlap`, `pipeline` (`StepProgram`; JAX `_steps_program`
  `:93-173`, `_fill_ring` `:176-187`, `overlap_mode` `:190-253`): each call
  runs `steps` product+psum steps on the ranks' streams, the reference's
  own form (`backup/matmul_overlap_benchmark.py:36-91`, `:93-180`,
  `:182-278`): a compute stream a rank for the products, and the psum
  (`collectives.psum_over`) on a communication stream of each card, after
  every rank's product (`no_overlap`), or beside this step's products on
  the oldest of the k in-flight products (`overlap`: k = 2, `pipeline`:
  k = 3). Under `--matmul-impl cuda` every product is K1;
- `collective_matmul`, `collective_matmul_bidir`, `collective_matmul_rs`,
  `collective_matmul_bidir_rs` (`CollectiveMatmul`; JAX `:260-303`,
  `:367-433`, `:451-494`, `:497-551`): rings of `matmul_2d` products (K1
  under `cuda`, cuBLAS under `torch`) whose chunks or accumulators hop to
  the neighbour (`ops/cuda_ring.py _hop`) on a copy stream while the rank's
  next product runs, on the ring schedule's streams and events
  (`ops/cuda_ring.py _Schedule`), each timed against its serialized
  baseline;
- the ring kernels `cuda_ring_hbm` (K2), `cuda_ring_rs_hbm` (K3), their
  bidirectional forms `cuda_ring_bidir_hbm` (K4) and
  `cuda_ring_bidir_rs_hbm` (K5), and `cuda_ring` (K6, its operands resident
  in L2, capped by `cuda_ring_max_size`), each timed against its
  serialized baseline (JAX `:584-803`).

Four ranks on one card share its SMs, and a psum there is one fp32 sum a
card plus copies (`collectives.psum_over`): on one card `overlap` against
`no_overlap` measures whether the sums fill the gaps between the products
on a second stream, and what the streams cost, never hiding over NVLink.

On the CPU the schedules' streams and events are no-ops and every launch
runs at once, in issue order, which is a valid order of the card's.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Sequence

import torch

from tpu_matmul_bench_torch.ops import cuda_ring
from tpu_matmul_bench_torch.ops.cuda_ring import (
    _COMPUTE,
    _COPY,
    CALLER,
    _Schedule,
    rank_streams,
    ring_ways,
)
from tpu_matmul_bench_torch.ops.matmul import matmul_2d
from tpu_matmul_bench_torch.parallel.collectives import (
    all_gather_over,
    psum_over,
    psum_scatter_over,
)
from tpu_matmul_bench_torch.parallel.mesh import (
    COLS,
    ROWS,
    Mesh,
    Sharded,
    global_block,
    mesh_device_kind,
    sharded_normal,
    world_size,
)
from tpu_matmul_bench_torch.parallel.modes import (
    ModeSetup,
    _mode_record,
    _record_base,
    estimate_memory_gib,
    expected_corner,
    make_corner_validate,
)
from tpu_matmul_bench_torch.utils.config import BenchConfig
from tpu_matmul_bench_torch.utils.metrics import (
    bytes_per_element,
    calculate_tflops,
    matmul_out_dtype,
)
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord
from tpu_matmul_bench_torch.utils.timing import Timing

# a rank's second stream in the step programs: the sums
_COMM = _COPY


class _SerialSchedule(_Schedule):
    """`_Schedule` that synchronises the card after every launch (as its
    `on` block ends, before another stream gets work, whatever the program
    marks): the programs' launches then run one at a time, in issue order.
    The race checks' reference (`serial=True` on a program)."""

    @contextlib.contextmanager
    def on(self, r: int, which: int, kind: str):
        with super().on(r, which, kind):
            yield
        torch.cuda.synchronize(self.mesh.devices[r])


class _RankStreamProgram:
    """A program on the ranks' streams: `per_rank` streams a rank, made on
    the first call on the card and kept; `serial` runs it one launch at a
    time (`_SerialSchedule`)."""

    per_rank = 2

    def __init__(self, mesh: Mesh, impl: str, blocks: tuple[int, int, int] | None):
        self.mesh = mesh
        self.mm = matmul_2d(impl, blocks, mesh_device_kind(mesh))
        self.serial = False
        self._streams: list[tuple[Any, ...]] | None = None

    def _schedule(self, card: bool) -> _Schedule:
        if not card:
            return _Schedule(self.mesh, None, self.per_rank)
        if self._streams is None:
            self._streams = rank_streams(self.mesh, self.per_rank)
        return (_SerialSchedule if self.serial else _Schedule)(self.mesh, self._streams)


# ---------------------------------------------------------------------------
# no_overlap, overlap, pipeline: product + psum steps on the rank streams
# ---------------------------------------------------------------------------

STEP_VARIANTS = ("compute_only", "no_overlap", "overlap", "pipeline",
                 "overlap_nocomm", "pipeline_nocomm")


class StepProgram(_RankStreamProgram):
    """`fn(a, b, ring0=None) -> Sharded` of per-step scalars: `steps`
    steps of one product a rank, JAX's `_steps_program` in its six variants.

    Operands: A and B stacked [D·nbuf, n, n], cut by rows (ROWS), so each
    rank holds nbuf pairs; `overlap` and `pipeline` also take `ring0`, the
    k in-flight products a rank (`fill_ring`). Output: each rank's [steps]
    scalars r[0, 0], where r is the step's psum, in the output dtype.
    - `compute_only`: C = A[0]·B[0] a step, chained by the compute stream's
      order; r = C.
    - `no_overlap`: the step's psum runs on the communication stream after
      every rank's product, and the next step's products wait for it (JAX's
      forced serialisation, `:121-136`).
    - `overlap`, `pipeline`: step i sums the oldest in-flight product (slot
      i mod k: ring0's for i < k, else the product of step i − k) on the
      communication stream while the ranks' products of step i run on their
      compute streams (the reference's two-stream trick). The products go
      to k + 1 slots of the call's own, product i into slot i mod (k + 1):
      the slot it overwrites held product i − k − 1, which the sum of step
      i − 1 read, so the product waits on that sum's event (the
      write-after-read hazard); the sum of step i waits on the products of
      step i − k. ring0 is never written, so every call starts from it, as
      JAX's scan does.
    - `*_nocomm`: the same streams, events and slots with the sum left out:
      r is the oldest product itself.
    Every slot is allocated on the caller's stream before the schedule
    starts (`_Schedule.enter`), so no stream meets a reused block."""

    def __init__(self, mesh: Mesh, variant: str, steps: int, impl: str = "torch",
                 blocks: tuple[int, int, int] | None = None):
        if variant not in STEP_VARIANTS:
            raise ValueError(variant)
        super().__init__(mesh, impl, blocks)
        self.variant = variant
        self.steps = steps
        self.per_rank = 1 if variant == "compute_only" else 2  # + the sums' stream
        self.psum = psum_over(mesh)
        # the rank that runs each card's sums, on its communication stream
        self._leads = sorted({mesh.devices.index(dev) for dev in mesh.cards})

    def __call__(self, a: Sequence[torch.Tensor], b: Sequence[torch.Tensor],
                 ring0: Sequence[torch.Tensor] | None = None) -> Sharded:
        n = a[0].shape[-1]
        out = matmul_out_dtype(a[0].dtype)
        devices = self.mesh.devices
        outs = [torch.empty(self.steps, dtype=out, device=dev) for dev in devices]
        sched = self._schedule(a[0].is_cuda)
        if self.variant in ("compute_only", "no_overlap"):
            prod = [torch.empty((n, n), dtype=out, device=dev) for dev in devices]
            sched.enter()
            self._serial_steps(sched, a, b, prod, outs)
        else:
            k = ring0[0].shape[0]
            slots = [torch.empty((k + 1, n, n), dtype=out, device=dev) for dev in devices]
            sched.enter()
            self._ring_steps(sched, a, b, ring0, slots, outs)
        sched.leave()
        return Sharded(outs, ROWS)

    def _product(self, sched: _Schedule, r: int, a: torch.Tensor, b: torch.Tensor,
                 dest: torch.Tensor) -> torch.cuda.Event | None:
        with sched.on(r, _COMPUTE, "product"):
            self.mm(a, b, out=dest)
        return sched.mark(r, _COMPUTE)

    def _sum(self, sched: _Schedule, i: int, src: list[torch.Tensor], ready: list,
             outs: list[torch.Tensor], comm: bool = True) -> list:
        """Step i's r on each card's communication stream, once every event
        in `ready` has passed: the psum of `src` (or `src` itself without
        `comm`), whose [0, 0] each rank keeps as its scalar of step i.
        Returns the events after it."""
        for r in self._leads:
            sched.wait(r, _COMM, *ready)
        with contextlib.ExitStack() as stack:
            for r in self._leads:
                stack.enter_context(sched.on(r, _COMM, "sum" if comm else "copy"))
            sums = self.psum(src) if comm else src
            for o, s in zip(outs, sums):
                o[i].copy_(s[0, 0])
        return [sched.mark(r, _COMM) for r in self._leads]

    def _serial_steps(self, sched, a, b, prod, outs) -> None:
        d = len(self.mesh.ranks)
        summed: list = []
        for i in range(self.steps):
            sched.step = i
            made = []
            for r in range(d):
                # no_overlap: the product overwrites what the last sum read
                sched.wait(r, _COMPUTE, *summed, reuse=True)
                made.append(self._product(sched, r, a[r][0], b[r][0], prod[r]))
                if self.variant == "compute_only":
                    with sched.on(r, _COMPUTE, "copy"):
                        outs[r][i].copy_(prod[r][0, 0])
            if self.variant == "no_overlap":
                summed = self._sum(sched, i, prod, made, outs)

    def _ring_steps(self, sched, a, b, ring0, slots, outs) -> None:
        d = len(self.mesh.ranks)
        k = ring0[0].shape[0]
        nbuf = a[0].shape[0]
        comm = not self.variant.endswith("_nocomm")
        made: dict[int, list] = {}
        summed: dict[int, list] = {}
        for i in range(self.steps):
            sched.step = i
            slot = i % k
            if i < k:
                src, ready = [ring0[r][slot] for r in range(d)], []
            else:
                src, ready = [slots[r][(i - k) % (k + 1)] for r in range(d)], made[i - k]
            summed[i] = self._sum(sched, i, src, ready, outs, comm)
            made[i] = []
            for r in range(d):
                if i > k:  # slot i mod (k+1) held product i−k−1, read at step i−1
                    sched.wait(r, _COMPUTE, *summed[i - 1], reuse=True)
                made[i].append(self._product(sched, r, a[r][slot % nbuf], b[r][slot % nbuf],
                                             slots[r][i % (k + 1)]))


def fill_ring(mesh: Mesh, k: int, impl: str = "torch",
              blocks: tuple[int, int, int] | None = None
              ) -> Callable[[Sharded, Sharded], Sharded]:
    """The k in-flight products a rank, stacked [k, n, n] (JAX `_fill_ring`
    `:176-187`, the reference's prologue `:213-218`): made once at set-up,
    outside every timed call."""
    mm = matmul_2d(impl, blocks, mesh_device_kind(mesh))

    def fill(a: Sharded, b: Sharded) -> Sharded:
        return Sharded([torch.stack([mm(ar[i % ar.shape[0]], br[i % br.shape[0]])
                                     for i in range(k)]) for ar, br in zip(a, b)], ROWS)

    return fill


def overlap_mode(config: BenchConfig, mesh: Mesh, size: int, variant: str, *,
                 steps_per_call: int = 8, depth: int = 3,
                 benchmark: str = "overlap") -> ModeSetup:
    """`no_overlap`, `overlap` or `pipeline` (JAX `overlap_mode`
    `:190-253`): the timed unit is one call of `steps_per_call` steps; the
    record's times are a step's. Compute leg: `compute_only`; for `overlap`
    and `pipeline` also the `*_nocomm` program, so comm_time_s is the psum
    alone and the streams' own cost is extras.overhead_time_s. TFLOPS:
    JAX's one product a rank a step, total over the ranks, per card over
    the cards they occupy (`_mode_record`)."""
    d = world_size(mesh)
    impl = config.matmul_impl
    nbuf = 1 if variant == "no_overlap" else (2 if variant == "overlap" else depth)
    a, b = sharded_normal(config.seed, (d * nbuf, size, size), config.dtype, mesh, ROWS)
    operands: tuple[Any, ...] = (a, b)
    if variant in ("overlap", "pipeline"):
        operands = (a, b, fill_ring(mesh, nbuf, impl, config.blocks)(a, b))
    compute = StepProgram(mesh, "compute_only", steps_per_call, impl, config.blocks)
    full = StepProgram(mesh, variant, steps_per_call, impl, config.blocks)
    nocomm = (StepProgram(mesh, f"{variant}_nocomm", steps_per_call, impl, config.blocks)
              if variant in ("overlap", "pipeline") else None)

    def build(t_compute: Timing, t_full: Timing | None, comm_s: float) -> BenchmarkRecord:
        t = t_full or t_compute
        total_s = t.avg_s / steps_per_call
        comm_step = comm_s / steps_per_call
        rec = _mode_record(
            config, benchmark, variant, size, mesh, t,
            calculate_tflops(size, total_s) * d,
            {"steps_per_program": steps_per_call, "buffers": nbuf, "matmul_impl": impl,
             "comm_overhead_vs_compute_pct":
                 round(100.0 * comm_step / total_s if total_s > 0 else 0.0, 2)},
            avg_time_s=total_s, compute_time_s=t_compute.avg_s / steps_per_call,
            comm_time_s=comm_step)
        rec.iterations = t.iterations * steps_per_call  # JAX counts steps
        return rec

    return ModeSetup(variant, operands, compute, full, build,
                     memory_gib_per_device=estimate_memory_gib(variant, config, d, size),
                     nocomm=nocomm, steps_per_program=steps_per_call)


# ---------------------------------------------------------------------------
# The collective-matmul rings: matmul_2d products, hops on copy streams
# ---------------------------------------------------------------------------

class CollectiveMatmul(_RankStreamProgram):
    """`fn(x_shards, w_shards) -> y_shards`, a ring of `matmul_2d` products
    (K1 under `cuda`, the library under `torch`) whose chunks (all-gather)
    or accumulators (reduce-scatter) hop to the neighbour on the rank's copy
    stream (`_hop`) while its next product runs on the compute stream.
    `bidir` splits each chunk or accumulator into a top half h = mshard // 2
    that goes right and the rest, which goes left, each direction on its
    own copy stream (`ring_ways`). JAX's arithmetic step for step.

    All-gather (`reduce_scatter=False`, JAX `collective_matmul_program`
    `:260-303`, `collective_matmul_bidir_program` `:367-433`): X row-sharded,
    W and Y column-sharded. At step t rank r multiplies the rows it holds
    of the chunk that started at rank (r − step·t) mod D into that chunk's
    rows of Y, and sends them into the reader's receive slot (t+1) mod 2 once
    they have arrived (`recv_sem`) and the reader has read that slot at step
    t − 1 (`free_sem`: its product and its hop). The bidirectional form's
    step 0 is one full-height product of the rank's own chunk.

    Reduce-scatter (`reduce_scatter=True`, JAX `collective_matmul_rs_program`
    `:451-494`, `collective_matmul_bidir_rs_program` `:497-551`): X
    column-sharded, W and Y row-sharded. At step t rank r holds the
    accumulator of row chunk c = (r − step·(1+t)) mod D and adds its product
    of those rows to it in the output dtype (acc + mm(rows, w), rounded at
    every step, not in fp32), into staging slot t mod 2, which hops into the
    reader's receive slot (t+1) mod 2 once the reader's sum of step t − 1
    has read it; the last step writes Y.

    Slots and Y are allocated on the caller's stream before the ring
    starts; each product's temporary is made and freed on its compute
    stream."""

    def __init__(self, mesh: Mesh, *, reduce_scatter: bool, bidir: bool = False,
                 impl: str = "torch", blocks: tuple[int, int, int] | None = None):
        super().__init__(mesh, impl, blocks)
        self.reduce_scatter = reduce_scatter
        self.bidir = bidir
        self.per_rank = 3 if bidir else 2

    def __call__(self, x: Sequence[torch.Tensor], w: Sequence[torch.Tensor]) -> Sharded:
        d = len(self.mesh.ranks)
        mshard = x[0].shape[0] // d if self.reduce_scatter else x[0].shape[0]
        if self.bidir and mshard < 2:
            if self.reduce_scatter:
                raise ValueError(
                    f"bidirectional RS ring needs ≥2 output rows per device "
                    f"(m/d = {mshard}); use collective_matmul_rs instead")
            # one local row would leave the forward half empty: a
            # unidirectional ring reported as bidirectional
            raise ValueError(
                f"bidirectional ring needs ≥2 local rows per device "
                f"(m/d = {mshard}); use collective_matmul instead")
        sched = self._schedule(x[0].is_cuda)
        if self.reduce_scatter:
            return self._reduce_scatter(sched, x, w, mshard)
        return self._allgather(sched, x, w, mshard)

    def _slots(self, ways, n: int, dtype: torch.dtype) -> dict[str, list[torch.Tensor]]:
        return {way.name: [torch.empty((2, way.hi - way.lo, n), dtype=dtype, device=dev)
                           for dev in self.mesh.devices] for way in ways}

    def _allgather(self, sched: _Schedule, x, w, mshard: int) -> Sharded:
        d = len(self.mesh.ranks)
        k = x[0].shape[1]
        y = [torch.empty((mshard * d, w[0].shape[1]), dtype=matmul_out_dtype(x[0].dtype),
                         device=dev) for dev in self.mesh.devices]
        ways = ring_ways(mshard, self.bidir)
        slots = self._slots(ways, k, x[0].dtype) if d > 1 else {}
        hop_done: dict[tuple[str, int, int], Any] = {}
        reads: dict[tuple[str, int, int], tuple] = {}
        sched.enter()
        for t in range(d):
            sched.step = t
            for r in range(d):
                whole = self.bidir and t == 0  # the own chunk, in one product
                if whole:
                    with sched.on(r, _COMPUTE, "product"):
                        self.mm(x[r], w[r], out=y[r][r * mshard:(r + 1) * mshard])
                    product = sched.mark(r, _COMPUTE)
                for way in ways:
                    writer, reader = way.neighbours(d, r)
                    chunk = x[r][way.lo:way.hi] if t == 0 else slots[way.name][r][t % 2]
                    arrived = hop_done.get((way.name, writer, t - 1))  # recv_sem
                    if not whole:
                        row0 = (r - way.step * t) % d * mshard
                        sched.wait(r, _COMPUTE, arrived)
                        with sched.on(r, _COMPUTE, "product"):
                            self.mm(chunk, w[r], out=y[r][row0 + way.lo:row0 + way.hi])
                        product = sched.mark(r, _COMPUTE)
                    if t + 1 < d:
                        # free_sem: the reader read its slot (t+1) mod 2 at
                        # step t−1 (a slot from t−1 = 1 on)
                        freed = reads[(way.name, reader, t - 1)] if t >= 2 else ()
                        sched.wait(r, way.copy, arrived)
                        sched.wait(r, way.copy, *freed, reuse=True)
                        # through the module, where a recorder's patch sees it
                        cuda_ring._hop(sched, r, slots[way.name][reader][(t + 1) % 2], chunk,
                                       way.copy)
                        hop_done[(way.name, r, t)] = sched.mark(r, way.copy)
                    reads[(way.name, r, t)] = (product, hop_done.get((way.name, r, t)))
        sched.leave()
        return Sharded(y, COLS)

    def _reduce_scatter(self, sched: _Schedule, x, w, mshard: int) -> Sharded:
        d = len(self.mesh.ranks)
        n = w[0].shape[1]
        out = matmul_out_dtype(x[0].dtype)
        y = [torch.empty((mshard, n), dtype=out, device=dev) for dev in self.mesh.devices]
        ways = ring_ways(mshard, self.bidir)
        recv = self._slots(ways, n, out) if d > 1 else {}
        stage = self._slots(ways, n, out) if d > 1 else {}
        hop_done: dict[tuple[str, int, int], Any] = {}
        summed: dict[tuple[str, int, int], Any] = {}
        sched.enter()
        for t in range(d):
            sched.step = t
            last = t + 1 == d
            for r in range(d):
                for way in ways:
                    writer, reader = way.neighbours(d, r)
                    row0 = (r - way.step * (1 + t)) % d * mshard
                    rows = x[r][row0 + way.lo:row0 + way.hi]
                    dest = y[r][way.lo:way.hi] if last else stage[way.name][r][t % 2]
                    if t == 0:  # acc = 0 + rows·w
                        with sched.on(r, _COMPUTE, "product"):
                            self.mm(rows, w[r], out=dest)
                    else:
                        with sched.on(r, _COMPUTE, "product"):
                            part = self.mm(rows, w[r])
                        # recv_sem of this step's accumulator; the hop that
                        # last read this staging slot, two steps ago
                        sched.wait(r, _COMPUTE, hop_done[(way.name, writer, t - 1)])
                        sched.wait(r, _COMPUTE, hop_done.get((way.name, r, t - 2)),
                                   reuse=True)
                        with sched.on(r, _COMPUTE, "add"):
                            torch.add(recv[way.name][r][t % 2], part, out=dest)
                    summed[(way.name, r, t)] = sched.mark(r, _COMPUTE)
                    if not last:
                        # free_sem: the reader's sum read its slot (t+1) mod
                        # 2 at step t−1 (a slot from t−1 = 1 on)
                        sched.wait(r, way.copy, summed[(way.name, r, t)])
                        sched.wait(r, way.copy,
                                   summed[(way.name, reader, t - 1)] if t >= 2 else None,
                                   reuse=True)
                        cuda_ring._hop(sched, r, recv[way.name][reader][(t + 1) % 2], dest,
                                       way.copy)
                        hop_done[(way.name, r, t)] = sched.mark(r, way.copy)
        sched.leave()
        return Sharded(y, ROWS)


def collective_matmul_program(mesh: Mesh, overlap: bool = True,
                              impl: str = "torch",
                              blocks: tuple[int, int, int] | None = None):
    """Y = X·W with X row-sharded [m/D, k] and W column-sharded [k, n/D]:
    logically Y_local = all_gather(X) @ W_local. Overlapped: the
    all-gather ring of `CollectiveMatmul`. overlap=False is the baseline:
    gather, then one product per rank."""
    if overlap:
        return CollectiveMatmul(mesh, reduce_scatter=False, impl=impl, blocks=blocks)
    mm = matmul_2d(impl, blocks, mesh_device_kind(mesh))
    gather_x = all_gather_over(mesh, gather_axis=0)

    def program(x: Sharded, w: Sharded) -> Sharded:
        sched = _Schedule(mesh, None)  # the caller's stream, in issue order
        with contextlib.ExitStack() as stack:
            for r in range(len(x)):
                stack.enter_context(sched.on(r, CALLER, "gather"))
            x_full = gather_x(x)
        ys = []
        for r, (xf, wr) in enumerate(zip(x_full, w)):
            with sched.on(r, CALLER, "product"):
                ys.append(mm(xf, wr))
        return Sharded(ys, COLS)

    return program


def collective_matmul_bidir_program(mesh: Mesh, impl: str = "torch",
                                    blocks: tuple[int, int, int] | None = None):
    """`collective_matmul_program`'s contract, each chunk in two
    counter-rotating halves (needs ≥ 2 rows a shard); its baseline is
    `collective_matmul_program(mesh, overlap=False)`."""
    return CollectiveMatmul(mesh, reduce_scatter=False, bidir=True, impl=impl, blocks=blocks)


def collective_matmul_rs_program(mesh: Mesh, overlap: bool = True,
                                 impl: str = "torch",
                                 blocks: tuple[int, int, int] | None = None):
    """Y = X·W with the contraction dim sharded: X [m, k/D] column-sharded,
    W [k/D, n] row-sharded, Y [m/D, n] row-sharded. Overlapped: the
    reduce-scatter ring of `CollectiveMatmul`. overlap=False is the
    baseline: each rank's whole partial product, then psum_scatter."""
    if overlap:
        return CollectiveMatmul(mesh, reduce_scatter=True, impl=impl, blocks=blocks)
    mm = matmul_2d(impl, blocks, mesh_device_kind(mesh))
    scatter = psum_scatter_over(mesh, scatter_dimension=0)

    def program(x: Sharded, w: Sharded) -> Sharded:
        sched = _Schedule(mesh, None)  # the caller's stream, in issue order
        parts = []
        for r, (xr, wr) in enumerate(zip(x, w)):
            with sched.on(r, CALLER, "product"):
                parts.append(mm(xr, wr))
        with contextlib.ExitStack() as stack:
            for r in range(len(parts)):
                stack.enter_context(sched.on(r, CALLER, "scatter"))
            out = scatter(parts)
        return Sharded(out, ROWS)

    return program


def collective_matmul_bidir_rs_program(mesh: Mesh, impl: str = "torch",
                                       blocks: tuple[int, int, int] | None = None):
    """`collective_matmul_rs_program`'s contract, each accumulator in two
    counter-rotating halves (needs ≥ 2 output rows a rank); its baseline is
    `collective_matmul_rs_program(mesh, overlap=False)`."""
    return CollectiveMatmul(mesh, reduce_scatter=True, bidir=True, impl=impl, blocks=blocks)


def _vs_baseline_mode(config: BenchConfig, mesh: Mesh, size: int,
                      mode_name: str, baseline_program, overlapped_program,
                      baseline_label: str, extra_fields: dict, benchmark: str,
                      x_spec: tuple = ROWS, w_spec: tuple = COLS,
                      fusable: bool = True) -> ModeSetup:
    """Shared builder for the collective-matmul forms: a serialized
    baseline leg timed against the overlapped program, with the speedup in
    extras. `tflops_per_device` is the total over the cards the ranks
    occupy, so on one card it is that card's throughput and
    `peak_efficiency_pct` keeps its 0–100 meaning."""
    d = world_size(mesh)
    cards = len(mesh.cards)
    (x,) = sharded_normal(config.seed, (size, size), config.dtype, mesh,
                          x_spec, count=1)
    (w,) = sharded_normal(config.seed + 1, (size, size), config.dtype, mesh,
                          w_spec, count=1)

    def build(t_compute: Timing, t_full: Timing | None, comm_s: float) -> BenchmarkRecord:
        # here 'compute' = the serialized baseline, 'full' = overlapped
        t_base = t_compute
        t_ovl = t_full if t_full else t_compute
        actual = calculate_tflops(size, t_ovl.avg_s)
        speedup = t_base.avg_s / t_ovl.avg_s if t_ovl.avg_s > 0 else 1.0
        return _record_base(
            config, benchmark, mode_name, size, d, t_ovl,
            avg_time_s=t_ovl.avg_s, tflops_per_device=actual / cards,
            tflops_total=actual, compute_time_s=t_base.avg_s, comm_time_s=None,
            device_kind=mesh_device_kind(mesh),
            extras={
                "baseline": baseline_label,
                "baseline_time_ms": round(t_base.avg_s * 1e3, 3),
                "overlap_speedup_x": round(speedup, 3),
                **extra_fields,
                "cards": cards,
                "ranks_per_card": mesh.ranks_per_card,
            })

    def expected() -> torch.Tensor:
        c = 128
        return expected_corner(global_block(x, c, size), global_block(w, size, c))

    return ModeSetup(mode_name, (x, w), baseline_program, overlapped_program,
                     build,
                     memory_gib_per_device=estimate_memory_gib(
                         mode_name, config, d, size),
                     validate=make_corner_validate(
                         overlapped_program, (x, w), expected, config.dtype),
                     fusable=fusable)


def hops_capturable(mesh: Mesh) -> bool:
    """Whether a CUDA graph can capture a collective-matmul ring's hops, so
    that the ring takes --timing fused: within one card a hop is
    cudaMemcpyAsync, which a graph captures; across cards it is
    cudaMemcpyPeerAsync (`csrc/ring.cu`), which no graph can capture, so
    there the ring demotes to the dispatch protocol."""
    return len(mesh.cards) == 1


def collective_matmul_mode(config: BenchConfig, mesh: Mesh, size: int,
                           benchmark: str = "overlap") -> ModeSetup:
    """The all-gather ring of `matmul_2d` products against gather-then-
    matmul (JAX `:354-364`); fusable where `hops_capturable`."""
    return _vs_baseline_mode(
        config, mesh, size, "collective_matmul",
        collective_matmul_program(mesh, overlap=False, impl=config.matmul_impl,
                                  blocks=config.blocks),
        collective_matmul_program(mesh, overlap=True, impl=config.matmul_impl,
                                  blocks=config.blocks),
        "all_gather-then-matmul", {"matmul_impl": config.matmul_impl}, benchmark,
        fusable=hops_capturable(mesh))


def collective_matmul_bidir_mode(config: BenchConfig, mesh: Mesh, size: int,
                                 benchmark: str = "overlap") -> ModeSetup:
    """The bidirectional all-gather ring against gather-then-matmul (JAX
    `:436-448`); fusable where `hops_capturable`."""
    return _vs_baseline_mode(
        config, mesh, size, "collective_matmul_bidir",
        collective_matmul_program(mesh, overlap=False, impl=config.matmul_impl,
                                  blocks=config.blocks),
        collective_matmul_bidir_program(mesh, impl=config.matmul_impl,
                                        blocks=config.blocks),
        "all_gather-then-matmul",
        {"matmul_impl": config.matmul_impl, "ring": "bidirectional"}, benchmark,
        fusable=hops_capturable(mesh))


def collective_matmul_rs_mode(config: BenchConfig, mesh: Mesh, size: int,
                              benchmark: str = "overlap") -> ModeSetup:
    """The reduce-scatter ring against matmul-then-psum_scatter (JAX
    `:571-582`); fusable where `hops_capturable`."""
    return _vs_baseline_mode(
        config, mesh, size, "collective_matmul_rs",
        collective_matmul_rs_program(mesh, overlap=False, impl=config.matmul_impl,
                                     blocks=config.blocks),
        collective_matmul_rs_program(mesh, overlap=True, impl=config.matmul_impl,
                                     blocks=config.blocks),
        "matmul-then-psum_scatter", {"matmul_impl": config.matmul_impl}, benchmark,
        x_spec=COLS, w_spec=ROWS, fusable=hops_capturable(mesh))


def collective_matmul_bidir_rs_mode(config: BenchConfig, mesh: Mesh, size: int,
                                    benchmark: str = "overlap") -> ModeSetup:
    """The bidirectional reduce-scatter ring against matmul-then-psum_scatter
    (JAX `:554-568`); fusable where `hops_capturable`."""
    return _vs_baseline_mode(
        config, mesh, size, "collective_matmul_bidir_rs",
        collective_matmul_rs_program(mesh, overlap=False, impl=config.matmul_impl,
                                     blocks=config.blocks),
        collective_matmul_bidir_rs_program(mesh, impl=config.matmul_impl,
                                           blocks=config.blocks),
        "matmul-then-psum_scatter",
        {"matmul_impl": config.matmul_impl, "ring": "bidirectional"}, benchmark,
        x_spec=COLS, w_spec=ROWS, fusable=hops_capturable(mesh))


def _explicit_blocks(config: BenchConfig) -> dict:
    """Only the explicitly-set --block-m/n/k flags, as kernel kwargs (the
    ring builders fill the rest from the default tile)."""
    return {f"block_{dim}": v for dim, v in
            zip("mnk", (config.block_m, config.block_n, config.block_k))
            if v is not None}


def _hbm_ring_kwargs(config: BenchConfig) -> dict:
    """Kernel kwargs the HBM ring builders share: explicit block overrides
    + the --wres tri-state."""
    return {**_explicit_blocks(config), "wres": config.wres_override}


def _wres_extras(config: BenchConfig, mesh: Mesh, size: int) -> dict:
    """Record extras for a ring mode's W-resident provenance: the flag, the
    engagement and the reason, for a size² W cut into world-size shards
    (`--wres on` raised when the ring was built)."""
    from tpu_matmul_bench_torch.ops.cuda_ring import resolve_wres

    d = world_size(mesh)
    engaged, reason = resolve_wres(config.wres_override, d,
                                   size * (size // d) * bytes_per_element(config.dtype))
    return {"wres": config.wres, "wres_engaged": engaged, "wres_reason": reason}


def cuda_ring_hbm_mode(config: BenchConfig, mesh: Mesh, size: int,
                       benchmark: str = "overlap") -> ModeSetup:
    """The all-gather ring (`ops/cuda_ring.py`, K2) against the
    gather-then-matmul baseline. `--block-m/n/k` set the products' tile."""
    from tpu_matmul_bench_torch.ops.cuda_ring import ring_allgather_matmul_hbm

    fn = ring_allgather_matmul_hbm(mesh, **_hbm_ring_kwargs(config))
    return _vs_baseline_mode(
        config, mesh, size, "cuda_ring_hbm",
        collective_matmul_program(mesh, overlap=False, impl=config.matmul_impl,
                                  blocks=config.blocks),
        fn,
        "all_gather-then-matmul",
        {"kernel": "CUDA HBM ring all-gather matmul (persistent-GEMM "
                   "products that store each chunk they load into the reader's "
                   "receive slot; K1 products and copy-engine hops between rank "
                   "streams across cards, or where a step "
                   "cannot forward)",
         **_wres_extras(config, mesh, size)}, benchmark,
        fusable=False,
    )


def cuda_ring_rs_hbm_mode(config: BenchConfig, mesh: Mesh, size: int,
                          benchmark: str = "overlap") -> ModeSetup:
    """The reduce-scatter ring (`ops/cuda_ring.py`, K3) against the
    matmul-then-psum_scatter baseline."""
    from tpu_matmul_bench_torch.ops.cuda_ring import ring_reduce_scatter_matmul_hbm

    fn = ring_reduce_scatter_matmul_hbm(mesh, **_hbm_ring_kwargs(config))
    return _vs_baseline_mode(
        config, mesh, size, "cuda_ring_rs_hbm",
        collective_matmul_rs_program(mesh, overlap=False,
                                     impl=config.matmul_impl,
                                     blocks=config.blocks),
        fn,
        "matmul-then-psum_scatter",
        {"kernel": "CUDA HBM ring reduce-scatter matmul (persistent pickup-GEMM "
                   "products stored into the reader's receive slot; copy-engine "
                   "hops between rank streams only across cards)",
         **_wres_extras(config, mesh, size)}, benchmark,
        x_spec=COLS, w_spec=ROWS,
        fusable=False,
    )


def cuda_ring_bidir_hbm_mode(config: BenchConfig, mesh: Mesh, size: int,
                             benchmark: str = "overlap") -> ModeSetup:
    """The bidirectional all-gather ring (`ops/cuda_ring.py`, K4):
    counter-rotating half chunks, two half-chunk products a step, against
    the gather-then-matmul baseline."""
    from tpu_matmul_bench_torch.ops.cuda_ring import ring_allgather_matmul_bidir_hbm

    fn = ring_allgather_matmul_bidir_hbm(mesh, **_hbm_ring_kwargs(config))
    return _vs_baseline_mode(
        config, mesh, size, "cuda_ring_bidir_hbm",
        collective_matmul_program(mesh, overlap=False, impl=config.matmul_impl,
                                  blocks=config.blocks),
        fn,
        "all_gather-then-matmul",
        {"kernel": "CUDA bidirectional HBM ring all-gather matmul (two "
                   "persistent-GEMM half-chunk products a step, each storing its "
                   "half into the reader's receive slot of its direction; "
                   "counter-rotating copy-engine hops across cards, or where a step "
                   "cannot forward)",
         **_wres_extras(config, mesh, size)}, benchmark,
        fusable=False,
    )


def cuda_ring_bidir_rs_hbm_mode(config: BenchConfig, mesh: Mesh, size: int,
                                benchmark: str = "overlap") -> ModeSetup:
    """The bidirectional reduce-scatter ring (`ops/cuda_ring.py`, K5):
    counter-rotating half accumulators, against the matmul-then-psum_scatter
    baseline."""
    from tpu_matmul_bench_torch.ops.cuda_ring import ring_reduce_scatter_matmul_bidir_hbm

    fn = ring_reduce_scatter_matmul_bidir_hbm(mesh, **_hbm_ring_kwargs(config))
    return _vs_baseline_mode(
        config, mesh, size, "cuda_ring_bidir_rs_hbm",
        collective_matmul_rs_program(mesh, overlap=False,
                                     impl=config.matmul_impl,
                                     blocks=config.blocks),
        fn,
        "matmul-then-psum_scatter",
        {"kernel": "CUDA bidirectional HBM ring reduce-scatter matmul (two "
                   "persistent pickup-GEMM half products a step, each stored "
                   "into the reader's receive slot of its direction; "
                   "counter-rotating copy-engine hops only across cards)",
         **_wres_extras(config, mesh, size)}, benchmark,
        x_spec=COLS, w_spec=ROWS,
        fusable=False,
    )


def cuda_ring_max_size(world: int, dtype, budget: int, ranks_per_card: int = 1) -> int:
    """Largest size whose fused-ring footprint fits `budget` bytes on one
    card: per rank the X shard, its 2 slots and the W shard (operand dtype)
    and the Y block (output dtype, int32 for int8), (3·mshard·k + k·nshard)
    · item + m·nshard · out_item (`pallas_ring.py:147-148`), that is
    size²/world · (4·item + out_item), summed over the `ranks_per_card` ranks
    that share the card. Rounded down to a multiple of 128·world, at least
    one. The form of `pallas_ring_max_size` (`overlap.py:597-606`), whose
    budget is the VMEM one and whose device holds one rank."""
    item = bytes_per_element(dtype)
    out_item = bytes_per_element(matmul_out_dtype(dtype))
    s = int((budget * world / (ranks_per_card * (4 * item + out_item))) ** 0.5)
    step = 128 * world  # keep shards lane-aligned and divisible by world
    return max((s // step) * step, step)


def l2_bytes(device: torch.device) -> int:
    """The card's L2, as it reports it: where the fused ring's operands stay
    between steps."""
    return torch.cuda.get_device_properties(device).L2_cache_size


def cuda_ring_mode(config: BenchConfig, mesh: Mesh, size: int,
                   benchmark: str = "overlap") -> ModeSetup:
    """The fused ring (`ops/cuda_ring_fused.py`, K6): the whole ring, every
    rank on the card, in one cooperative launch, against the
    gather-then-matmul baseline. On the card the size is capped by
    `cuda_ring_max_size` at the card's L2 (the CPU has no such cap, as the
    JAX package's interpreter has no VMEM cap)."""
    from tpu_matmul_bench_torch.ops.cuda_ring_fused import ring_allgather_matmul

    d = world_size(mesh)
    card = mesh.devices[0]
    if card.type == "cuda":
        limit = cuda_ring_max_size(d, config.dtype, l2_bytes(card), mesh.ranks_per_card)
        if size > limit:
            raise ValueError(
                f"cuda_ring at size {size} exceeds the L2-residency budget (max "
                f"size for {d} ranks, {mesh.ranks_per_card} per card/"
                f"{config.dtype_name}: {limit}); use --sizes {limit} or the "
                "HBM-blocked cuda_ring_hbm")
    return _vs_baseline_mode(
        config, mesh, size, "cuda_ring",
        collective_matmul_program(mesh, overlap=False, impl=config.matmul_impl,
                                  blocks=config.blocks),
        ring_allgather_matmul(mesh),
        "all_gather-then-matmul",
        {"kernel": "CUDA fused ring all-gather matmul (one cooperative launch, "
                   "wgmma tiles and TMA-store hops for TMA-describable bf16/f16, "
                   "a grid barrier a step)",
         # as the JAX package's pallas_ring: the HBM ring is the headline
         "superseded_by": "cuda_ring_hbm"}, benchmark,
        fusable=False,
    )


OVERLAP_MODES: dict[str, Callable[..., ModeSetup]] = {
    "no_overlap": functools.partial(overlap_mode, variant="no_overlap"),
    "overlap": functools.partial(overlap_mode, variant="overlap"),
    "pipeline": functools.partial(overlap_mode, variant="pipeline"),
    "collective_matmul": collective_matmul_mode,
    "collective_matmul_bidir": collective_matmul_bidir_mode,
    "collective_matmul_rs": collective_matmul_rs_mode,
    "collective_matmul_bidir_rs": collective_matmul_bidir_rs_mode,
    "cuda_ring": cuda_ring_mode,
    "cuda_ring_hbm": cuda_ring_hbm_mode,
    "cuda_ring_bidir_hbm": cuda_ring_bidir_hbm_mode,
    "cuda_ring_rs_hbm": cuda_ring_rs_hbm_mode,
    "cuda_ring_bidir_rs_hbm": cuda_ring_bidir_rs_hbm_mode,
}
