"""Admission queue: shape bucketing, micro-batching, bounded backpressure.

A copy of `tpu_matmul_bench/serve/queue.py` on the port's registry.

Serving on a compiled-program accelerator is an executable-reuse problem:
every distinct (M, K, N) would otherwise be its own trace + compile, so
arbitrary request shapes must first be **bucketed** onto a padded grid —
each request runs at the smallest grid shape covering it, wasting at most
the grid's step in FLOPs but sharing one cached executable per bucket
(DESIGN §10). `ShapeGrid` owns that rounding.

Admitted requests wait in a bounded FIFO. The worker drains it in
**micro-batches**: the head request names a bucket, and the batch
collects up to `max_batch` same-bucket requests, waiting up to
`window_s` after the head's enqueue for stragglers — so a burst of
same-shape traffic pays one queue wakeup and dispatches back-to-back on
one executable instead of interleaving wakeups with other buckets.

Backpressure is **shed-on-overflow**: `submit` on a full queue raises
`utils.errors.QueueOverflowError` immediately instead of blocking the
producer. An overloaded service answering "no" in µs keeps its admitted
tail bounded; queueing everything would push p99 toward the timeout
horizon for every request. The shed count is first-class ledger data.

Thread model: one or more producers call `submit`; one worker calls
`take_batch`. All state is guarded by a single condition variable — the
queue is the only cross-thread structure in the serving harness.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from typing import Any, Sequence

from tpu_matmul_bench_torch.obs.registry import get_registry
from tpu_matmul_bench_torch.utils.errors import QueueOverflowError

# Default padding grid: the lane-aligned ladder from the smallest shape
# the MXU tiles well through the repo's headline sweep sizes. Geometric
# steps bound padding waste per dim at 2x compute (< 2x per dim in
# FLOPs only when the dim lands just above a grid point); a finer grid
# trades padding waste for more executables (cache pressure).
DEFAULT_GRID = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)

DEFAULT_MAX_DEPTH = 256
DEFAULT_WINDOW_S = 0.002
DEFAULT_MAX_BATCH = 8


@dataclasses.dataclass
class Request:
    """One admitted unit of work: a C[m,n] = A[m,k]·B[k,n] ask."""

    rid: int
    m: int
    k: int
    n: int
    dtype: str
    arrival_s: float = 0.0  # planned offset in the load schedule
    submitted_at: float = 0.0  # wall clock at successful submit
    bucket: tuple[int, int, int] | None = None  # stamped on admission
    tenant: str = "default"  # traffic class (serve/tenants.py)
    dispatched_at: float = 0.0  # wall clock when its batch was taken
    trace: str = ""  # flight-recorder id, parented under the run context
    group: int | None = None  # replica group that served it (serve/pod.py)


class ShapeGrid:
    """Padded shape grid: rounds each dim up to its covering grid point."""

    def __init__(self, points: Sequence[int] = DEFAULT_GRID) -> None:
        pts = sorted(set(int(p) for p in points))
        if not pts or pts[0] < 1:
            raise ValueError(f"grid needs positive points, got {points!r}")
        self.points = tuple(pts)

    def bucket_dim(self, dim: int) -> int:
        """Smallest grid point >= dim; dims beyond the grid round up to
        the next multiple of the largest point (huge requests still get
        a shared executable class instead of an unbounded shape set)."""
        if dim < 1:
            raise ValueError(f"dims must be positive, got {dim}")
        i = bisect.bisect_left(self.points, dim)
        if i < len(self.points):
            return self.points[i]
        top = self.points[-1]
        return ((dim + top - 1) // top) * top

    def bucket(self, m: int, k: int, n: int) -> tuple[int, int, int]:
        return (self.bucket_dim(m), self.bucket_dim(k), self.bucket_dim(n))


class AdmissionQueue:
    """Bounded FIFO with per-bucket micro-batching (see module docstring)."""

    def __init__(
        self,
        grid: ShapeGrid | None = None,
        *,
        max_depth: int = DEFAULT_MAX_DEPTH,
        window_s: float = DEFAULT_WINDOW_S,
        max_batch: int = DEFAULT_MAX_BATCH,
        recorder: Any = None,
    ) -> None:
        if max_depth < 1 or max_batch < 1 or window_s < 0:
            raise ValueError(
                f"bad queue policy: depth={max_depth} batch={max_batch} "
                f"window={window_s}")
        self.grid = grid or ShapeGrid()
        self.max_depth = max_depth
        self.window_s = window_s
        self.max_batch = max_batch
        # flight recorder (serve/trace.py): shed requests get a terminal
        # trace event, so a p99 forensics pass can see WHO was refused,
        # not just how many (a None recorder no-ops)
        self.recorder = recorder
        self._items: list[tuple[float, Request]] = []  # (enqueue_wall, req)
        self._cond = threading.Condition()
        self._closed = False
        # obs-bus instruments (per-instance; see serve/cache.py for the
        # compat-view rationale). The depth gauge tracks live queue
        # length so `obs status` sees backpressure while it happens.
        reg = get_registry()
        self._m_submitted = reg.counter("serve_queue_submitted_total")
        self._m_shed = reg.counter("serve_queue_shed_total")
        self._m_depth = reg.gauge("serve_queue_depth")
        # shed attribution by traffic class: the fixed-window queue sheds
        # whoever hits the full queue — recording WHO was shed is what
        # lets the A/B harness show that indiscriminate shedding spills
        # onto well-behaved tenants (scheduler.py sheds selectively)
        self._shed_by_tenant: dict[str, int] = {}

    # -- compat view: pre-registry int attributes, reading the bus
    @property
    def submitted(self) -> int:
        return int(self._m_submitted.value)

    @property
    def shed(self) -> int:
        return int(self._m_shed.value)

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._items)

    @property
    def offered(self) -> int:
        """Distinct submission attempts (admitted + shed at the door)."""
        return self.submitted + self.shed

    def submit(self, req: Request) -> Request:
        """Admit a request (stamping its bucket + submit time), or raise
        `QueueOverflowError` without blocking when the queue is full."""
        req.bucket = self.grid.bucket(req.m, req.k, req.n)
        with self._cond:
            if self._closed:
                raise RuntimeError("queue is closed to new submissions")
            if len(self._items) >= self.max_depth:
                self._m_shed.inc()
                self._shed_by_tenant[req.tenant] = \
                    self._shed_by_tenant.get(req.tenant, 0) + 1
                if self.recorder:
                    self.recorder.terminal(req, "shed_overflow",
                                           depth=len(self._items))
                raise QueueOverflowError(len(self._items), self.max_depth)
            req.submitted_at = time.perf_counter()
            self._items.append((req.submitted_at, req))
            self._m_submitted.inc()
            self._m_depth.set(len(self._items))
            self._cond.notify()
        return req

    def close(self) -> None:
        """No more submissions; `take_batch` drains what remains, then
        returns None."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def _collect_locked(self) -> list[Request]:
        """Same-bucket requests from the front, head's bucket, FIFO order."""
        key = self._items[0][1].bucket
        picked = [it for it in self._items if it[1].bucket == key]
        return [r for _, r in picked[: self.max_batch]]

    def take_batch(self) -> list[Request] | None:
        """Next micro-batch (all one bucket), or None when closed + empty.

        Blocks while empty; once a head request exists, waits until its
        micro-batch window elapses or the batch fills, then pops the
        batch. Requests of other buckets keep their queue positions.
        """
        with self._cond:
            while True:
                while not self._items:
                    if self._closed:
                        return None
                    self._cond.wait()
                head_enqueued = self._items[0][0]
                deadline = head_enqueued + self.window_s
                while True:
                    batch = self._collect_locked()
                    remaining = deadline - time.perf_counter()
                    if (len(batch) >= self.max_batch or remaining <= 0
                            or self._closed):
                        break
                    self._cond.wait(timeout=remaining)
                    if not self._items:  # drained by another worker
                        break
                if not self._items:
                    continue
                batch = self._collect_locked()
                picked = set(id(r) for r in batch)
                self._items = [it for it in self._items
                               if id(it[1]) not in picked]
                self._m_depth.set(len(self._items))
                dispatch = time.perf_counter()
                for r in batch:
                    r.dispatched_at = dispatch
                return batch

    def stats(self) -> dict[str, Any]:
        with self._cond:
            out: dict[str, Any] = {
                "scheduler": "fixed",
                "submitted": self.submitted,
                "shed": self.shed,
                "max_depth": self.max_depth,
                "window_ms": round(self.window_s * 1e3, 3),
                "max_batch": self.max_batch,
            }
            if self._shed_by_tenant:
                out["shed_by_tenant"] = dict(sorted(
                    self._shed_by_tenant.items()))
            return out
