"""The admission paths on the CPU (`serve/queue.py AdmissionQueue`,
`serve/scheduler.py ContinuousScheduler`) against the JAX package's: one
seeded stream of submits, batch takes, service and failure feedback, run
through both under one injected clock, gives the same batches in the same
order, the same sheds (type and message), the same breaker transitions,
the same stats and the same flight-recorder terminal records."""

import random

import pytest

from tpu_matmul_bench.serve import queue as jax_queue
from tpu_matmul_bench.serve import scheduler as jax_scheduler
from tpu_matmul_bench.serve import tenants as jax_tenants
from tpu_matmul_bench.serve import trace as jax_trace
from tpu_matmul_bench_torch.serve import queue, scheduler, tenants, trace

TENANTS = {"interactive": {"weight": 4, "priority": 0, "slo_ms": 3.0},
           "bulk": {"weight": 1, "priority": 1},
           "batch": {"weight": 2, "priority": 1, "slo_ms": 40.0}}
SHAPES = [(128, 128, 128), (200, 64, 256), (1000, 1000, 1000)]
FAILING = (256, 128, 256)  # the bucket of SHAPES[1]: its dispatches fail


class Clock:
    """A clock that ticks 10 µs at every read, standing in for both the
    modules' `time` (perf_counter, monotonic) and the breakers' clock."""

    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        self.now += 1e-5
        return self.now

    perf_counter = monotonic = __call__

    def advance(self, seconds: float) -> None:
        self.now += seconds


def _ops(seed: int, n: int = 400) -> list[tuple]:
    """A seeded op stream: submits of random tenants and shapes, clock
    advances, batch takes with success/failure feedback."""
    rng = random.Random(seed)
    ops = []
    for rid in range(n):
        ops.append(("advance", rng.choice([0.0, 1e-4, 2e-3, 0.03, 0.3])))
        ops.append(("submit", rid, rng.choice(list(TENANTS)), rng.choice(SHAPES)))
        if rng.random() < 0.35:
            ops.append(("take", rng.uniform(1e-4, 5e-3)))
    ops.append(("close",))
    return ops


def _drive(mod_queue, mod_sched, mod_tenants, mod_trace, ops, *, fixed: bool,
           monkeypatch) -> list:
    """Run `ops` through one package's admission path; returns what every
    op observed."""
    clock = Clock()
    for mod in (mod_queue, mod_sched, mod_trace):
        monkeypatch.setattr(mod, "time", clock)
    recorder = mod_trace.FlightRecorder()
    grid = mod_queue.ShapeGrid()
    if fixed:
        q = mod_queue.AdmissionQueue(grid, max_depth=6, window_s=0.0, max_batch=3,
                                     recorder=recorder)
    else:
        specs = mod_tenants.tenants_from_dict({"tenants": TENANTS})
        q = mod_sched.ContinuousScheduler(grid, tenants=specs, max_depth=6, max_batch=3,
                                          starvation_ms=30.0, breaker_threshold=2,
                                          breaker_cooldown_s=0.5, clock=clock,
                                          recorder=recorder)
    seen = []
    for op in ops:
        if op[0] == "advance":
            clock.advance(op[1])
            continue
        if op[0] == "submit":
            _, rid, tenant, (m, k, n) = op
            req = mod_queue.Request(rid=rid, m=m, k=k, n=n, dtype="bfloat16",
                                    tenant=tenant if not fixed else "default",
                                    trace=f"run-r{rid:06d}")
            try:
                q.submit(req)
                seen.append(("admitted", rid, req.bucket, req.submitted_at))
            except Exception as e:  # noqa: BLE001 — the shed is the observation
                seen.append(("shed", rid, type(e).__name__, str(e)))
        elif op[0] == "take" and q.depth:
            batch = q.take_batch()
            seen.append(("batch", [r.rid for r in batch], [r.dispatched_at for r in batch]))
            for r in batch:
                if hasattr(q, "note_result"):
                    q.note_result(r.bucket, r.dtype, ok=r.bucket != FAILING)
            if hasattr(q, "note_service"):
                q.note_service(op[1], len(batch))
        elif op[0] == "close":
            q.close()
            while (batch := q.take_batch()) is not None:
                seen.append(("batch", [r.rid for r in batch], [r.dispatched_at for r in batch]))
        seen.append(("stats", q.stats(), q.submitted, q.shed, q.offered))
        seen.append(("spans", recorder.drain()))
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_continuous_scheduler_is_jaxs(seed, monkeypatch):
    ops = _ops(seed)
    port = _drive(queue, scheduler, tenants, trace, ops, fixed=False,
                  monkeypatch=monkeypatch)
    ref = _drive(jax_queue, jax_scheduler, jax_tenants, jax_trace, ops, fixed=False,
                 monkeypatch=monkeypatch)
    assert port == ref
    final = port[-2][1]
    # the stream exercised every decision the scheduler makes
    assert final["evictions"] and final["slo_sheds"] and final["breaker_sheds"]
    assert final["preemptions"] and final["starvation_promotions"]
    assert final["breakers"]["256x128x256/bfloat16"]["opens"] >= 2
    states = {s["state"] for op in port if op[0] == "spans" for s in op[1]}
    assert states == {"shed_overflow", "shed_breaker", "shed_slo", "evicted"}


@pytest.mark.parametrize("seed", [0, 1])
def test_fixed_window_queue_is_jaxs(seed, monkeypatch):
    ops = _ops(seed)
    port = _drive(queue, scheduler, tenants, trace, ops, fixed=True, monkeypatch=monkeypatch)
    ref = _drive(jax_queue, jax_scheduler, jax_tenants, jax_trace, ops, fixed=True,
                 monkeypatch=monkeypatch)
    assert port == ref
    assert port[-2][1]["shed"] > 0 and port[-2][1]["shed_by_tenant"] == {
        "default": port[-2][1]["shed"]}


def test_explorer_guards_read_the_scheduler(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(scheduler, "time", clock)
    specs = tenants.tenants_from_dict({"tenants": TENANTS})
    q = scheduler.ContinuousScheduler(queue.ShapeGrid(), tenants=specs, breaker_threshold=1,
                                      clock=clock)
    assert not q.tenant_in_slo_debt("interactive") and not q.breaker_open(FAILING, "int8")
    q.note_service(0.01, 1)  # 10 ms a request: one queued request is past 3 ms
    q.submit(queue.Request(rid=0, m=128, k=128, n=128, dtype="int8", tenant="interactive"))
    assert q.tenant_in_slo_debt("interactive") and not q.tenant_in_slo_debt("bulk")
    q.note_result(FAILING, "int8", ok=False)
    assert q.breaker_open(FAILING, "int8")
    with pytest.raises(ValueError, match="unknown tenant"):
        q.submit(queue.Request(rid=1, m=1, k=1, n=1, dtype="int8", tenant="nobody"))
