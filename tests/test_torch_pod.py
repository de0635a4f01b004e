"""Pod-scale serving on the CPU (`tpu_matmul_bench_torch/serve/pod.py`)
against the JAX package's `serve/pod.py`.

- the pod comms model (`pod_axis_collectives`, `pod_expected_collectives`):
  JAX's for both factorizations' group meshes, bf16, fp32 and int8, exact
  and quantized;
- the group program: the same numpy operands through JAX's
  `pod_group_program` on the conftest's 8-device mesh and the port's over 8
  ranks on the CPU (`TMB_RANKS_PER_CARD=8`), at 64×48×96 on both group
  meshes: every rank's replicated output within `validation_tolerance`
  (int8 exact); under `dcn=fp8-block:32,ici=none`, on operands whose
  products are exact in both packages, bitwise JAX's (the wire's payloads
  and scales are JAX's bits, tests/test_torch_wire.py);
- the collectives audit: every group program's recorded collectives are
  `pod_expected_collectives`' (POD-002), and a seeded cross-group gather
  trips POD-003;
- `PodQueue`: one seeded stream of submits, batch takes and feedback
  through both packages' pod fronts under one ticking fake clock gives the
  same placements, sheds, batches and stats; then `tests/test_pod.py`'s
  conservation, backlog spread, breaker isolation and group-count checks;
- the whole path: `serve pod selftest --device cpu` exits 0; a pod bench
  record's `extras["serve"]["pod"]` keys are JAX's; the CLI's pod flags.
"""

import collections
import json
import random

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_port_util import as_numpy, numpy_operands, rel_err, single_torch_thread  # noqa: F401

from tpu_matmul_bench.analysis import comms_model as jcomms
from tpu_matmul_bench.serve import placement as jplacement
from tpu_matmul_bench.serve import pod as jpod
from tpu_matmul_bench.serve import queue as jqueue
from tpu_matmul_bench.serve import scheduler as jscheduler
from tpu_matmul_bench.serve import tenants as jtenants
from tpu_matmul_bench.serve import trace as jtrace
from tpu_matmul_bench_torch.__main__ import main as port_main
from tpu_matmul_bench_torch.analysis import comms_model as comms
from tpu_matmul_bench_torch.obs.registry import reset_registry
from tpu_matmul_bench_torch.parallel import mesh
from tpu_matmul_bench_torch.parallel.mesh import shard_from_numpy
from tpu_matmul_bench_torch.parallel.modes import validation_tolerance
from tpu_matmul_bench_torch.serve import placement, pod, queue, scheduler, tenants, trace
from tpu_matmul_bench_torch.serve.service import validate_serve_record
from tpu_matmul_bench_torch.train.audit import record_collectives
from tpu_matmul_bench_torch.utils.errors import QueueOverflowError

pytestmark = pytest.mark.usefixtures("single_torch_thread")

FACTORIZATIONS = [("dcn:2,ici:4", 2), ("dcn:4,ici:2", 2)]
QUANT = "dcn=fp8-block:32,ici=none"
M, K, N = 64, 48, 96


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


# ------------------------------------------------------------ comms model

@pytest.mark.parametrize("quant", [None, QUANT, "fp8-block:32", "int8-block:16"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("spec", ["ici:4", "dcn:2,ici:2", "dcn:2,ici:4", "dcn:4,ici:2"])
def test_pod_comms_model_is_jaxs(spec, dtype, quant):
    assert comms.pod_axis_collectives(spec, 256, 128, 512) == \
        jcomms.pod_axis_collectives(spec, 256, 128, 512)
    assert comms.pod_expected_collectives(spec, 256, 128, 512, dtype, quant) == \
        jcomms.pod_expected_collectives(spec, 256, 128, 512, dtype, quant)


@pytest.mark.parametrize("spec, mkn", [("dcn:2,ici:2", (3, 8, 8)), ("dcn:2,ici:2", (8, 8, 3)),
                                       ("ici:4", (8, 8, 6))])
def test_pod_comms_model_refuses_as_jax(spec, mkn):
    with pytest.raises(ValueError) as got:
        comms.pod_axis_collectives(spec, *mkn)
    with pytest.raises(ValueError) as want:
        jcomms.pod_axis_collectives(spec, *mkn)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------- group program

def _group_pairs(devices, spec, groups):
    ranks = [torch.device("cpu")] * 8
    return zip(placement.group_meshes(ranks, spec, groups),
               jplacement.group_meshes(devices, spec, groups))


def _run_both(devices, spec, groups, a, b, quant, impl="torch"):
    """Each group's outputs: the port's ranks' (numpy) and JAX's replicated
    array, for the same operands."""
    out = []
    for (group, pm), (_jg, jm) in _group_pairs(devices, spec, groups):
        spec_a, spec_b = pod.pod_operand_specs(pm)
        program = pod.pod_group_program(pm, impl, None, "cpu", quant)
        got = program(shard_from_numpy(a, spec_a, pm), shard_from_numpy(b, spec_b, pm))
        assert got.spec == () and len(got) == group.world
        want = jpod.pod_group_program(jm, "xla", None, "cpu", quant)(jnp.asarray(a),
                                                                    jnp.asarray(b))
        out.append(([as_numpy(g) for g in got], np.asarray(want), got[0].dtype))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("spec, groups", FACTORIZATIONS)
def test_group_program_matches_jax(devices, ranks8, spec, groups, dtype):
    a, b = numpy_operands(3, M, K, N, dtype)
    for ranks, want, out_dtype in _run_both(devices, spec, groups, a, b, None):
        assert str(out_dtype).removeprefix("torch.") == str(want.dtype)
        for got in ranks:
            assert got.shape == (M, N)
            assert rel_err(got, want.astype(np.float64)) <= validation_tolerance(dtype)
            if dtype == "int8":
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec, groups", FACTORIZATIONS)
def test_quantized_group_program_is_bitwise_jax(devices, ranks8, spec, groups):
    # entries in {-1, 0, 1}: every product is a small integer, exact in both
    # packages' bf16 outputs, so the wire quantizes the same bits
    rng = np.random.default_rng(11)
    a = rng.integers(-1, 2, size=(M, K)).astype(ml_dtypes.bfloat16)
    b = rng.integers(-1, 2, size=(K, N)).astype(ml_dtypes.bfloat16)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    for ranks, want, _ in _run_both(devices, spec, groups, a, b, QUANT):
        for got in ranks:
            np.testing.assert_array_equal(got, want.astype(np.float32))
            # fp8 on the dcn link (dcn:2,ici:2 groups); exact on ici:4 groups
            assert rel_err(got, exact) <= 0.08


def test_group_program_cuts_the_products_of_the_pod_table(ranks8):
    a, b = numpy_operands(5, M, K, N, "bfloat16")
    for spec, groups in FACTORIZATIONS:
        for group, pm in placement.group_meshes([torch.device("cpu")] * 8, spec, groups):
            spec_a, spec_b = pod.pod_operand_specs(pm)
            ops = shard_from_numpy(a, spec_a, pm), shard_from_numpy(b, spec_b, pm)
            want = pod.pod_group_program(pm, "torch", None, "cpu")(*ops)
            got = pod.pod_group_program(pm, "cuda", None, "cpu")(*ops)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(as_numpy(g), as_numpy(w))
            # the per-rank products' shapes: the table of the pod cells
            shapes = {(tuple(x.shape), tuple(y.shape)) for x, y in zip(*ops)}
            o, i = pm.dims if len(pm.dims) == 2 else (1, pm.dims[0])
            assert shapes == {((M // o, K), (K, N // i))}


# ------------------------------------------------------ collectives audit

def test_recorded_collectives_are_the_models(ranks8):
    from tpu_matmul_bench_torch.utils.device import resolve_devices

    assert pod.pod_findings(resolve_devices("cpu", 8)) == []


def test_audit_needs_eight_ranks():
    (f,) = pod.pod_findings([torch.device("cpu")] * 4)
    assert f.rule == "POD-001" and f.severity == "warn" and "needs 8 ranks" in f.message


def test_cross_group_gather_trips_pod003(ranks8):
    from tpu_matmul_bench_torch.parallel import collectives

    (_g0, m0), (_g1, m1) = placement.group_meshes([torch.device("cpu")] * 8,
                                                  "dcn:2,ici:4", 2)
    x = shard_from_numpy(np.ones((8, 4), np.float32), (None, "ici"), m0)

    def leaky(shards):
        # a gather over a mesh that is not the group's own: the parent's
        # dcn axis, which joins the two groups
        parent = mesh.make_factorized_mesh([torch.device("cpu")] * 8, "dcn:2,ici:4")
        sub = parent.sub_mesh("dcn", 0)
        return collectives.all_gather_over(sub)([shards[0], shards[1]])

    with record_collectives() as log:
        leaky(x)
    assert log and pod.pod_collective_scope_problems(log, m0.axis_names) != []
    assert pod.pod_collective_scope_problems(log, ("dcn",)) == []


# ------------------------------------------------------------- PodQueue

class Clock:
    """Ticks 10 µs at every read: both packages' `time` and breaker clock."""

    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        self.now += 1e-5
        return self.now

    perf_counter = monotonic = __call__

    def advance(self, seconds: float) -> None:
        self.now += seconds


TENANTS = {"a": {"weight": 4, "priority": 0},
           "b": {"weight": 2, "priority": 1, "slo_ms": 50.0},
           "c": {"weight": 1, "priority": 1}}
SHAPES = [(128, 128, 128), (128, 128, 256), (256, 128, 128), (256, 256, 256)]
FAILING = (256, 256, 256)


def _stream(seed: int, n: int = 400) -> list[tuple]:
    rng = random.Random(seed)
    ops = []
    for rid in range(n):
        ops.append(("advance", rng.choice([0.0, 1e-4, 2e-3, 0.03])))
        ops.append(("submit", rid, rng.choice("abc"), rng.choice(SHAPES)))
        if rng.random() < 0.3:
            ops.append(("take", rng.randrange(2), rng.uniform(1e-4, 5e-3)))
    ops.append(("close",))
    return ops


def _drive_pod(mods, ops, monkeypatch) -> list:
    q_mod, s_mod, t_mod, tr_mod, p_mod, pl_mod = mods
    clock = Clock()
    for mod in (q_mod, s_mod, tr_mod):
        monkeypatch.setattr(mod, "time", clock)
    recorder = tr_mod.FlightRecorder()
    grid = q_mod.ShapeGrid()
    specs = t_mod.tenants_from_dict({"tenants": TENANTS})
    parts = pl_mod.partition_spec("dcn:2,ici:4", 2)
    scheds = [s_mod.ContinuousScheduler(grid, tenants=specs, max_depth=16, max_batch=4,
                                        breaker_threshold=2, breaker_cooldown_s=0.5,
                                        clock=clock, recorder=recorder) for _ in parts]
    q = p_mod.PodQueue(grid, parts, scheds, recorder=recorder)
    for s in scheds:
        s.note_service(0.01, 1)
    seen = []
    for op in ops:
        if op[0] == "advance":
            clock.advance(op[1])
            continue
        if op[0] == "submit":
            _, rid, tenant, (m, k, n) = op
            req = q_mod.Request(rid=rid, m=m, k=k, n=n, dtype="float32", tenant=tenant,
                                trace=f"run-r{rid:06d}")
            try:
                q.submit(req)
                seen.append(("admitted", rid, req.group, req.bucket))
            except Exception as e:  # noqa: BLE001 — the shed is the observation
                seen.append(("shed", rid, req.group, type(e).__name__, str(e)))
        elif op[0] == "take" and q.scheds[op[1]].depth:
            batch = q.scheds[op[1]].take_batch()
            if batch:
                seen.append(("batch", op[1], [(r.rid, r.group) for r in batch]))
                for r in batch:
                    q.scheds[op[1]].note_result(r.bucket, r.dtype, ok=r.bucket != FAILING)
                q.scheds[op[1]].note_service(op[2], len(batch))
        elif op[0] == "close":
            q.close()
            for gi, s in enumerate(q.scheds):
                while (batch := s.take_batch()) is not None:
                    seen.append(("batch", gi, [(r.rid, r.group) for r in batch]))
        seen.append(("stats", q.stats(), q.submitted, q.shed, q.offered, q.depth))
        seen.append(("spans", recorder.drain()))
    return seen


PORT_MODS = (queue, scheduler, tenants, trace, pod, placement)
JAX_MODS = (jqueue, jscheduler, jtenants, jtrace, jpod, jplacement)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pod_queue_decisions_are_jaxs(seed, monkeypatch):
    ops = _stream(seed)
    port = _drive_pod(PORT_MODS, ops, monkeypatch)
    reset_registry()
    ref = _drive_pod(JAX_MODS, ops, monkeypatch)
    assert port == ref
    final = port[-2][1]
    assert final["scheduler"] == "pod" and final["shed"] > 0
    placed = collections.Counter(op[2] for op in port if op[0] == "admitted")
    assert placed[0] and placed[1]


def _req(rid, tenant="default", m=128, k=128, n=128, dtype="float32"):
    return queue.Request(rid=rid, m=m, k=k, n=n, dtype=dtype, tenant=tenant)


def _pod(groups=2, **kw):
    parts = placement.partition_spec("dcn:2,ici:4", groups)
    return pod.PodQueue(queue.ShapeGrid(), parts,
                        [scheduler.ContinuousScheduler(queue.ShapeGrid(), **kw)
                         for _ in parts])


def test_pod_queue_conserves_a_seeded_mix():
    specs = (tenants.TenantSpec("a", weight=4.0, priority=0),
             tenants.TenantSpec("b", weight=2.0, priority=1, slo_ms=50.0),
             tenants.TenantSpec("c", weight=1.0, priority=1))
    q = _pod(tenants=specs, max_depth=16, max_batch=4)
    for s in q.scheds:
        s.note_service(0.01, 1)
    rng = random.Random(7)
    attempts = collections.Counter()
    batches = []
    for rid in range(400):
        tid = rng.choice("abc")
        m, k, n = rng.choice(SHAPES)
        attempts[tid] += 1
        try:
            q.submit(_req(rid, tid, m=m, k=k, n=n))
        except QueueOverflowError:
            pass
        if rng.random() < 0.3:
            gi = rng.randrange(2)
            if q.scheds[gi].depth and (b := q.scheds[gi].take_batch()):
                batches.append((gi, b))
    q.close()
    for gi, s in enumerate(q.scheds):
        while (b := s.take_batch()) is not None:
            batches.append((gi, b))
    stats = q.stats()
    dispatched = collections.Counter()
    for gi, batch in batches:
        assert 1 <= len(batch) <= 4 and len({(r.bucket, r.dtype) for r in batch}) == 1
        for r in batch:
            assert r.group == gi
            dispatched[r.tenant] += 1
    for tid in attempts:
        assert dispatched[tid] + stats["tenants"][tid]["shed"] == attempts[tid]
    assert sum(dispatched.values()) + stats["shed"] == 400 == q.offered
    per = stats["groups"]
    assert sum(per[g]["submitted"] for g in per) == stats["submitted"]
    assert all(per[g]["submitted"] > 0 for g in per)


def test_pod_queue_spreads_by_backlog():
    q = _pod(max_depth=64)
    assert [q.submit(_req(rid)).group for rid in range(8)] == [0, 1] * 4
    assert q.scheds[0].depth == q.scheds[1].depth == 4


def test_pod_breaker_isolation_diverts_never_sheds():
    q = _pod(max_depth=64, breaker_threshold=3)
    bucket = queue.ShapeGrid().bucket(128, 128, 128)
    for _ in range(3):
        q.scheds[0].note_result(bucket, "float32", ok=False)
    assert q.scheds[0].breaker_open(bucket, "float32") and not q.breaker_open(bucket, "float32")
    before = q.shed
    assert [q.submit(_req(rid)).group for rid in range(6)] == [1] * 6
    assert q.shed == before and q.scheds[1].depth == 6 and q.scheds[0].depth == 0
    assert q.submit(_req(100, m=512, k=512, n=512)).group == 0
    for _ in range(3):
        q.scheds[1].note_result(bucket, "float32", ok=False)
    assert q.breaker_open(bucket, "float32")
    with pytest.raises(QueueOverflowError):
        q.submit(_req(101))
    assert q.shed == before + 1


def test_pod_queue_refuses_mismatched_groups():
    parts = placement.partition_spec("dcn:2,ici:4", 2)
    with pytest.raises(ValueError, match="2 group"):
        pod.PodQueue(queue.ShapeGrid(), parts, [scheduler.ContinuousScheduler(queue.ShapeGrid())])
    with pytest.raises(ValueError):
        pod.PodQueue(queue.ShapeGrid(), (), [])


# -------------------------------------------------------------- the path

def test_pod_selftest_on_the_cpu_exits_0(monkeypatch, capsys):
    # unset, so the CLI puts the mesh's 8 ranks on the CPU itself
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "1")
    monkeypatch.delenv(mesh.RANKS_PER_CARD_ENV)
    (rec,) = port_main(["serve", "pod", "selftest", "--device", "cpu"])
    assert "pod selftest ok: POD-001..003 clean at 2 factorizations" in capsys.readouterr().out
    assert rec.extras["serve"]["scheduler"] == "pod" and rec.world == 8


POD_FLAGS = ["--mesh", "dcn:2,ici:4", "--replica-groups", "2", "--mix", "128,64x128x256:0.5",
             "--qps", "40", "--duration", "0.3", "--prewarm"]


@pytest.fixture(scope="module")
def jax_pod_ledger(tmp_path_factory):
    from tpu_matmul_bench.serve import cli as jax_serve_cli

    path = tmp_path_factory.mktemp("jax-pod") / "pod.jsonl"
    jax_serve_cli.main(["bench", *POD_FLAGS, "--json-out", str(path)])
    return path


def _serve_record(path) -> dict:
    (rec,) = [d for d in map(json.loads, path.read_text().splitlines())
              if d.get("benchmark") == "serve"]
    return rec


def test_pod_record_has_jaxs_keys(tmp_path, ranks8, jax_pod_ledger):
    path = tmp_path / "pod.jsonl"
    (rec,) = port_main(["serve", "bench", *POD_FLAGS, "--device", "cpu", "--matmul-impl",
                        "cuda", "--json-out", str(path)])
    assert validate_serve_record(rec) == []
    got, want = _serve_record(path), _serve_record(jax_pod_ledger)
    gp, wp = got["extras"]["serve"]["pod"], want["extras"]["serve"]["pod"]
    assert set(gp) == set(wp)
    assert [set(r) for r in gp["groups"]] == [set(r) for r in wp["groups"]]
    assert [r["placement"] for r in gp["groups"]] == [r["placement"] for r in wp["groups"]]
    assert set(got["extras"]["serve"]) == set(want["extras"]["serve"])
    assert set(got["extras"]["serve"]["queue"]) == set(want["extras"]["serve"]["queue"])
    assert got["world"] == want["world"] == 8
    s = got["extras"]["serve"]
    assert s["cold_requests"] == 0 and sum(r["requests"] for r in gp["groups"]) == s["requests"]
    # each group's executables, and each `cuda` entry's books over its 4 ranks
    assert {label.split(":")[0] for label in s["cache"]["by_entry"] if ":" in label} == \
        {"g0", "g1"}
    assert all(book["ranks"] == 4 for book in got["extras"]["cost_analysis"].values())


def test_pod_ab_writes_both_arms(tmp_path, ranks8):
    path = tmp_path / "ab.jsonl"
    try:
        port_main(["serve", "ab", *POD_FLAGS, "--device", "cpu", "--json-out", str(path)])
    except SystemExit as e:  # the single card may beat the pod on the CPU
        assert e.code == 1
    recs = [d for d in map(json.loads, path.read_text().splitlines())
            if d.get("benchmark") == "serve"]
    assert [r["extras"]["serve"]["scheduler"] for r in recs] == ["continuous", "pod"]
    verdict = recs[1]["extras"]["ab"]
    assert verdict["baseline"] == "single" and verdict["candidate"] == "pod"


@pytest.mark.parametrize("flags, match", [
    (["--replica-groups", "2"], "--replica-groups needs --mesh"),
    (["--mesh", "dcn:2,ici:4", "--replica-groups", "3"], "must divide the outer dcn axis"),
    (["--mesh", "ici:4,dcn:2"], "must order dcn before ici"),
    (["--mesh", "dcn:2,ici:4", "--scheduler", "fixed", "--device", "cpu"],
     "requires the continuous scheduler"),
    (["--mesh", "dcn:2,ici:4", "--explore", "0.1", "--device", "cpu"],
     "does not compose with --explore")])
def test_pod_flags_refused_as_jax(ranks8, flags, match):
    with pytest.raises((SystemExit, ValueError), match=match):
        port_main(["serve", "bench", "--mix", "64", "--duration", "0.1", *flags])


def test_a_mesh_past_the_placed_ranks_raises_naming_the_variable(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "4")
    with pytest.raises(ValueError, match="spans 8 ranks: .*TMB_RANKS_PER_CARD"):
        port_main(["serve", "bench", "--device", "cpu", "--mesh", "dcn:2,ici:4",
                   "--mix", "64", "--duration", "0.1"])


def test_replayed_graph_needs_its_own_operands():
    from tpu_matmul_bench_torch.serve import cache

    shards = mesh.Sharded([torch.ones(2, 2)] * 2, (), {"x": 2})

    class Replay:
        replays = 0

        def replay(self):
            Replay.replays += 1

    out = mesh.Sharded([torch.zeros(2, 2)] * 2, (), {"x": 2})
    ex = cache.GraphExecutable(Replay(), shards, shards, out)
    assert ex(shards, shards) is out and Replay.replays == 1
    with pytest.raises(ValueError, match="captured over"):
        ex(mesh.Sharded(list(shards), (), {"x": 2}), shards)
    eager = cache.EagerExecutable(lambda a, b: a, shards, shards)
    eager.wait()
    with pytest.raises(ValueError, match="executable built for"):
        eager(mesh.Sharded([torch.ones(2, 3)] * 2, (), {"x": 2}), shards)
