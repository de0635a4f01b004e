"""The port's recorder (`tpu_matmul_bench_torch/analysis/recording.py`)
against JAX's tracer (`tpu_matmul_bench/analysis/jaxpr_tools.py`).

The same audit programs, built from the same seeds, are traced by JAX
under conftest's 8 host devices and run by the port over 8 ranks on the
CPU while its recorder logs them. The inventories are compared as integer
multisets, and each against the comms model: the five parallel modes at
4 and 8 ranks, the quantizable families in the four wire formats, and
both 2-D modes at both factorizations exact and per link. The recorder's
own parts (casts, host round trips, the live-bytes walk, storage identity)
and its reach into every program that makes collectives are held on
seeded programs.
"""

import collections
import dataclasses

import jax
import pytest
import torch

from tpu_matmul_bench.analysis import auditor as jaud
from tpu_matmul_bench.analysis import jaxpr_tools as jt
from tpu_matmul_bench.analysis.comms_model import (
    expected_collectives as jax_expected,
    hier_expected_collectives as jax_hier_expected,
)
from tpu_matmul_bench.parallel.mesh import make_mesh as jax_make_mesh
from tpu_matmul_bench_torch.analysis import auditor as aud
from tpu_matmul_bench_torch.analysis import comms_model as cm
from tpu_matmul_bench_torch.analysis import recording as rec
from tpu_matmul_bench_torch.parallel import collectives
from tpu_matmul_bench_torch.parallel import mesh as pmesh
from tpu_matmul_bench_torch.utils.device import resolve_devices
from torch_port_util import single_torch_thread  # noqa: F401 — a fixture

pytestmark = pytest.mark.usefixtures("single_torch_thread")

MODES = ("independent", "batch_parallel", "matrix_parallel", "data_parallel",
         "model_parallel")


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(pmesh.RANKS_PER_CARD_ENV, "8")


def _cpu8():
    return resolve_devices("cpu", None)


def _jax_inventory(fn, operands):
    return collections.Counter((u.kind, u.payload_bytes)
                               for u in jt.collective_inventory(jax.make_jaxpr(fn)(*operands)))


def _port_inventory(fn, operands, mesh, steps=1):
    uses = aud.per_collective(aud.run_recorded(fn, *operands), mesh, steps)
    return collections.Counter((k, n) for k, _a, n, _d in uses)


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_mode_inventory_is_jax_traced_and_the_model(ranks8, devices, mode, world):
    jcfg = jaud._audit_config("bfloat16")
    js = jaud._all_modes()[mode](jcfg, jax_make_mesh(devices[:world]), jaud.AUDIT_SIZE)
    want = _jax_inventory(js.full or js.compute, js.operands)

    mesh = pmesh.make_mesh(_cpu8()[:world])
    ps = aud._all_modes()[mode](aud._audit_config("bfloat16", "cuda"), mesh, aud.AUDIT_SIZE)
    got = _port_inventory(ps.full or ps.compute, ps.operands, mesh)

    model = collections.Counter((e.kind, e.payload_bytes) for e in cm.expected_collectives(
        mode, world, aud.AUDIT_SIZE, torch.bfloat16, batch=aud.AUDIT_BATCH))
    assert got == want == model
    assert model == collections.Counter(
        (e.kind, e.payload_bytes) for e in jax_expected(
            mode, world, jaud.AUDIT_SIZE, jax.numpy.bfloat16, batch=jaud.AUDIT_BATCH))


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("fmt", ["int8", "fp8", "int8-block:32", "fp8-block:32"])
def test_wire_inventories_are_jax_traced(ranks8, devices, fmt, world):
    jcases = {c[0]: c for c in jaud._comm_quant_cases(world, devices) if c[1] == "xla"}
    pcases = {c[0]: c for c in aud._comm_quant_cases(world, _cpu8()) if c[1] == "cuda"}
    assert set(jcases) == set(pcases)
    for mode in sorted(jcases):
        _m, _i, kw, jbuild = jcases[mode]
        js = jbuild(dataclasses.replace(jaud._audit_config("bfloat16"), comm_quant=fmt))
        want = collections.Counter(
            (u.kind, u.payload_bytes, u.operand_dtypes)
            for u in jt.collective_inventory(jax.make_jaxpr(js.full)(*js.operands)))
        _m, _i, pkw, mesh, pbuild = pcases[mode]
        assert pkw == kw
        ps = pbuild(dataclasses.replace(aud._audit_config("bfloat16", "cuda"), comm_quant=fmt))
        steps = cm.mode_steps(mode, world, kw.get("rows"))
        uses = aud.per_collective(aud.run_recorded(ps.full, *ps.operands), mesh, steps)
        got = collections.Counter((k, n, (d,)) for k, _a, n, d in uses)
        assert got == want, mode
        model = collections.Counter((e.kind, e.payload_bytes) for e in cm.wire_collectives(
            mode, world, aud.AUDIT_SIZE, torch.bfloat16, fmt, batch=aud.AUDIT_BATCH, **kw))
        assert collections.Counter((k, n) for k, n, _ in got.elements()) == model, mode


@pytest.mark.parametrize("quant", [None, aud.HIER_QUANT])
@pytest.mark.parametrize("spec", aud.HIER_FACTORIZATIONS)
def test_axis_inventories_are_jax_traced(ranks8, devices, spec, quant):
    jcfg = dataclasses.replace(jaud._audit_config("bfloat16"), comm_quant=quant)
    pcfg = dataclasses.replace(aud._audit_config("bfloat16", "cuda"), comm_quant=quant)
    jcases = dict(jaud._hier_cases(spec, devices[:8]))
    for mode, mesh, build in aud._hier_cases(spec, _cpu8()):
        js = jcases[mode](jcfg)
        want = sorted(jaud._observed_axis_inventory(jax.make_jaxpr(js.full)(*js.operands)))
        ps = build(pcfg)
        uses = aud.per_collective(aud.run_recorded(ps.full, *ps.operands), mesh,
                                  cm.hier_mode_steps(mode, spec))
        got = sorted((k, a, n) for k, a, n, _ in uses)
        assert got == want, mode
        assert got == sorted(cm.hier_expected_collectives(
            mode, spec, aud.AUDIT_SIZE, torch.bfloat16, quant, batch=aud.AUDIT_BATCH))
        assert want == sorted(jax_hier_expected(
            mode, spec, jaud.AUDIT_SIZE, jax.numpy.bfloat16, quant, batch=jaud.AUDIT_BATCH))


# ------------------------------------------------------------- the reach

def _program_cases():
    """(name, build() -> (program, operands), the kinds its log must hold)
    for every program family that makes collectives."""
    from tpu_matmul_bench_torch.ops.matmul import random_operands
    from tpu_matmul_bench_torch.parallel.hybrid import hybrid_mode
    from tpu_matmul_bench_torch.parallel.summa import summa_mode
    from tpu_matmul_bench_torch.serve import pod
    from tpu_matmul_bench_torch.train.step import make_train_setup

    def mode(name):
        def build():
            mesh = pmesh.make_mesh(_cpu8()[:4])
            s = aud._all_modes()[name](aud._audit_config("bfloat16", "cuda"), mesh, 64)
            return s.full, s.operands
        return build

    def two_d(fn):
        def build():
            mesh = pmesh.make_factorized_mesh(_cpu8(), "dcn:2,ici:4")
            s = fn(aud._audit_config("bfloat16", "cuda"), mesh, 64)
            return s.full, s.operands
        return build

    def train():
        mesh = pmesh.make_factorized_mesh(_cpu8(), "dcn:2,ici:4")
        s = make_train_setup(mesh, "hybrid", 64, torch.bfloat16, batch=4, zero=True)
        return s.step, s.operands

    def pod_group():
        _g, mesh = pod.group_meshes(_cpu8(), "dcn:2,ici:4", 2)[0]
        a, b = random_operands(0, (64, 64), torch.bfloat16, device="cpu")
        spec_a, spec_b = pod.pod_operand_specs(mesh)
        ops = pmesh.shard_tensor(a, spec_a, mesh), pmesh.shard_tensor(b, spec_b, mesh)
        return pod.pod_group_program(mesh, "cuda", None, "cpu", None), ops

    return [
        ("batch_parallel", mode("batch_parallel"), {"all_reduce"}),
        ("matrix_parallel", mode("matrix_parallel"), {"all_gather"}),
        ("data_parallel", mode("data_parallel"), {"all_reduce"}),
        ("model_parallel", mode("model_parallel"), {"all_reduce"}),
        ("hybrid", two_d(hybrid_mode), {"all_gather", "all_reduce"}),
        ("summa", two_d(summa_mode), {"all_reduce"}),
        ("train", train, {"reduce_scatter", "all_gather"}),
        ("pod", pod_group, {"all_gather"}),
    ]


@pytest.mark.parametrize("case", _program_cases(), ids=lambda c: c[0])
def test_a_collective_called_from_each_program_is_recorded(ranks8, case):
    _name, build, kinds = case
    program, operands = build()
    with rec.record_collectives() as log:
        program(*operands)
    assert {kind for kind, _axis, _nbytes in log} >= kinds
    assert all(nbytes > 0 for _k, _a, nbytes in log)


def test_a_door_bound_before_the_recording_shows_as_coll_001(ranks8):
    # a program that kept the door it found at build time escapes the
    # recorder; the audit then reports the missing collective, not silence
    mesh = pmesh.make_mesh(_cpu8()[:4])
    s = aud._all_modes()["model_parallel"](aud._audit_config("bfloat16", "cuda"), mesh, 64)
    bound = collectives.psum_over(mesh)
    x, w = s.operands

    def early_bound(a, b):
        return bound([torch.ones(64, 64, dtype=torch.bfloat16) for _ in range(4)])

    got = aud.run_recorded(early_bound, x, w)
    assert got.log == []
    found = aud._inventory_findings(aud.per_collective(got, mesh), "model_parallel", 4,
                                    64, torch.bfloat16, "seed:early-bound")
    assert [f.rule for f in found] == ["COLL-001"]
    assert collectives.psum_over.__name__ == "psum_over"  # restored


# ------------------------------------------------------------ its parts

def test_casts_round_trips_and_wire_casts():
    x = torch.ones(8, 8)
    with rec.record() as r:
        y = x.to(torch.bfloat16)       # downcast, a conversion
        y.float()                       # ... widened again: a round trip
        x.to(torch.int8)                # wire cast
        x.to(torch.float8_e4m3fn)       # wire cast
        x.half() + 1                    # downcast, no round trip
    assert r.downcasts == [("float32", "bfloat16"), ("float32", "float16")]
    assert r.roundtrips == [("bfloat16", "float32")]
    assert r.wire_casts == [("float32", "int8"), ("float32", "float8_e4m3fn")]
    assert r.host_syncs == []


def test_host_round_trips_are_recorded():
    x = torch.arange(4.0)
    with rec.record() as r:
        x[0].item()
        x.tolist()
        bool(x[1])
        torch.cuda.synchronize  # a reference is no call
    assert r.host_syncs == ["item", "tolist", "__bool__"]


def test_opaque_primitives_hide_their_own_casts(ranks8):
    from tpu_matmul_bench_torch.ops import cuda_matmul as k

    a = torch.ones(16, 16, dtype=torch.bfloat16)
    with rec.record() as plain:
        k.cuda_matmul(a, a)
    with rec.record(opaque=True) as opaque:
        k.cuda_matmul(a, a)
    assert plain.downcasts == [("float32", "bfloat16")]
    assert opaque.downcasts == [] and k.matmul_plain.__name__ == "matmul_plain"


def test_live_bytes_walk_counts_creation_and_frees():
    x = torch.ones(1024)  # exists before: not counted
    with rec.record_live_bytes() as walk:
        a = x + 1          # 4096 B
        b = a * 2          # 8192 live
        view = b.view(32, 32)  # a view: no new storage
        del a              # 4096 live
        c = torch.zeros(2048)  # 4096 + 8192 = 12288 live
        del b, view, c
    assert walk.peak["cpu"] == 12288
    assert walk.live["cpu"] == 0
    assert walk.peak_bytes() == 12288


def test_storage_identity():
    t = torch.zeros(4)
    before = rec.storage_state(t)
    assert not rec.written_in_place(before, t)
    t.add_(1)
    assert rec.written_in_place(before, t)
    u = t.clone()
    assert not rec.written_in_place(rec.storage_state(t), u)
