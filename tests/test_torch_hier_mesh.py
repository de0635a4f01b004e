"""The port's factorized meshes (`tpu_matmul_bench_torch/parallel/mesh.py`)
against the JAX package's.

- `parse_mesh_spec` and `canonical_mesh_spec` on good and bad specs: the
  same results and the same messages; `mesh_spec_of`.
- Rank placement and the collectives over one axis, for `dcn:2,ici:4` and
  `dcn:4,ici:2` (and the hybrid and SUMMA meshes): each rank's coordinates,
  and an all_gather and a psum over each axis of the ranks' indices, held
  to JAX's `shard_map` on the conftest's 8-device CPU mesh.
- Every named spec (P('dp') on a 3-D stack, P(None, 'tp'), P('i', 'j'),
  P(('dp', 'tp')), and the flat ones) through `shard_from_numpy`: each
  rank's shard is the JAX device's shard of the same numpy array under
  `NamedSharding`; `gather`, `global_block` and `stacked_item` put it back.
- The per-axis inventory: the port's collective doors wrapped, hybrid's and
  SUMMA's full programs run once on both factorizations, and the calls
  (kind, axis, per-rank shape) held to `mode_axis_collectives` ×
  `hier_mode_steps` × the axis's groups (JAX's COLL-H audit, from a log).
"""

import collections

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch_port_util import single_torch_thread  # noqa: F401

from tpu_matmul_bench.parallel import mesh as jmesh
from tpu_matmul_bench_torch.analysis import comms_model as cm
from tpu_matmul_bench_torch.parallel import collectives, hybrid, mesh, summa
from tpu_matmul_bench_torch.parallel.mesh import (
    gather,
    global_block,
    shard_from_numpy,
    stacked_item,
)
from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args
from tpu_matmul_bench_torch.utils.device import resolve_devices

pytestmark = pytest.mark.usefixtures("single_torch_thread")

FACTORIZATIONS = ["dcn:2,ici:4", "dcn:4,ici:2"]
GOOD = ["dcn:2,ici:4", "dcn:4,ici:2", " dcn:2 , ici:4 ", "ici:8", "dcn:8", "dcn:1,ici:8"]
BAD = ["", "  ", "ici:4,dcn:2", "dcn:2,dcn:4", "dcn:0", "dcn:-1", "dcn:x", "dcn",
       "tor:2", "dcn:2,ici:2,ici:2", "dcn=2", "dcn:2,,ici:4"]


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "ValueError", str(e)


@pytest.mark.parametrize("spec", GOOD + BAD)
def test_spec_grammar_matches_jax(spec):
    assert _outcome(mesh.parse_mesh_spec, spec) == _outcome(jmesh.parse_mesh_spec, spec)
    assert _outcome(mesh.canonical_mesh_spec, spec) == \
        _outcome(jmesh.canonical_mesh_spec, spec)


def _meshes(spec: str, devices, ranks):
    """(JAX mesh, port mesh) of the same name: a factorized spec, or the
    hybrid ('dp', 'tp') and SUMMA ('i', 'j') meshes of a given outer size."""
    from tpu_matmul_bench.parallel.hybrid import make_hybrid_mesh as jhybrid
    from tpu_matmul_bench.parallel.summa import make_summa_mesh as jsumma

    kind, _, arg = spec.partition("=")
    if kind == "hybrid":
        return jhybrid(devices, int(arg)), hybrid.make_hybrid_mesh(ranks, int(arg))
    if kind == "summa":
        return jsumma(devices, int(arg)), summa.make_summa_mesh(ranks, int(arg))
    return (jmesh.make_factorized_mesh(devices, spec),
            mesh.make_factorized_mesh(ranks, spec))


MESHES = FACTORIZATIONS + ["ici:8", "hybrid=2", "hybrid=8", "summa=2", "summa=4"]


@pytest.mark.parametrize("spec", MESHES)
def test_placement_and_axis_collectives_match_jax(devices, ranks8, spec):
    jm, pm = _meshes(spec, devices, resolve_devices("cpu", 8))
    assert pm.axis_names == tuple(jm.axis_names)
    assert pm.shape == dict(jm.shape) and pm.size == jm.size == 8
    assert mesh.mesh_spec_of(pm) == jmesh.mesh_spec_of(jm)
    assert mesh.mesh_link_classes(pm) == jmesh.mesh_link_classes(jm)
    flat = tuple(jm.axis_names)
    ids = np.arange(8, dtype=np.float32)
    for axis in jm.axis_names:
        def body(x, axis=axis):
            return (jax.lax.all_gather(x, axis, tiled=True)[None],
                    jax.lax.psum(x, axis))

        gathered, summed = jmesh.smap(body, jm, in_specs=(P(flat),),
                                      out_specs=(P(flat), P(flat)), check_vma=False)(
            jax.device_put(ids, NamedSharding(jm, P(flat))))
        shards = [torch.tensor([float(r)]) for r in range(8)]
        port_g = collectives.over_axis(pm, axis, shards,
                                       lambda sub, g: collectives.all_gather_over(sub)(g))
        port_s = collectives.over_axis(pm, axis, shards,
                                       lambda sub, g: collectives.psum_over(sub)(g))
        for r in range(8):
            assert port_g[r].tolist() == np.asarray(gathered)[r].tolist(), (axis, r)
            assert port_s[r].item() == np.asarray(summed)[r], (axis, r)
            sub = pm.sub_mesh(axis, r)
            assert sub.axis == axis and sub.size == pm.shape[axis]
            group = next(g for g in pm.axis_groups(axis) if r in g)
            assert sub.ranks[group.index(r)].index == pm.coords(r)[axis]
    # rank r is the JAX mesh's r-th device, row-major
    assert [pm.coords(r) for r in range(8)] == [
        dict(zip(jm.axis_names, np.unravel_index(r, tuple(jm.shape.values()))))
        for r in range(8)]


def test_mesh_spec_of_flat_and_named_meshes(devices, ranks8):
    ranks = resolve_devices("cpu", 8)
    assert mesh.mesh_spec_of(mesh.make_mesh(ranks)) is \
        jmesh.mesh_spec_of(jmesh.make_mesh(devices)) is None
    assert mesh.mesh_spec_of(mesh.make_factorized_mesh(ranks, " dcn:2 , ici:4")) == \
        "dcn:2,ici:4"
    with pytest.raises(ValueError, match="covers 6 devices but 8 are available"):
        mesh.make_factorized_mesh(ranks, "dcn:2,ici:3")
    with pytest.raises(ValueError, match="no single axis"):
        mesh.make_factorized_mesh(ranks, "dcn:2,ici:4").axis


SPEC_CASES = [  # (mesh, spec, global shape)
    ("hybrid=2", ("dp",), (4, 16, 16)),
    ("hybrid=2", (None, "tp"), (16, 16)),
    ("hybrid=4", (("dp", "tp"),), (64, 8)),
    ("summa=2", ("i", "j"), (16, 32)),
    ("summa=4", ("i", "j"), (16, 32)),
    ("dcn:2,ici:4", ("dcn", "ici"), (16, 32)),
    ("dcn:4,ici:2", (("dcn", "ici"), None), (32, 8)),
    ("dcn:4,ici:2", (None, "dcn"), (8, 16)),
    ("dcn:2,ici:4", (), (8, 8)),
    ("ici:8", ("ici", None), (16, 8)),
]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("case", SPEC_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_named_specs_shard_as_jax(devices, ranks8, case, dtype):
    name, spec, shape = case
    jm, pm = _meshes(name, devices, resolve_devices("cpu", 8))
    arr = (np.random.default_rng(0).standard_normal(shape) * 8).astype(dtype)
    jarr = jax.device_put(arr, NamedSharding(jm, P(*spec)))
    by_device = {s.device: np.asarray(s.data) for s in jarr.addressable_shards}
    port = shard_from_numpy(arr, spec, pm)
    assert len(port) == 8 and port.grid == pm.shape
    for r, dev in enumerate(jm.devices.flat):
        np.testing.assert_array_equal(port[r].numpy(), by_device[dev])
    np.testing.assert_array_equal(gather(port).numpy(), arr)
    if len(shape) == 2:
        for rows, cols in ((3, 5), (shape[0], 2), (shape[0] + 9, shape[1] + 9)):
            np.testing.assert_array_equal(global_block(port, rows, cols).numpy(),
                                          arr[:rows, :cols])
    elif spec == ("dp",):
        for i in range(shape[0]):
            np.testing.assert_array_equal(stacked_item(port, i).numpy(), arr[i])
    # the chain's targets: every copy of the block that holds [0, ..., 0]
    origin = [s.data_ptr() for s in port.origin_shards()]
    want = [port[r].data_ptr() for r, dev in enumerate(jm.devices.flat)
            if all(sl.start in (0, None) for sl in jarr.sharding.devices_indices_map(
                arr.shape)[dev])]
    assert origin == want


def test_sharded_rejects_axes_off_its_mesh():
    with pytest.raises(ValueError, match="does not fit the mesh"):
        mesh.Sharded([torch.ones(2)] * 4, ("dp", None), {"x": 4})
    with pytest.raises(ValueError, match="does not fit the mesh"):
        mesh.Sharded([torch.ones(2)] * 4, ("i", "i"), {"i": 2, "j": 2})


# ------------------------------------------------------- the per-axis inventory

def _logged(monkeypatch):
    """Wrap the exact collective doors: each call logs (kind, axis, shape)."""
    log = []
    psum_over, all_gather_over = collectives.psum_over, collectives.all_gather_over

    def psum(sub):
        def fn(shards):
            log.append(("all_reduce", sub.axis, tuple(shards[0].shape)))
            return psum_over(sub)(shards)
        return fn

    def ag(sub, gather_axis=0):
        def fn(shards):
            log.append(("all_gather", sub.axis, tuple(shards[0].shape)))
            return all_gather_over(sub, gather_axis=gather_axis)(shards)
        return fn

    monkeypatch.setattr(collectives, "psum_over", psum)
    monkeypatch.setattr(collectives, "all_gather_over", ag)
    return log


@pytest.mark.parametrize("batch", [4, 8])
@pytest.mark.parametrize("spec", FACTORIZATIONS)
@pytest.mark.parametrize("mode", ["hybrid", "summa"])
def test_full_programs_make_the_modelled_collectives(ranks8, monkeypatch, mode, spec, batch):
    size = 64
    config = config_from_args(build_parser("t", mesh=True).parse_args(
        ["--sizes", str(size), "--dtype", "float32", "--device", "cpu"]))
    pm = mesh.make_factorized_mesh(resolve_devices("cpu", 8), spec)
    setup = (hybrid.hybrid_mode(config, pm, size, batch=batch) if mode == "hybrid"
             else summa.summa_mode(config, pm, size))
    log = _logged(monkeypatch)
    setup.full(*setup.operands)
    want = collections.Counter()
    steps = cm.hier_mode_steps(mode, spec)
    for kind, axis, _, shape in cm.mode_axis_collectives(mode, spec, size, batch=batch):
        want[(kind, axis, shape)] += steps * len(pm.axis_groups(axis))
    assert collections.Counter(log) == want
    log.clear()
    setup.compute(*setup.operands)
    assert log == []  # the compute leg makes no collective


def test_mode_axis_collectives_is_jax_inventory_shape():
    # the per-rank operand of hybrid's gather is the local batch's columns
    assert cm.mode_axis_collectives("hybrid", "dcn:2,ici:4", 64) == [
        ("all_gather", "ici", 4, (2, 64, 16)), ("all_reduce", "dcn", 2, (64, 64))]
