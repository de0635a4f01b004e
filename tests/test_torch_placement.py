"""The port's replica-group placement (`tpu_matmul_bench_torch/serve/
placement.py`) against the JAX package's `serve/placement.py`.

Over a table of mesh specs and group counts, good and bad, both give the
same groups (index, parent and group spec, rank indices, placement label)
or raise the same ValueError text; `partition_problems` names the same
problems for seeded bad partitions; `mesh_world` agrees; and
`group_meshes` puts each group on the same ranks (JAX's device ids, the
port's rank indices) with the same axis names and shape.
"""

import pytest
import torch

from tpu_matmul_bench.serve import placement as jplacement
from tpu_matmul_bench_torch.parallel import mesh
from tpu_matmul_bench_torch.serve import placement

SPECS = ["dcn:2,ici:4", "dcn:4,ici:2", "ici:8", "dcn:8", " dcn:2 , ici:4 ", "dcn:1,ici:8",
         "dcn:8,ici:1", "dcn:2", "ici:4,dcn:2", "dcn:2,dcn:2", "pcie:8", "dcn:0",
         "dcn:x", "dcn", "", "dcn:2,,ici:4", "dcn:2,ici:2,ici:2"]
GROUPS = [1, 2, 3, 4, 8, 0, -1]


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "ValueError", str(e)


def _groups(parts):
    return [(g.index, g.parent_spec, g.mesh_spec, g.device_indices, g.placement, g.world)
            for g in parts]


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("spec", SPECS)
def test_partition_spec_is_jaxs(spec, groups):
    got = _outcome(lambda: _groups(placement.partition_spec(spec, groups)))
    want = _outcome(lambda: _groups(jplacement.partition_spec(spec, groups)))
    assert got == want
    if got[0] == "ok":
        parts = placement.partition_spec(spec, groups)
        world = placement.mesh_world(spec)
        assert placement.partition_problems(parts, world) == [] == \
            jplacement.partition_problems(jplacement.partition_spec(spec, groups), world)


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_world_is_jaxs(spec):
    assert _outcome(placement.mesh_world, spec) == _outcome(jplacement.mesh_world, spec)


def test_placement_labels_are_parent_unique():
    wide = placement.partition_spec("dcn:2,ici:4", 2)
    tall = placement.partition_spec("dcn:4,ici:2", 2)
    assert [g.mesh_spec for g in wide] == ["ici:4", "ici:4"]
    assert [g.mesh_spec for g in tall] == ["dcn:2,ici:2", "dcn:2,ici:2"]
    labels = {g.placement for g in wide} | {g.placement for g in tall}
    assert len(labels) == 4
    assert wide[0].placement == "dcn:2,ici:4/g0=ici:4"


def _bad_partitions(cls):
    def grp(i, devs):
        return cls(index=i, parent_spec="dcn:2,ici:4", mesh_spec="ici:4",
                   device_indices=devs)

    return {"overlap": [grp(0, (0, 1, 2, 3)), grp(1, (3, 4, 5, 6, 7))],
            "gap": [grp(0, (0, 1, 2)), grp(1, (4, 5, 6, 7))],
            "outside": [grp(0, (0, 1, 2, 3)), grp(1, (4, 5, 6, 8))],
            "empty": [grp(0, tuple(range(8))), grp(1, ())]}


@pytest.mark.parametrize("case, words", [("overlap", "not disjoint"),
                                         ("gap", "no replica group"),
                                         ("outside", "outside"),
                                         ("empty", "owns no devices")])
def test_bad_partitions_trip_pod001_as_jax(case, words):
    got = placement.partition_problems(_bad_partitions(placement.ReplicaGroup)[case], 8)
    want = jplacement.partition_problems(_bad_partitions(jplacement.ReplicaGroup)[case], 8)
    assert got == want
    assert any(words in p for p in got)


@pytest.mark.parametrize("spec, groups", [("dcn:2,ici:4", 2), ("dcn:4,ici:2", 2),
                                          ("dcn:2,ici:4", 1), ("ici:8", 4), ("dcn:8", 2)])
def test_group_meshes_place_ranks_as_jax(devices, monkeypatch, spec, groups):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")
    ranks = [torch.device("cpu")] * 8
    port = placement.group_meshes(ranks, spec, groups)
    ref = jplacement.group_meshes(devices, spec, groups)
    assert len(port) == len(ref) == groups
    for (pg, pm), (jg, jm) in zip(port, ref):
        assert _groups([pg]) == _groups([jg])
        assert pm.axis_names == tuple(jm.axis_names)
        assert pm.dims == tuple(jm.devices.shape)
        # the group's ranks, row-major, are the JAX devices' positions
        ids = [d.id for d in jm.devices.flat]
        assert [pg.device_indices[r.index] for r in pm.ranks] == ids


def test_group_meshes_refuse_a_short_world():
    with pytest.raises(ValueError, match="spans 8 devices, only 4 available"):
        placement.group_meshes([torch.device("cpu")] * 4, "dcn:2,ici:4", 2)
