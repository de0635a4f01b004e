"""Replica-group placement: partitioning a factorized mesh for serving.

Port of `tpu_matmul_bench/serve/placement.py`. Pod-scale serving splits
one ``dcn:R,ici:C`` world of ranks (parallel/mesh.py) into **replica
groups**: the outer (dcn) axis is divided into G data-parallel replicas
for throughput, and each group keeps the full inner (ici) axis for
model-parallel execution of big shapes. Every group owns a contiguous,
disjoint slice of the flat rank order, the same row-major order
``make_factorized_mesh`` lays out, so the G groups cover the world exactly
once (the POD-001 contract).

Each group also carries a **placement label** unique within the parent
mesh (``dcn:2,ici:4/g0=ici:4``). The label rides the executable-cache key
and the artifact-store key, so two groups of identical shape never share
an executable.

Everything but `group_meshes` is stdlib only: the partition math runs
before any device is touched. `group_meshes` is the one door to the
port's meshes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence


@dataclasses.dataclass(frozen=True)
class ReplicaGroup:
    """One serving replica: a contiguous slice of the parent mesh.

    `mesh_spec` is the group's own factorization (what its executables
    run over); `device_indices` its flat positions in the parent rank
    order; `placement` the parent-unique label that keys caches and
    artifacts.
    """

    index: int
    parent_spec: str
    mesh_spec: str
    device_indices: tuple[int, ...]

    @property
    def placement(self) -> str:
        return f"{self.parent_spec}/g{self.index}={self.mesh_spec}"

    @property
    def world(self) -> int:
        return len(self.device_indices)


def _parse_spec_pure(spec: str) -> tuple[tuple[str, int], ...]:
    """The `dcn:R,ici:C` grammar with the JAX package's placement messages
    (parallel/mesh.py `parse_mesh_spec` owns the port's own; this one keeps
    the pod layer's text). Raises ValueError where the grammar does."""
    axes: list[tuple[str, int]] = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            raise ValueError(f"empty axis in mesh spec {spec!r}")
        if ":" not in part:
            raise ValueError(
                f"mesh spec axis {part!r} must be <class>:<size>")
        cls, _, size_s = part.partition(":")
        cls = cls.strip()
        if cls not in ("dcn", "ici"):
            raise ValueError(
                f"unknown link class {cls!r} in mesh spec {spec!r} "
                "(want dcn or ici)")
        try:
            size = int(size_s)
        except ValueError:
            raise ValueError(
                f"mesh spec size {size_s!r} is not an integer") from None
        if size < 1:
            raise ValueError(f"mesh spec size must be positive, got {size}")
        if any(c == cls for c, _ in axes):
            raise ValueError(f"duplicate link class {cls!r} in {spec!r}")
        axes.append((cls, size))
    if not axes or len(axes) > 2:
        raise ValueError(f"mesh spec {spec!r} needs 1 or 2 axes")
    if len(axes) == 2 and [c for c, _ in axes] != ["dcn", "ici"]:
        raise ValueError(
            f"mesh spec {spec!r} must order dcn before ici")
    return tuple(axes)


def mesh_world(spec: str) -> int:
    """Total ranks the spec spans."""
    world = 1
    for _, size in _parse_spec_pure(spec):
        world *= size
    return world


def partition_spec(mesh_spec: str, groups: int) -> tuple[ReplicaGroup, ...]:
    """Split `mesh_spec` into `groups` replica groups along its OUTER axis
    (the dcn axis when both exist). Each group is a contiguous row-major
    slice, group g owning flat ranks ``[g * world/G, (g+1) * world/G)``,
    so the partition composes with `make_factorized_mesh`'s layout without
    any reshuffle.

    The group count must divide the outer axis: a replica group spans
    whole dcn rows (splitting a row would put one ici group across a dcn
    hop, the cross-group traffic POD-003 bans).
    """
    axes = _parse_spec_pure(mesh_spec)
    if groups < 1:
        raise ValueError(f"replica groups must be positive, got {groups}")
    outer_cls, outer = axes[0]
    if outer % groups:
        raise ValueError(
            f"{groups} replica group(s) must divide the outer "
            f"{outer_cls} axis of {mesh_spec!r} (size {outer})")
    outer_left = outer // groups
    inner = axes[1:]  # () for a flat spec
    if outer_left == 1 and inner:
        group_spec = f"{inner[0][0]}:{inner[0][1]}"
    else:
        group_spec = ",".join(
            f"{c}:{s}" for c, s in ((outer_cls, outer_left), *inner))
    per_group = outer_left * (inner[0][1] if inner else 1)
    canonical = ",".join(f"{c}:{s}" for c, s in axes)
    return tuple(
        ReplicaGroup(
            index=g,
            parent_spec=canonical,
            mesh_spec=group_spec,
            device_indices=tuple(
                range(g * per_group, (g + 1) * per_group)),
        )
        for g in range(groups))


def partition_problems(groups: Sequence[ReplicaGroup],
                       world: int) -> list[str]:
    """The POD-001 invariant as checkable problems: the groups' rank index
    sets must cover ``range(world)`` disjointly. Empty = valid."""
    problems: list[str] = []
    seen: dict[int, int] = {}
    for g in groups:
        if not g.device_indices:
            problems.append(f"group {g.index} owns no devices")
        for d in g.device_indices:
            if d in seen:
                problems.append(
                    f"device {d} claimed by both group {seen[d]} and "
                    f"group {g.index} — the partition is not disjoint")
            seen[d] = g.index
        for d in g.device_indices:
            if not 0 <= d < world:
                problems.append(
                    f"group {g.index} claims device {d} outside the "
                    f"{world}-device world")
    missing = sorted(set(range(world)) - set(seen))
    if missing:
        problems.append(
            f"device(s) {missing} belong to no replica group — the "
            "partition does not cover the mesh")
    return problems


def group_meshes(devices: Sequence[Any], mesh_spec: str,
                 groups: int) -> list[tuple[ReplicaGroup, Any]]:
    """Each replica group paired with its own mesh, built by
    `make_factorized_mesh` over the group's slice of the rank devices
    (`devices`: one entry a rank, as `utils/device.py resolve_devices`
    gives them)."""
    from tpu_matmul_bench_torch.parallel.mesh import make_factorized_mesh

    parts = partition_spec(mesh_spec, groups)
    world = sum(g.world for g in parts)
    if len(devices) < world:
        raise ValueError(
            f"mesh spec {mesh_spec!r} spans {world} devices, only "
            f"{len(devices)} available")
    return [
        (g, make_factorized_mesh([devices[i] for i in g.device_indices],
                                 g.mesh_spec))
        for g in parts]
