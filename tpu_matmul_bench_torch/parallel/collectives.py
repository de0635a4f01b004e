"""Collectives over the world of ranks (`parallel/mesh.py`).

Port of the exact path of `tpu_matmul_bench/parallel/collectives.py:541-663`
and of the `jax.lax` collectives the overlap baselines call. The ranks live
in one process, so each collective is plain tensor copies and sums between
the ranks' tensors, in the role XLA's collectives play in the JAX package.
Every function takes and returns per-rank tensors in rank order; results
lie on each rank's device. Ranks that are processes on several cards (NCCL
process groups) are later work.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from tpu_matmul_bench_torch.parallel.mesh import Mesh, ring_perm
from tpu_matmul_bench_torch.utils.metrics import matmul_acc_dtype
from tpu_matmul_bench_torch.utils.reporting import report

Shards = Sequence[torch.Tensor]


def _check(mesh: Mesh, shards: Shards) -> None:
    if len(shards) != len(mesh.ranks):
        raise ValueError(f"{len(shards)} shards for {len(mesh.ranks)} ranks")


def _sum_on(shards: Shards, device: torch.device,
            parts: Callable[[torch.Tensor], torch.Tensor] = lambda s: s) -> torch.Tensor:
    """Σ parts(shard) in rank order, in the accumulator dtype (fp32, int32
    for integers), rounded once to the shards' dtype, on `device`. Each
    part is added into the accumulator in place; widening a part is exact,
    so this is the sum of the widened parts."""
    acc_dtype = matmul_acc_dtype(shards[0].dtype)
    acc = None
    for s in shards:
        part = parts(s).to(device)
        if acc is None:
            acc = part.to(acc_dtype, copy=True)
        else:
            acc.add_(part)
    return acc.to(shards[0].dtype)


def _per_card(mesh: Mesh, total: Callable[[torch.device], torch.Tensor]
              ) -> list[torch.Tensor]:
    """`total(card)` once for each device the ranks occupy; the first rank
    on a device takes it, each other rank there its own copy."""
    out, seen = [], {}
    for device in mesh.devices:
        if device in seen:
            out.append(seen[device].clone())
        else:
            seen[device] = total(device)
            out.append(seen[device])
    return out


def psum_over(mesh: Mesh) -> Callable[[Shards], list[torch.Tensor]]:
    """all_reduce(SUM): every rank ends with the sum of all shards
    (≙ `jax.lax.psum`, reference `dist.all_reduce(..., SUM)`). The sum is
    made once for each device the ranks occupy; the other ranks on that
    device get copies of it."""
    def fn(shards: Shards) -> list[torch.Tensor]:
        _check(mesh, shards)
        return _per_card(mesh, lambda d: _sum_on(shards, d))
    return fn


def pmean_over(mesh: Mesh) -> Callable[[Shards], list[torch.Tensor]]:
    """all_reduce(AVG) of float shards (≙ `jax.lax.pmean`), made once for
    each device as `psum_over` is."""
    def fn(shards: Shards) -> list[torch.Tensor]:
        _check(mesh, shards)
        n = len(shards)
        return _per_card(mesh, lambda d: (_sum_on(shards, d).float() / n)
                         .to(shards[0].dtype))
    return fn


def all_gather_over(mesh: Mesh, *, gather_axis: int = 0
                    ) -> Callable[[Shards], list[torch.Tensor]]:
    """all_gather: every rank ends with the concatenation of all shards
    along `gather_axis` (≙ `jax.lax.all_gather(..., tiled=True)`)."""
    def fn(shards: Shards) -> list[torch.Tensor]:
        _check(mesh, shards)
        return [torch.cat([s.to(d) for s in shards], dim=gather_axis)
                for d in mesh.devices]
    return fn


def psum_scatter_over(mesh: Mesh, *, scatter_dimension: int = 0
                      ) -> Callable[[Shards], list[torch.Tensor]]:
    """reduce_scatter: rank r ends with block r (along `scatter_dimension`)
    of the sum of all shards, summed in the accumulator dtype in rank order
    and rounded once (≙ `jax.lax.psum_scatter(..., tiled=True)`)."""
    def fn(shards: Shards) -> list[torch.Tensor]:
        _check(mesh, shards)
        d = len(shards)
        size = shards[0].shape[scatter_dimension]
        if size % d:
            raise ValueError(f"dimension {scatter_dimension} ({size}) does not "
                             f"split into {d} blocks")
        block = size // d
        return [_sum_on(shards, rank.device,
                        lambda s, r=rank.index: s.narrow(scatter_dimension,
                                                         r * block, block))
                for rank in mesh.ranks]
    return fn


def ppermute(mesh: Mesh, shards: Shards,
             perm: Sequence[tuple[int, int]]) -> list[torch.Tensor | None]:
    """Rank dst receives the shard of rank src for each (src, dst) in
    `perm` (≙ `jax.lax.ppermute`); a rank that receives nothing gets None."""
    _check(mesh, shards)
    out: list[torch.Tensor | None] = [None] * len(shards)
    for src, dst in perm:
        out[dst] = shards[src].to(mesh.devices[dst], copy=True)
    return out


def verify_collectives(mesh: Mesh, *, verbose: bool = True) -> bool:
    """Startup check of the collectives the suite depends on, ≙ the JAX
    package's `verify_collectives` (reference `matmul_scaling_benchmark.py:
    26-57`): psum, pmean, all_gather and the ring shift, each PASSED or
    FAILED. Returns True when every check passes."""
    n = len(mesh.ranks)

    def check(name: str, got: Sequence[torch.Tensor],
              expect: Callable[[int], object]) -> bool:
        good, detail = True, ""
        for r, g in enumerate(got):
            arr = g.detach().cpu().numpy()
            want = np.broadcast_to(np.asarray(expect(r), arr.dtype), arr.shape)
            if not np.allclose(arr, want, rtol=1e-3, atol=1e-3):
                good, detail = False, f"rank {r}: got {arr!r}, want {want!r}"
        if verbose:
            report(f"  - {name}: {'PASSED' if good else 'FAILED'}")
            if not good:
                report(f"      {detail}")
        return good

    plus_one = [torch.full((1,), r.index + 1.0, device=r.device) for r in mesh.ranks]
    ok = check("psum (all_reduce SUM)", psum_over(mesh)(plus_one),
               lambda r: n * (n + 1) / 2.0)
    ok &= check("pmean (all_reduce AVG)", pmean_over(mesh)(plus_one),
                lambda r: (n + 1) / 2.0)
    twice = [torch.full((1,), 2.0 * r.index, device=r.device) for r in mesh.ranks]
    ok &= check("all_gather", all_gather_over(mesh)(twice),
                lambda r: 2.0 * np.arange(n, dtype=np.float32))
    index = [torch.full((1,), float(r.index), device=r.device) for r in mesh.ranks]
    ok &= check("ppermute (ring shift)", ppermute(mesh, index, ring_perm(n)),
                lambda r: (r - 1) % n)
    return bool(ok)
