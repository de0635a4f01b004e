"""Cost-model pruning of the kernel's tile candidates.

Port of `tpu_matmul_bench/tune/prune.py`, with a Hopper cost model in
place of the TPU's VMEM. Measuring every tile costs a timed window a
candidate a shape on the card; much of that is decidable without it. This
module spends no device time ranking the candidates with the repo's
models and keeps the top K:

- **feasibility**: the tile `effective_blocks` resolves a request to must
  be instantiated on the route `gemm_route` picks for the dtype (the
  tensor-core TILES on wgmma and wmma, SIMT_TILE on simt), and its shared
  memory (`smem_bytes`: `wgmma_plan` on wgmma, the wmma and SIMT kernels'
  own layouts) must fit one block on an SM (`SMEM_PER_BLOCK`); requests
  that resolve alike are scored once;
- **roofline ranking**: arithmetic intensity, 2·m·k·n over the bytes the
  launch's tiles load and store (`obs/attribution.kernel_cost`): A is read
  once a column of tiles, B once a row of tiles, so bigger output tiles
  read less;
- **wire costs**: for a ring's step problem, `analysis/comms_model`'s
  RING_WIRE_FACTOR prices the collective's bytes, reported beside the
  tiles.

Ties in intensity break toward a deeper K (fewer passes over the
accumulator), then a smaller shared-memory footprint. At bf16 16384³ the
kept set holds DEFAULT_TILE, the measured winner (tests pin this).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

DEFAULT_TOP_K = 4


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One tile's static scorecard for a specific problem."""

    requested: tuple[int, int, int]
    blocks: tuple[int, int, int]    # after effective_blocks
    feasible: bool
    reason: str                      # why infeasible ("" when feasible)
    smem_bytes: int
    hbm_bytes: int
    intensity: float                 # matmul flops per modeled byte


@dataclasses.dataclass
class PruneReport:
    """The prune decision for one problem, with its audit trail."""

    m: int
    k: int
    n: int
    dtype: str
    route: str
    candidates: list[Candidate]      # deduped, ranked (feasible first)
    kept: list[tuple[int, int, int]]
    dropped_infeasible: list[Candidate]
    dropped_ranked: list[Candidate]
    trials_before: int               # requested candidates (pre-dedupe)
    trials_after: int                # = len(kept): what gets measured
    wire: dict[str, Any] | None = None  # ring context (see ring_wire)

    @property
    def reduction_pct(self) -> float:
        if not self.trials_before:
            return 0.0
        return round(100.0 * (self.trials_before - self.trials_after)
                     / self.trials_before, 1)

    def log_lines(self) -> list[str]:
        """N candidates → K measured trials, and why each drop happened."""
        label = f"{self.m}x{self.k}x{self.n}/{self.dtype}"
        lines = [f"[{label}] prune ({self.route}): {self.trials_before} "
                 f"candidates → {self.trials_after} measured trials "
                 f"(-{self.reduction_pct}%)"]
        dup = self.trials_before - len(self.candidates)
        if dup:
            lines.append(f"  {dup} resolve to an already-scored tile "
                         "(effective_blocks dedupe)")
        for c in self.dropped_infeasible:
            lines.append(f"  drop {c.requested}: {c.reason}")
        for c in self.dropped_ranked:
            lines.append(
                f"  drop {c.requested}: ranked below top-{len(self.kept)} "
                f"(intensity {c.intensity:.1f} flops/B)")
        if self.wire:
            w = self.wire
            lines.append(
                f"  ring {w['ring']}@d{w['world']}: chunk "
                f"{w['chunk_m']}x{w['chunk_k']}x{w['chunk_n']}, "
                f"{w['collective']} wire ≈ {w['wire_bytes'] / 2**20:.1f} "
                "MiB/step (comms_model floor under the compute tiles)")
        return lines


def default_candidates(dtype: Any) -> list[tuple[int, int, int]]:
    """Every instantiated tile, and SIMT_TILE for float32."""
    from tpu_matmul_bench_torch.ops.cuda_matmul import SIMT_TILE, TILES
    from tpu_matmul_bench_torch.utils.metrics import dtype_name

    return list(TILES) + ([SIMT_TILE] if dtype_name(dtype) == "float32" else [])


def smem_bytes(route: str, tile: tuple[int, int, int], dtype: Any) -> int:
    """Dynamic plus static shared memory of one block of `route` at
    `tile`: `wgmma_plan`'s on wgmma; on wmma csrc/matmul.cu's `Tile`
    (two padded stages, or the fp32/int32 epilogue's staging if larger);
    on simt the two padded 16x64 fp32 tiles."""
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.utils.metrics import bytes_per_element

    bm, bn, bk = tile
    if route == "wgmma":
        return cm.wgmma_plan(tile)["smem_bytes"]
    if route == "wmma":
        item = bytes_per_element(dtype)
        pitch = 16 + 16 // item
        stage = (bk // 16) * bm * pitch + (bn // 16) * bk * pitch
        return max(2 * stage * item, 8 * 256 * 4)
    return 2 * 16 * (64 + 4) * 4


def _instantiated(route: str, tile: tuple[int, int, int]) -> bool:
    from tpu_matmul_bench_torch.ops.cuda_matmul import SIMT_TILE, TILES

    return tile == SIMT_TILE if route == "simt" else tile in TILES


def score_candidate(m: int, k: int, n: int, dtype: Any,
                    requested: tuple[int, int, int]) -> Candidate:
    """Static scorecard for one requested tile on one problem."""
    from tpu_matmul_bench_torch.obs.attribution import kernel_cost
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm

    route = problem_route(m, k, n, dtype)
    eff = cm.effective_blocks(m, n, k, *requested, dtype)
    smem = smem_bytes(route, eff, dtype)
    traffic = int(kernel_cost(route, m, n, k, eff, 1, dtype)["bytes_accessed"])
    intensity = 2.0 * m * k * n / traffic
    feasible, reason = True, ""
    if not _instantiated(route, eff):
        feasible, reason = False, f"tile {eff} is not instantiated on the {route} route"
    elif smem > cm.SMEM_PER_BLOCK:
        feasible = False
        reason = (f"shared memory {smem} B exceeds the {cm.SMEM_PER_BLOCK} B "
                  "a block may use (one block a SM would not fit)")
    return Candidate(requested=tuple(requested), blocks=eff,
                     feasible=feasible, reason=reason, smem_bytes=smem,
                     hbm_bytes=traffic, intensity=intensity)


def problem_route(m: int, k: int, n: int, dtype: Any) -> str:
    """The route `gemm_route` picks for contiguous, aligned operands."""
    from tpu_matmul_bench_torch.ops.cuda_matmul import gemm_route

    return gemm_route(dtype, m, n, k, k, n, 0, 0)


def rank_candidates(m: int, k: int, n: int, dtype: Any,
                    candidates: Iterable[tuple[int, int, int]],
                    ) -> tuple[list[Candidate], int]:
    """(deduped ranked candidates, requested count). Feasible candidates
    sort by descending intensity, then deeper K, then smaller shared
    memory; infeasible ones sink to the tail."""
    requested = [tuple(c) for c in candidates]
    seen: set[tuple[int, int, int]] = set()
    scored: list[Candidate] = []
    for want in requested:
        c = score_candidate(m, k, n, dtype, want)
        if c.blocks in seen:
            continue  # resolves to an already-scored tile
        seen.add(c.blocks)
        scored.append(c)
    scored.sort(key=lambda c: (not c.feasible, -c.intensity,
                               -c.blocks[2], c.smem_bytes, c.blocks))
    return scored, len(requested)


def ring_wire(ring: str, world: int, size: int, dtype: Any) -> dict[str, Any]:
    """The step problem and wire bytes of a `--ring` sweep at `size`
    (`cuda_tune._ring_effective_blocks`'s chunk geometry: all-gather rings
    multiply [rows, k]×[k, n/d] chunks, reduce-scatter rings
    [rows, k/d]×[k/d, n]; the bidirectional forms halve the rows), the
    collective's payload priced by comms_model's RING_WIRE_FACTOR."""
    from tpu_matmul_bench_torch.analysis.comms_model import (
        RING_WIRE_FACTOR,
        matmul_out_itemsize,
    )
    from tpu_matmul_bench_torch.utils.metrics import bytes_per_element

    kind = "rs" if "rs" in ring else "ag"
    rows = size // world
    if "bidir" in ring:
        rows //= 2
    if kind == "ag":
        chunk_m, chunk_k, chunk_n = rows, size, size // world
        collective = "all_gather"
        payload = (size // world) * size * bytes_per_element(dtype)
    else:
        chunk_m, chunk_k, chunk_n = rows, size // world, size
        collective = "reduce_scatter"
        payload = size * size * matmul_out_itemsize(dtype)
    return {
        "ring": ring, "world": world, "collective": collective,
        "chunk_m": chunk_m, "chunk_k": chunk_k, "chunk_n": chunk_n,
        "wire_bytes": int(RING_WIRE_FACTOR[collective](world) * payload),
    }


def prune(m: int, k: int, n: int, dtype: Any,
          candidates: Iterable[tuple[int, int, int]] | None = None,
          *, top_k: int = DEFAULT_TOP_K,
          ring: str | None = None, world: int = 1) -> PruneReport:
    """Rank the candidates for C[m,n] = A[m,k]·B[k,n] and keep the top-K
    feasible tiles (the set a sweep would measure). With `ring`, the
    ranked problem is the step chunk the ring multiplies, and the report
    carries the collective's wire bytes."""
    from tpu_matmul_bench_torch.utils.metrics import dtype_name

    if candidates is None:
        candidates = default_candidates(dtype)
    wire = None
    pm, pk, pn = m, k, n
    if ring is not None:
        wire = ring_wire(ring, world, max(m, k, n), dtype)
        pm, pk, pn = wire["chunk_m"], wire["chunk_k"], wire["chunk_n"]
    ranked, requested = rank_candidates(pm, pk, pn, dtype, candidates)
    feasible = [c for c in ranked if c.feasible]
    kept = feasible[:top_k]
    return PruneReport(
        m=pm, k=pk, n=pn, dtype=dtype_name(dtype),
        route=problem_route(pm, pk, pn, dtype),
        candidates=ranked,
        kept=[c.blocks for c in kept],
        dropped_infeasible=[c for c in ranked if not c.feasible],
        dropped_ranked=feasible[top_k:],
        trials_before=requested,
        trials_after=len(kept),
        wire=wire,
    )
