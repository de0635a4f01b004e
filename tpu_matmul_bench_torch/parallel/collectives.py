"""Collectives over the world of ranks (`parallel/mesh.py`), exact and on
quantized wire formats.

Port of `tpu_matmul_bench/parallel/collectives.py`. Each collective is
plain tensor copies and sums between the ranks' tensors, in the role XLA's
collectives play in the JAX package. Every function takes and returns
per-rank tensors in rank order; results lie on each rank's device. A
collective over one axis of a 2-D mesh runs over each of that axis's
groups, on its 1-D sub-mesh (`over_axis`).

Across processes (`parallel/group.py`) the exact collectives first fetch
the bytes of the other processes' shards of the mesh (`_fetch`: one gloo
all_gather; `ppermute`: sends and receives of the moved shards only), then
run the one-process code, which computes the local ranks' results and
placeholders for the others: the sums keep their fp32 rank-order
accumulation and one rounding, so every result is the one-process world's
bits. The wire formats cross processes the same way, with only what a
hop moves on the wire: each hop of the ring sends its quantized payload
and fp32 scales together, in one exchange (`ppermute_together`), and the
closing gather fetches the payloads and scales in one all_gather
(`_fetch_together`), so a wire psum over D ranks makes D − 1 + 1
crossings a call on each process and a wire reduce-scatter D − 1. A rank
of another process gets no quantize or dequantize here: its payload,
scales and result are placeholders of the shapes the format fixes
(`_quantize_ranks`). Two halves:

1. **Wire formats** (`--comm-quant`, JAX `:71-538`): `WireFormat` and its
   grammar, `wire_psum`, `wire_reduce_scatter` and `wire_all_gather`, the
   `psum_impl`, `allgather_impl` and `reduce_scatter_impl` doors the modes
   take, and the record's `comm_quant` value. A quantized payload travels
   with its fp32 scales on the same hop. `wire_psum` is a ring over the
   ranks even when they share a card: each of its d-1 hops re-quantizes
   the partial sum and moves it with `ppermute`, so its result and its
   error are JAX's, in JAX's order. Ranks that share a card move their
   payloads within its memory, so there the quantize and dequantize passes
   only add time; the byte saving shows only across cards.
   `WIRE_CALLS` counts each call that put a quantized payload on the wire,
   by (format, collective), in place of JAX's obs counter.
2. **The exact collectives** (JAX `:541-663`) and `verify_collectives`:
   `psum_over` sums once for each card and copies the sum to the other
   ranks there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import numpy as np
import torch

from tpu_matmul_bench_torch.parallel import group
from tpu_matmul_bench_torch.parallel.mesh import (
    LINK_CLASSES,
    Mesh,
    axis_link_class,
    ring_perm,
)
from tpu_matmul_bench_torch.utils.metrics import is_integer_dtype, matmul_acc_dtype
from tpu_matmul_bench_torch.utils.reporting import report

Shards = Sequence[torch.Tensor]


def _check(mesh: Mesh, shards: Shards) -> None:
    if len(shards) != len(mesh.ranks):
        raise ValueError(f"{len(shards)} shards for {len(mesh.ranks)} ranks")


def _fetch(mesh: Mesh, shards: Shards) -> list[torch.Tensor]:
    """The shards with every other process's placeholder replaced by its
    bytes (host tensors), where the mesh spans processes; else as given."""
    return _fetch_together(mesh, shards)[0]


def _fetch_together(mesh: Mesh, *lists: Shards) -> list[list[torch.Tensor]]:
    """`_fetch` of several per-rank lists in one all_gather."""
    if not mesh.spans_processes:
        return [list(shards) for shards in lists]
    owners = [r.process for r in mesh.ranks]
    flat = group.all_gather_shards(owners * len(lists), [t for ts in lists for t in ts])
    n = len(owners)
    return [flat[i * n:(i + 1) * n] for i in range(len(lists))]


def _placeholder(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """What another process's rank holds here: shape and dtype, no data."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


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
        shards = _fetch(mesh, shards)
        return _per_card(mesh, lambda d: _sum_on(shards, d))
    return fn


def pmean_over(mesh: Mesh) -> Callable[[Shards], list[torch.Tensor]]:
    """all_reduce(AVG) of float shards (≙ `jax.lax.pmean`), made once for
    each device as `psum_over` is."""
    def fn(shards: Shards) -> list[torch.Tensor]:
        _check(mesh, shards)
        shards = _fetch(mesh, shards)
        n = len(shards)
        return _per_card(mesh, lambda d: (_sum_on(shards, d).float() / n)
                         .to(shards[0].dtype))
    return fn


def all_gather_over(mesh: Mesh, *, gather_axis: int = 0
                    ) -> Callable[[Shards], list[torch.Tensor]]:
    """all_gather: every rank ends with the concatenation of all shards
    along `gather_axis` (≙ `jax.lax.all_gather(..., tiled=True)`); another
    process's rank gets a placeholder of the gathered shape."""
    return lambda shards: _all_gather_lists(mesh, gather_axis, [shards])[0]


def all_gather_together_over(mesh: Mesh, *, gather_axis: int = 0
                             ) -> Callable[..., list[list[torch.Tensor]]]:
    """`all_gather_over` of each per-rank list it is called with, the
    lists fetched from other processes in one all_gather (a wire gather's
    payloads and scales). A door as `all_gather_over` is: one all_gather a
    list."""
    return lambda *lists: _all_gather_lists(mesh, gather_axis, lists)


def _all_gather_lists(mesh: Mesh, gather_axis: int,
                      lists: Sequence[Shards]) -> list[list[torch.Tensor]]:
    for shards in lists:
        _check(mesh, shards)
    outs = []
    for shards in _fetch_together(mesh, *lists):
        shape = list(shards[0].shape)
        shape[gather_axis] *= len(shards)
        outs.append([torch.cat([s.to(r.device) for s in shards], dim=gather_axis)
                     if r.local else _placeholder(shape, shards[0].dtype)
                     for r in mesh.ranks])
    return outs


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
        shards = _fetch(mesh, shards)
        return [_sum_on(shards, rank.device,
                        lambda s, r=rank.index: s.narrow(scatter_dimension,
                                                         r * block, block))
                for rank in mesh.ranks]
    return fn


def ppermute(mesh: Mesh, shards: Shards,
             perm: Sequence[tuple[int, int]]) -> list[torch.Tensor | None]:
    """Rank dst receives the shard of rank src for each (src, dst) in
    `perm` (≙ `jax.lax.ppermute`); a rank that receives nothing gets None."""
    return _ppermute_lists(mesh, [shards], perm)[0]


def ppermute_together(mesh: Mesh, lists: Sequence[Shards],
                      perm: Sequence[tuple[int, int]]
                      ) -> list[list[torch.Tensor | None]]:
    """`ppermute` of each per-rank list in `lists` by one permutation, the
    moves of all of them between processes in one exchange (a wire hop's
    payload and scales). A door as `ppermute` is: one ppermute a list."""
    return _ppermute_lists(mesh, lists, perm)


def _ppermute_lists(mesh: Mesh, lists: Sequence[Shards],
                    perm: Sequence[tuple[int, int]]) -> list[list[torch.Tensor | None]]:
    for shards in lists:
        _check(mesh, shards)
    lists = [list(shards) for shards in lists]
    if mesh.spans_processes:
        # only the moved shards cross, each from its holder to its reader
        procs = [r.process for r in mesh.ranks]
        moves = [(procs[src], procs[dst], shards[src])
                 for shards in lists for src, dst in perm]
        for i, t in group.exchange_pairs(moves).items():
            lists[i // len(perm)][perm[i % len(perm)][0]] = t
    outs = []
    for shards in lists:
        out: list[torch.Tensor | None] = [None] * len(shards)
        for src, dst in perm:
            out[dst] = shards[src].to(mesh.devices[dst], copy=True)
        outs.append(out)
    return outs


def all_to_all_over(mesh: Mesh, *, split_axis: int = 0, concat_axis: int = 0
                    ) -> Callable[[Shards], list[torch.Tensor]]:
    """all_to_all: each rank cuts its shard into D blocks along
    `split_axis` and sends block j to rank j, which concatenates what it
    receives in rank order along `concat_axis` (≙ `jax.lax.all_to_all(...,
    tiled=True)`)."""
    def fn(shards: Shards) -> list[torch.Tensor]:
        _check(mesh, shards)
        d = len(shards)
        size = shards[0].shape[split_axis]
        if size % d:
            raise ValueError(f"dimension {split_axis} ({size}) does not "
                             f"split into {d} blocks")
        block = size // d
        shards = _fetch(mesh, shards)
        return [torch.cat([s.narrow(split_axis, r.index * block, block).to(r.device)
                           for s in shards], dim=concat_axis)
                for r in mesh.ranks]
    return fn


def over_axis(mesh: Mesh, axis: str, shards: Shards,
              collective: Callable[[Mesh, list[torch.Tensor]], list[torch.Tensor]]
              ) -> list[torch.Tensor]:
    """`collective(sub_mesh, group_shards)` over each group of `axis` (the
    ranks that share every other coordinate; JAX's collective over one mesh
    axis), the results put back in rank order. On a 1-D mesh this is one
    call over the whole world."""
    _check(mesh, shards)
    out: list[torch.Tensor | None] = [None] * mesh.size
    for group in mesh.axis_groups(axis):
        sub = mesh.sub_mesh(axis, group[0])
        for r, res in zip(group, collective(sub, [shards[r] for r in group])):
            out[r] = res
    return out


def verify_collectives(mesh: Mesh, *, verbose: bool = True) -> bool:
    """Startup check of the collectives the suite depends on, ≙ the JAX
    package's `verify_collectives` (reference `matmul_scaling_benchmark.py:
    26-57`): psum, pmean, all_gather and the ring shift, each PASSED or
    FAILED. Returns True when every check passes; each process checks its
    own ranks, and the verdict is the AND over the processes (JAX
    `:650-660`)."""
    n = len(mesh.ranks)

    def check(name: str, got: Sequence[torch.Tensor],
              expect: Callable[[int], object]) -> bool:
        good, detail = True, ""
        for r, g in enumerate(got):
            if not mesh.ranks[r].local:
                continue
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


# ---------------------------------------------------------------------------
# Wire formats (`--comm-quant`)
# ---------------------------------------------------------------------------

# dtype names that only ever appear on the wire (quantized payloads)
WIRE_DTYPES = ("int8", "float8_e4m3fn")

_WIRE_QMAX = {"int8": 127.0, "fp8": 448.0}  # fp8 = float8_e4m3fn finfo.max
_TINY = torch.finfo(torch.float32).tiny


def fp32_reciprocal(value: float) -> float:
    """1 / value rounded to fp32. XLA compiles a division by a constant into
    a product with this reciprocal, so JAX's programs compute amax / qmax
    as amax · fp32(1 / qmax); the port does the same to give their bits."""
    return float(np.float32(1.0 / value))

# calls that put a quantized payload on the wire, by (format, collective):
# the port's counter in place of JAX's `comm_quant_programs_total`. The
# legacy tier ("int8" and "int8-tensor") counts under "int8"; inert calls
# (integer operands, one rank) count nowhere
WIRE_CALLS: dict[tuple[str, str], int] = {}


def _tick(spec: str, collective: str) -> None:
    WIRE_CALLS[(spec, collective)] = WIRE_CALLS.get((spec, collective), 0) + 1


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """A parsed --comm-quant value (see `parse_wire_format`)."""

    spec: str          # the normalized flag value, e.g. "int8-block:32"
    qtype: str         # "int8" | "fp8"
    block: int | None  # columns per scale block; None = one scale per row
    legacy: bool = False  # True → parallel/quantized.py control tier

    @property
    def wire_dtype(self) -> torch.dtype:
        return torch.int8 if self.qtype == "int8" else torch.float8_e4m3fn

    @property
    def qmax(self) -> float:
        return _WIRE_QMAX[self.qtype]

    def scale_blocks(self, cols: int) -> int:
        """Scales per row for a `cols`-wide payload."""
        if self.block is None:
            return 1
        if cols % self.block:
            raise ValueError(
                f"--comm-quant {self.spec}: block size {self.block} must "
                f"divide the collective payload's last dim ({cols})")
        return cols // self.block


def parse_wire_format(spec: str | None) -> WireFormat | None:
    """Parse a --comm-quant value; None/"none" → None (exact collectives).

    Grammar: ``none | int8 | int8-tensor | fp8 | int8-block:<B> |
    fp8-block:<B>`` with ``<B>`` a positive int. ``int8`` and
    ``int8-tensor`` both name the legacy per-row control tier.
    """
    if spec in (None, "none"):
        return None
    if spec in ("int8", "int8-tensor"):
        return WireFormat(spec=spec, qtype="int8", block=None, legacy=True)
    if spec == "fp8":
        return WireFormat(spec=spec, qtype="fp8", block=None)
    base, sep, arg = spec.partition(":")
    if sep and base in ("int8-block", "fp8-block"):
        try:
            block = int(arg)
        except ValueError:
            block = 0
        if block > 0:
            return WireFormat(spec=spec, qtype=base.split("-")[0], block=block)
    raise ValueError(
        f"unknown comm quantization {spec!r} (expected none, int8, "
        f"int8-tensor, fp8, int8-block:<B> or fp8-block:<B>)")


def is_per_link_spec(spec: str | None) -> bool:
    """Whether a --comm-quant value is the per-link-class form
    (``dcn=<fmt>,ici=<fmt>``) rather than one uniform wire format."""
    return bool(spec) and "=" in spec


def parse_link_formats(spec: str) -> dict[str, WireFormat | None]:
    """Parse a per-link --comm-quant value, e.g. ``dcn=fp8-block:32,ici=none``
    → {"dcn": WireFormat(fp8-block:32), "ici": None}.

    Grammar: comma-separated ``<link>=<format>`` with link ∈ {dcn, ici},
    each link at most once, format from the uniform grammar minus the
    legacy tier (it downcasts at every collective, so it stays
    uniform-only). Links not named are exact (None).
    """
    if not is_per_link_spec(spec):
        raise ValueError(f"not a per-link comm-quant spec: {spec!r}")
    out: dict[str, WireFormat | None] = {}
    for part in spec.split(","):
        link, sep, fmt_spec = part.strip().partition("=")
        if not sep or link not in LINK_CLASSES:
            raise ValueError(
                f"--comm-quant {spec!r}: bad entry {part.strip()!r} "
                f"(expected <link>=<format> with link in {LINK_CLASSES})")
        if link in out:
            raise ValueError(f"--comm-quant {spec!r}: link {link!r} repeats")
        fmt = parse_wire_format(fmt_spec)  # raises on bad grammar
        if fmt is not None and fmt.legacy:
            raise ValueError(
                f"--comm-quant {spec!r}: the legacy {fmt.spec!r} control "
                "tier is uniform-only; per-link formats use the fused "
                "block/per-row tier (none, fp8, int8-block:<B>, "
                "fp8-block:<B>)")
        out[link] = fmt
    for link in LINK_CLASSES:
        out.setdefault(link, None)
    return out


def link_format_spec(spec: str | None, axis_name: str) -> str | None:
    """The uniform wire-format spec one axis's collectives run under: the
    axis's link-class entry of a per-link spec, or the spec itself when
    uniform. Only an axis named 'dcn' takes the dcn entry; every other axis
    (the flat world's 'x' included) the ici entry."""
    if not is_per_link_spec(spec):
        return spec
    fmt = parse_link_formats(spec)[axis_link_class(axis_name)]
    return fmt.spec if fmt is not None else None


def validate_comm_quant(spec: str | None) -> None:
    """Raise ValueError unless `spec` is a valid --comm-quant value in
    either the uniform or the per-link grammar."""
    if is_per_link_spec(spec):
        parse_link_formats(spec)
    else:
        parse_wire_format(spec)


def _wire_quantize(x: torch.Tensor, fmt: WireFormat) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-quantize a [rows, cols] float tensor.

    Returns (q [rows, cols] in fmt.wire_dtype, scales [rows, nb] fp32)
    where nb = fmt.scale_blocks(cols). Symmetric: scale = blockmax/qmax.
    JAX's fp32 operations in JAX's order, so payloads and scales are its
    bits.
    """
    xf = x.float()
    rows, cols = xf.shape
    nb = fmt.scale_blocks(cols)
    xb = xf.reshape(rows, nb, cols // nb)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax * fp32_reciprocal(fmt.qmax), _TINY)
    scaled = xb / scale
    if fmt.qtype == "int8":
        q = torch.round(scaled).clamp_(-fmt.qmax, fmt.qmax).to(torch.int8)
    else:
        # an fp32→fp8 cast out of range is NaN in JAX (torch's CPU cast
        # saturates): clip to ±448 first, so both give the same finite
        # payload at the top of the range
        q = scaled.clamp_(-fmt.qmax, fmt.qmax).to(torch.float8_e4m3fn)
    return q.reshape(rows, cols), scale.reshape(rows, nb)


def _wire_dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Invert `_wire_quantize` → fp32 [rows, cols]. The block size comes
    from the shapes (cols // scales.shape[-1]), so the same function is
    right after a gather along either axis."""
    rows, cols = q.shape
    nb = scales.shape[-1]
    xf = q.float().reshape(rows, nb, cols // nb)
    return (xf * scales[:, :, None]).reshape(rows, cols)


def _ring_rows(shape: Sequence[int], d: int) -> int:
    """The rows a ring cuts into `d` chunks: the leading dims flattened
    (JAX's row-divisibility check)."""
    m = math.prod(shape[:-1])
    if m % d:
        raise ValueError(
            f"flattened leading dim {m} of shape {tuple(shape)} must divide "
            f"the {d}-device axis")
    return m


def _scatter_rows(shape: Sequence[int], d: int) -> None:
    if shape[0] % d:
        raise ValueError(
            f"leading dim {shape[0]} of shape {tuple(shape)} must divide "
            f"the {d}-device axis to scatter row chunks")


def _dequantize_add(q: torch.Tensor, scales: torch.Tensor,
                    part: torch.Tensor) -> torch.Tensor:
    """`_wire_dequantize(q, scales) + part` with one rounding a value, as
    XLA's fused loop computes JAX's dequantize-then-add (a fused
    multiply-add): fp32 [rows, cols]."""
    rows, cols = q.shape
    nb = scales.shape[-1]
    return torch.addcmul(part.reshape(rows, nb, cols // nb),
                         q.float().reshape(rows, nb, cols // nb),
                         scales[:, :, None]).reshape(rows, cols)


def _quantize_ranks(mesh: Mesh, xs: Sequence[torch.Tensor | None], fmt: WireFormat,
                    shape: Sequence[int]) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Each local rank's `_wire_quantize` of its [rows, cols] tensor; for a
    rank of another process (its entry None or a placeholder), a payload
    and scales that are placeholders of the shapes `fmt` fixes."""
    rows, cols = shape
    q, s = [], []
    for rank, x in zip(mesh.ranks, xs):
        if rank.local:
            qr, sr = _wire_quantize(x, fmt)
        else:
            qr = _placeholder((rows, cols), fmt.wire_dtype)
            sr = _placeholder((rows, fmt.scale_blocks(cols)), torch.float32)
        q.append(qr)
        s.append(sr)
    return q, s


def _gather_dequantize(mesh: Mesh, q: Shards, s: Shards, axis: int,
                       res_dtype: torch.dtype, shape: Sequence[int] | None = None
                       ) -> list[torch.Tensor]:
    """Gather every rank's payload and scales along `axis` (one crossing
    where the mesh spans processes) and dequantize them on each local rank
    in `res_dtype`, reshaped to `shape` where one is given; another
    process's rank gets a placeholder. Gathered columns and their scale
    blocks line up in rank order along either axis, so the block width
    comes out of the shapes."""
    q_all, s_all = all_gather_together_over(mesh, gather_axis=axis)(q, s)
    out = []
    for rank, qa, sa in zip(mesh.ranks, q_all, s_all):
        if not rank.local:
            out.append(_placeholder(shape or qa.shape, res_dtype))
            continue
        x = _wire_dequantize(qa, sa)
        out.append((x if shape is None else x.reshape(shape)).to(res_dtype))
    return out


def quantized_ring(mesh: Mesh, shards: Shards, fmt: WireFormat) -> list[torch.Tensor]:
    """The reduce-scatter ring of `wire_psum` and `wire_reduce_scatter`
    (JAX `:254-268`; the legacy `quantized_psum`'s, `quantized.py:86-92`,
    is this ring in its per-row int8 format): each rank's shard flattened
    to rows × cols and cut into D row chunks; rank r's accumulator starts
    at chunk (r + 2D − 1) mod D in fp32, and at hop t it is quantized
    (payload and its [rows, blocks] scales), moved to rank r + 1 with its
    scales in one exchange (`ppermute_together`), dequantized there and
    added to that rank's chunk (r + 2D − 1 − t) mod D. After D − 1 hops
    rank r holds chunk r fully summed (fp32, [rows / D, cols]); another
    process's rank holds a placeholder, and nothing is computed for it."""
    d = len(shards)
    rows = [s.reshape(-1, s.shape[-1]) for s in shards]
    chunk, cols = rows[0].shape[0] // d, rows[0].shape[1]
    perm = ring_perm(d)
    local = [r.local for r in mesh.ranks]

    def my_chunk(r: int, c: int) -> torch.Tensor:
        return rows[r][c * chunk:(c + 1) * chunk].float()

    acc = [my_chunk(r, (r + 2 * d - 1) % d) if local[r] else None for r in range(d)]
    for t in range(1, d):
        q, s = _quantize_ranks(mesh, acc, fmt, (chunk, cols))
        del acc  # the hop's partials go once quantized
        q, s = ppermute_together(mesh, [q, s], perm)
        acc = [_dequantize_add(q[r], s[r], my_chunk(r, (r + 2 * d - 1 - t) % d))
               if local[r] else None for r in range(d)]
        del q, s
    return [a if a is not None else _placeholder((chunk, cols), torch.float32)
            for a in acc]


def wire_psum(mesh: Mesh, shards: Shards, fmt: WireFormat,
              out_dtype: torch.dtype | None = None) -> list[torch.Tensor]:
    """all_reduce(SUM) with block-quantized wire traffic (JAX `:229`; in the
    legacy format, `quantized_psum`).

    The ring of `quantized_ring` with every hop carrying `fmt` payloads +
    per-block fp32 scales, then one gather of each rank's quantized chunk
    and its scales. `out_dtype=None` downcasts once to the shards' dtype at
    the end; torch.float32 keeps the fp32 value for a consuming product
    (`fuse_f32`). Integer shards take the exact `psum_over`; one rank is
    inert.
    """
    _check(mesh, shards)
    if is_integer_dtype(shards[0].dtype):
        return psum_over(mesh)(shards)
    d = len(shards)
    if d == 1:
        return list(shards)  # fully inert: the exact program's
    shape = shards[0].shape
    res_dtype = out_dtype or shards[0].dtype
    m = _ring_rows(shape, d)
    fmt.scale_blocks(shape[-1])
    _tick(fmt.spec, "all_reduce")
    acc = quantized_ring(mesh, shards, fmt)
    q, s = _quantize_ranks(mesh, acc, fmt, (m // d, shape[-1]))
    del acc
    return _gather_dequantize(mesh, q, s, 0, res_dtype, shape)


def wire_reduce_scatter(mesh: Mesh, shards: Shards, fmt: WireFormat,
                        out_dtype: torch.dtype | None = None) -> list[torch.Tensor]:
    """reduce_scatter(SUM) with block-quantized wire traffic (JAX `:278`):
    rank i ends with the fully reduced i-th row chunk, as `psum_scatter_over`
    gives it. `wire_psum`'s ring without the gather, so it moves 1/D of its
    wire bytes. `out_dtype` as in `wire_psum`; integer shards take the
    exact path; one rank is inert."""
    _check(mesh, shards)
    if is_integer_dtype(shards[0].dtype):
        return psum_scatter_over(mesh, scatter_dimension=0)(shards)
    d = len(shards)
    if d == 1:
        return list(shards)  # fully inert: the exact program's
    shape = shards[0].shape
    res_dtype = out_dtype or shards[0].dtype
    _scatter_rows(shape, d)
    fmt.scale_blocks(shape[-1])
    _tick(fmt.spec, "reduce_scatter")
    acc = quantized_ring(mesh, shards, fmt)
    out_shape = (shape[0] // d,) + tuple(shape[1:])
    return [a.reshape(out_shape).to(res_dtype) if rank.local
            else _placeholder(out_shape, res_dtype)
            for rank, a in zip(mesh.ranks, acc)]


def wire_all_gather(mesh: Mesh, shards: Shards, fmt: WireFormat, axis: int = 0,
                    out_dtype: torch.dtype | None = None) -> list[torch.Tensor]:
    """all_gather with block-quantized wire traffic (JAX `:323`; in the
    legacy format, `quantized_all_gather`): each rank
    quantizes its shard once and the payloads and scales are gathered (one
    rounding; no per-hop accumulation as in the psum ring). An N-D shard
    gathers along its last axis, its leading dims flattened into rows.
    `out_dtype` as in `wire_psum`; integer shards gather exactly; one rank
    is inert."""
    _check(mesh, shards)
    if is_integer_dtype(shards[0].dtype):
        return all_gather_over(mesh, gather_axis=axis)(shards)
    if len(shards) == 1:
        return list(shards)  # fully inert: the exact program's
    res_dtype = out_dtype or shards[0].dtype
    ndim = shards[0].ndim
    if ndim > 2:
        if axis != ndim - 1:
            raise ValueError(f"unsupported gather axis {axis} for rank {ndim}")
        lead = shards[0].shape[:-1]
        out = wire_all_gather(mesh, [s.reshape(-1, s.shape[-1]) for s in shards],
                              fmt, axis=1, out_dtype=out_dtype)
        return [o.reshape(*lead, -1) for o in out]
    if axis not in (0, 1):
        raise ValueError(f"unsupported gather axis {axis}")
    rows, cols = shards[0].shape
    fmt.scale_blocks(cols)
    _tick(fmt.spec, "all_gather")
    q, s = _quantize_ranks(mesh, shards, fmt, (rows, cols))
    return _gather_dequantize(mesh, q, s, axis, res_dtype)


def check_wire_payload(comm_quant: str | None, collective: str,
                       shape: Sequence[int], world: int, dtype: Any,
                       axis_name: str = "x") -> None:
    """Raise now the ValueError that `collective` ("all_reduce",
    "reduce_scatter" or "all_gather") under `comm_quant` would raise on
    per-rank payloads of `shape` over `world` ranks: a mode calls it when
    it builds its program, so that a bad size fails there and never inside
    a CUDA-graph capture. Inert cases pass."""
    fmt = parse_wire_format(link_format_spec(comm_quant, axis_name))
    if fmt is None or world == 1 or is_integer_dtype(dtype):
        return
    if collective == "all_reduce":
        _ring_rows(shape, world)
    elif collective == "reduce_scatter":
        _scatter_rows(shape, world)
    fmt.scale_blocks(shape[-1])


Impl = Callable[..., list[torch.Tensor]]


def psum_impl(comm_quant: str | None, varying_out: bool = False,
              fuse_f32: bool = False) -> Impl:
    """The psum a mode takes for --comm-quant (JAX `:371`), called as
    `impl(mesh, shards)`: None/"none" → the exact `psum_over`;
    "int8"/"int8-tensor" → the legacy per-row tier (`quantized_psum`, which
    ignores `fuse_f32`: it downcasts at every collective by design);
    anything else → `wire_psum`.

    `varying_out` is JAX's flag for shard_map bodies whose out_specs shard
    the axis; the port's results are per-rank lists either way, so both
    values give the same function. `fuse_f32=True` keeps the non-legacy
    output in fp32 for the consuming product, which then owns the one
    downcast. A per-link spec is parsed here, so bad grammar fails when
    the program is built, and resolved per mesh axis at the call.
    """
    if is_per_link_spec(comm_quant):
        parse_link_formats(comm_quant)  # fail fast on bad grammar

        def per_link(mesh: Mesh, shards: Shards) -> list[torch.Tensor]:
            sub = link_format_spec(comm_quant, mesh.axis)
            return psum_impl(sub, varying_out, fuse_f32)(mesh, shards)

        return per_link
    fmt = parse_wire_format(comm_quant)
    if fmt is None:
        return lambda mesh, shards: psum_over(mesh)(shards)
    if fmt.legacy:
        from tpu_matmul_bench_torch.parallel.quantized import quantized_psum

        return quantized_psum
    out_dtype = torch.float32 if fuse_f32 else None
    return lambda mesh, shards: wire_psum(mesh, shards, fmt, out_dtype=out_dtype)


def allgather_impl(comm_quant: str | None, fuse_f32: bool = False) -> Impl:
    """The all_gather a mode takes for --comm-quant (JAX `:429`), called as
    `impl(mesh, shards, axis=0)`: the AG analogue of `psum_impl`, with the
    same format routing, per-link resolution and `fuse_f32` contract."""
    if is_per_link_spec(comm_quant):
        parse_link_formats(comm_quant)  # fail fast on bad grammar

        def per_link(mesh: Mesh, shards: Shards, axis: int = 0) -> list[torch.Tensor]:
            sub = link_format_spec(comm_quant, mesh.axis)
            return allgather_impl(sub, fuse_f32)(mesh, shards, axis=axis)

        return per_link
    fmt = parse_wire_format(comm_quant)
    if fmt is None:
        return lambda mesh, shards, axis=0: all_gather_over(mesh, gather_axis=axis)(shards)
    if fmt.legacy:
        from tpu_matmul_bench_torch.parallel.quantized import quantized_all_gather

        return quantized_all_gather
    out_dtype = torch.float32 if fuse_f32 else None
    return lambda mesh, shards, axis=0: wire_all_gather(mesh, shards, fmt, axis=axis,
                                                        out_dtype=out_dtype)


def reduce_scatter_impl(comm_quant: str | None, fuse_f32: bool = False) -> Impl:
    """The reduce_scatter a program takes for a wire format spec (JAX
    `:457`), called as `impl(mesh, shards)`; routing, per-link resolution
    and `fuse_f32` as in `psum_impl`. The legacy tier has no reduce_scatter
    half and is rejected rather than run exact, so a record never names a
    quantized wire it did not use."""
    if is_per_link_spec(comm_quant):
        parse_link_formats(comm_quant)  # fail fast on bad grammar

        def per_link(mesh: Mesh, shards: Shards) -> list[torch.Tensor]:
            sub = link_format_spec(comm_quant, mesh.axis)
            return reduce_scatter_impl(sub, fuse_f32)(mesh, shards)

        return per_link
    fmt = parse_wire_format(comm_quant)
    if fmt is None:
        return lambda mesh, shards: psum_scatter_over(mesh, scatter_dimension=0)(shards)
    if fmt.legacy:
        raise ValueError(
            f"--grad-quant {fmt.spec!r}: the legacy control tier has no "
            "reduce_scatter half; use none, fp8, int8-block:<B> or "
            "fp8-block:<B>")
    out_dtype = torch.float32 if fuse_f32 else None
    return lambda mesh, shards: wire_reduce_scatter(mesh, shards, fmt,
                                                    out_dtype=out_dtype)


def comm_quant_record_extra(config, world: int, *, mode: str, size: int,
                            batch: int = 4, dp: int | None = None,
                            rows: int | None = None,
                            mesh_spec: str | None = None) -> dict:
    """The record's `extras["comm_quant"]` value (JAX `:494-538`): the
    inertness-aware format label, plus the static wire-byte model of this
    (mode, world, size) cell when the wire is live: on a factorized mesh
    (`mesh_spec`) the per-link breakdown of `analysis/comms_model.py
    hier_wire_bytes_summary`, so a per-link spec shows its reduction
    charged only to the link it quantizes; else `wire_bytes_summary`."""
    from tpu_matmul_bench_torch.parallel.quantized import comm_quant_extra

    tp = (world // dp) if dp else None
    extra: dict = {
        "spec": config.comm_quant,
        "format": comm_quant_extra(config, world, dp=dp, tp=tp),
    }
    if is_per_link_spec(config.comm_quant):
        quantized = any(f is not None
                        for f in parse_link_formats(config.comm_quant).values())
    else:
        quantized = parse_wire_format(config.comm_quant) is not None
    inert = not quantized or world <= 1 or is_integer_dtype(config.dtype)
    if not inert:
        from tpu_matmul_bench_torch.analysis.comms_model import (
            hier_wire_bytes_summary,
            wire_bytes_summary,
        )

        try:
            if mesh_spec is not None:
                extra.update(hier_wire_bytes_summary(
                    mode, mesh_spec, size, config.dtype_name, config.comm_quant,
                    batch=batch))
            else:
                # a per-link spec on a mesh without link classes: every
                # axis is on 'ici'
                uniform = link_format_spec(config.comm_quant, "x")
                if uniform is not None:
                    extra.update(wire_bytes_summary(
                        mode, world, size, config.dtype_name, uniform,
                        batch=batch, dp=dp, rows=rows))
        except ValueError:
            pass  # modes the analytic model doesn't cover stay label-only
    return extra
