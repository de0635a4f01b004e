"""Kernel tile tuner — sweep the hand-written GEMM's tiles on the card.

Port of `tpu_matmul_bench/benchmarks/pallas_tune.py`, the `tune`
program's measurement sweep. The kernel (`csrc/matmul.cu`) exposes its
tile, so this program measures each candidate tile on the device, checks
it, and reports the ranking; feed the winner back via --block-m/n/k.
`--grid-order` picks the raster of output tiles and `--ksplit` runs every
candidate as the split-K GEMM plus its reduction (`cuda_matmul_ksplit`).
Each record carries the kernel's own cost books for its launch
(`extras["cost_analysis"]`, `obs/attribution.py`), split-K partials
included.

`--ring MODE` sweeps the same tiles over one of the HBM ring matmuls (K2–K5,
`ops/cuda_ring.py`) instead: their step products take the candidate's
tile, and only the default tile is instantiated on the persistent ring-step
GEMM (`cuda_matmul.PERSISTENT_TILES`), so another tile takes the steps off
it (`cuda_matmul.step_route`) and an all-gather ring then hops its chunks.
Operands are sharded per the ring's contract over the world of
--num-devices ranks (`parallel/mesh.py`, `TMB_RANKS_PER_CARD`); each record
says which route its step products took and how the data moved
(`step_route`, `transfer`), read from the launch counters.

Run: python -m tpu_matmul_bench_torch tune --sizes 16384 --iterations 10 \\
        [--candidates 128,128,32 128,256,32 ...] [--mkn M K N] \\
        [--grid-order nmk] [--ksplit 2] [--ring cuda_ring_hbm]

Candidates are requests: each resolves to the tile that actually runs
(`effective_blocks`), and requests that resolve alike are measured once.
The tuning database's subcommands (`tune show/prune/promote/selftest`) are
`tune/cli.py`, which hands every flag-style invocation to this program;
`tune promote` turns this program's ledgers into database cells.
"""

from __future__ import annotations

import argparse
from typing import Sequence

from tpu_matmul_bench_torch.models.workloads import (
    MatmulWorkload,
    RectMatmulWorkload,
)
from tpu_matmul_bench_torch.obs import attribution
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops import cuda_ring as cr
from tpu_matmul_bench_torch.ops.cuda_matmul import (
    TILES,
    cuda_matmul,
    cuda_matmul_ksplit,
    effective_blocks,
    effective_ksplit,
)
from tpu_matmul_bench_torch.parallel.mesh import (
    COLS,
    ROWS,
    global_block,
    make_mesh,
    sharded_normal,
)
from tpu_matmul_bench_torch.parallel.modes import (
    VALIDATION_CORNER,
    corner_validation,
    expected_corner,
)
from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args
from tpu_matmul_bench_torch.utils.device import (
    apply_matmul_precision,
    collect_device_info,
    device_banner,
    resolve_devices,
)
from tpu_matmul_bench_torch.utils.metrics import calculate_tflops, throughput_unit
from tpu_matmul_bench_torch.utils.profiling import maybe_trace
from tpu_matmul_bench_torch.utils.reporting import (
    BenchmarkRecord,
    JsonWriter,
    header,
    report,
)
from tpu_matmul_bench_torch.utils.timing import (
    choose_timer,
    effective_warmup,
    protocol_extras,
    time_jitted,
    time_variants_n,
)

# Every instantiated tile, smallest first.
DEFAULT_CANDIDATES = list(TILES)

# The HBM ring matmuls `--ring` sweeps (`ops.ring_matmul_builders`); the
# fused ring (K6) is left out, as the JAX package leaves out its resident
# ring
RING_MODES = ("cuda_ring_hbm", "cuda_ring_bidir_hbm", "cuda_ring_rs_hbm",
              "cuda_ring_bidir_rs_hbm")


def _candidate_fn(eff: tuple[int, int, int], grid_order: str = "mnk",
                  ksplit: int = 1):
    """A candidate: the kernel at tile `eff`, under `grid_order`, as the
    split-K GEMM when `ksplit` > 1."""
    if ksplit > 1:
        return lambda a, b: cuda_matmul_ksplit(a, b, splits=ksplit, blocks=eff,
                                               grid_order=grid_order)
    return lambda a, b: cuda_matmul(a, b, blocks=eff, grid_order=grid_order)


def _candidate_cost(eff: tuple[int, int, int], ksplit: int, a, b) -> dict:
    """`extras["cost_analysis"]` of one candidate (`pallas_tune.py:111-125`
    of the JAX package): the kernel's own books for the launch the
    candidate makes on these operands (`cuda_matmul.launch_plan`), its
    split-K partials counted in `bytes_accessed`."""
    (m, k), n = a.shape, b.shape[1]
    route, tile, splits = cm.launch_plan(a, b, eff, ksplit)
    return {"cost_analysis": attribution.attribution_block(
        route, m, n, k, tile, splits, a.dtype)}


def _structural_extras(grid_order: str, ksplit: int) -> dict:
    """Record extras for the non-default structural axes: a record has to
    say which order and split produced its number, not only the tile."""
    out: dict = {}
    if grid_order != "mnk":
        out["grid_order"] = grid_order
    if ksplit > 1:
        out["ksplit"] = ksplit
    return out


def _parse_candidate(text: str) -> tuple[int, int, int]:
    parts = tuple(int(p) for p in text.split(","))
    if len(parts) != 3 or any(p <= 0 for p in parts):
        raise argparse.ArgumentTypeError(
            f"candidate must be 'bm,bn,bk' positive ints, got {text!r}")
    return parts


def _ring_effective_blocks(kind: str, bidir: bool, size: int, d: int,
                           want: tuple[int, int, int], dtype) -> tuple[int, int, int]:
    """The tile a ring candidate's step products run
    (`pallas_tune.py:128-154`): all-gather rings multiply [rows, k]×[k,
    nshard] chunks, reduce-scatter rings [rows, klocal]×[klocal, n], and
    the bidirectional forms halve the rows. The port's `effective_blocks`
    does not read the shape, so both halves of a bidirectional ring run one
    tile, and the tile is the dedupe key."""
    mshard = size // d
    rows = mshard // 2 if bidir else mshard
    dims = (rows, size // d, size) if kind == "ag" else (rows, size, size // d)
    return effective_blocks(*dims, *want, dtype)


def _risen(before: dict, after: dict) -> str:
    """The keys whose launch counts rose between two snapshots, joined by
    "+"; "plain" where none did (on the CPU the wrappers run their plain
    versions and launch nothing)."""
    return "+".join(key for key in after if after[key] != before[key]) or "plain"


def _tune_ring(ring: str, candidates, config, devices, info,
               jw) -> list[BenchmarkRecord]:
    """Sweep tiles over one HBM ring matmul (`pallas_tune.py:157-259`):
    operands sharded per the ring's contract over the resolved ranks, each
    candidate validated on the corner and timed by the dispatch protocol.
    Beside JAX's per-candidate decision (`wres_engaged`, always False: the
    port has no W-resident kernel) each record reads, from the launch
    counters around the candidate's calls, the route its step products took
    (`step_route`, `cuda_matmul.LAUNCHES_BY_ROUTE`) and how the ring moved
    its data (`transfer`, `cuda_ring.AG_TRANSFERS` or `RS_TRANSFERS`).
    `tflops_per_device` counts cards, as the overlap program's records do,
    so ranks that share a card do not read as cards; with one rank a card
    it is the JAX package's total over the world."""
    from tpu_matmul_bench_torch.ops import ring_matmul_builders

    builder, kind = ring_matmul_builders()[ring]
    bidir = "bidir" in ring
    mesh = make_mesh(devices)
    d, cards = len(mesh.ranks), mesh.card_count
    x_spec, w_spec = (ROWS, COLS) if kind == "ag" else (COLS, ROWS)
    transfers = cr.AG_TRANSFERS if kind == "ag" else cr.RS_TRANSFERS
    records: list[BenchmarkRecord] = []
    for size in config.sizes:
        if size % d:
            report(f"\n[{size}] skip: size must divide the {d}-device ring")
            continue
        if bidir and size // d < 2:
            report(f"\n[{size}] skip: bidirectional rings need ≥ 2 rows "
                   f"per {d}-device chunk (have {size // d})")
            continue
        label = f"{ring}:{size}"
        (a,) = sharded_normal(config.seed, (size, size), config.dtype, mesh,
                              x_spec, count=1)
        (b,) = sharded_normal(config.seed + 1, (size, size), config.dtype,
                              mesh, w_spec, count=1)
        results: list[tuple[tuple[int, int, int], float]] = []
        seen: set[tuple[int, int, int]] = set()
        for want in candidates:
            # a request resolves to an instantiated tile: dedupe and report
            # on what the step products actually run
            eff = _ring_effective_blocks(kind, bidir, size, d, want, config.dtype)
            if eff in seen:
                report(f"\n[{label}] skip {want}: resolves to already-"
                       f"measured {eff}")
                continue
            seen.add(eff)
            bm, bn, bk = eff
            note = "" if eff == tuple(want) else f" (requested {want})"
            report(f"\n[{label}] timing bm={bm} bn={bn} bk={bk}{note} ...")
            routes, moved = dict(cm.LAUNCHES_BY_ROUTE), dict(transfers)
            try:
                fn = builder(mesh, block_m=want[0], block_n=want[1],
                             block_k=want[2], wres=config.wres_override)
                verdict: dict = {}
                if config.validate:  # a wrong tile fails fast
                    c = min(VALIDATION_CORNER, size)
                    verdict = corner_validation(
                        global_block(fn(a, b), c, c),
                        expected_corner(global_block(a, c, size),
                                        global_block(b, size, c), corner=c),
                        config.dtype)
                    if verdict["validation"] != "ok":
                        report(f"  VALIDATION FAILED: {verdict}")
                        continue
                t = time_jitted(fn, (a, b), iterations=config.iterations,
                                warmup=config.warmup)
            except Exception as e:  # noqa: BLE001 — a bad tile skips
                report(f"  FAILED: {type(e).__name__}: {str(e)[:160]}")
                continue
            step_route = _risen(routes, cm.LAUNCHES_BY_ROUTE)
            transfer = _risen(moved, transfers)
            tflops = calculate_tflops(size, t.avg_s)
            results.append((eff, tflops))
            unit = throughput_unit(config.dtype)
            report(f"  {tflops:.2f} {unit} total ({t.avg_s * 1e3:.3f} ms; "
                   f"steps {step_route}, transfer {transfer})")
            rec = BenchmarkRecord(
                benchmark="tune", mode=f"tune_{ring}", size=size,
                dtype=config.dtype_name, world=d,
                iterations=t.iterations, warmup=config.warmup,
                avg_time_s=t.avg_s, tflops_per_device=tflops / cards,
                tflops_total=tflops, device_kind=info.device_kind,
                extras={"block_m": bm, "block_n": bn, "block_k": bk,
                        "ring": ring, "wres": config.wres,
                        "wres_engaged": cr.resolve_wres(config.wres_override, d)[0],
                        "step_route": step_route, "transfer": transfer,
                        **verdict},
            ).finalize()
            records.append(rec)
            jw.write(rec)
        if results:
            results.sort(key=lambda r: -r[1])
            (bm, bn, bk), best = results[0]
            report(f"\n[{label}] BEST: --block-m {bm} --block-n {bn} "
                   f"--block-k {bk}  ({best:.2f} "
                   f"{throughput_unit(config.dtype)} total)")
        del a, b
    return records


def main(argv: Sequence[str] | None = None) -> list[BenchmarkRecord]:
    parser = build_parser(__doc__ or "kernel tile tuner",
                          extra_dtypes=("int8",), profile=True)
    parser.add_argument(
        "--candidates", type=_parse_candidate, nargs="+",
        default=list(DEFAULT_CANDIDATES),
        help="Tiles to try, each as 'bm,bn,bk' (default: every instantiated "
             "tile)",
    )
    parser.add_argument(
        "--mkn", type=int, nargs=3, metavar=("M", "K", "N"), default=None,
        help="Tune one rectangular A[M,K]·B[K,N] instead of the square "
             "--sizes sweep",
    )
    parser.add_argument(
        "--confirm-top", type=int, default=3,
        help="After the sweep, re-measure the best N candidates "
             "interleaved (median-of-3 rounds, time_variants_n) and re-rank: "
             "the sweep times candidates one after another, so drift "
             "between them can bias the ranking. 0 disables (default 3).",
    )
    parser.add_argument(
        "--grid-order", type=str, default="mnk", choices=["mnk", "nmk"],
        help="Raster of output tiles for every candidate: mnk (M slowest, "
             "default) or nmk (N slowest)",
    )
    parser.add_argument(
        "--ksplit", type=int, default=1,
        help="Split-K: each candidate computes C as the fp32 sum of N "
             "partial products over K/N-wide slabs (cuda_matmul_ksplit; a "
             "single pass when K has no 128-aligned equal split). Default "
             "1 = single pass.",
    )
    parser.add_argument(
        "--ring", type=str, default=None, choices=list(RING_MODES),
        help="Sweep the candidates over this HBM ring matmul instead of the "
             "plain kernel (operands sharded over the --num-devices ranks; "
             "TMB_RANKS_PER_CARD places several on one card)",
    )
    parser.add_argument(
        "--wres", type=str, default="auto", choices=["auto", "on", "off"],
        help="W-resident mode of the --ring kernels. The port has no "
             "W-resident kernel: auto and off stream W from device memory; "
             "on is an error.",
    )
    args = parser.parse_args(argv)
    if args.ring and (args.grid_order != "mnk" or args.ksplit != 1):
        raise SystemExit("--grid-order/--ksplit tune the plain kernel; "
                         "they cannot combine with --ring")
    config = config_from_args(args)
    if args.ring and args.mkn:
        raise SystemExit("--ring tunes the square --sizes sweep; "
                         "it cannot combine with --mkn")
    if args.ring and config.timing == "fused":
        # the ring sweep keeps the reference dispatch protocol, as the JAX
        # package's does
        raise SystemExit("--ring tuning uses the dispatch protocol; "
                         "drop --timing fused")
    apply_matmul_precision(config.precision)

    devices = resolve_devices(config.device, config.num_devices)
    info = collect_device_info(devices)
    device = devices[0]
    report(device_banner(info))
    report(header(
        "CUDA Matmul Tile Tuner" + (f" — ring {args.ring}" if args.ring else ""),
        {
            ("Shape" if args.mkn else "Sizes"):
                ("x".join(map(str, args.mkn)) if args.mkn
                 else config.sizes),
            "Data type": config.dtype_name,
            "Candidates": len(args.candidates),
            "Iterations per candidate": config.iterations,
        },
    ))
    if args.mkn:
        report("note: --mkn tunes the one rectangle; --sizes is ignored")

    # an explicit --block-m/n/k tile is tried first, ahead of the grid
    candidates = list(args.candidates)
    if config.blocks is not None:
        candidates.insert(0, config.blocks)

    def _manifest():
        return telemetry.build_manifest(config) if config.json_out else None

    traced = maybe_trace(config.profile_dir, cuda=info.platform == "cuda")
    if args.ring:
        with telemetry.session(config.trace_out), traced, \
                JsonWriter(config.json_out, manifest=_manifest()) as jw:
            return _tune_ring(args.ring, candidates, config, devices, info, jw)

    shapes: list[tuple[int, int, int]] = (
        [tuple(args.mkn)] if args.mkn
        else [(s, s, s) for s in config.sizes])

    records: list[BenchmarkRecord] = []
    with telemetry.session(config.trace_out), traced, \
            JsonWriter(config.json_out, manifest=_manifest()) as jw:
        for m, k, n in shapes:
            rect = not (m == k == n)
            label = f"{m}x{k}x{n}" if rect else str(m)
            # label records with the split the kernels actually use: a K
            # without a 128-aligned equal split runs as a single pass, and
            # such a run must not pass for a split-K one
            eff_ks = effective_ksplit(k, args.ksplit)
            if eff_ks != args.ksplit:
                report(f"\n[{label}] note: --ksplit {args.ksplit} has no "
                       f"128-aligned equal split of K={k} — running "
                       "single-pass (records carry no ksplit tag)")
            wl = (RectMatmulWorkload(m, k, n, config.dtype, seed=config.seed)
                  if rect else
                  MatmulWorkload(m, config.dtype, seed=config.seed))
            a, b = wl.operands(device)
            results: list[tuple[tuple[int, int, int], float]] = []
            seen: set[tuple[int, int, int]] = set()
            for want in candidates:
                # a request resolves to an instantiated tile: dedupe and
                # report on what actually runs
                eff = effective_blocks(m, n, k, *want, config.dtype)
                if eff in seen:
                    report(f"\n[{label}] skip {want}: resolves to already-"
                           f"measured bm={eff[0]} bn={eff[1]} bk={eff[2]}")
                    continue
                seen.add(eff)
                bm, bn, bk = eff
                note = "" if eff == tuple(want) else f" (requested {want})"
                report(f"\n[{label}] timing bm={bm} bn={bn} bk={bk}{note} ...")
                try:
                    mm = _candidate_fn(eff, args.grid_order, args.ksplit)
                    verdict: dict = {}
                    if config.validate:  # a wrong tile fails fast
                        c = min(VALIDATION_CORNER, m, n)
                        got = mm(a, b)[:c, :c]
                        verdict = corner_validation(
                            got, expected_corner(a, b, corner=c), config.dtype)
                        if verdict["validation"] != "ok":
                            report(f"  VALIDATION FAILED: {verdict}")
                            continue
                    t = choose_timer(config.timing)(
                        mm, (a, b), iterations=config.iterations,
                        warmup=config.warmup)
                except Exception as e:  # noqa: BLE001 — a bad tile skips
                    report(f"  FAILED: {type(e).__name__}: {str(e)[:160]}")
                    continue
                tflops = calculate_tflops(max(m, k, n), t.avg_s,
                                          flops=wl.flops)
                results.append((eff, tflops))
                unit = throughput_unit(config.dtype)
                report(f"  {tflops:.2f} {unit} ({t.avg_s * 1e3:.3f} ms)")
                extras = {"block_m": bm, "block_n": bn, "block_k": bk,
                          **_structural_extras(args.grid_order, eff_ks),
                          **protocol_extras(config.timing, t), **verdict,
                          **_candidate_cost(eff, eff_ks, a, b)}
                if rect:
                    extras["shape"] = label
                if config.precision != "default":
                    extras["precision"] = config.precision
                rec = BenchmarkRecord(
                    benchmark="tune", mode="cuda_tune", size=max(m, k, n),
                    dtype=config.dtype_name, world=1,
                    iterations=t.iterations,
                    warmup=effective_warmup(config.timing, config.iterations,
                                            config.warmup),
                    avg_time_s=t.avg_s, tflops_per_device=tflops,
                    tflops_total=tflops, device_kind=info.device_kind,
                    # rectangular only: set for a square it would suppress
                    # finalize()'s roofline gate
                    flops_per_op=wl.flops if rect else None,
                    extras=extras,
                ).finalize()
                records.append(rec)
                jw.write(rec)
            if results:
                results.sort(key=lambda r: -r[1])
                if args.confirm_top > 1 and len(results) > 1:
                    results = _confirm_top(
                        results, args.confirm_top, config, wl, max(m, k, n),
                        (a, b), label, info, jw, records,
                        shape=label if rect else None,
                        grid_order=args.grid_order, ksplit=eff_ks)
                (bm, bn, bk), best = results[0]
                report(f"\n[{label}] BEST: --block-m {bm} --block-n {bn} "
                       f"--block-k {bk}  ({best:.2f} "
                       f"{throughput_unit(config.dtype)})")
            del a, b
    return records


def _confirm_top(results, top_n, config, wl, size, operands, label, info,
                 jw, records, shape=None, grid_order="mnk", ksplit=1):
    """Interleaved confirm pass over the sweep's finalists: re-measure the
    top N round-robin, median-of-3 (`time_variants_n`), so that drift
    between the sweep's back-to-back measurements cannot decide a close
    ranking. Confirm records carry `confirm_pass`; when the top two are
    within 1%, both carry `tie_margin_pct`."""
    finalists = results[:top_n]
    report(f"\n[{label}] confirm pass: top {len(finalists)} interleaved "
           "(median-of-3)")
    fns = [_candidate_fn(eff, grid_order, ksplit) for eff, _ in finalists]
    try:
        times = time_variants_n(
            fns, operands, iterations=config.iterations,
            warmup=1,  # every finalist is already built and warm
            protocol=config.timing)
    except Exception as e:  # noqa: BLE001 — confirm must not kill the sweep
        report(f"  confirm FAILED ({type(e).__name__}: {str(e)[:120]}) — "
               "keeping the sweep ranking")
        return results
    unit = throughput_unit(config.dtype)
    confirmed = []
    recs_by_eff: dict = {}
    for (eff, sweep_tflops), t in zip(finalists, times):
        tflops = calculate_tflops(size, t.avg_s, flops=wl.flops)
        confirmed.append((eff, tflops))
        report(f"  {eff}: {tflops:.2f} {unit} confirmed "
               f"(sweep said {sweep_tflops:.2f})")
        extras = {"block_m": eff[0], "block_n": eff[1], "block_k": eff[2],
                  "confirm_pass": True,
                  **_structural_extras(grid_order, ksplit),
                  **protocol_extras(config.timing, t)}
        if shape is not None:  # a rectangle keeps its MxKxN provenance
            extras["shape"] = shape
        if config.precision != "default":
            extras["precision"] = config.precision
        recs_by_eff[eff] = BenchmarkRecord(
            benchmark="tune", mode="cuda_tune", size=size,
            dtype=config.dtype_name, world=1, iterations=t.iterations,
            warmup=1, avg_time_s=t.avg_s, tflops_per_device=tflops,
            tflops_total=tflops, device_kind=info.device_kind,
            extras=extras,
        ).finalize()
    confirmed.sort(key=lambda r: -r[1])
    if len(confirmed) > 1 and confirmed[1][1] > 0:
        margin = (confirmed[0][1] - confirmed[1][1]) / confirmed[1][1]
        if margin < 0.01:
            # even interleaved, a margin under 1% is inside run noise: the
            # flag goes on the top two records, the channel tooling reads
            for eff, _ in confirmed[:2]:
                recs_by_eff[eff].extras["tie_margin_pct"] = round(
                    margin * 100, 2)
            report(f"  note: top-2 margin {margin * 100:.2f}% is inside "
                   "run noise — treat as a tie (re-run with more "
                   "--iterations before choosing a tile)")
    # written after ranking, so the tie flag lands on the records; confirm
    # order is the finalists' order
    for eff, _ in finalists:
        records.append(recs_by_eff[eff])
        jw.write(recs_by_eff[eff])
    # non-finalists keep their sweep numbers, ranked below the finalists
    return confirmed + results[len(finalists):]


if __name__ == "__main__":
    main()
