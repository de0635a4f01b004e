"""Scaling-curve driver: one command, one mode, a sweep of rank counts.

Port of `tpu_matmul_bench/benchmarks/scaling_curve.py`. The reference
publishes its scaling story as a table over device counts (`README.md:
39-47`: total TFLOPS and scaling % per count), assembled by hand from
separate runs. This driver reruns the port's scaling program
(`matmul_scaling_benchmark.run`) at each count, every other flag passed
through (`--matmul-impl cuda` puts every product on K1), and renders the
per-count totals with the scaling efficiency against the measured
one-device baseline.

A count is the number of ranks in the world (`parallel/mesh.py`);
`TMB_RANKS_PER_CARD` ranks may share a card. In a process group (torchrun,
or `python -m tpu_matmul_bench_torch.multihost`) the default counts are
multiples of the process count, and only process 0 writes the table. The efficiency
counts cards, not ranks (`utils/reporting.py attach_scaling_efficiency`),
and where the ranks of a row share cards the table says on how many they
lie, so that "4 devices" on one card is not read as four cards.

Run: TMB_RANKS_PER_CARD=4 python -m tpu_matmul_bench_torch curve \
        --mode batch_parallel --sizes 16384 [--device-counts 1,2,4] \
        [--markdown-out t.md]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Sequence

from tpu_matmul_bench_torch.benchmarks import matmul_scaling_benchmark as scaling
from tpu_matmul_bench_torch.parallel.modes import SCALING_MODES
from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args
from tpu_matmul_bench_torch.parallel import group
from tpu_matmul_bench_torch.utils.device import maybe_init_process_group, resolve_devices
from tpu_matmul_bench_torch.utils.reporting import (
    BenchmarkRecord,
    JsonWriter,
    is_reporting_process,
    report,
)


def _parse_counts(text: str) -> list[int]:
    try:
        counts = sorted({int(p) for p in text.split(",") if p.strip()})
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--device-counts must be comma-separated ints, got {text!r}")
    if not counts or any(c <= 0 for c in counts):
        raise argparse.ArgumentTypeError(
            f"--device-counts must be positive, got {text!r}")
    return counts


def default_counts(world: int) -> list[int]:
    """1, 2, 4, ... up to the world size (always including the world)."""
    counts = []
    c = 1
    while c < world:
        counts.append(c)
        c *= 2
    counts.append(world)
    return counts


def render_curve(mode: str, size: int,
                 rows: list[tuple[int, BenchmarkRecord]]) -> str:
    """The reference README's table shape, one row per rank count, as the
    JAX package renders it. Rows whose ranks share cards (extras `cards`
    below the world) add a note under the table naming the cards, since
    TFLOPS/device and Scaling there count cards."""
    lines = [
        f"| Devices | Total TFLOPS ({size}x{size}, {mode}) | "
        "TFLOPS/device | Scaling |",
        "|---|---|---|---|",
    ]
    shared = []
    for n, rec in rows:
        scaling_pct = (f"{rec.scaling_efficiency_pct:.0f}%"
                       if rec.scaling_efficiency_pct is not None else "N/A")
        lines.append(f"| {n} | {rec.tflops_total:.1f} | "
                     f"{rec.tflops_per_device:.1f} | {scaling_pct} |")
        cards = rec.extras.get("cards", rec.world)
        if cards != rec.world:
            shared.append(f"{n} on {cards} card(s)")
    if shared:
        lines += ["", "Devices are ranks: " + ", ".join(shared) + "; "
                  "TFLOPS/device and Scaling count cards."]
    return "\n".join(lines)


def main(argv: Sequence[str] | None = None) -> list[BenchmarkRecord]:
    parser = build_parser(__doc__ or "scaling curve",
                          modes=list(SCALING_MODES),
                          default_mode="independent",
                          extra_dtypes=("int8",),
                          fused_timing=True,
                          comm_quant=True)
    parser.add_argument(
        "--device-counts", type=_parse_counts, default=None,
        help="comma-separated rank counts to sweep (default: powers of "
             "two up to the available world size)")
    parser.add_argument(
        "--markdown-out", type=str, default=None,
        help="write the README-style curve table here")
    args = parser.parse_args(argv)
    config = config_from_args(args)
    if len(config.sizes) != 1:
        raise SystemExit("curve sweeps device counts at ONE size; "
                         "pass a single --sizes value")
    size = config.sizes[0]

    maybe_init_process_group()
    if args.device_counts is not None:
        counts = args.device_counts
    else:
        world = len(resolve_devices(config.device, config.num_devices))
        nprocs = group.process_count()
        # in a process group every count keeps each process's share equal
        # (resolve_devices refuses one that does not split), so the counts
        # are multiples of the process count up to the world (JAX `:100-114`)
        counts = [c * nprocs for c in default_counts(world // nprocs)]

    rows: list[tuple[int, BenchmarkRecord]] = []
    # one session over the whole sweep: scaling.run's own session call is
    # re-entrant, so the trace shows every count's spans on one timeline
    with telemetry.session(config.trace_out):
        for n in counts:
            report(f"\n### scaling curve: {config.mode} at {n} device(s) "
                   + "#" * 30)
            # each count is a full scaling run at --num-devices n; the run
            # writes no JSONL of its own (this driver aggregates)
            sub = dataclasses.replace(config, num_devices=n, json_out=None)
            with telemetry.span(f"devices:{n}", devices=n, mode=config.mode):
                recs = scaling.run(sub)
            if recs:
                rows.append((n, recs[-1]))

    table = render_curve(config.mode, size, rows)
    report("\n" + table)
    if args.markdown_out and is_reporting_process():
        with open(args.markdown_out, "w") as fh:
            fh.write(table + "\n")
    manifest = telemetry.build_manifest(config) if config.json_out else None
    with JsonWriter(config.json_out, manifest=manifest) as jw:
        for n, rec in rows:
            rec.extras.setdefault("curve_devices", n)
            jw.write(rec)
    if len(rows) != len(counts):
        # the scaling run reported why; a curve with a hole is no result
        report(f"[curve] {len(counts) - len(rows)} of {len(counts)} counts "
               "gave no record — exiting 1")
        raise SystemExit(1)
    return [rec for _, rec in rows]


if __name__ == "__main__":
    main()
