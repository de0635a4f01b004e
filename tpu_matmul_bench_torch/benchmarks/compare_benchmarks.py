"""Comparison driver ≙ reference `backup/compare_benchmarks.py` (SURVEY L4).

Port of `tpu_matmul_bench/benchmarks/compare_benchmarks.py`. The reference
spawns its launchers and greps stdout for the 16384×16384 block; here the
port's programs run in-process and their structured records are compared
directly. The qualitative summary (overlap ≥ no_overlap, both below
independent) is derived from the measured numbers.

The rows: `single`, the five parallel modes, `hybrid`, `summa`, the seven
library overlap modes, the fused ring `cuda_ring` (K6) and the four HBM
rings (K2–K5), the dtype sweep and the strict-fp32 row. The rows keep the
JAX package's keys, the five `pallas_ring*` keys becoming the port's mode
names (`RING_ROW_KEYS`). The programs default to `--matmul-impl auto`,
which stays on cuBLAS (`ops/impl_select.py`), so the table's product rows
are the library's and its ring rows the hand-written rings.

Run: python -m tpu_matmul_bench_torch compare \
        [--size 16384] [--num-devices N] [--dtype bfloat16] [--isolate]

`--isolate` runs each row in a child process (`python -m
tpu_matmul_bench_torch.benchmarks.<program>`, which inherits
`TMB_RANKS_PER_CARD`) and reads its records back from its --json-out
JSONL. A child that exits non-zero has its rc reported and its row left
out; a child past `--mode-timeout` is killed and its row left out. Unlike
the JAX package's tunnel clients, which it leaves running, a live child
would share the card with every later row and skew its time, so the port
keeps no orphans.
"""

from __future__ import annotations

import argparse
import json
from typing import Sequence

from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.config import comm_quant_arg
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord, report

# the JAX package's ring row keys → the port's (its overlap mode names,
# `parallel/overlap.py`)
RING_ROW_KEYS = {
    "pallas_ring": "cuda_ring",
    "pallas_ring_hbm": "cuda_ring_hbm",
    "pallas_ring_bidir_hbm": "cuda_ring_bidir_hbm",
    "pallas_ring_rs_hbm": "cuda_ring_rs_hbm",
    "pallas_ring_bidir_rs_hbm": "cuda_ring_bidir_rs_hbm",
}
HBM_RINGS = tuple(v for k, v in RING_ROW_KEYS.items() if k != "pallas_ring")

# every row key compare() can produce: the valid --only vocabulary
ROW_KEYS = frozenset({
    "single", "independent", "batch_parallel", "matrix_parallel",
    "data_parallel", "model_parallel", "hybrid", "summa",
    "no_overlap", "overlap", "pipeline",
    "collective_matmul", "collective_matmul_bidir",
    "collective_matmul_rs", "collective_matmul_bidir_rs",
    *RING_ROW_KEYS.values(),
    "single_float32", "single_float16", "single_bfloat16",
    "single_float32_strict",
})

def _run(module_main, argv: list[str]) -> list[BenchmarkRecord]:
    try:
        return module_main(argv)
    except SystemExit:
        return []


def _run_isolated(module_name: str, argv: list[str],
                  timeout_s: float) -> list[BenchmarkRecord]:
    """Run one program in a child process and read its records back from
    its --json-out JSONL (the records are the machine channel, never
    stdout). A child that exits non-zero, or that exceeds `timeout_s` and
    is killed, yields no row: the rc is reported, and no record the
    child may have written is used."""
    import os
    import subprocess
    import sys
    import tempfile

    fd, path = tempfile.mkstemp(prefix="compare_row_", suffix=".jsonl")
    os.close(fd)
    try:
        # the child's human report flows to the parent's streams, as the
        # in-process rows' does
        proc = subprocess.Popen(
            [sys.executable, "-m", module_name, *argv, "--json-out", path])
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            report(f"[compare] {module_name} exceeded {timeout_s:.0f}s — "
                   "killed, row skipped")
            return []
        if proc.returncode != 0:
            report(f"[compare] {module_name} exited rc={proc.returncode} — "
                   "row skipped")
            return []
        with open(path) as fh:
            lines = fh.read().splitlines()
        records = []
        for line in lines:
            try:
                records.append(BenchmarkRecord.from_json(line))
            except (ValueError, TypeError, KeyError):
                continue  # the manifest line
        return records
    finally:
        os.unlink(path)


def _probe_backend(timeout_s: float, device: str = "cuda"
                   ) -> tuple[str | None, int, int | None]:
    """(backend, ranks, the card's L2 bytes) from a child process, so that
    the --isolate parent never initializes the device itself. The ranks
    are every place `utils/device.py resolve_devices` gives (with
    `TMB_RANKS_PER_CARD`); the L2 caps the fused ring's row. A failed or
    timed-out probe gives (None, 0, None)."""
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from tpu_matmul_bench_torch.utils.device import resolve_devices\n"
        f"ranks = resolve_devices({device!r})\n"
        "l2 = (torch.cuda.get_device_properties(ranks[0]).L2_cache_size\n"
        "      if ranks[0].type == 'cuda' else None)\n"
        "print('PROBE::', ranks[0].type, len(ranks), l2)\n")
    try:
        # a sentinel-prefixed line: only the line the probe printed
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=timeout_s)
        for line in out.stdout.splitlines():
            if line.startswith("PROBE:: "):
                _, backend, n, l2 = line.split()
                return backend, int(n), None if l2 == "None" else int(l2)
        raise ValueError(f"no probe line in {out.stdout!r} ({out.stderr[-300:]!r})")
    except (OSError, ValueError, subprocess.SubprocessError) as e:
        report(f"[compare] device probe failed or timed out: {e}")
        return None, 0, None


def compare(size: int, dtype: str, num_devices: int | None,
            iterations: int, warmup: int,
            precision: str = "default",
            isolate: bool = False,
            mode_timeout: float = 900.0,
            only: set[str] | None = None,
            comm_quant: str | None = None,
            timing: str = "dispatch",
            device: str = "cuda",
            validate: bool = False) -> dict[str, BenchmarkRecord]:
    if only is not None:
        only = {k.strip() for k in only if k.strip()}
        unknown = only - ROW_KEYS
        if unknown:
            # a typo must not silently run zero rows (an empty table would
            # read as 'those rows produced nothing')
            raise SystemExit(
                f"--only: unknown row key(s) {sorted(unknown)}; "
                f"valid keys: {', '.join(sorted(ROW_KEYS))}")

    if isolate:
        # scope the reporting-gate override to this call: callers of
        # compare() must not be left with the process-wide gate forced
        from tpu_matmul_bench_torch.utils.reporting import (
            force_reporting_process,
            reporting_process_override,
        )

        prev = reporting_process_override()
        force_reporting_process(True)
        try:
            return _compare_rows(size, dtype, num_devices, iterations,
                                 warmup, precision, isolate, mode_timeout,
                                 only, comm_quant, timing, device, validate)
        finally:
            force_reporting_process(prev)
    return _compare_rows(size, dtype, num_devices, iterations, warmup,
                         precision, isolate, mode_timeout, only, comm_quant,
                         timing, device, validate)


def _compare_rows(size, dtype, num_devices, iterations, warmup, precision,
                  isolate, mode_timeout, only, comm_quant=None,
                  timing="dispatch", device="cuda",
                  validate=False) -> dict[str, BenchmarkRecord]:
    from tpu_matmul_bench_torch.benchmarks import (
        matmul_benchmark,
        matmul_distributed_benchmark,
        matmul_hybrid_benchmark,
        matmul_overlap_benchmark,
        matmul_scaling_benchmark,
        matmul_summa_benchmark,
    )
    from tpu_matmul_bench_torch.parallel.mesh import ranks_per_card

    if isolate:
        # the parent stays device-free: the world, the platform and the L2
        # come from a probe child. Only the hybrid, summa and cuda_ring
        # gates read them; skip the probe when --only excludes them all
        needs_probe = only is None or bool(only & {"hybrid", "summa", "cuda_ring"})
        if needs_probe:
            backend, probed_n, l2 = _probe_backend(min(120.0, mode_timeout), device)
            if backend is None:
                # the device cannot even come up inside the probe window:
                # fail fast rather than spend every row's timeout on it
                report("[compare] device probe failed — refusing to start a "
                       "table no row of which can run (rc 3)")
                raise SystemExit(3)
        else:
            backend, probed_n, l2 = "unknown", 1, None
        world = num_devices or probed_n
    else:
        from tpu_matmul_bench_torch.parallel.overlap import l2_bytes
        from tpu_matmul_bench_torch.utils.device import resolve_devices

        ranks = resolve_devices(device)
        backend = ranks[0].type
        l2 = l2_bytes(ranks[0]) if backend == "cuda" else None
        world = num_devices or len(ranks)
    common = ["--sizes", str(size), "--dtype", dtype,
              "--iterations", str(iterations), "--warmup", str(warmup),
              "--precision", precision, "--device", device]
    # one protocol per table: every row program takes --timing; the ring
    # kernels demote to dispatch and say so in extras. --validate rides
    # every row the same way
    row_args = (["--timing", timing] if timing and timing != "dispatch" else []) + \
        (["--validate"] if validate else [])
    common = common + row_args
    base = common + (["--num-devices", str(num_devices)] if num_devices else [])
    # the wire format rides the rows whose programs route a collective
    # through it (scaling, distributed, hybrid, summa); the others take no
    # --comm-quant in the port
    quant = (["--comm-quant", comm_quant]
             if comm_quant and comm_quant != "none" else [])

    def run_prog(module, argv: list[str]) -> list[BenchmarkRecord]:
        label = module.__name__.rsplit(".", 1)[-1]
        if "--mode" in argv:
            label += ":" + argv[argv.index("--mode") + 1]
        with telemetry.span(f"row:{label}"):
            if isolate:
                return _run_isolated(module.__name__, argv, mode_timeout)
            return _run(module.main, argv)

    def want(name: str) -> bool:
        # --only: rerun a subset of rows without paying for the whole table
        return only is None or name in only

    results: dict[str, BenchmarkRecord] = {}

    # the 'single' row is the per-card baseline: always exactly 1 rank
    if want("single"):
        report("\n### single-device matmul " + "#" * 40)
        for rec in run_prog(matmul_benchmark, common + ["--num-devices", "1"]):
            results["single"] = rec

    for mode in ("independent", "batch_parallel", "matrix_parallel"):
        if not want(mode):
            continue
        report(f"\n### scaling: {mode} " + "#" * 40)
        for rec in run_prog(matmul_scaling_benchmark, base + quant + ["--mode", mode]):
            results[mode] = rec

    # the distributed-benchmark rows the reference's compare also runs
    for mode in ("data_parallel", "model_parallel"):
        if not want(mode):
            continue
        report(f"\n### distributed: {mode} " + "#" * 40)
        for rec in run_prog(matmul_distributed_benchmark,
                            base + quant + ["--mode", mode]):
            results[mode] = rec

    # the 2-D dp×tp mode: dp divides the world and tp = world/dp ≥ 2
    hybrid_dp = 2
    if not want("hybrid"):
        pass
    elif world > hybrid_dp and world % hybrid_dp == 0:
        report("\n### hybrid (dp x tp) " + "#" * 40)
        for rec in run_prog(matmul_hybrid_benchmark,
                            base + quant + ["--dp", str(hybrid_dp)]):
            results["hybrid"] = rec
    else:
        report(f"\n### hybrid skipped (needs a device count divisible by "
               f"dp={hybrid_dp} with tp ≥ 2, have {world})")

    # SUMMA's 2-D grid: meaningful on ≥ 2 ranks, and the size must split
    # into whole blocks and panels on the default grid
    from tpu_matmul_bench_torch.parallel.summa import summa_size_ok

    if not want("summa"):
        pass
    elif world > 1 and summa_size_ok(world, size):
        report("\n### summa (2-D grid) " + "#" * 40)
        for rec in run_prog(matmul_summa_benchmark, base + quant):
            results["summa"] = rec
    elif world > 1:
        report(f"\n### summa skipped (size {size} does not split on the "
               f"{world}-device default grid)")
    else:
        report("\n### summa skipped (1 device makes a degenerate 1x1 grid)")

    for mode in ("no_overlap", "overlap", "pipeline", "collective_matmul",
                 "collective_matmul_bidir", "collective_matmul_rs",
                 "collective_matmul_bidir_rs"):
        if not want(mode):
            continue
        report(f"\n### overlap: {mode} " + "#" * 40)
        for rec in run_prog(matmul_overlap_benchmark, base + ["--mode", mode]):
            results[mode] = rec

    # the fused ring keeps every operand in the card's L2, so it runs only
    # where the table's size fits its cap; the HBM rings below carry the
    # full-size ring either way (the CPU has no such cap)
    from tpu_matmul_bench_torch.parallel.overlap import cuda_ring_max_size

    ring_cap = (cuda_ring_max_size(world, dtype, l2, min(ranks_per_card(), world))
                if backend == "cuda" else size)
    if not want("cuda_ring"):
        pass
    elif size <= ring_cap:
        report("\n### overlap: cuda_ring " + "#" * 40)
        for rec in run_prog(matmul_overlap_benchmark, base + ["--mode", "cuda_ring"]):
            results["cuda_ring"] = rec
    else:
        report(f"\n### overlap: cuda_ring skipped — L2-resident cap "
               f"~{ring_cap} < {size}; see cuda_ring_hbm for the "
               f"full-size ring")

    for hbm_mode in HBM_RINGS:
        if not want(hbm_mode):
            continue
        report(f"\n### overlap: {hbm_mode} " + "#" * 36)
        for rec in run_prog(matmul_overlap_benchmark, base + ["--mode", hbm_mode]):
            results[hbm_mode] = rec

    # the dtype sweep on one device ≙ the reference README's bf16-vs-fp32
    # key insight (README.md:50, ~5× on the RTX 6000 Ada)
    for dt in ("float32", "float16", "bfloat16"):
        if not want(f"single_{dt}"):
            continue
        if dt == dtype and "single" in results:
            # the baseline row already measured it; a row --only asked for
            # without 'single' is measured below
            results[f"single_{dt}"] = results["single"]
            continue
        report(f"\n### single-device {dt} " + "#" * 40)
        sweep_args = ["--sizes", str(size), "--dtype", dt,
                      "--iterations", str(iterations), "--warmup", str(warmup),
                      "--precision", precision, "--device", device,
                      "--num-devices", "1"]
        sweep_args += row_args
        for rec in run_prog(matmul_benchmark, sweep_args):
            results[f"single_{dt}"] = rec

    # the strict-fp32 row: --precision highest, true fp32 products
    if want("single_float32_strict"):
        # under --precision highest every fp32 row is already strict
        alias = None
        if precision == "highest":
            alias = results.get("single_float32") or (
                results.get("single") if dtype == "float32" else None)
        if alias is not None:
            report("\n### single_float32_strict = the fp32 row already "
                   "measured (--precision highest makes it strict)")
            results["single_float32_strict"] = alias
        else:
            report("\n### single-device float32 (strict) " + "#" * 33)
            strict_args = ["--sizes", str(size), "--dtype", "float32",
                           "--iterations", str(iterations),
                           "--warmup", str(warmup),
                           "--precision", "highest", "--device", device,
                           "--num-devices", "1"]
            strict_args += row_args
            for rec in run_prog(matmul_benchmark, strict_args):
                results["single_float32_strict"] = rec

    return results


def bf16_vs_fp32_line(results: dict[str, BenchmarkRecord]) -> str | None:
    """The dtype key-insight line ≙ reference README.md:50 (~5x on the RTX
    6000 Ada), shared by the summary and the markdown table."""
    f32 = results.get("single_float32")
    bf16 = results.get("single_bfloat16")
    if not (f32 and bf16 and f32.avg_time_s > 0 and bf16.avg_time_s > 0):
        return None
    line = (f"bf16 vs fp32 speedup: {f32.avg_time_s / bf16.avg_time_s:.2f}x "
            f"(reference observed ~5x on the RTX 6000 Ada, README.md:50)")
    strict = results.get("single_float32_strict")
    if strict and strict.avg_time_s > 0:
        line += (f"; vs strict-fp32 lowering (--precision highest): "
                 f"{strict.avg_time_s / bf16.avg_time_s:.2f}x")
    return line


def summarize(results: dict[str, BenchmarkRecord]) -> str:
    """The comparison summary ≙ reference `compare_benchmarks.py:51-63`,
    computed from the records."""
    lines = ["", "=" * 70, "BENCHMARK COMPARISON SUMMARY", "=" * 70]
    lines.append(f"{'mode':<20}{'total TFLOPS':>14}{'time/op ms':>12}{'comm ms':>10}")
    for name, rec in results.items():
        comm = f"{rec.comm_time_s * 1e3:.2f}" if rec.comm_time_s is not None else "-"
        lines.append(
            f"{name:<20}{rec.tflops_total:>14.2f}{rec.avg_time_s * 1e3:>12.3f}{comm:>10}"
        )

    def t(name: str) -> float | None:
        return results[name].avg_time_s if name in results else None

    lines.append("-" * 70)
    if t("no_overlap") and t("overlap"):
        gain = (t("no_overlap") - t("overlap")) / t("no_overlap") * 100
        lines.append(
            f"Overlap hides {gain:.1f}% of the serialized step time "
            f"({'wins' if gain > 0 else 'no win'} vs no_overlap)"
        )
    if t("pipeline") and t("no_overlap"):
        gain = (t("no_overlap") - t("pipeline")) / t("no_overlap") * 100
        lines.append(f"Pipeline (depth 3) hides {gain:.1f}% of the serialized step time")
    if "independent" in results and "batch_parallel" in results:
        lines.append(
            "Independent mode is the upper bound (no collectives); "
            f"batch_parallel reaches {results['batch_parallel'].tflops_total:.1f} "
            f"of its {results['independent'].tflops_total:.1f} total TFLOPS"
        )
    if "collective_matmul" in results:
        sp = results["collective_matmul"].extras.get("overlap_speedup_x")
        if sp:
            lines.append(f"ppermute collective matmul: {sp}x vs gather-then-matmul")
    if "collective_matmul_bidir" in results and "collective_matmul" in results:
        uni, bi = t("collective_matmul"), t("collective_matmul_bidir")
        if uni and bi:
            gain = (uni - bi) / uni * 100
            lines.append(
                f"Bidirectional ring vs unidirectional: {gain:+.1f}% step "
                "time (expect a win only when the ring is comm-bound — "
                "both ICI directions carry half-chunks)")
    rs, bidir_rs = RING_ROW_KEYS["pallas_ring_rs_hbm"], RING_ROW_KEYS["pallas_ring_bidir_rs_hbm"]
    if bidir_rs in results and rs in results:
        uni, bi = t(rs), t(bidir_rs)
        if uni and bi:
            gain = (uni - bi) / uni * 100
            lines.append(
                f"In-kernel bidirectional RS ring vs unidirectional: "
                f"{gain:+.1f}% step time (same comm-bound caveat)")
    if "summa" in results:
        lines.append(
            f"SUMMA 2-D grid ({results['summa'].extras.get('grid', '?')}): "
            f"{results['summa'].tflops_total:.1f} total TFLOPS with O(1/p) "
            "per-device memory (no full-size matrix anywhere)")
    dtype_line = bf16_vs_fp32_line(results)
    if dtype_line:
        lines.append(dtype_line)
    lines.append("=" * 70)
    return "\n".join(lines)


def render_markdown(results: dict[str, BenchmarkRecord]) -> str:
    """README-style results table ≙ the reference's published table shape
    (`README.md:39-47`): per mode, total TFLOPS, per-device TFLOPS and
    scaling efficiency."""
    size = next(iter(results.values())).size if results else 0
    lines = [
        f"| Mode | Total TFLOPS ({size}x{size}) | TFLOPS/device | Scaling |",
        "|---|---|---|---|",
    ]
    notes = []
    for name, rec in results.items():
        if name.startswith("single_"):
            continue  # the dtype rows have their own line
        scaling = (f"{rec.scaling_efficiency_pct:.0f}%"
                   if rec.scaling_efficiency_pct is not None else "N/A")
        if rec.extras.get("note"):
            notes.append(f"{name}: {rec.extras['note']}")
        lines.append(
            f"| {name} | {rec.tflops_total:.1f} | "
            f"{rec.tflops_per_device:.1f} | {scaling} |"
        )
    dtype_line = bf16_vs_fp32_line(results)
    extra_lines = notes + ([dtype_line] if dtype_line else [])
    protocols = {rec.extras.get("timing", "dispatch") for rec in results.values()}
    if protocols - {"dispatch"}:
        # a fused table says so, and names the rows that ran dispatch
        demoted = [n for n, r in results.items()
                   if r.extras.get("timing", "dispatch") == "dispatch"]
        extra_lines.append(
            "timing protocol: fused (all iterations in one compiled "
            "program)" + (f"; dispatch-demoted rows: {', '.join(demoted)}"
                          if demoted else ""))
    if extra_lines:
        lines.append("")
        lines.extend(extra_lines)
    return "\n".join(lines)


def main(argv: Sequence[str] | None = None) -> dict[str, BenchmarkRecord]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=16384)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "float16", "bfloat16"])
    p.add_argument("--num-devices", type=int, default=None)
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--precision", type=str, default="default",
                   choices=["default", "high", "highest"],
                   help="float32 matmul precision for every row incl. the "
                        "dtype sweep ('high' allows TF32)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Where every row runs (default: cuda). With no CUDA "
                        "device the rows stop unless --device cpu is given.")
    p.add_argument("--comm-quant", type=comm_quant_arg, default=None,
                   metavar="{none,int8,int8-tensor,fp8,int8-block:<B>,"
                           "fp8-block:<B>}",
                   help="quantized-wire collectives for every row whose "
                        "program routes its collective through a wire "
                        "format (scaling, distributed, hybrid, summa)")
    p.add_argument("--timing", type=str, default="dispatch",
                   choices=["dispatch", "fused"],
                   help="timed-loop protocol for every row (fused: all "
                        "iterations in one CUDA graph; the ring-kernel rows "
                        "demote to dispatch and say so in extras)")
    p.add_argument("--validate", action="store_true",
                   help="pass --validate to every row: each record carries "
                        "its corner check against a float64 reference")
    p.add_argument("--json-out", type=str, default=None,
                   help="write the comparison table as JSON lines")
    p.add_argument("--markdown-out", type=str, default=None,
                   help="write the README-style results table here "
                        "(the reference table shape, README.md:39-47)")
    p.add_argument("--isolate", action="store_true",
                   help="run each row in a child process reading its "
                        "--json-out records (a failed or hung row is left "
                        "out; the others still run)")
    p.add_argument("--mode-timeout", type=float, default=900.0,
                   help="per-row timeout (seconds) under --isolate; a child "
                        "past it is killed")
    p.add_argument("--only", type=str, default=None,
                   help="comma-separated row keys to run (e.g. "
                        "'single,overlap,single_float32_strict')")
    p.add_argument("--trace-out", type=str, default=None,
                   help="write a Chrome-trace span timeline of the whole "
                        "table run (one span per row; '-' = stdout)")
    args = p.parse_args(argv)

    from tpu_matmul_bench_torch.utils.reporting import (
        force_reporting_process,
        reporting_process_override,
    )

    prev = reporting_process_override()
    try:
        # under --isolate the parent is the reporting process for its own
        # report() calls in _finish too (compare() scopes its override)
        if args.isolate:
            force_reporting_process(True)
        with telemetry.session(args.trace_out):
            results = compare(args.size, args.dtype, args.num_devices,
                              args.iterations, args.warmup,
                              precision=args.precision,
                              isolate=args.isolate,
                              mode_timeout=args.mode_timeout,
                              only=(set(args.only.split(","))
                                    if args.only else None),
                              comm_quant=args.comm_quant,
                              timing=args.timing,
                              device=args.device,
                              validate=args.validate)
            return _finish(args, results)
    finally:
        force_reporting_process(prev)


def _finish(args, results: dict[str, BenchmarkRecord]):
    report(summarize(results))
    if args.markdown_out:
        with open(args.markdown_out, "w") as fh:
            fh.write(render_markdown(results) + "\n")
    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(json.dumps(telemetry.build_manifest(),
                                sort_keys=True) + "\n")
            for name, rec in results.items():
                fh.write(json.dumps({"comparison_key": name,
                                     **json.loads(rec.to_json())}) + "\n")
    if not results:
        # a table with no measured row is a failed run, not a result
        report("[compare] no rows measured — exiting 4")
        raise SystemExit(4)
    return results


if __name__ == "__main__":
    main()
