"""Device-memory bandwidth microbenchmark, STREAM-style, on one device.

Port of `tpu_matmul_bench/benchmarks/membw_benchmark.py`. The roofline on
matmul records divides by the card's memory rate (`utils/metrics.py
hbm_bandwidth_gbps`); this program measures the rate the card sustains:
the STREAM kernels copy, scale, add and triad plus a reduction, timed by
the shared engine, reported as GB/s with the share of the datasheet rate
in extras. The reference never measures memory bandwidth.

Each op is one library call that passes over memory once, writing into an
output made before the timed loop, so that the byte model (`STREAM_OPS`:
the arrays each op reads and writes) is what the card moves:

- copy:  `out.copy_(a)`                          read a, write out;
- scale: `torch.mul(a, s, out=out)`               read a, write out;
- add:   `torch.add(a, b, out=out)`               read a and b, write out;
- triad: `torch.add(a, b, alpha=s, out=out)`      read a and b, write out;
- dot:   `torch.dot(a, b, out=scalar)` over the flat arrays (one fused
  multiply-reduce; no product array)              read a and b.

The scalar s is a Python number, as eager PyTorch folds nothing away: a
0-d tensor on the card would take the broadcast path of the elementwise
kernels, which on an H100 ran scale at half the rate of copy.

These are library elementwise calls, as the JAX package's are XLA
fusions; no Pallas kernel lies here. Operands come from an explicit
`torch.Generator` seeded with --seed.

Run: python -m tpu_matmul_bench_torch membw [--sizes 8192 16384] [--mode triad]
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from tpu_matmul_bench_torch.benchmarks.runner import run_sizes
from tpu_matmul_bench_torch.ops.matmul import random_operands
from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.config import BenchConfig, parse_config
from tpu_matmul_bench_torch.utils.device import (
    collect_device_info,
    device_banner,
    resolve_devices,
)
from tpu_matmul_bench_torch.utils.metrics import bytes_per_element, hbm_spec_gbps
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
    sample_extras,
)

SCALAR = 1.0001

# STREAM convention: name -> (op(a, b, out), arrays of n² elements each
# call reads and writes). `out` is an n×n array for the elementwise ops and
# a 0-d one for dot.
STREAM_OPS: dict[str, tuple[Callable, int]] = {
    "copy": (lambda a, b, out: out.copy_(a), 2),
    "scale": (lambda a, b, out: torch.mul(a, SCALAR, out=out), 2),
    "add": (lambda a, b, out: torch.add(a, b, out=out), 3),
    "triad": (lambda a, b, out: torch.add(a, b, alpha=SCALAR, out=out), 3),
    "dot": (lambda a, b, out: torch.dot(a.view(-1), b.view(-1), out=out), 2),
}


def bench_membw(config: BenchConfig, size: int, op: str,
                device: torch.device, device_kind: str) -> BenchmarkRecord:
    fn, bytes_factor = STREAM_OPS[op]
    a, b = random_operands(config.seed, (size, size), config.dtype, device=device)
    out = torch.empty((), dtype=config.dtype, device=device) if op == "dot" \
        else torch.empty_like(a)
    operands = (a, b, out)
    t = choose_timer(config.timing)(fn, operands, iterations=config.iterations,
                                    warmup=config.warmup)
    moved = bytes_factor * size * size * bytes_per_element(config.dtype)
    gbps = moved / t.avg_s / 1e9
    spec = hbm_spec_gbps(device_kind)
    rec = BenchmarkRecord(
        benchmark="membw",
        mode=op,
        size=size,
        dtype=config.dtype_name,
        world=1,
        iterations=t.iterations,
        warmup=effective_warmup(config.timing, config.iterations, config.warmup),
        avg_time_s=t.avg_s,
        tflops_per_device=0.0,  # not a FLOP benchmark
        tflops_total=0.0,
        device_kind=device_kind,
        bytes_per_device=moved,
        algbw_gbps=gbps,
        extras={"stream_op": op, "bytes_factor": bytes_factor,
                **protocol_extras(config.timing, t)},
    )
    if spec:
        # the datasheet, never the measured table: this program is what
        # fills that table (utils/metrics.py _MEASURED_HBM_GBPS)
        rec.extras["pct_of_spec_hbm_bw"] = round(100.0 * gbps / spec, 1)
    if config.samples:
        rec.extras["samples"] = sample_extras(fn, operands, config)
    return rec


def main(argv: Sequence[str] | None = None) -> list[BenchmarkRecord]:
    config = parse_config(
        argv,
        description=__doc__ or "memory bandwidth benchmark",
        modes=list(STREAM_OPS) + ["all"],
        default_mode="all",
        fused_timing=True,
        wres=False,
    )
    devices = resolve_devices(config.device, 1)
    device = devices[0]
    info = collect_device_info(devices)
    report(device_banner(info))
    ops = list(STREAM_OPS) if config.mode == "all" else [config.mode]
    report(header(
        "Device Memory Bandwidth Microbenchmark (STREAM-style)",
        {
            "Ops": ", ".join(ops),
            "Sizes": config.sizes,
            "Data type": config.dtype_name,
            "Iterations per test": config.iterations,
        },
    ))

    records: list[BenchmarkRecord] = []
    # run_sizes opens config.json_out in "w" mode per call, so the per-op
    # calls run with it cleared and this driver writes the one file
    sub = dataclasses.replace(config, json_out=None)
    item = bytes_per_element(config.dtype)
    with telemetry.session(config.trace_out), \
            maybe_trace(config.profile_dir, cuda=info.platform == "cuda"):
        for op in ops:
            report(f"\n### membw: {op} " + "#" * 40)
            with telemetry.span(f"mode:{op}", mode=op):
                records += run_sizes(
                    sub, lambda size, _op=op: bench_membw(config, size, _op, device,
                                                          info.device_kind),
                    memory_gib=lambda s: 3 * s * s * item / 2**30,
                    memory_limit_gib=info.memory_gib,
                )
    manifest = telemetry.build_manifest(config) if config.json_out else None
    with JsonWriter(config.json_out, manifest=manifest) as jw:
        for rec in records:
            jw.write(rec)
    report("\n" + "=" * 70, "Benchmark completed!", "=" * 70)
    if len(records) != len(ops) * len(config.sizes):
        # the runner reported each failed (op, size); a table with a hole
        # is no result
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
