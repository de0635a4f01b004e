"""CLI config: one argparse module for the port's programs.

Port of `tpu_matmul_bench/utils/config.py` for the flags the matmul
program consumes: the reference's --sizes (default 4096 8192 16384),
--iterations (50), --warmup (10) and --dtype (default bfloat16, plus int8),
and the benchmark's --device --num-devices --json-out --matmul-impl --seed
--validate --precision --trace-out --samples --percentiles --repeats
--timing. The JAX package's flags that no program of the port consumes yet
are left out rather than accepted and ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Sequence

import torch

DEFAULT_SIZES = [4096, 8192, 16384]
DTYPE_CHOICES = ["float32", "float16", "bfloat16"]

_DTYPE_MAP = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    # offered where a program opts in via build_parser(extra_dtypes=...)
    "int8": torch.int8,
}


def parse_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPE_MAP[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; choose from {list(_DTYPE_MAP)}")


@dataclasses.dataclass
class BenchConfig:
    """Parsed benchmark configuration."""

    sizes: list[int]
    iterations: int
    warmup: int
    dtype_name: str
    device: str
    num_devices: int | None
    json_out: str | None
    matmul_impl: str
    seed: int
    # span timeline: Chrome-trace JSON of nested phase timers
    trace_out: str | None = None
    # per-iteration sampling into record extras["samples"]
    samples: bool = False
    percentiles: bool = False
    validate: bool = False
    # float32 matmul precision: "default"/"highest" keep true fp32, "high"
    # allows TF32 (utils/device.py apply_matmul_precision)
    precision: str = "default"
    # timed-loop protocol: "dispatch" = N launches between two CUDA events;
    # "fused" = N chained launches captured in one CUDA graph
    timing: str = "dispatch"
    # best-of-N repeats of the whole timed loop
    repeats: int = 1

    @property
    def dtype(self) -> torch.dtype:
        return parse_dtype(self.dtype_name)


def build_parser(description: str,
                 extra_dtypes: Sequence[str] = ()) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument(
        "--sizes", type=int, nargs="+", default=list(DEFAULT_SIZES),
        help=f"Matrix sizes to benchmark (default: {DEFAULT_SIZES})",
    )
    p.add_argument(
        "--iterations", type=int, default=50,
        help="Number of timed iterations per benchmark (default: 50)",
    )
    p.add_argument(
        "--warmup", type=int, default=10,
        help="Warmup iterations (absorb kernel build and library "
             "autotuning; default: 10)",
    )
    p.add_argument(
        "--dtype", type=str, default="bfloat16",
        choices=list(DTYPE_CHOICES) + list(extra_dtypes),
        help="Matrix dtype (default: bfloat16)",
    )
    p.add_argument(
        "--device", type=str, default="cuda", choices=["cuda", "cpu"],
        help="Where to run (default: cuda). With no CUDA device the "
             "program stops unless --device cpu is given.",
    )
    p.add_argument(
        "--num-devices", type=int, default=None,
        help="Number of devices (the port runs on one device so far)",
    )
    p.add_argument(
        "--json-out", type=str, default=None,
        help="Write JSON-lines results here ('-' for stdout)",
    )
    p.add_argument(
        "--matmul-impl", type=str, default="auto",
        choices=["auto", "torch", "cuda"],
        help="Matmul implementation: 'torch' is the library product "
             "(torch.matmul; torch._int_mm for int8 on the card), 'cuda' "
             "the hand-written kernel (csrc/matmul.cu), 'auto' (default) "
             "routes each (dtype, shape) by ops/impl_select.py.",
    )
    p.add_argument("--seed", type=int, default=0, help="Seed for operand data")
    p.add_argument(
        "--validate", action="store_true",
        help="Corner-check the result against a float64 reference before "
             "the timed run, reporting the verdict in record extras",
    )
    p.add_argument(
        "--precision", type=str, default="default",
        choices=["default", "high", "highest"],
        help="float32 matmul precision: 'default' and 'highest' keep true "
             "fp32, 'high' allows TF32 (torch.set_float32_matmul_precision).",
    )
    p.add_argument(
        "--trace-out", type=str, default=None,
        help="Write a Chrome-trace-format span timeline here ('-' for "
             "stdout), plus a stdout phase summary (utils/telemetry.py).",
    )
    p.add_argument(
        "--samples", action="store_true",
        help="Record each timed iteration's time (individually synced) and "
             "attach p50/p95/p99, stddev and a warmup-drift flag to record "
             "extras['samples'].",
    )
    p.add_argument(
        "--percentiles", action="store_true",
        help="Also measure per-iteration latency percentiles (p50/p90/p99)",
    )
    p.add_argument(
        "--repeats", type=int, default=1,
        help="Best-of-N: repeat the whole timed loop N times and report "
             "the fastest (default: 1).",
    )
    p.add_argument(
        "--timing", type=str, default="dispatch",
        choices=["dispatch", "fused"],
        help="Timed-loop protocol: 'dispatch' launches each iteration from "
             "the host between two CUDA events; 'fused' captures all "
             "iterations, chained through their operands, in one CUDA "
             "graph, so host launch overhead cannot cap the measurement.",
    )
    return p


def config_from_args(args: argparse.Namespace) -> BenchConfig:
    return BenchConfig(
        sizes=list(args.sizes),
        iterations=args.iterations,
        warmup=args.warmup,
        dtype_name=args.dtype,
        device=args.device,
        num_devices=args.num_devices,
        json_out=args.json_out,
        matmul_impl=args.matmul_impl,
        seed=args.seed,
        trace_out=args.trace_out,
        samples=args.samples,
        percentiles=args.percentiles,
        validate=args.validate,
        precision=args.precision,
        timing=args.timing,
        repeats=args.repeats,
    )

