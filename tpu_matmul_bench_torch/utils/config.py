"""CLI config: one argparse module for the port's programs.

Port of `tpu_matmul_bench/utils/config.py` for the flags the port's
programs consume: the reference's --sizes (default 4096 8192 16384),
--iterations (50), --warmup (10) and --dtype (default bfloat16, plus int8),
and the benchmark's --mode --device --num-devices --json-out --matmul-impl
--seed --validate --precision --trace-out --samples --percentiles --repeats
--timing --block-m/n/k --wres --profile-dir --comm-quant. `--repeats` and
`--timing` are offered only to programs whose timed loop reads them
(`best_of`, `fused_timing`), `--mode` and `--profile-dir` only to the mode
programs (scaling, distributed, overlap, collectives), whose runners read
them, `--wres` only to those whose modes run the ring kernels (`wres`), and
`--comm-quant` only to those whose modes route a collective through a wire
format (scaling, distributed: `comm_quant`). The JAX package's flags that no
program of the port consumes yet are left out rather than accepted and
ignored.
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
    # kernel tile request (None → the kernel's default tile); ignored by
    # --matmul-impl torch
    block_m: int | None = None
    block_n: int | None = None
    block_k: int | None = None
    # the benchmark mode of a program with several (overlap)
    mode: str | None = None
    # the ring kernels' W-resident mode: auto, on (error when it cannot
    # engage), off; the port has no W-resident kernel (ops/cuda_ring.py)
    wres: str = "auto"
    # torch.profiler trace of the run (utils/profiling.py maybe_trace)
    profile_dir: str | None = None
    # wire format of the modes' collectives (parallel/collectives.py):
    # None/"none" exact; int8 formats and fp8 formats quantize the payload
    comm_quant: str | None = None

    @property
    def wres_override(self) -> bool | None:
        """--wres as the ring builders' tri-state kwarg (see
        ops/cuda_ring.py resolve_wres)."""
        return {"auto": None, "on": True, "off": False}[self.wres]

    @property
    def dtype(self) -> torch.dtype:
        return parse_dtype(self.dtype_name)

    @property
    def blocks(self) -> tuple[int, int, int] | None:
        """(bm, bn, bk) when any block flag is set; unset dimensions come
        from the kernel's default tile (ops/cuda_matmul.py DEFAULT_TILE)."""
        given = (self.block_m, self.block_n, self.block_k)
        if all(v is None for v in given):
            return None
        if any(v is not None and v <= 0 for v in given):
            raise ValueError(f"block sizes must be positive, got {given}")
        from tpu_matmul_bench_torch.ops.cuda_matmul import DEFAULT_TILE

        return tuple(d if v is None else v for v, d in zip(given, DEFAULT_TILE))


def comm_quant_arg(value: str) -> str:
    """argparse type for --comm-quant: validate against the wire-format
    grammar, uniform (none | int8 | int8-tensor | fp8 | int8-block:<B> |
    fp8-block:<B>) or per-link (dcn=<fmt>,ici=<fmt>), at parse time, keeping
    the raw string as the config value (parallel/collectives.py parses it
    again where it is used)."""
    from tpu_matmul_bench_torch.parallel.collectives import validate_comm_quant

    try:
        validate_comm_quant(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))
    return value


def build_parser(description: str,
                 extra_dtypes: Sequence[str] = (),
                 modes: Sequence[str] | None = None,
                 default_mode: str | None = None,
                 fused_timing: bool = True,
                 best_of: bool = True,
                 wres: bool = True,
                 comm_quant: bool = False) -> argparse.ArgumentParser:
    """The shared parser. `modes` adds --mode (default `default_mode`, else
    the first) and --profile-dir, which the mode programs' runners read,
    and with `wres` --wres, which their ring kernels read; `comm_quant`
    adds --comm-quant, for the programs whose modes read it; `best_of` adds
    --repeats and `fused_timing` adds --timing, for the programs whose
    timed loop reads them."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument(
        "--sizes", type=int, nargs="+", default=list(DEFAULT_SIZES),
        help=f"Matrix sizes to benchmark (default: {DEFAULT_SIZES})",
    )
    if modes:
        default = default_mode or modes[0]
        p.add_argument(
            "--mode", type=str, default=default, choices=list(modes),
            help=f"Benchmark mode (default: {default})",
        )
        if wres:
            p.add_argument(
                "--wres", type=str, default="auto", choices=["auto", "on", "off"],
                help="W-resident mode of the ring kernels. The port has no "
                     "W-resident kernel (a W shard is far larger than a "
                     "block's shared memory): auto and off stream W from "
                     "device memory and the record says why; on is an error.",
            )
        p.add_argument(
            "--profile-dir", type=str, default=None,
            help="Write a torch.profiler trace of the benchmark here (Chrome "
                 "trace: host operations, and the card's kernels when the "
                 "ranks are on a card; view with Perfetto). The reference's "
                 "nearest analogue is NCCL_DEBUG=INFO (run_benchmark.sh:16-17).",
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
        help="Number of ranks (default: every place there is). Ranks fill "
             "each device in turn, TMB_RANKS_PER_CARD (default 1) to a "
             "device, all in one process (parallel/mesh.py).",
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
    if comm_quant:
        p.add_argument(
            "--comm-quant", type=comm_quant_arg, default=None,
            metavar="{none,int8,int8-tensor,fp8,int8-block:<B>,fp8-block:<B>}",
            help="Wire format for the collectives (parallel/collectives.py): "
                 "quantized payloads + fp32 scale side-channel over the ring "
                 "— half the bf16 wire bytes at a bounded relative error. "
                 "'int8'/'int8-tensor' select the legacy per-row control tier "
                 "(parallel/quantized.py); 'fp8' is per-row float8_e4m3fn; "
                 "'int8-block:<B>'/'fp8-block:<B>' quantize per B-column "
                 "block with one fp32 scale each. Applies to every "
                 "distributed mode's psum/all_gather leg. The per-link form "
                 "'dcn=<fmt>,ici=<fmt>' picks a format per link class; the "
                 "port's world is flat, so its one axis takes the ici entry "
                 "(unnamed links stay exact). Ranks that share a card move "
                 "the payloads within its memory: there the wire saves no "
                 "time.",
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
    if best_of:
        p.add_argument(
            "--repeats", type=int, default=1,
            help="Best-of-N: repeat the whole timed loop N times and report "
                 "the fastest (default: 1).",
        )
    if fused_timing:
        p.add_argument(
            "--timing", type=str, default="dispatch",
            choices=["dispatch", "fused"],
            help="Timed-loop protocol: 'dispatch' launches each iteration "
                 "from the host between two CUDA events; 'fused' captures "
                 "all iterations, chained through their operands, in one "
                 "CUDA graph, so host launch overhead cannot cap the "
                 "measurement.",
        )
    for dim in "mnk":
        p.add_argument(
            f"--block-{dim}", type=int, default=None,
            help=f"Kernel tile along {dim} for --matmul-impl cuda (default: "
                 "the default tile 128x256x64; a request resolves to an "
                 "instantiated tile, ops/cuda_matmul.py effective_blocks). "
                 "Ignored by --matmul-impl torch. Tune with the 'tune' "
                 "program.",
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
        timing=getattr(args, "timing", "dispatch"),
        repeats=getattr(args, "repeats", 1),
        block_m=args.block_m,
        block_n=args.block_n,
        block_k=args.block_k,
        mode=getattr(args, "mode", None),
        wres=getattr(args, "wres", "auto"),
        profile_dir=getattr(args, "profile_dir", None),
        comm_quant=getattr(args, "comm_quant", None),
    )


def parse_config(
    argv: Sequence[str] | None,
    description: str,
    modes: Sequence[str] | None = None,
    default_mode: str | None = None,
    extra_dtypes: Sequence[str] = (),
    fused_timing: bool = False,
    best_of: bool = False,
    wres: bool = True,
    comm_quant: bool = False,
) -> BenchConfig:
    """Parse a mode program's argv, as the JAX package's `parse_config`."""
    parser = build_parser(description, extra_dtypes=extra_dtypes, modes=modes,
                          default_mode=default_mode, fused_timing=fused_timing,
                          best_of=best_of, wres=wres, comm_quant=comm_quant)
    return config_from_args(parser.parse_args(argv))

