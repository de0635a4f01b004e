"""`python -m tpu_matmul_bench_torch parallel {stream, hier selftest}`.

Port of `tpu_matmul_bench/parallel/cli.py`:

- `stream`: the out-of-core K-streaming benchmark (parallel/stream_k.py):
  host-resident operands, a bounded device window, the MEM-003 gate before
  any allocation. The shared benchmark flags plus `--stream-k` (panels),
  `--mem-budget-gib` and `--mesh`.
- `hier selftest`: JAX's certification reads its jaxpr inventory auditor
  (`analysis/auditor.py`), which has no torch form; it is refused by name
  until ROADMAP A15.
"""

from __future__ import annotations

import sys
from typing import Sequence

_USAGE = ("usage: python -m tpu_matmul_bench_torch parallel {stream,hier} ...\n"
          "  stream        out-of-core K-streaming benchmark "
          "(--stream-k, --mem-budget-gib)\n"
          "  hier selftest not ported: waits for ROADMAP A15")


def _stream_main(argv: Sequence[str]) -> list:
    from tpu_matmul_bench_torch.benchmarks.runner import run_sizes
    from tpu_matmul_bench_torch.parallel.mesh import make_factorized_mesh, make_mesh
    from tpu_matmul_bench_torch.parallel.stream_k import stream_benchmark
    from tpu_matmul_bench_torch.utils import telemetry
    from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args
    from tpu_matmul_bench_torch.utils.device import (
        collect_device_info,
        device_banner,
        resolve_devices,
    )
    from tpu_matmul_bench_torch.utils.reporting import header, report

    parser = build_parser(
        "Out-of-core K-streaming matmul benchmark (parallel/stream_k.py).",
        extra_dtypes=("int8",), fused_timing=False, best_of=False, mesh=True,
        stream=True)
    config = config_from_args(parser.parse_args(list(argv)))

    devices = resolve_devices(config.device, config.num_devices)
    info = collect_device_info(devices)
    mesh = (make_factorized_mesh(devices, config.mesh) if config.mesh
            else make_mesh(devices))
    report(device_banner(info))
    report(header(
        "Out-of-core K-streaming Benchmark",
        {
            "Mesh": " x ".join(f"{mesh.shape[ax]} ({ax})" for ax in mesh.axis_names),
            "K panels": config.stream_k or "default",
            "Memory budget": (f"{config.mem_budget_gib:g} GiB"
                              if config.mem_budget_gib is not None
                              else "the device's memory (default)"),
            "Data type": config.dtype_name,
            "Iterations per test": config.iterations,
        },
    ))

    with telemetry.session(config.trace_out):
        # no memory guard on purpose: the runner's own MEM-003 gate is the
        # admission check, and the in-core estimate would reject exactly
        # the shapes this program exists to run
        records = run_sizes(config, lambda s: stream_benchmark(config, mesh, s))
    report("\n" + "=" * 70, "Benchmark completed!", "=" * 70)
    return records


def main(argv: Sequence[str] | None = None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "stream" in argv and (not argv or argv[0] != "hier"):
        # the subcommand may stand anywhere among the flags, as in JAX
        argv.remove("stream")
        return _stream_main(argv)
    if argv and argv[0] == "hier":
        if argv[1:2] == ["selftest"]:
            raise SystemExit(
                "parallel hier selftest: not ported; JAX's certification reads "
                "its jaxpr inventory auditor, which has no torch form "
                "(waits for ROADMAP A15)")
        print(_USAGE, file=sys.stderr)
        raise SystemExit(2)
    is_help = bool(argv) and argv[0] in ("-h", "--help")
    print(_USAGE, file=sys.stdout if is_help else sys.stderr)
    raise SystemExit(0 if is_help else 2)


if __name__ == "__main__":
    main()
