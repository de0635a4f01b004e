"""Top-level CLI: `python -m tpu_matmul_bench_torch <program> [flags]`.

Port of `tpu_matmul_bench/__main__.py`: one entry point over the port's
programs; everything after the program name goes to that program.
"""

from __future__ import annotations

import importlib
import sys

_PROGRAMS = {
    "matmul": "tpu_matmul_bench_torch.benchmarks.matmul_benchmark",
    # the kernel tile sweep, and with --ring the HBM rings' (benchmarks/
    # cuda_tune.py); the tuning-database subcommands fail by name (A12)
    "tune": "tpu_matmul_bench_torch.benchmarks.cuda_tune",
    # the parallel modes over a world of ranks, with a scaling efficiency
    "scaling": "tpu_matmul_bench_torch.benchmarks.matmul_scaling_benchmark",
    "distributed": "tpu_matmul_bench_torch.benchmarks.matmul_distributed_benchmark",
    # the ring matmuls against their baselines over a world of ranks
    "overlap": "tpu_matmul_bench_torch.benchmarks.matmul_overlap_benchmark",
    # bandwidth per collective op over the ranks, and `collectives
    # selftest`, the wire formats' numeric selftest
    "collectives": "tpu_matmul_bench_torch.benchmarks.collective_benchmark",
}


def main(argv: list[str] | None = None):
    """Dispatch to a program's main(); returns its records list."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in _PROGRAMS:
        is_help = bool(argv) and argv[0] in ("-h", "--help")
        names = ", ".join(_PROGRAMS)
        print(f"usage: python -m tpu_matmul_bench_torch {{{names}}} [flags]\n"
              f"Per-program flags: add --help after the program name.",
              file=sys.stdout if is_help else sys.stderr)
        raise SystemExit(0 if is_help else 2)
    return importlib.import_module(_PROGRAMS[argv[0]]).main(argv[1:])


if __name__ == "__main__":
    main()
