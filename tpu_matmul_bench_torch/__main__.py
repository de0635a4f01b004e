"""Top-level CLI: `python -m tpu_matmul_bench_torch <program> [flags]`.

Port of `tpu_matmul_bench/__main__.py`: one entry point over the port's
programs; everything after the program name goes to that program.
"""

from __future__ import annotations

import importlib
import sys

_PROGRAMS = {
    "matmul": "tpu_matmul_bench_torch.benchmarks.matmul_benchmark",
    # the tuning database's front end, `tune {show,prune,promote,selftest}`
    # (tune/cli.py); flag-style invocations fall through to the kernel tile
    # sweep, and with --ring the HBM rings' (benchmarks/cuda_tune.py)
    "tune": "tpu_matmul_bench_torch.tune.cli",
    # the parallel modes over a world of ranks, with a scaling efficiency
    "scaling": "tpu_matmul_bench_torch.benchmarks.matmul_scaling_benchmark",
    "distributed": "tpu_matmul_bench_torch.benchmarks.matmul_distributed_benchmark",
    # the ring matmuls against their baselines over a world of ranks
    "overlap": "tpu_matmul_bench_torch.benchmarks.matmul_overlap_benchmark",
    # bandwidth per collective op over the ranks, and `collectives
    # selftest`, the wire formats' numeric selftest
    "collectives": "tpu_matmul_bench_torch.benchmarks.collective_benchmark",
    # the 2-D modes over a (dp, tp), (i, j) or --mesh dcn:R,ici:C mesh
    "hybrid": "tpu_matmul_bench_torch.benchmarks.matmul_hybrid_benchmark",
    "summa": "tpu_matmul_bench_torch.benchmarks.matmul_summa_benchmark",
    # `parallel stream`, the out-of-core K-streaming benchmark
    "parallel": "tpu_matmul_bench_torch.parallel.cli",
    # one mode swept over rank counts: the README-style scaling table
    "curve": "tpu_matmul_bench_torch.benchmarks.scaling_curve",
    # STREAM-style device-memory bandwidth (GB/s against the datasheet)
    "membw": "tpu_matmul_bench_torch.benchmarks.membw_benchmark",
    # the staged device-health probe: exit 0 healthy, 3 degraded, 1 failed
    "doctor": "tpu_matmul_bench_torch.benchmarks.doctor",
    # the comparison driver: every row program, one table
    "compare": "tpu_matmul_bench_torch.benchmarks.compare_benchmarks",
    # the training-step workload: one optimizer step (local fwd/bwd,
    # gradient sync via --grad-quant, ZeRO-style sharded update via
    # --zero) with per-phase timing (`train bench`), and `train selftest`
    "train": "tpu_matmul_bench_torch.train.cli",
    # matmul as a service under load: `serve {bench,ab,selftest,explain,
    # trace selftest}` (serve/cli.py)
    "serve": "tpu_matmul_bench_torch.serve.cli",
    # declarative sweeps over the programs above, resumable at job
    # granularity, with a noise-aware regression gate: `campaign
    # {run,resume,status,gate}` (campaign/cli.py)
    "campaign": "tpu_matmul_bench_torch.campaign.cli",
    # fault injection and crash-consistency certification: `faults
    # {run,audit,selftest}` (faults/cli.py)
    "faults": "tpu_matmul_bench_torch.faults.cli",
    # the perf observatory: live snapshots, the bus selftest, and the
    # metric-history store with its drift verdicts and report: `obs
    # {status,selftest,ingest,history,detect,report}` (obs/cli.py)
    "obs": "tpu_matmul_bench_torch.obs.cli",
    # the contract auditor: every impl x mode run once and recorded against
    # the comms model and its dtype, purity, reuse and tile contracts, plus
    # offline spec validation (analysis/cli.py)
    "lint": "tpu_matmul_bench_torch.analysis.cli",
}


def main(argv: list[str] | None = None, _cli: bool = False):
    """Dispatch to a program's main(); returns its records list. `_cli`
    marks a real process entry, where `doctor` takes its hard-exit path;
    in-process callers (tests) get normal return and SystemExit."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in _PROGRAMS:
        is_help = bool(argv) and argv[0] in ("-h", "--help")
        names = ", ".join(_PROGRAMS)
        print(f"usage: python -m tpu_matmul_bench_torch {{{names}}} [flags]\n"
              f"Per-program flags: add --help after the program name.",
              file=sys.stdout if is_help else sys.stderr)
        raise SystemExit(0 if is_help else 2)
    module = importlib.import_module(_PROGRAMS[argv[0]])
    if argv[0] == "doctor" and _cli:
        module.cli_main(argv[1:])
    return module.main(argv[1:])


if __name__ == "__main__":
    main(_cli=True)
