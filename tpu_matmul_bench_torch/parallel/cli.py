"""`python -m tpu_matmul_bench_torch parallel {stream, hier selftest}`.

Port of `tpu_matmul_bench/parallel/cli.py`:

- `stream`: the out-of-core K-streaming benchmark (parallel/stream_k.py):
  host-resident operands, a bounded device window, the MEM-003 gate before
  any allocation. The shared benchmark flags plus `--stream-k` (panels),
  `--mem-budget-gib` and `--mesh`.
- `hier selftest`: the two-level mesh's certification, in three parts: the
  COLL-H audit (`analysis/auditor.py audit_hier`: each 2-D mode run and
  recorded at both transposed factorizations, exact and per-link
  quantized), the MEM-003 gate both ways, and a streamed product at 256 on
  `dcn:2,ici:4` within 1e-5 (relative) of the float64 reference. It runs
  on the card unless `--device cpu` is given (its 8 ranks share the
  device: the program sets `TMB_RANKS_PER_CARD` to 8 when it is unset),
  and the stream's panel products there are K1's pickups.
"""

from __future__ import annotations

import sys
from typing import Sequence

_USAGE = ("usage: python -m tpu_matmul_bench_torch parallel {stream,hier} ...\n"
          "  stream        out-of-core K-streaming benchmark "
          "(--stream-k, --mem-budget-gib)\n"
          "  hier selftest two-level inventory-vs-model certification (--device)")


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


def _hier_selftest(argv: Sequence[str]) -> list:
    import argparse

    parser = argparse.ArgumentParser(
        prog="parallel hier selftest",
        description="two-level inventory-vs-model certification")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress per-finding lines")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the audited programs and the stream run "
                             "(default: the card)")
    args = parser.parse_args(list(argv))

    from tpu_matmul_bench_torch.analysis.auditor import (
        HIER_FACTORIZATIONS,
        audit_devices,
        audit_hier,
    )
    from tpu_matmul_bench_torch.analysis.cli import audit_ranks
    from tpu_matmul_bench_torch.analysis.memory_model import check_stream_budget
    from tpu_matmul_bench_torch.ops.stream_k import StreamPlan, stage_host, stream_matmul
    from tpu_matmul_bench_torch.parallel.mesh import gather, make_factorized_mesh
    from tpu_matmul_bench_torch.parallel.stream_k import _expected_corner_host, host_operands
    from tpu_matmul_bench_torch.utils.config import BenchConfig

    failures: list[str] = []
    with audit_ranks():
        try:
            devices = audit_devices(args.device)
        except (RuntimeError, ValueError) as e:
            raise SystemExit(f"parallel hier selftest: {e}") from None
        # 1) COLL-H-*: recorded per-axis inventories vs the two-level model
        #    at two transposed factorizations (exact + per-link quantized)
        findings = audit_hier(devices)
    for f in findings:
        if not args.quiet:
            print(f"[{f.severity:5s}] {f.rule} {f.where}: {f.message}")
        if f.severity == "error":
            failures.append(f"{f.rule} {f.where}")
    print(f"hier inventory: {len(findings)} finding(s) across "
          f"{', '.join(HIER_FACTORIZATIONS)}")

    # 2) the MEM gate, both directions: an over-budget window must trip
    #    MEM-003; a fitting one must certify clean
    over = check_stream_budget(4096, "bfloat16", 8, panels=4, window=2, budget_gib=0.001)
    if [f.rule for f in over] != ["MEM-003"]:
        failures.append(f"over-budget stream case did not MEM-gate (got "
                        f"{[f.rule for f in over]})")
    fits = check_stream_budget(1024, "bfloat16", 8, panels=8, window=2, budget_gib=1.0)
    if fits:
        failures.append(f"in-budget stream plan failed certification: "
                        f"{[f.rule for f in fits]}")
    print(f"mem gate: over-budget -> {[f.rule for f in over]}, in-budget -> clean"
          if not fits else "mem gate: BROKEN")

    # 3) a small streamed product on a factorized mesh must be right (the
    #    gate certifies the window; this certifies the arithmetic behind it)
    config = BenchConfig(sizes=[256], iterations=1, warmup=0, dtype_name="float32",
                         device=args.device, num_devices=None, json_out=None,
                         matmul_impl="cuda", seed=0)
    mesh = make_factorized_mesh(devices[:8], "dcn:2,ici:4")
    plan = StreamPlan(size=256, panels=8, window=2, world=8)
    a, b = host_operands(config, 256)
    host = stage_host(a, b, plan, pin=args.device == "cuda")
    got = gather(stream_matmul(host, mesh, config.matmul_impl), "cpu").double()
    exp = _expected_corner_host(a, b, corner=256)
    err = float((got - exp).abs().max()) / (float(exp.abs().max()) or 1.0)
    if err > 1e-5:
        failures.append(f"streamed matmul corner error {err:.2e} > 1e-5")
    print(f"stream numerics: max rel err {err:.2e} on dcn:2,ici:4")

    if failures:
        print(f"hier selftest: FAILED ({len(failures)} problem(s))")
        for msg in failures:
            print(f"  - {msg}")
        raise SystemExit(1)
    print("hier selftest: OK")
    return [f.to_record() for f in findings]


def main(argv: Sequence[str] | None = None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "stream" in argv and (not argv or argv[0] != "hier"):
        # the subcommand may stand anywhere among the flags, as in JAX
        argv.remove("stream")
        return _stream_main(argv)
    if argv and argv[0] == "hier":
        if argv[1:2] == ["selftest"]:
            return _hier_selftest(argv[2:])
        print(_USAGE, file=sys.stderr)
        raise SystemExit(2)
    is_help = bool(argv) and argv[0] in ("-h", "--help")
    print(_USAGE, file=sys.stdout if is_help else sys.stderr)
    raise SystemExit(0 if is_help else 2)


if __name__ == "__main__":
    main()
