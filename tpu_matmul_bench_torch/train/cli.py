"""`python -m tpu_matmul_bench_torch train {bench, selftest}`.

Port of `tpu_matmul_bench/train/cli.py`:

- `bench` — one optimizer step a mode × mesh × size: the per-phase
  (fwd/bwd/grad_comm/update/allgather) split, `--grad-quant` wire formats
  on the gradient collectives, `--zero {0,1}`, the update's drift against
  an exact-wire shadow over `--steps`, and the dense fp32 reference check
  under `--validate`.
- `selftest` — the train step's contract in one process, over 8 ranks
  (`TMB_RANKS_PER_CARD=8` puts them on one device): the call-log audit
  (`train/audit.py`, JAX's TRAIN audit), a ZeRO step equal to the
  replicated one and to the dense reference at fp32 (≤ 1e-5) on a flat and
  a dcn:2,ici:4 world, the drift monotone in the wire's block size, and one
  record through `validate_train_record`. Exit 0 = the contract holds.

Both run on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import Sequence

_USAGE = ("usage: python -m tpu_matmul_bench_torch train {bench,selftest} ...\n"
          "  bench     one-optimizer-step benchmark (--grad-quant, --zero, "
          "--steps)\n"
          "  selftest  call-log audit + ZeRO-vs-replicated numerics + drift "
          "monotonicity")


def grad_quant_arg(value: str) -> str:
    """argparse type for --grad-quant: the --comm-quant grammar without the
    legacy control tier, which has no reduce_scatter half."""
    from tpu_matmul_bench_torch.parallel.collectives import (
        is_per_link_spec,
        parse_wire_format,
        validate_comm_quant,
    )

    try:
        validate_comm_quant(value)
        if not is_per_link_spec(value):
            fmt = parse_wire_format(value)
            if fmt is not None and fmt.legacy:
                raise ValueError(
                    f"--grad-quant {value!r}: the legacy control tier has "
                    "no reduce_scatter half; use none, fp8, int8-block:<B> "
                    "or fp8-block:<B> (or the per-link form)")
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from e
    return value


def _bench_main(argv: Sequence[str]) -> list:
    from tpu_matmul_bench_torch.train.step import (
        DEFAULT_BATCH,
        DEFAULT_LR,
        DEFAULT_STEPS,
        TRAIN_MODES,
    )
    from tpu_matmul_bench_torch.utils.config import build_parser

    parser = build_parser(
        "Training-step benchmark: sharded fwd/bwd matmul, quantized "
        "gradient sync, ZeRO-style sharded update (train/step.py).",
        modes=TRAIN_MODES, default_mode="dp", wres=False, comm_quant=True,
        mesh=True)
    # one step of a 256² linear model is the CPU default; the matmul
    # sweep's 4k-16k defaults would dwarf it
    parser.set_defaults(sizes=[256], iterations=5, warmup=2)
    parser.add_argument(
        "--grad-quant", type=grad_quant_arg, default=None,
        metavar="{none,fp8,int8-block:<B>,fp8-block:<B>,dcn=<f>,ici=<f>}",
        help="Wire format for the GRADIENT collectives only (the ZeRO "
             "all_gather of updated parameters always travels exact). The "
             "--comm-quant grammar without the legacy control tier; the "
             "per-link form picks a format per link class on a --mesh "
             "factorized mesh, e.g. dcn=fp8-block:32,ici=none.")
    parser.add_argument(
        "--zero", type=int, choices=(0, 1), default=0,
        help="1 = ZeRO-style sharded update: reduce_scatter the gradient "
             "over the data axis, update only the owned weight rows, "
             "all_gather the updated shards. 0 (default) = all_reduce and "
             "a replicated update, the A/B control.")
    parser.add_argument(
        "--steps", type=int, default=DEFAULT_STEPS,
        help="Optimizer steps of the update's drift series (quantized wire "
             f"against an exact-wire shadow; default {DEFAULT_STEPS})")
    parser.add_argument(
        "--batch", type=int, default=DEFAULT_BATCH,
        help=f"Global batch a step (default {DEFAULT_BATCH}; grown to "
             "cover the data axis when it does not divide)")
    parser.add_argument(
        "--lr", type=float, default=DEFAULT_LR,
        help=f"SGD learning rate of the weight update (default {DEFAULT_LR})")
    args = parser.parse_args(list(argv))
    if args.steps < 1:
        parser.error("--steps must be >= 1")
    if args.comm_quant:
        parser.error("the train step takes --grad-quant (gradient "
                     "collectives), not --comm-quant")
    from tpu_matmul_bench_torch.train.harness import resolve_train_impl

    try:
        resolve_train_impl(args.matmul_impl)
    except ValueError as e:
        parser.error(str(e))

    from tpu_matmul_bench_torch.benchmarks.runner import run_sizes
    from tpu_matmul_bench_torch.parallel.mesh import make_factorized_mesh, make_mesh
    from tpu_matmul_bench_torch.train.harness import TrainArgs, bench_one
    from tpu_matmul_bench_torch.utils import telemetry
    from tpu_matmul_bench_torch.utils.config import config_from_args
    from tpu_matmul_bench_torch.utils.device import (
        collect_device_info,
        device_banner,
        resolve_devices,
    )
    from tpu_matmul_bench_torch.utils.profiling import maybe_trace
    from tpu_matmul_bench_torch.utils.reporting import header, report

    config = config_from_args(args)
    targs = TrainArgs(mode=config.mode or "dp", zero=bool(args.zero),
                      grad_quant=args.grad_quant, steps=args.steps,
                      batch=args.batch, lr=args.lr)

    # the ranks are places in one process (TMB_RANKS_PER_CARD), where JAX
    # forces host devices before its backend starts
    devices = resolve_devices(config.device, config.num_devices)
    info = collect_device_info(devices)
    mesh = (make_factorized_mesh(devices, config.mesh) if config.mesh
            else make_mesh(devices))
    report(device_banner(info))
    report(header(
        "Training-step Benchmark",
        {
            "Mode": targs.mode,
            "Mesh": " x ".join(f"{mesh.shape[ax]} ({ax})" for ax in mesh.axis_names),
            "ZeRO": "sharded update" if targs.zero else "replicated update",
            "Gradient wire": targs.grad_quant or "exact",
            "Steps (drift series)": targs.steps,
            "Global batch": targs.batch,
            "Data type": config.dtype_name,
            "Iterations per test": config.iterations,
        },
    ))

    with telemetry.session(config.trace_out), \
            maybe_trace(config.profile_dir, cuda=info.platform == "cuda"):
        records = run_sizes(config, lambda s: bench_one(config, mesh, targs, s))
    report("\n" + "=" * 70, "Benchmark completed!", "=" * 70)
    if len(records) != len(config.sizes):
        # the runner reported each failed size; a run with one is no result
        raise SystemExit(1)
    return records


def _selftest(argv: Sequence[str]) -> list:
    parser = argparse.ArgumentParser(
        prog="train selftest",
        description="call-log audit + ZeRO numerics + drift-monotonicity "
                    "certification, over 8 ranks")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress per-problem lines")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Where the ranks run (default: cuda)")
    args = parser.parse_args(list(argv))

    import torch

    from tpu_matmul_bench_torch.parallel.mesh import make_factorized_mesh, make_mesh
    from tpu_matmul_bench_torch.train.audit import audit_train
    from tpu_matmul_bench_torch.train.harness import (
        TrainArgs,
        _rel_err,
        bench_one,
        drift_series,
        validate_train_record,
    )
    from tpu_matmul_bench_torch.train.step import make_train_setup
    from tpu_matmul_bench_torch.utils.config import BenchConfig
    from tpu_matmul_bench_torch.utils.device import apply_matmul_precision, resolve_devices

    try:
        devices = resolve_devices(args.device, 8)
    except ValueError as e:
        print(f"train selftest: needs 8 ranks ({e})")
        raise SystemExit(1)
    apply_matmul_precision("default")  # true fp32 products for the 1e-5 checks
    failures: list[str] = []

    # 1) the call-log audit: the full step's collectives against the
    #    gradient-collective model, the ZeRO rows, the downcasts
    problems = audit_train(devices)
    for p in problems:
        if not args.quiet:
            print(f"[error] {p}")
    failures.extend(problems)
    print(f"train audit: {len(problems)} finding(s)")

    # 2) the ZeRO ownership contract in numbers: a sharded-update step
    #    equals the replicated-update step (and the dense reference) at
    #    fp32 to 1e-5, on both mesh families
    cells = [("dp", make_mesh(devices)),
             ("hybrid", make_factorized_mesh(devices, "dcn:2,ici:4"))]
    for mode, mesh in cells:
        sz = make_train_setup(mesh, mode, 256, torch.float32, zero=True)
        sr = make_train_setup(mesh, mode, 256, torch.float32, zero=False)
        x, w0 = sz.operands
        wz = sz.step(x, w0)
        err_ab = _rel_err(wz, sr.step(x, w0))
        err_ref = _rel_err(wz, sz.reference(x, w0))
        if err_ab > 1e-5:
            failures.append(f"{mode}: ZeRO step != replicated step (rel {err_ab:.2e})")
        if err_ref > 1e-5:
            failures.append(f"{mode}: ZeRO step != dense reference (rel {err_ref:.2e})")
        print(f"zero numerics [{mode}]: vs replicated {err_ab:.2e}, "
              f"vs reference {err_ref:.2e}")

    # 3) drift monotone in block size: coarser scale blocks must not
    #    DECREASE the update error
    mesh = make_mesh(devices)
    drifts = {}
    for block in (16, 128):
        s_q = make_train_setup(mesh, "dp", 256, torch.float32, zero=True,
                               grad_quant=f"fp8-block:{block}")
        s_x = make_train_setup(mesh, "dp", 256, torch.float32, zero=True)
        drifts[block] = drift_series(s_q, s_x, 4)
    print(f"drift series: block16 {drifts[16]}, block128 {drifts[128]}")
    if drifts[128][-1] < drifts[16][-1]:
        failures.append(
            f"drift not monotone in block size: fp8-block:128 final "
            f"{drifts[128][-1]:.3e} < fp8-block:16 final {drifts[16][-1]:.3e}")

    # 4) the train record's schema contract on one small measured cell
    cfg = BenchConfig(sizes=[128], iterations=1, warmup=0, dtype_name="float32",
                      device=args.device, num_devices=8, json_out=None,
                      matmul_impl="torch", seed=0, mode="dp")
    rec = bench_one(cfg, make_mesh(devices),
                    TrainArgs(mode="dp", zero=True, grad_quant="fp8-block:16",
                              steps=2), 128)
    schema_problems = validate_train_record(rec)
    failures.extend(f"train record schema: {p}" for p in schema_problems)
    print(f"train record schema: {'ok' if not schema_problems else schema_problems}")

    if failures:
        print(f"train selftest: FAILED ({len(failures)} problem(s))")
        for msg in failures:
            print(f"  - {msg}")
        raise SystemExit(1)
    print("train selftest: OK")
    return []


def main(argv: Sequence[str] | None = None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "bench" in argv and (not argv or argv[0] != "selftest"):
        # the subcommand may stand anywhere: campaign specs put their
        # default flags before the job's own
        argv.remove("bench")
        return _bench_main(argv)
    if argv and argv[0] == "selftest":
        return _selftest(argv[1:])
    is_help = bool(argv) and argv[0] in ("-h", "--help")
    print(_USAGE, file=sys.stdout if is_help else sys.stderr)
    raise SystemExit(0 if is_help else 2)


if __name__ == "__main__":
    main()
