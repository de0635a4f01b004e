"""`python -m tpu_matmul_bench_torch serve {bench,ab,selftest,explain,trace,pod}`.

Port of `tpu_matmul_bench/serve/cli.py`, with the JAX package's flags,
except that `--matmul-impl` takes {auto,torch,cuda} and `--device`
{cuda,cpu} (default cuda: with no card and no `--device cpu` the run
stops).

`bench` runs one load window — open loop (Poisson at `--qps`, the
default) or closed loop (`--concurrency N`) — over a declarative
request mix, and writes one schema-v2 ledger record whose extras carry
the full serving headline set (p50/p95/p99/max latency, achieved QPS,
shed rate, cache hit/miss/eviction counters, per-bucket breakdown).

`ab` runs the same seeded offered load twice — once through the
fixed-window admission queue, once through the continuous-batching
multi-tenant scheduler — writes both records into one ledger, and exits
nonzero when continuous batching regresses p99 or goodput beyond the
noise-aware tolerance (the in-repo form of the scheduler's perf claim).

`selftest` is the no-load CI hook: compile one executable, serve a
handful of requests synchronously across two traffic classes, and exit
nonzero unless the ledger contract holds (percentile monotonicity,
counter consistency, the extras["serve"] key set, per-tenant SLO
attainment rows).

`explain` is the flight recorder's forensics view: given a serve ledger
with per-request `serve_span` terminal records, render the causal
critical-path decomposition (queue-wait → batch-wait → cache → execute)
of one trace (`--trace ID`) or the slowest N (`--slowest N`), with each
trace's components reconciled against its measured wall latency. Pure
ledger reading: it renders a ledger either package wrote, and needs no
card.

`trace selftest` certifies the recorder end to end: static span-coverage
audit (TRACE-001/002/003) over the port's package, a seeded in-process
run whose span records reconcile, and the exemplar bound.

`--mesh dcn:R,ici:C --replica-groups G` lifts bench/ab to pod scale
(serve/pod.py): G data-parallel replica groups over the factorized world
of ranks, each bucket's group program captured in one CUDA graph keyed by
the group's placement label, and the pod SLO block (per-group goodput +
worst-tenant attainment) in the ledger. `pod selftest` is its check: the
POD-001/002/003 audit plus a seeded pod window (default `dcn:2,ici:4` in
2 groups). The ranks are placed `TMB_RANKS_PER_CARD` to a device
(parallel/mesh.py); under `--device cpu` the CLI sets it to the mesh's
world when it is unset, and on the card a mesh with more ranks than that
places raises, naming it.

`--artifacts [DIR]` attaches the kernel-library store (tune/artifacts.py,
default under `build/artifacts/`): with `--prewarm`, a fresh process
imports each `cuda` executable's library from it instead of running nvcc.
"""

from __future__ import annotations

import argparse
from typing import Sequence

from tpu_matmul_bench_torch.serve.loadgen import DEFAULT_MIX
from tpu_matmul_bench_torch.serve.queue import (
    DEFAULT_GRID,
    DEFAULT_MAX_BATCH,
    DEFAULT_MAX_DEPTH,
)
from tpu_matmul_bench_torch.serve.scheduler import DEFAULT_STARVATION_MS


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mix", default=DEFAULT_MIX,
                   help="request mix, 'MxKxN:weight,...' (bare N = square "
                        "NxNxN, weight defaults to 1; default %(default)r)")
    p.add_argument("--dtype", dest="dtype_name", default="float32",
                   help="operand dtype for every request (default "
                        "%(default)s)")
    p.add_argument("--grid", default=None,
                   help="padding grid points, comma-separated (default "
                        f"{','.join(str(g) for g in DEFAULT_GRID)})")
    p.add_argument("--scheduler", default="continuous",
                   choices=["fixed", "continuous"],
                   help="admission path: 'fixed' = single FIFO with a "
                        "micro-batch window, 'continuous' = multi-tenant "
                        "weighted-fair continuous batching (default "
                        "%(default)s)")
    p.add_argument("--tenants", default=None,
                   help="traffic classes: a [tenants.*] TOML path, or "
                        "inline 'id=weight[/priority[/slo_ms]],...' "
                        "(default: one 'default' tenant)")
    p.add_argument("--starvation-ms", type=float,
                   default=DEFAULT_STARVATION_MS,
                   help="continuous scheduler aging guard: a head request "
                        "waiting longer jumps the priority-class order "
                        "(default %(default)s ms)")
    p.add_argument("--window-ms", type=float, default=2.0,
                   help="fixed scheduler micro-batch window after the head "
                        "request's enqueue (default %(default)s ms)")
    p.add_argument("--max-depth", type=int, default=DEFAULT_MAX_DEPTH,
                   help="admission queue depth; submissions beyond it are "
                        "shed (default %(default)s)")
    p.add_argument("--max-batch", type=int, default=DEFAULT_MAX_BATCH,
                   help="micro-batch size cap (default %(default)s)")
    p.add_argument("--cache-capacity", type=int, default=None,
                   help="executable cache LRU capacity (default 64)")
    p.add_argument("--matmul-impl", default="auto",
                   choices=["auto", "torch", "cuda"],
                   help="matmul implementation the executables are built "
                        "from: the library product, the hand-written "
                        "kernel, or routed per bucket (default %(default)s)")
    p.add_argument("--seed", type=int, default=0,
                   help="load schedule + operand seed (default %(default)s)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device to serve on (default %(default)s; without "
                        "a card the run stops unless cpu is asked for)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="device count (default: all visible)")
    p.add_argument("--json-out", default=None,
                   help="schema-v2 JSONL ledger path ('-' for stdout)")
    p.add_argument("--append", action="store_true",
                   help="append to an existing ledger instead of "
                        "truncating (the manifest is written only once)")
    p.add_argument("--trace-out", default=None,
                   help="Chrome-trace span timeline ('-' for stdout)")
    p.add_argument("--obs-dir", default=None,
                   help="export live metrics snapshots (obs_snapshot.jsonl "
                        "+ metrics.prom) into this directory")
    p.add_argument("--obs-exemplars", action="store_true",
                   help="annotate exported histogram lines with "
                        "OpenMetrics exemplars (`# {trace_id=...}`) so "
                        "tail quantiles in /metrics name the requests "
                        "behind them")
    p.add_argument("--artifacts", default=None, nargs="?",
                   const="", metavar="DIR",
                   help="kernel-library store: a `cuda` executable's "
                        "library is imported from it at prewarm instead of "
                        "built with nvcc, and exported after a build (bare "
                        "flag = the default store under build/artifacts)")
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="pod serving over a dcn:R,ici:C world of ranks "
                        "(serve/pod.py); bench/ab then run the replica-"
                        "group arm")
    p.add_argument("--replica-groups", type=int, default=1,
                   dest="replica_groups", metavar="G",
                   help="data-parallel replica groups the --mesh is split "
                        "into along its outer axis (default %(default)s)")
    p.add_argument("--comm-quant", default=None, metavar="SPEC",
                   help="wire format(s) of the pod group programs' "
                        "all-gathers, per link class allowed "
                        "(e.g. dcn=fp8-block:32,ici=none)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_matmul_bench_torch serve",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    def _add_load(sp: argparse.ArgumentParser) -> None:
        sp.add_argument("--qps", type=float, default=50.0,
                        help="open-loop offered load, Poisson arrivals "
                             "(default %(default)s)")
        sp.add_argument("--duration", type=float, default=2.0,
                        dest="duration_s",
                        help="load window length in seconds "
                             "(default %(default)s)")
        sp.add_argument("--concurrency", type=int, default=None,
                        help="closed loop with N clients instead of the "
                             "open-loop Poisson process (--qps is then "
                             "ignored: arrivals are completion-driven)")
        sp.add_argument("--prewarm", action="store_true",
                        help="compile every mix bucket before the load "
                             "window, so latencies are steady-state (the "
                             "gated configuration)")
        sp.add_argument("--explore", type=float, default=0.0,
                        help="online-autotuning shadow-traffic budget: at "
                             "most this fraction of requests is routed "
                             "through each bucket's runner-up impl "
                             "(0 = off; default %(default)s)")
        sp.add_argument("--explore-db", default=None,
                        help="tuning DB the explorer routes from and "
                             "promotes measured-online winners into "
                             "(needs --json-out for the ledger citation; "
                             "default: route from the committed DB, "
                             "promote nothing)")
        _add_common(sp)

    bench = sub.add_parser("bench", help="one load window → one ledger")
    _add_load(bench)

    ab = sub.add_parser(
        "ab", help="fixed-window vs continuous scheduler at identical "
                   "seeded load → two records, nonzero exit on regression")
    _add_load(ab)

    selftest = sub.add_parser(
        "selftest", help="no-load ledger-contract check (CI hook)")
    _add_common(selftest)

    explain = sub.add_parser(
        "explain", help="critical-path decomposition of a traced request "
                        "from a serve ledger's span records (no card)")
    explain.add_argument("--ledger", required=True,
                         help="schema-v2 serve ledger with serve_span "
                              "lines (a --json-out from a bench run)")
    pick = explain.add_mutually_exclusive_group()
    pick.add_argument("--trace", default=None,
                      help="explain this trace id (default: slowest N)")
    pick.add_argument("--slowest", type=int, default=3,
                      help="explain the N slowest traces "
                           "(default %(default)s)")

    trace = sub.add_parser(
        "trace", help="flight-recorder tooling")
    tsub = trace.add_subparsers(dest="trace_command", required=True)
    tselftest = tsub.add_parser(
        "selftest", help="span-coverage audit + seeded-run reconciliation "
                         "+ exemplar bound (CI hook)")
    _add_common(tselftest)

    pod = sub.add_parser(
        "pod", help="pod-scale replica-group serving tooling")
    psub = pod.add_subparsers(dest="pod_command", required=True)
    pselftest = psub.add_parser(
        "selftest", help="POD-001/002/003 audit + a seeded pod window "
                         "(default dcn:2,ici:4 in 2 groups)")
    _add_common(pselftest)
    return p


def _parse_grid(spec: str | None) -> tuple[int, ...] | None:
    if spec is None:
        return None
    try:
        points = tuple(int(s) for s in spec.split(",") if s.strip())
    except ValueError:
        raise SystemExit(f"serve: bad --grid {spec!r} (want comma-separated "
                         f"integers)")
    if not points:
        raise SystemExit(f"serve: empty --grid {spec!r}")
    return points


def _config_from(args: argparse.Namespace):
    from tpu_matmul_bench_torch.serve.service import ServeConfig

    kwargs = dict(
        mix=args.mix,
        dtype_name=args.dtype_name,
        grid=_parse_grid(args.grid),
        scheduler=args.scheduler,
        tenants=args.tenants,
        starvation_ms=args.starvation_ms,
        window_ms=args.window_ms,
        max_depth=args.max_depth,
        max_batch=args.max_batch,
        seed=args.seed,
        matmul_impl=args.matmul_impl,
        device=args.device,
        num_devices=args.num_devices,
        json_out=args.json_out,
        append_ledger=args.append,
        trace_out=args.trace_out,
        obs_dir=args.obs_dir,
        obs_exemplars=args.obs_exemplars,
        artifacts=args.artifacts,
        mesh=args.mesh,
        replica_groups=args.replica_groups,
        comm_quant=args.comm_quant,
    )
    if args.cache_capacity is not None:
        kwargs["cache_capacity"] = args.cache_capacity
    # the pod flags are checked before any device is touched: the
    # partition grammar and its divisibility rules are pure
    if args.mesh is not None:
        from tpu_matmul_bench_torch.serve.placement import partition_spec

        try:
            partition_spec(args.mesh, args.replica_groups)
        except ValueError as e:
            raise SystemExit(f"serve: {e}")
    elif args.replica_groups != 1:
        raise SystemExit(
            "serve: --replica-groups needs --mesh (there is no pod to "
            "partition)")
    if args.command in ("bench", "ab"):
        if not 0.0 <= args.explore <= 1.0:
            raise SystemExit(f"serve: --explore must be in [0, 1], "
                             f"got {args.explore}")
        kwargs.update(qps=args.qps, duration_s=args.duration_s,
                      concurrency=args.concurrency, prewarm=args.prewarm,
                      explore=args.explore, explore_db=args.explore_db)
    return ServeConfig(**kwargs)


def _place_cpu_ranks(args: argparse.Namespace) -> None:
    """The counterpart of the JAX CLI's forced host device count: under
    `--device cpu`, put the mesh's world of ranks on the CPU by setting
    TMB_RANKS_PER_CARD, unless the caller set it. On the card nothing is
    set: a mesh with more ranks than the card holds raises, naming the
    variable (parallel/mesh.py place_ranks)."""
    import os

    from tpu_matmul_bench_torch.parallel.mesh import RANKS_PER_CARD_ENV
    from tpu_matmul_bench_torch.serve.placement import mesh_world

    if args.device == "cpu" and RANKS_PER_CARD_ENV not in os.environ:
        os.environ[RANKS_PER_CARD_ENV] = str(mesh_world(args.mesh))


def main(argv: Sequence[str] | None = None):
    args = build_parser().parse_args(argv)
    if args.command == "explain":
        # pure ledger forensics: never imports the serving stack (torch)
        from tpu_matmul_bench_torch.serve.trace import run_explain

        rc = run_explain(args.ledger, trace_id=args.trace,
                         slowest=args.slowest)
        if rc:
            raise SystemExit(rc)
        return None
    if args.command == "pod" and args.mesh is None:
        args.mesh = "dcn:2,ici:4"  # the selftest's certified default
        if args.replica_groups == 1:
            args.replica_groups = 2
    from tpu_matmul_bench_torch.serve.service import (
        run_ab,
        run_bench,
        run_selftest,
        run_trace_selftest,
    )

    try:
        config = _config_from(args)
        config.mix_entries  # validate the mix spec before touching devices
        config.tenant_specs  # ... and the tenant definitions
    except ValueError as e:
        raise SystemExit(f"serve: {e}")
    if args.mesh is not None:
        _place_cpu_ranks(args)
    if args.command == "pod":
        from tpu_matmul_bench_torch.serve.pod import run_pod_selftest

        return run_pod_selftest(config)
    if args.command == "trace":
        return run_trace_selftest(config)
    if args.command == "selftest":
        return run_selftest(config)
    if args.command == "ab":
        return run_ab(config)
    return run_bench(config)


if __name__ == "__main__":
    main()
