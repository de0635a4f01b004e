"""Collective bandwidth benchmark: throughput per collective op over the ranks.

Port of `tpu_matmul_bench/benchmarks/collective_benchmark.py`: nccl-tests
style per-op bandwidth over the world of ranks (`parallel/mesh.py`). Ops:
psum, all_gather, reduce_scatter, ppermute, ppermute_bidir, all_to_all.
Reports algorithmic and bus bandwidth; `--sizes N` sweeps an N×N payload a
rank of the benchmark dtype. Ranks that share a card copy within its
memory: such a bandwidth is the card's memory, not NVLink.

Run: TMB_RANKS_PER_CARD=4 python -m tpu_matmul_bench_torch collectives \
        --mode psum --num-devices 4 --sizes 16384 --validate

`... collectives selftest [--device cpu] [--num-devices N]` instead runs the
wire formats' numeric selftest (`comm_quant_selftest`) over the ranks: the
error bound of each format, the block→per-row identity, the outlier fixture
where block scales must beat per-row scales, and integer inertness. It
needs at least 2 ranks and exits 1 on any failed check.
"""

from __future__ import annotations

import argparse
import sys
from typing import Sequence

from tpu_matmul_bench_torch.benchmarks.runner import run_sizes
from tpu_matmul_bench_torch.parallel.collective_bench import (
    COLLECTIVES,
    run_collective_benchmark,
)
from tpu_matmul_bench_torch.parallel.collectives import verify_collectives
from tpu_matmul_bench_torch.parallel.mesh import make_mesh
from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.config import BenchConfig, parse_config
from tpu_matmul_bench_torch.utils.device import (
    cluster_exit_barrier,
    collect_device_info,
    device_banner,
    maybe_init_process_group,
    resolve_devices,
)
from tpu_matmul_bench_torch.utils.metrics import matrix_memory_gib
from tpu_matmul_bench_torch.utils.profiling import maybe_trace
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord, header, report


def run(config: BenchConfig) -> list[BenchmarkRecord]:
    maybe_init_process_group()
    devices = resolve_devices(config.device, config.num_devices)
    if len(devices) < 2:
        report("ERROR: collective benchmark needs >= 2 devices "
               "(use --num-devices, and TMB_RANKS_PER_CARD to put several "
               "ranks on one device)")
        sys.exit(1)
    info = collect_device_info(devices)
    mesh = make_mesh(devices)
    report(device_banner(info))
    report(
        header(
            "Collective Bandwidth Benchmark (PyTorch/CUDA)",
            {
                "Collective": config.mode,
                "Number of devices": len(devices),
                "Data type": config.dtype_name,
                "Iterations per test": config.iterations,
                "Warmup iterations": config.warmup,
            },
        )
    )

    report("\nVerifying collectives:")
    if not verify_collectives(mesh):
        report("\nERROR: collective verification failed — aborting benchmark")
        sys.exit(1)

    def bench_one(size: int) -> BenchmarkRecord:
        return run_collective_benchmark(config, mesh, size, config.mode)

    d = len(devices)
    sizes = list(config.sizes)
    if COLLECTIVES[config.mode].needs_divisible_size:
        for s in [s for s in sizes if s % d]:
            report(f"\nSkipping size {s}: {config.mode} needs the size "
                   f"divisible by the {d}-device world")
        sizes = [s for s in sizes if s % d == 0]

    mem_factor = COLLECTIVES[config.mode].mem_factor(d)
    with telemetry.session(config.trace_out), \
            maybe_trace(config.profile_dir, cuda=info.platform == "cuda"):
        records = run_sizes(
            config,
            bench_one,
            sizes=sizes,
            # the ranks that share a device share its memory
            memory_gib=lambda s: (matrix_memory_gib(s, config.dtype, count=mem_factor)
                                  * info.ranks_per_card),
            memory_limit_gib=info.memory_gib,
        )
    cluster_exit_barrier()
    report("\n" + "=" * 70, "Benchmark completed!", "=" * 70)
    return records


def comm_quant_selftest(argv: Sequence[str] = ()) -> list[BenchmarkRecord]:
    """Numeric selftest of the quantized wire formats over the world of
    ranks (JAX `:104-202`): seeded, seconds. Runs `wire_psum` and
    `wire_all_gather` against the exact collectives and checks the error
    bound of each format. Exits 1 on any failure, and with fewer than 2
    ranks."""
    import numpy as np

    from tpu_matmul_bench_torch.parallel.collectives import (
        parse_wire_format,
        psum_over,
        wire_all_gather,
        wire_psum,
    )
    from tpu_matmul_bench_torch.parallel.mesh import ROWS, shard_from_numpy
    from tpu_matmul_bench_torch.parallel.quantized import quantized_psum

    p = argparse.ArgumentParser(prog="collectives selftest",
                                description=comm_quant_selftest.__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Where the ranks run (default: cuda)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="Number of ranks (default: every place there is; "
                        "TMB_RANKS_PER_CARD ranks to a device)")
    args = p.parse_args(list(argv))
    devices = resolve_devices(args.device, args.num_devices)
    if len(devices) < 2:
        report("ERROR: comm-quant selftest needs >= 2 ranks (set "
               "TMB_RANKS_PER_CARD to put several on one device)")
        sys.exit(1)
    mesh = make_mesh(devices)
    report(f"Comm-quant selftest on {len(devices)} ranks "
           f"({len(mesh.cards)} x {devices[0].type}):")

    def all_reduce(x: np.ndarray, fn) -> np.ndarray:
        out = fn(mesh, shard_from_numpy(x, ROWS, mesh))[0]
        return out.cpu().numpy()

    def exact(mesh_, shards):
        return psum_over(mesh_)(shards)

    def rel(got, want):
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    ok = True

    def check(name: str, good: bool, detail: str = "") -> None:
        nonlocal ok
        ok &= bool(good)
        report(f"  - {name}: {'PASSED' if good else 'FAILED'}"
               + (f" ({detail})" if detail else ""))

    def wire(spec: str):
        fmt = parse_wire_format(spec)
        return lambda m, s: wire_psum(m, s, fmt)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 256)).astype(np.float32)
    want = all_reduce(x, exact)
    errs = {}
    for spec, bound in (("int8", 0.02), ("int8-block:32", 0.02),
                        ("fp8", 0.08), ("fp8-block:32", 0.08)):
        fn = quantized_psum if parse_wire_format(spec).legacy else wire(spec)
        errs[spec] = rel(all_reduce(x, fn), want)
        check(f"wire_psum {spec} rel-err < {bound}", errs[spec] < bound,
              f"{errs[spec]:.4f}")

    # block size == payload width degenerates to the per-row control tier
    deg = rel(all_reduce(x, wire("int8-block:256")), want)
    check("int8-block:cols == per-row control",
          np.isclose(deg, errs["int8"], rtol=1e-6),
          f"{deg:.6f} vs {errs['int8']:.6f}")

    # adversarial outlier column: block scales confine the damage
    xo = rng.normal(size=(64, 256)).astype(np.float32)
    xo[:, 3] *= 1000.0
    want_o = all_reduce(xo, exact)
    e_row = rel(all_reduce(xo, quantized_psum), want_o)
    e_blk = rel(all_reduce(xo, wire("int8-block:32")), want_o)
    check("outlier rows: int8-block beats per-row", e_blk < e_row,
          f"{e_blk:.4f} < {e_row:.4f}")

    # integer operands must take the exact path bit for bit
    xi = rng.integers(-8, 8, size=(64, 256)).astype(np.int32)
    check("integer operands inert",
          bool((all_reduce(xi, wire("int8-block:32")) == all_reduce(xi, exact)).all()))

    # the gather leg quantizes once (no per-hop accumulation): tighter
    fmt = parse_wire_format("int8-block:32")
    gathered = wire_all_gather(mesh, shard_from_numpy(x, ROWS, mesh), fmt, axis=0)[0]
    ge = rel(gathered.cpu().numpy(), x)
    check("wire_all_gather int8-block:32 rel-err < 0.01", ge < 0.01, f"{ge:.4f}")

    if not ok:
        report("\nERROR: comm-quant selftest failed")
        sys.exit(1)
    report("Comm-quant selftest passed.")
    return []


def main(argv: Sequence[str] | None = None) -> list[BenchmarkRecord]:
    args = list(sys.argv[1:] if argv is None else argv)
    if args[:1] == ["selftest"]:
        return comm_quant_selftest(args[1:])
    config = parse_config(
        args,
        description=__doc__ or "collective benchmark",
        modes=list(COLLECTIVES),
        default_mode="psum",
        # int8 payloads: collectives move bytes, and the reductions (psum,
        # reduce_scatter) stay in range for the small-int operand data
        extra_dtypes=("int8",),
        fused_timing=True,
        wres=False,
    )
    return run(config)


if __name__ == "__main__":
    main()
