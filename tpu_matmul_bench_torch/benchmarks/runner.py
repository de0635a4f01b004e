"""Shared per-size benchmark loop with OOM resilience.

Port of `tpu_matmul_bench/benchmarks/runner.py:31-106`: preamble → run →
report/record for each size, skipping sizes that do not fit (before
allocating, when the footprint and the device memory are known) or that
run out of memory, and going on with the next. In a process group a size
that fails on any process ends the run on that process (its peers then
fail on their next exchange, or at the launcher's reaping): a process that
skipped a size while the others ran it would go on out of step.
"""

from __future__ import annotations

import sys
import traceback
from typing import Callable, Iterable

from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.config import BenchConfig
from tpu_matmul_bench_torch.utils.device import apply_matmul_precision
from tpu_matmul_bench_torch.utils.errors import (
    distributed_active,
    is_oom_error,
    is_transport_error,
    release_device_memory,
)
from tpu_matmul_bench_torch.utils.reporting import (
    BenchmarkRecord,
    JsonWriter,
    format_record,
    report,
    size_preamble,
)


def run_sizes(
    config: BenchConfig,
    bench_one: Callable[[int], BenchmarkRecord],
    *,
    sizes: Iterable[int] | None = None,
    memory_gib: Callable[[int], float] | None = None,
    memory_limit_gib: float | None = None,
    preamble: Callable[[int], str] | None = None,
) -> list[BenchmarkRecord]:
    """Run `bench_one(size)` over the size sweep; skip sizes that run out
    of memory and continue. Any other failure of a size is reported and
    skipped too, so an empty list means no size produced a record."""
    apply_matmul_precision(config.precision)
    records: list[BenchmarkRecord] = []
    manifest = (telemetry.build_manifest(config)
                if config.json_out else None)
    with JsonWriter(config.json_out, manifest=manifest) as jw:
        for size in sizes if sizes is not None else config.sizes:
            report(preamble(size) if preamble is not None
                   else size_preamble(size, config.dtype_name))
            if (
                memory_gib is not None
                and memory_limit_gib is not None
                and memory_gib(size) > 0.95 * memory_limit_gib
            ):
                report(
                    f"\n  ERROR: Out of memory for {size}x{size} matrices "
                    f"(needs ~{memory_gib(size):.1f} GiB, "
                    f"device has {memory_limit_gib:.1f} GiB) — skipped"
                )
                continue
            try:
                with telemetry.span(f"size:{size}", size=size):
                    rec = bench_one(size).finalize()
            except Exception as e:  # noqa: BLE001 — per-size resilience
                if distributed_active():
                    # every process says why, not only the reporting one
                    what = ("cluster transport failure" if is_transport_error(e)
                            else "failure in a process group")
                    print(f"\n  FATAL: {what} at {size}x{size}: {e}",
                          file=sys.stderr, flush=True)
                    traceback.print_exc()
                    raise
                if is_oom_error(e):
                    report(f"\n  ERROR: Out of memory for {size}x{size} matrices")
                else:
                    report(f"\n  ERROR: {e}")
                    report(traceback.format_exc())
                release_device_memory()
                continue
            if config.precision != "default":
                rec.extras["precision"] = config.precision
            records.append(rec)
            jw.write(rec)
            report(format_record(rec))
            release_device_memory()
    return records
