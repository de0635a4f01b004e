"""Reporting: human-readable stdout blocks + structured JSON lines.

Port of `tpu_matmul_bench/utils/reporting.py`: the same `BenchmarkRecord`
field names and derived fields, the same text blocks, and the same
fsync-per-line `JsonWriter`, so ledgers of the two packages read alike.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import sys
from typing import IO, Any

import torch

from tpu_matmul_bench_torch.utils.durable import repair_torn_tail
from tpu_matmul_bench_torch.utils.metrics import (
    hbm_bandwidth_gbps,
    matmul_flops,
    matmul_out_dtype,
    matmul_roofline_s,
    matrix_memory_gib,
    scaling_efficiency,
    theoretical_peak_tflops,
    throughput_unit,
)


@dataclasses.dataclass
class BenchmarkRecord:
    """One (benchmark, mode, size) measurement — the unit of reporting."""

    benchmark: str  # e.g. 'matmul'
    mode: str  # e.g. 'single'
    size: int
    dtype: str
    world: int
    iterations: int
    warmup: int
    avg_time_s: float
    tflops_per_device: float
    tflops_total: float
    device_kind: str = ""
    # collective-bandwidth benchmarks: payload bytes per device per iteration
    # and the derived algorithmic/bus bandwidth (matmul benchmarks leave None)
    bytes_per_device: int | None = None
    algbw_gbps: float | None = None
    busbw_gbps: float | None = None
    compute_time_s: float | None = None
    comm_time_s: float | None = None
    comm_overhead_pct: float | None = None
    scaling_efficiency_pct: float | None = None
    peak_efficiency_pct: float | None = None
    # measured vs the memory roofline, set only for comm-free records at
    # sizes where the memory leg binds (peak_efficiency_pct covers compute)
    roofline_pct: float | None = None
    # rectangular problems (--mkn): actual FLOPs per op; None → square 2·size³
    flops_per_op: float | None = None
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def tf32(self) -> bool:
        """Whether float32 products ran with TF32 allowed (the record's
        `float32_matmul_precision` extra): its peak is the TF32 row."""
        return self.extras.get("float32_matmul_precision") in ("high", "medium")

    def finalize(self) -> "BenchmarkRecord":
        """Fill derived fields (comm overhead, peak efficiency, roofline)."""
        if (
            self.comm_overhead_pct is None
            and self.comm_time_s is not None
            and self.compute_time_s is not None
            and (self.compute_time_s + self.comm_time_s) > 0
        ):
            self.comm_overhead_pct = (
                100.0 * self.comm_time_s / (self.compute_time_s + self.comm_time_s)
            )
        if self.algbw_gbps is None and throughput_unit(self.dtype) != "TFLOPS":
            self.extras.setdefault("throughput_unit", throughput_unit(self.dtype))
        if self.peak_efficiency_pct is None and self.device_kind:
            peak = theoretical_peak_tflops(self.device_kind, self.dtype,
                                           tf32=self.tf32)
            if peak:
                self.peak_efficiency_pct = 100.0 * self.tflops_per_device / peak
        if (
            self.roofline_pct is None
            and self.device_kind
            and self.algbw_gbps is None  # FLOP benchmarks only
            and self.flops_per_op is None  # square problems only
            and self.avg_time_s > 0
            and not self.comm_time_s
        ):
            bounds = matmul_roofline_s(self.size, self.dtype, self.device_kind,
                                       tf32=self.tf32)
            if bounds and bounds[1] > bounds[0]:
                # only when the memory leg binds; in the compute-bound
                # regime the roofline equals peak efficiency
                self.roofline_pct = 100.0 * bounds[1] / self.avg_time_s
                self.extras.setdefault(
                    "roofline_bw_gbps", hbm_bandwidth_gbps(self.device_kind))
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "BenchmarkRecord":
        """Rebuild a record from a `to_json` line (another process's JSONL
        records); unknown keys, such as the compare driver's
        `comparison_key`, are ignored."""
        d = json.loads(line)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def attach_scaling_efficiency(
    rec: BenchmarkRecord, single_device_tflops: float | None
) -> BenchmarkRecord:
    """`scaling_efficiency_pct` = tflops_total / (single-device TFLOPS ·
    cards) · 100, counting the cards the ranks occupy (extra `cards`,
    default the world), not the ranks: R ranks on one card run their
    products one after another, so the mode's total is already that card's,
    and R ranks must not read as R cards. With one rank per card, cards ==
    world and this is the JAX package's formula exactly."""
    if single_device_tflops:
        rec.scaling_efficiency_pct = scaling_efficiency(
            rec.tflops_total, single_device_tflops,
            rec.extras.get("cards", rec.world))
    return rec


_FORCE_REPORTING: bool | None = None


def force_reporting_process(value: bool | None) -> None:
    """Override the reporting-process gate (JAX `utils/reporting.py:131`):
    a driver that spawns the programs as children (compare --isolate) is
    the one reporting process whatever else it may hold. None clears it."""
    global _FORCE_REPORTING
    _FORCE_REPORTING = value


def reporting_process_override() -> bool | None:
    """The current `force_reporting_process` value, for callers that save
    and restore it around a scoped use."""
    return _FORCE_REPORTING


def is_reporting_process() -> bool:
    """Rank 0 of a process group, or the only process, unless overridden
    (`force_reporting_process`)."""
    if _FORCE_REPORTING is not None:
        return _FORCE_REPORTING
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def report(*lines: str, file: IO[str] | None = None) -> None:
    """Print on the reporting process only."""
    if is_reporting_process():
        print(*lines, sep="\n", file=file or sys.stdout, flush=True)


def header(title: str, config: dict[str, Any]) -> str:
    """Config header block."""
    bar = "=" * 60
    lines = [bar, title, bar, "Configuration:"]
    lines += [f"  - {k}: {v}" for k, v in config.items()]
    lines.append(bar)
    return "\n".join(lines)


def size_preamble(size: int, dtype: str) -> str:
    """Per-size memory preamble; C is counted at its own dtype (int8
    operands produce an int32 C)."""
    per = matrix_memory_gib(size, dtype)
    c = matrix_memory_gib(size, matmul_out_dtype(dtype))
    return (
        f"\nBenchmarking {size}x{size} matrix multiplication:\n"
        f"  - Memory per matrix: {per:.2f} GiB ({dtype})\n"
        f"  - Total memory for A, B, C: {2 * per + c:.2f} GiB"
    )


def format_record(rec: BenchmarkRecord) -> str:
    """Per-size results block."""
    rec.finalize()
    shape = rec.extras.get("shape") or f"{rec.size}x{rec.size}"
    lines = [
        f"\nResults for {shape} [{rec.mode}]:",
        f"  - Average time per operation: {rec.avg_time_s * 1e3:.3f} ms",
    ]
    if rec.algbw_gbps is None:  # FLOP benchmark; collectives do no matmul
        unit = throughput_unit(rec.dtype)  # TFLOPS, or TOPS for int8
        ops_name, ops_unit = (
            ("FLOPs", "TFLOPs") if unit == "TFLOPS" else ("ops", "Tops")
        )
        flops = rec.flops_per_op if rec.flops_per_op is not None \
            else matmul_flops(rec.size)
        cards = rec.extras.get("cards", rec.world)
        # ranks that share a card: per-device figures are per card, and
        # the banner says so, so that one card is never read as several
        where = (f"{rec.world} device(s)" if cards == rec.world else
                 f"{rec.world} ranks; cards: {cards}, ranks_per_card: "
                 f"{rec.extras.get('ranks_per_card')}")
        lines += [
            f"  - {unit} per {'device' if cards == rec.world else 'card'}: "
            f"{rec.tflops_per_device:.2f}",
            f"  - Total {unit} ({where}): {rec.tflops_total:.2f}",
            f"  - {ops_name} per operation: {flops / 1e12:.2f} {ops_unit}",
        ]
    if rec.algbw_gbps is not None:
        bus = f", bus {rec.busbw_gbps:.2f} GB/s" if rec.busbw_gbps is not None else ""
        lines.append(
            f"  - Bandwidth: {rec.algbw_gbps:.2f} GB/s algorithmic{bus} "
            f"({rec.bytes_per_device / 2**20:.1f} MiB/device)"
        )
    if rec.compute_time_s is not None and rec.comm_time_s is not None:
        lines.append(
            f"  - Compute: {rec.compute_time_s * 1e3:.3f} ms, "
            f"Comm: {rec.comm_time_s * 1e3:.3f} ms "
            f"({rec.comm_overhead_pct:.1f}% comm overhead)"
        )
    if rec.scaling_efficiency_pct is not None:
        lines.append(f"  - Scaling efficiency: {rec.scaling_efficiency_pct:.1f}%")
    if rec.peak_efficiency_pct is not None:
        lines.append(
            f"  - Device efficiency: {rec.peak_efficiency_pct:.1f}% of "
            f"{rec.device_kind} theoretical peak"
        )
    if rec.roofline_pct is not None:
        lines.append(
            f"  - Roofline: {rec.roofline_pct:.1f}% of the memory-bandwidth "
            f"bound (memory-bound size; device efficiency understates it)"
        )
    for k, v in rec.extras.items():
        lines.append(f"  - {k}: {v}")
    return "\n".join(lines)


def _has_manifest(path: str) -> bool:
    """True when `path` exists and its first line is a manifest record."""
    try:
        with open(path) as fh:
            first = fh.readline()
    except OSError:
        return False
    if not first.strip():
        return False
    try:
        rec = json.loads(first)
    except json.JSONDecodeError:
        return False
    return isinstance(rec, dict) and rec.get("record_type") == "manifest"


class JsonWriter:
    """JSON-lines sink for BenchmarkRecords.

    `manifest` (see `utils.telemetry.build_manifest`) is written as the
    file's first line. Every line is flushed and fsynced, so a killed run
    leaves a readable partial file. `append=True` extends an existing
    ledger, repairing a torn last line first and writing the manifest only
    when the file does not already start with one.
    """

    def __init__(self, path: str | None, manifest: dict[str, Any] | None = None,
                 *, append: bool = False):
        self._fh: IO[str] | None = None
        if path and is_reporting_process():
            if path == "-":
                self._fh = sys.stdout
            else:
                if append:
                    repair_torn_tail(path)
                if append and manifest is not None and _has_manifest(path):
                    manifest = None
                self._fh = open(path, "a" if append else "w")
        if self._fh is not None and manifest is not None:
            self._fh.write(json.dumps(manifest, sort_keys=True) + "\n")
            self._sync()

    def _sync(self) -> None:
        fh = self._fh
        fh.flush()
        try:
            os.fsync(fh.fileno())
        except (AttributeError, OSError, ValueError,
                io.UnsupportedOperation):
            pass  # stdout/pipes and captured streams: flush is the best

    def write(self, rec: BenchmarkRecord) -> None:
        if self._fh is not None:
            self._fh.write(rec.to_json() + "\n")
            self._sync()

    def close(self) -> None:
        if self._fh is not None and self._fh is not sys.stdout:
            self._fh.close()
        self._fh = None

    def __enter__(self) -> "JsonWriter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

