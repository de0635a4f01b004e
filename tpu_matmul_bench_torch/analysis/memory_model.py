"""Peak live bytes of the modes' programs (MEM-001/002) and the
out-of-core stream's memory gate (MEM-003).

Port of `tpu_matmul_bench/analysis/memory_model.py`. JAX walks the
compiled HLO of each program for def→last-use live intervals. PyTorch
compiles nothing, so the port runs each program once and walks what it
allocates (`analysis/recording.py LiveBytes`): each storage an operation
creates counts from its creation until it is freed, and the peak of that
sum on a device is the program's peak live bytes there (the operands,
which exist before the call, are not counted). Ranks that share a device
sum there, as the MEM-003 gate sums them.

- MEM-001 (error): some mode's peak exceeds the per-device budget. The
  budget is a device's: by default its own memory (`default_budget_gib`:
  the card's total memory, or the CPU's physical memory), where the JAX
  package assumes one TPU's 16 GiB.
- MEM-002 (warn): the self-check against the comms model, each
  collective's per-shard payload at most the peak (the payload buffer is
  live while the collective runs).
- MEM-003 (error): `stream_window_bytes` prices the K-streaming program's
  resident set in closed form, and `check_stream_budget` is the gate the
  `parallel stream` runner must pass before it allocates anything;
  `nonstreaming_over_budget` names the in-core modes the same budget
  rejects.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Sequence

import torch

from tpu_matmul_bench_torch.analysis.findings import Finding
from tpu_matmul_bench_torch.utils.metrics import as_dtype

#: the audit worlds, as JAX's
MEM_WORLDS = (4, 8)


def default_budget_gib(device: torch.device | str) -> float:
    """A device's own memory in GiB: the card's total memory, or the CPU's
    physical memory."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 2**30
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 2**30


def stream_window_bytes(size: int, dtype: Any, world: int, panels: int,
                        window: int = 2) -> int:
    """Closed-form resident bytes of one rank of the K-streaming program
    (ops/stream_k.py): its row block of the accumulator (fp32, int32 for
    integers: the accumulate-high dtype, not the operand's) plus both
    buffers of staged panel windows (window w computes while w + 1
    copies), the A panels row-cut and the B panels whole. Analytic on
    purpose: the gate certifies a run whose whole operands could never be
    allocated."""
    from tpu_matmul_bench_torch.ops.stream_k import StreamPlan, acc_dtype

    plan = StreamPlan(size=size, panels=panels, window=window, world=world)
    item = as_dtype(dtype).itemsize
    acc_item = acc_dtype(dtype).itemsize
    kp = plan.panel_k
    acc_b = (size // world) * size * acc_item
    a_win_b = window * (size // world) * kp * item   # row-cut panels
    b_win_b = window * kp * size * item              # whole panels
    return acc_b + 2 * (a_win_b + b_win_b)           # both buffer windows


def check_stream_budget(size: int, dtype: Any, world: int, panels: int,
                        window: int = 2, *, budget_gib: float,
                        ranks_per_card: int = 1) -> list[Finding]:
    """MEM-003: the streaming windows of the ranks on one device must fit
    its budget. An empty return is the certificate the out-of-core runner
    needs before it allocates anything. With one rank a device, the
    finding is JAX's, word for word."""
    resident = ranks_per_card * stream_window_bytes(size, dtype, world, panels, window)
    budget = int(budget_gib * 2**30)
    if resident <= budget:
        return []
    ranks = f" ({ranks_per_card} ranks)" if ranks_per_card > 1 else ""
    return [Finding(
        "MEM-003", f"mem:stream_k@d{world}",
        f"streaming resident window {resident / 2**30:.3f} GiB{ranks} exceeds the "
        f"{budget_gib:g} GiB per-device budget at {panels} panels × window "
        f"{window} (size {size}) — raise --stream-k or the budget",
        details={"resident_bytes": resident, "budget_bytes": budget,
                 "panels": panels, "window": window})]


def nonstreaming_over_budget(config, world: int, size: int, budget_gib: float,
                             ranks_per_card: int = 1) -> dict[str, float]:
    """{mode: estimated GiB of a device} for every in-core mode of the
    scaling and distributed programs (the modes of JAX's `_all_modes`)
    whose footprint at this shape busts the budget: the contrast half of
    the out-of-core certificate."""
    from tpu_matmul_bench_torch.parallel.modes import (
        DISTRIBUTED_MODES,
        SCALING_MODES,
        estimate_memory_gib,
    )

    over = {}
    for mode in sorted({**SCALING_MODES, **DISTRIBUTED_MODES}):
        gib = ranks_per_card * estimate_memory_gib(mode, config, world, size,
                                                   dp=max(world // 2, 1))
        if gib > budget_gib:
            over[mode] = round(gib, 3)
    return over


def estimate_peak_bytes(fn: Callable[..., Any], *args: Any) -> int:
    """Peak live bytes on the busiest device over one call of `fn(*args)`
    (the live-bytes walk, `analysis/recording.py LiveBytes`)."""
    from tpu_matmul_bench_torch.analysis.recording import record_live_bytes

    with record_live_bytes() as walk:
        fn(*args)
    return walk.peak_bytes()


def _audit_setup(mode: str, world: int, size: int, devices: Sequence[torch.device],
                 impl: str):
    from tpu_matmul_bench_torch.analysis.auditor import _all_modes, _audit_config
    from tpu_matmul_bench_torch.parallel.mesh import make_mesh

    config = _audit_config("bfloat16", impl, devices[0])
    return config, _all_modes()[mode](config, make_mesh(devices[:world]), size)


@functools.lru_cache(maxsize=None)
def _mode_peak_bytes(mode: str, world: int, size: int, devices: tuple, impl: str) -> int:
    _, setup = _audit_setup(mode, world, size, devices, impl)
    fn = setup.full if setup.full is not None else setup.compute
    return estimate_peak_bytes(fn, *setup.operands)


def mode_peak_bytes(mode: str, world: int, size: int, devices: Sequence[torch.device],
                    impl: str = "cuda") -> int:
    """Run one mode's full program over the first `world` ranks and walk
    its peak live bytes (cached a process; the lint's ledger reuses it)."""
    return _mode_peak_bytes(mode, world, size, tuple(devices), impl)


def peak_report(devices: Sequence[torch.device], worlds=MEM_WORLDS,
                size: int | None = None, impl: str = "cuda") -> dict[str, int]:
    """``{"mode@d{world}": peak_bytes}`` for every mode and world the
    ranks cover: the peak-memory column of the findings ledger's
    manifest."""
    from tpu_matmul_bench_torch.analysis.auditor import AUDIT_SIZE, _all_modes

    size = size or AUDIT_SIZE
    return {f"{mode}@d{world}": mode_peak_bytes(mode, world, size, devices, impl)
            for world in worlds if world <= len(devices)
            for mode in sorted(_all_modes())}


def check_budget(peaks: dict[str, int], budget_gib: float) -> list[Finding]:
    """MEM-001 over a peak report (pure: seeded tests feed fake peaks)."""
    budget = int(budget_gib * 2**30)
    return [
        Finding(
            "MEM-001", f"mem:{key}",
            f"peak live bytes {peak / 2**30:.3f} GiB exceed the "
            f"{budget_gib:g} GiB per-device budget",
            details={"peak_bytes": peak, "budget_bytes": budget})
        for key, peak in sorted(peaks.items()) if peak > budget
    ]


def check_comms_consistency(mode: str, world: int, size: int, peak: int,
                            dtype: Any) -> list[Finding]:
    """MEM-002: every expected collective payload must fit under the peak
    (the payload buffer is live while the collective runs)."""
    from tpu_matmul_bench_torch.analysis.comms_model import expected_collectives

    return [
        Finding(
            "MEM-002", f"mem:{mode}@d{world}",
            f"peak {peak} B is below the {exp.kind} payload "
            f"{exp.payload_bytes} B the comms model requires live — "
            "the walk or the program shape is wrong",
            details={"peak_bytes": peak, "kind": exp.kind,
                     "payload_bytes": exp.payload_bytes})
        for exp in expected_collectives(mode, world, size, dtype)
        if exp.payload_bytes > peak
    ]


def audit_memory(devices: Sequence[torch.device], worlds=MEM_WORLDS,
                 size: int | None = None, budget_gib: float | None = None,
                 impl: str = "cuda") -> list[Finding]:
    """Walk every mode × world peak, gate it against the budget (default:
    the device's memory) and self-check it against the comms model."""
    from tpu_matmul_bench_torch.analysis.auditor import AUDIT_SIZE, _all_modes

    size = size or AUDIT_SIZE
    if budget_gib is None:
        budget_gib = default_budget_gib(devices[0])
    findings: list[Finding] = []
    for world in worlds:
        if world > len(devices):
            findings.append(Finding(
                "MEM-002", f"mesh:d{world}",
                f"cannot audit world={world}: only {len(devices)} ranks (set "
                "TMB_RANKS_PER_CARD to put more on one device)",
                details={"available": len(devices)}))
            continue
        for mode in sorted(_all_modes()):
            peak = mode_peak_bytes(mode, world, size, devices, impl)
            findings.extend(check_budget({f"{mode}@d{world}": peak}, budget_gib))
            findings.extend(check_comms_consistency(mode, world, size, peak,
                                                    torch.bfloat16))
    return findings
