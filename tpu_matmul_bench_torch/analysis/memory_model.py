"""The out-of-core stream's memory gate (MEM-003) and its contrast half.

Port of the streaming part of `tpu_matmul_bench/analysis/memory_model.py`
(`:141-204`): `stream_window_bytes` prices the K-streaming program's
resident set in closed form, `check_stream_budget` is the MEM-003 gate the
`parallel stream` runner must pass before it allocates anything, and
`nonstreaming_over_budget` names the in-core modes the same budget rejects.
The HLO half (MEM-001/002, a walk of compiled programs) has no torch form.

The budget is a device's: by default the device's own memory
(`default_budget_gib`: the card's total memory, or the CPU's physical
memory), where the JAX package assumes one TPU's 16 GiB. Ranks that share a
device share its budget, so the gate certifies `ranks_per_card` times a
rank's resident bytes, as the in-core modes' memory guard multiplies.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from tpu_matmul_bench_torch.utils.metrics import as_dtype

# the one rule of this module, and its severity (JAX `analysis/findings.py`)
RULES = {"MEM-003": "error"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One gate finding (the fields of JAX `analysis/findings.py:326`): a
    rule ID, where it fired, what it says, and its evidence."""

    rule: str
    where: str
    message: str
    severity: str = ""  # defaults to the rule's severity
    details: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.rule not in RULES:
            raise ValueError(f"unknown rule id {self.rule!r}")
        object.__setattr__(self, "severity", self.severity or RULES[self.rule])


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
