"""Out-of-core K-streaming matmul: the plan, the host layout, and the
double-buffered consumer.

Port of `tpu_matmul_bench/ops/stream_k.py`. A and B stay on the host, K is
split into panels, and each rank's device holds only

- its row block of the C accumulator, fp32 for float operands (int32 for
  int8): the accumulate-high discipline, with no downcast of its own;
- two buffers of one window of staged panel pairs: while the products
  read window w, the copy of window w + 1 runs.

`stage_host` lays the host operands out once, before any timing, in pinned
memory when the ranks are on a card: A as [ranks, windows, n/ranks, W·kp],
so that each rank's A slab of a window is one contiguous copy, and B as
[n, n], whose window rows already are. `stream_matmul` copies each
window on one copy stream a card into the buffer it takes in turn; the
products wait on that copy's event, and the copy into a buffer waits on
the event of the products that last read it. B's window is whole on every
rank, so the ranks on one card share one copy of it.

Each panel's product is JAX's `acc + dot(a_p, b_p,
preferred_element_type=acc)` (`ops/stream_k.py:102-106`): under
`--matmul-impl cuda` K1's pickup kernel (`cuda_matmul_acc`, accumulating
into acc in place; its epilogue reads each accin element before it stores
the same element, in the same thread); otherwise the library product, in
the role XLA's dot plays (`torch.addmm` into the fp32 accumulator).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from tpu_matmul_bench_torch.parallel.mesh import Mesh, Sharded
from tpu_matmul_bench_torch.utils.metrics import is_integer_dtype, matmul_acc_dtype


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """A validated K-streaming decomposition of one [n, n]·[n, n] matmul:
    `panels` K-panels of width n/panels, consumed `window` at a time, over
    `world` ranks that cut the A panels and the accumulator by rows (each
    rank's rows need every B row of a panel)."""

    size: int
    panels: int
    window: int
    world: int

    def __post_init__(self) -> None:
        if self.panels <= 0:
            raise ValueError(f"--stream-k {self.panels} must be positive")
        if self.size % self.panels:
            raise ValueError(
                f"--stream-k {self.panels} panels must divide size "
                f"{self.size}")
        if self.window <= 0 or self.panels % self.window:
            raise ValueError(
                f"stream window {self.window} must be positive and divide "
                f"the {self.panels}-panel plan")
        if self.size % self.world:
            raise ValueError(
                f"size {self.size} must divide over the {self.world}-device "
                "row shard")

    @property
    def panel_k(self) -> int:
        return self.size // self.panels

    @property
    def num_windows(self) -> int:
        return self.panels // self.window

    @property
    def window_k(self) -> int:
        """K width of one window: `window` panels side by side."""
        return self.window * self.panel_k


def acc_dtype(dtype: Any) -> torch.dtype:
    """The accumulator dtype: int32 for integer operands, fp32 for floats,
    so panel partial sums never round in the operand dtype."""
    return matmul_acc_dtype(dtype)


@dataclasses.dataclass(frozen=True)
class HostOperands:
    """A and B on the host, laid out for one plan (`stage_host`)."""

    a: torch.Tensor  # [ranks, windows, n/ranks, W·kp]
    b: torch.Tensor  # [n, n]
    plan: StreamPlan


def stage_host(a: torch.Tensor, b: torch.Tensor, plan: StreamPlan,
               pin: bool) -> HostOperands:
    """Lay host A and B out for `plan`, in pinned memory when `pin`."""
    n, width = a.shape[0], plan.window_k
    rows = n // plan.world
    lay = torch.empty((plan.world, plan.num_windows, rows, width), dtype=a.dtype,
                      pin_memory=pin)
    lay.copy_(a.reshape(plan.world, rows, plan.num_windows, width).transpose(1, 2))
    if pin:
        b = torch.empty(b.shape, dtype=b.dtype, pin_memory=True).copy_(b)
    return HostOperands(lay, b, plan)


Product = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Any]


def _library_acc(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor) -> None:
    """acc += a·b through the library, the product in acc's dtype. The
    CPU has no mixed-dtype product (`aten::mm.dtype`), so there the
    operands are widened first."""
    if a.device.type == "cpu":
        acc.add_(a.to(acc.dtype) @ b.to(acc.dtype))
    elif is_integer_dtype(a.dtype):
        from tpu_matmul_bench_torch.ops.matmul import _library

        acc.add_(_library(a, b))
    elif a.dtype == acc.dtype:
        acc.addmm_(a, b)
    else:
        torch.addmm(acc, a, b, out_dtype=acc.dtype, out=acc)


def panel_product(impl: str, blocks: tuple[int, int, int] | None = None) -> Product:
    """acc += a·b for one panel pair, in acc's dtype: K1's pickup kernel
    for `impl` "cuda" (at the tile `blocks`), the library product for
    "torch" and "auto"."""
    if impl == "cuda":
        from tpu_matmul_bench_torch.ops.cuda_matmul import cuda_matmul_acc

        return lambda a, b, acc: cuda_matmul_acc(a, b, acc, out=acc,
                                                 out_dtype=acc.dtype, blocks=blocks)
    if impl not in ("torch", "auto"):
        raise ValueError(f"unknown matmul impl {impl!r}")
    return _library_acc


def _consume(product: Product, a_win: torch.Tensor, b_win: torch.Tensor,
             acc: torch.Tensor, plan: StreamPlan) -> None:
    """One window's panels into acc: A's panels are column views of the
    rank's slab, B's row blocks of the window."""
    kp = plan.panel_k
    for p in range(plan.window):
        product(a_win[:, p * kp:(p + 1) * kp], b_win[p * kp:(p + 1) * kp], acc)


def stream_matmul(host: HostOperands, mesh: Mesh, impl: str = "torch",
                  blocks: tuple[int, int, int] | None = None, *,
                  serial: bool = False) -> Sharded:
    """C = A·B from host operands through windows of K-panels into a
    row-cut accumulator, returned as each rank's rows (P(all axes, None))
    in `acc_dtype`; the caller owns any downcast. `serial` (on a card)
    makes every copy and product on the current stream and waits for each
    before the next: the same arithmetic with no overlap, which the race
    check holds the stream to."""
    plan = host.plan
    if plan.world != mesh.size:
        raise ValueError(f"a plan over {plan.world} ranks on a mesh of {mesh.size}")
    product = panel_product(impl, blocks)
    n, width = host.b.shape[0], plan.window_k
    rows = n // plan.world
    acc = [torch.zeros((rows, n), dtype=acc_dtype(host.b.dtype), device=r.device)
           for r in mesh.ranks]
    out = Sharded(acc, (tuple(mesh.axis_names), None), mesh.shape)
    if mesh.devices[0].type != "cuda":
        for w in range(plan.num_windows):
            for r in mesh.ranks:
                _consume(product, host.a[r.index, w], host.b[w * width:(w + 1) * width],
                         acc[r.index], plan)
        return out

    def buffers(shape: tuple[int, int], device: torch.device) -> list[torch.Tensor]:
        return [torch.empty(shape, dtype=host.b.dtype, device=device) for _ in range(2)]

    cards = mesh.cards
    b_buf = {card: buffers((width, n), card) for card in cards}
    a_buf = [buffers((rows, width), r.device) for r in mesh.ranks]
    copy = {card: torch.cuda.current_stream(card) if serial else torch.cuda.Stream(card)
            for card in cards}
    consumed: dict[tuple[torch.device, int], torch.cuda.Event] = {}
    for card in cards:
        # the window buffers may reuse memory the card's current stream
        # still reads: the copies start after what it has queued so far
        copy[card].wait_stream(torch.cuda.current_stream(card))
    for w in range(plan.num_windows):
        slot = w % 2
        for card in cards:
            compute = torch.cuda.current_stream(card)
            with torch.cuda.stream(copy[card]):
                if (card, slot) in consumed:
                    copy[card].wait_event(consumed[card, slot])
                b_buf[card][slot].copy_(host.b[w * width:(w + 1) * width], non_blocking=True)
                for r in mesh.ranks:
                    if r.device == card:
                        a_buf[r.index][slot].copy_(host.a[r.index, w], non_blocking=True)
                copied = torch.cuda.Event()
                copied.record()
            if serial:
                torch.cuda.synchronize(card)
            compute.wait_event(copied)
            for r in mesh.ranks:
                if r.device == card:
                    _consume(product, a_buf[r.index][slot], b_buf[card][slot], acc[r.index],
                             plan)
                    if serial:
                        torch.cuda.synchronize(card)
            consumed[card, slot] = torch.cuda.Event()
            consumed[card, slot].record(compute)
    return out
