"""Matmul implementation routing — `--matmul-impl auto`.

Port of the table tier of `tpu_matmul_bench/ops/impl_select.py`. A route
to the hand-written kernel is taken only where a committed head-to-head
measurement on that device shows it winning; until one exists, every
device kind is unrouted and goes to the library product, as the JAX
package's `table_select` sends unrouted kinds to XLA. The port has no
tuning-database tier yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ImplChoice:
    """A routing decision: which impl, and the measurement that chose it."""

    impl: str         # "torch" | "cuda"
    provenance: str   # committed artifact (or rule) behind the decision
    source: str = "table"


def table_select(m: int, n: int, k: int, device_kind: str,
                 dtype: Any) -> ImplChoice:
    """The routing table: a pure lookup, no device calls. It has no rows
    yet — no committed measurement shows the kernel winning on any device
    kind — so every kind is unrouted. Rows arrive with the first measured
    head-to-head, as in the JAX package's `table_select`."""
    return ImplChoice("torch", "unrouted device kind: the library product "
                               "(torch.matmul) is the default until a "
                               "measured head-to-head routes the kernel")


def select_impl(m: int, n: int, k: int, device_kind: str,
                dtype: Any) -> ImplChoice:
    """The implementation for C[m,n] = A[m,k]·B[k,n] of `dtype` on
    `device_kind`."""
    return table_select(m, n, k, device_kind, dtype)


def resolve_route(m: int, n: int, k: int, device_kind: str,
                  dtype: Any) -> tuple[ImplChoice, None]:
    """(choice, cell): the audit-facing form of `select_impl`. The cell is
    None while the port has no tuning database."""
    return table_select(m, n, k, device_kind, dtype), None


def auto_extras(matmul_impl: str, m: int, n: int, k: int,
                device_kind: str, dtype: Any) -> dict:
    """Record extras for an `auto` run: the resolved impl and the
    provenance behind the choice. Empty for explicit impls."""
    if matmul_impl != "auto":
        return {}
    choice = select_impl(m, n, k, device_kind, dtype)
    return {"matmul_impl_resolved": choice.impl,
            "impl_provenance": choice.provenance,
            "impl_source": choice.source}
