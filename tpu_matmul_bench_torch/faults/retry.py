"""Unified retry budget + backoff policy.

Port of `tpu_matmul_bench/faults/retry.py`, a stdlib module copied here
because the port imports nothing of the JAX package: every retry loop —
campaign attempts, supervised children, the fault audit's resumption
accounting — prices failures the same way: jittered exponential backoff
with a cap, and a floor for transport-shaped failures (a closed Gloo
pair needs the whole gang torn down and re-formed; retrying in seconds
just burns the budget, see DESIGN §8).

Failure *kinds* come from `utils.errors.classify`: transport failures
get the floor; other `transient` failures (OOM, ENOSPC, injected chaos)
retry on the plain exponential; `overload` is the caller's signal to
shed, not retry; `permanent` failures spend the budget fast so a
deterministic crash doesn't hold a campaign hostage.

Jitter is seeded and deterministic — `random.Random(f"{seed}:{attempt}:
{kind}")` — so a replayed campaign backs off identically. The default
`jitter_pct=0` keeps the extracted policy byte-identical to the
executor's historical delays.
"""

from __future__ import annotations

import dataclasses
import random

# Historical executor constants, now owned here (executor re-exports).
BACKOFF_CAP_S = 900.0
TRANSPORT_MIN_BACKOFF_S = 60.0


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Delay schedule for retry attempt N (1-based failure count)."""

    base_s: float = 30.0
    cap_s: float = BACKOFF_CAP_S
    transport_min_s: float = TRANSPORT_MIN_BACKOFF_S
    jitter_pct: float = 0.0
    seed: int = 0

    def delay(self, attempt: int, kind: str = "error") -> float:
        """Backoff (seconds) after the `attempt`-th failure of `kind`.

        `kind` is the executor's failure taxonomy ('timeout' |
        'transport' | 'error') or an `errors.classify` category;
        transport/transient failures get the re-rendezvous floor.
        """
        d = min(self.base_s * (2.0 ** max(0, attempt - 1)), self.cap_s)
        if kind == "transport":
            d = max(d, self.transport_min_s)
        if self.jitter_pct > 0:
            r = random.Random(f"{self.seed}:{attempt}:{kind}")
            d *= 1.0 + (self.jitter_pct / 100.0) * (2.0 * r.random() - 1.0)
        return d


@dataclasses.dataclass
class RetryBudget:
    """A bounded number of retries, spent one failure at a time."""

    retries: int
    used: int = 0

    def allow(self) -> bool:
        return self.used < self.retries

    def spend(self) -> None:
        self.used += 1

    @property
    def attempts(self) -> int:
        """Total process launches implied: the first try + retries used."""
        return self.used + 1
