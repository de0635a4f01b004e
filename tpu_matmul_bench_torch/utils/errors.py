"""OOM and transport-failure classification, the serving sheds, the
failure taxonomy, and releasing device memory.

Port of `tpu_matmul_bench/utils/errors.py`. A failed CUDA allocation
raises `torch.cuda.OutOfMemoryError`; the runner skips that size and
continues, as the reference does, and `classify` counts it transient where
the JAX package reads RESOURCE_EXHAUSTED.
"""

from __future__ import annotations

import errno
import gc
import re

import torch


def is_oom_error(e: BaseException) -> bool:
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    msg = str(e)
    return "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg or "out of memory" in msg


# Distributed-transport failure signatures, kept to explicit transport
# phrases so unrelated errors never take the fail-fast path.
_TRANSPORT_SIGNATURES = (
    "Connection closed by peer",
    "Connection reset by peer",
    "Connection refused",
    "Broken pipe",
    "Socket closed",
    # gloo's own, in this torch: a peer that stopped answering
    "Read timeout",
    "Timed out waiting",
)

# A failed Gloo collective reports as "Gloo <Op> failed: <cause>".
_GLOO_OP_FAILED = re.compile(r"gloo \w+ failed", re.IGNORECASE)


def is_transport_message(msg: str) -> bool:
    low = msg.lower()
    return (any(sig.lower() in low for sig in _TRANSPORT_SIGNATURES)
            or _GLOO_OP_FAILED.search(low) is not None)


def is_transport_error(e: BaseException) -> bool:
    """A dropped cluster transport. Unlike an OOM it is not per-size
    recoverable: the processes may have diverged, so callers in a process
    group must fail fast."""
    return is_transport_message(str(e))


def distributed_active() -> bool:
    """True inside a process group of more than one process — the only
    regime where a transport failure is fatal to the run."""
    dist = torch.distributed
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


# Marker prefix for admission-queue sheds: it survives formatting, so a
# shed is classifiable from a logged message as well as from the exception.
_OVERLOAD_MARKER = "ADMISSION_QUEUE_FULL"


class QueueOverflowError(RuntimeError):
    """The serving admission queue is at max depth: the request was SHED,
    not queued. Sheds are load feedback, not faults: the serve harness
    counts them into the ledger's shed rate."""

    def __init__(self, depth: int, max_depth: int):
        super().__init__(
            f"{_OVERLOAD_MARKER}: depth {depth} at configured max "
            f"{max_depth}; request shed")
        self.depth = depth
        self.max_depth = max_depth


def is_overload_error(e: BaseException | str) -> bool:
    """Overload-shed classification, by type for live exceptions and by
    marker for captured text."""
    if isinstance(e, QueueOverflowError):
        return True
    return _OVERLOAD_MARKER in str(e)


# Marker for circuit-breaker sheds, distinct from the depth-overflow marker
# so ledgers and log tails attribute a shed to a tripped bucket.
_BREAKER_MARKER = "BREAKER_OPEN"


class BreakerOpenError(QueueOverflowError):
    """The request's bucket has its circuit breaker open: recent dispatches
    on that executable kept failing, so the scheduler sheds new work for the
    bucket until a half-open probe succeeds (serve/scheduler.py). A breaker
    shed is load feedback, so every producer that treats overflow as "shed,
    don't crash" handles it unchanged."""

    def __init__(self, depth: int, max_depth: int, bucket: str = ""):
        RuntimeError.__init__(
            self,
            f"{_BREAKER_MARKER}: bucket {bucket or '?'} circuit open; "
            "request shed")
        self.depth = depth
        self.max_depth = max_depth
        self.bucket = bucket


# The failure taxonomy, the JAX package's classes:
#   transient - worth a backed-off retry (dropped transport, OOM, timeouts,
#               disk pressure)
#   overload  - load feedback: shed/propagate, never retry in place
#   permanent - deterministic; retries spend budget without hope
TRANSIENT = "transient"
OVERLOAD = "overload"
PERMANENT = "permanent"

_TRANSIENT_EXTRA_SIGNATURES = (
    "No space left on device",
    "Read timeout",
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
)


def classify(e: BaseException | str) -> str:
    """Map an exception (or captured failure text) onto the
    transient/overload/permanent taxonomy. A card's OOM
    (`torch.cuda.OutOfMemoryError`, or its message) is transient."""
    if is_overload_error(e):
        return OVERLOAD
    msg = str(e)
    if is_transport_message(msg) or is_oom_error(e if isinstance(
            e, BaseException) else RuntimeError(msg)):
        return TRANSIENT
    if isinstance(e, BaseException):
        if isinstance(e, (TimeoutError, ConnectionError)):
            return TRANSIENT
        if isinstance(e, OSError) and e.errno in (errno.ENOSPC,
                                                  errno.EAGAIN):
            return TRANSIENT
    low = msg.lower()
    if any(sig.lower() in low for sig in _TRANSIENT_EXTRA_SIGNATURES):
        return TRANSIENT
    return PERMANENT


def release_device_memory() -> None:
    """Collect dropped tensors and return the cached blocks to the card,
    as the reference empties the CUDA cache between sizes."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
