"""OOM and transport-failure classification, and releasing device memory.

Port of `tpu_matmul_bench/utils/errors.py:20-45, 188-197`. A failed CUDA
allocation raises `torch.cuda.OutOfMemoryError`; the runner skips that
size and continues, as the reference does.
"""

from __future__ import annotations

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


def release_device_memory() -> None:
    """Collect dropped tensors and return the cached blocks to the card,
    as the reference empties the CUDA cache between sizes."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
