"""Torn-tail repair for append-mode durable JSONL files.

Every durable store in the repo is an append-only JSONL file written
fsync-per-line, such as a benchmark ledger opened in append mode. A crash
(SIGKILL, power loss, ENOSPC) can still land mid-write, leaving a final
line with no terminating newline. Readers tolerate that, skipping the
unparseable tail, but *appending* after such a crash would splice the
next record onto the torn half-line. Every appending writer therefore
calls `repair_torn_tail` before reopening a file in append mode: it
truncates the file back to its last complete line. The torn suffix was
never durable data (its fsync never returned), so dropping it is exactly
what the readers already do.

A copy of `tpu_matmul_bench/utils/durable.py`: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import os
from pathlib import Path

# Probe window for locating the last newline; a single JSONL record is
# far smaller than this, so the second full-file read is cold-path.
_TAIL_CHUNK = 1 << 16


def repair_torn_tail(path: str | os.PathLike[str]) -> bool:
    """Truncate `path` back to its last newline-terminated line.

    Returns True when a torn (newline-less) suffix was dropped; missing,
    empty, and cleanly-terminated files are left untouched. The
    truncation is fsynced so a crash immediately after repair cannot
    resurrect the torn bytes.
    """
    p = Path(path)
    try:
        size = p.stat().st_size
    except OSError:
        return False
    if size == 0:
        return False
    with open(p, "rb+") as fh:
        fh.seek(max(0, size - _TAIL_CHUNK))
        tail = fh.read()
        if tail.endswith(b"\n"):
            return False
        nl = tail.rfind(b"\n")
        if nl < 0 and len(tail) < size:
            # Torn line longer than the probe window: scan the whole file.
            fh.seek(0)
            tail = fh.read()
            nl = tail.rfind(b"\n")
            base = 0
        else:
            base = size - len(tail)
        keep = base + nl + 1  # nl == -1 -> keep == base (drop everything)
        fh.truncate(keep)
        fh.flush()
        os.fsync(fh.fileno())
    return True
