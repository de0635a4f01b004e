"""Tracing: `--profile-dir` through `torch.profiler`, and a reader of its
traces.

Port of `tpu_matmul_bench/utils/profiling.py`. The JAX package writes a
`jax.profiler` trace of the run; the port writes `torch.profiler`'s Chrome
trace (host operations, and the card's kernels, copies and fills when the
ranks are on a card), viewable in Perfetto or chrome://tracing. Every timed
window of `utils/timing.py` is a `MEASURE_REGION` range in the trace, so
`device_summary` can read the device's busy and idle share inside the
windows apart from set-up, validation and warm-up.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Any, Iterator

import torch

from tpu_matmul_bench_torch.utils import telemetry
from tpu_matmul_bench_torch.utils.reporting import report

# the host range around each timed loop (utils/timing.py _timed_loop)
MEASURE_REGION = "tmb_measure"
# Chrome-trace categories of the card's own work in a torch.profiler trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_TRACE_NUMBER = itertools.count()


def trace_path(profile_dir: str) -> str:
    """A new trace file in `profile_dir`, unique to this process and run."""
    stamp = time.strftime("%Y%m%d-%H%M%S")
    return os.path.join(profile_dir,
                        f"trace-{stamp}-{os.getpid()}-{next(_TRACE_NUMBER)}.json")


@contextlib.contextmanager
def maybe_trace(profile_dir: str | None, cuda: bool = False) -> Iterator[str | None]:
    """Wrap a benchmark run in a `torch.profiler` trace when a directory is
    given; yields the trace file's path (None without a directory). `cuda`
    adds the card's activity: a trace of a run on the card that holds no
    device event raises, rather than leave an empty trace to be read as an
    idle card."""
    if not profile_dir:
        yield None
        return
    # registered before the JSONL sink opens, so the run's manifest
    # cross-references the profiler artifact (for this run only)
    telemetry.note_artifact("profiler_trace_dir", profile_dir)
    os.makedirs(profile_dir, exist_ok=True)
    path = trace_path(profile_dir)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    report(f"\n[profiler] tracing to {profile_dir}")
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield path
    finally:
        telemetry.forget_artifact("profiler_trace_dir")
    prof.export_chrome_trace(path)
    report(f"[profiler] trace written to {path} (view: Perfetto or chrome://tracing)")
    if cuda and not device_events(load_events(path)):
        raise RuntimeError(
            f"torch.profiler recorded no CUDA activity in {path}: the card's "
            "kernels are not traced here (time them with CUDA events)")


def load_events(path: str) -> list[dict[str, Any]]:
    """The complete ("X") events of a Chrome trace."""
    with open(path) as fh:
        trace = json.load(fh)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    return [e for e in events if isinstance(e, dict) and e.get("ph") == "X"
            and "ts" in e and "dur" in e]


def device_events(events: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """The card's kernels, copies and fills."""
    return [e for e in events if str(e.get("cat", "")).lower() in DEVICE_CATEGORIES]


def _union_us(spans: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) spans."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def device_summary(path: str, top: int = 10) -> dict[str, Any]:
    """What the card did in a trace: its kernels' device time, in all and
    by kernel name with their launches (the `top` largest), and inside the timed windows (`MEASURE_REGION`
    ranges; each window runs from its first device event's start to its
    last one's end) the device's busy and idle share. Times in µs; the
    shares are None where no device event lies in a window."""
    events = load_events(path)
    device = device_events(events)
    by_name: dict[str, list[float]] = {}
    for e in device:
        if str(e.get("cat", "")).lower() == "kernel":
            by_name.setdefault(e["name"], []).append(float(e["dur"]))
    kernels = sorted(({"name": name, "device_us": sum(durs), "count": len(durs)}
                      for name, durs in by_name.items()),
                     key=lambda k: -k["device_us"])
    windows = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
               if e.get("name") == MEASURE_REGION
               and str(e.get("cat", "")).lower() == "user_annotation"]
    span_us = busy_us = 0.0
    for start, end in windows:
        inside = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device
                  if start <= float(e["ts"]) <= end]
        if inside:
            span_us += max(b for _, b in inside) - min(a for a, _ in inside)
            busy_us += _union_us(inside)
    busy = busy_us / span_us if span_us > 0 else None
    return {"device_events": len(device), "kernel_launches": sum(k["count"] for k in kernels),
            "device_us": sum(k["device_us"] for k in kernels),
            "kernels": kernels[:top], "windows": len(windows),
            "window_us": span_us, "busy_us": busy_us, "busy_share": busy,
            "idle_share": None if busy is None else 1.0 - busy}


def kernel_time_us(path: str, name_part: str) -> dict[str, Any]:
    """Device time of the kernels whose name holds `name_part`: their
    count, total and mean µs a launch."""
    durs = [float(e["dur"]) for e in device_events(load_events(path))
            if str(e.get("cat", "")).lower() == "kernel" and name_part in e["name"]]
    return {"count": len(durs), "device_us": sum(durs),
            "us_per_launch": sum(durs) / len(durs) if durs else None}
