"""Device health diagnosis: `python -m tpu_matmul_bench_torch doctor`.

Port of `tpu_matmul_bench/benchmarks/doctor.py`. Before trusting a number
a user asks "can I trust a measurement right now": is the device there at
all, and does the host's launch path keep up with it. This program runs a
staged probe and reports which state the device is in, with the evidence,
announcing each phase before it runs so that a hang shows where it hangs:

1. CUDA init (timed) and the device banner;
2. the sync round trip (`utils/timing.py _measure_sync_overhead` on
   finished work: the fixed cost every dispatch measurement pays);
3. a validated 1024² bf16 product, `torch.matmul` (the counterpart of
   JAX's plain `x @ y`), its corner against a float64 reference;
4. the launch-path verdict: the same product timed under the dispatch
   protocol (`time_jitted`, a launch from the host per call) and the fused
   one (`time_fused`, one CUDA graph of all calls). The path is reported
   degraded when dispatch reads slower than fused by `--degraded-ratio`
   (1.5×) AND by `--degraded-abs-ms` (2 ms) an op: the ratio alone misfires
   on ops so small that healthy launch overhead dominates, the gap alone
   on giant ops.

Exit status: 0 healthy, 3 degraded (the device is fine, use `--timing
fused`), 1 anything failed. With no CUDA device and no `--device cpu` it
fails (exit 1) with the reason; it never carries on on the CPU.

Run: python -m tpu_matmul_bench_torch doctor [--size 1024] [--json-out -]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Sequence


def _phase(msg: str) -> None:
    # progress before each call that could hang, flushed: a wedge then
    # shows in the log at the phase that caused it
    print(f"[doctor] {msg} ...", flush=True)


def run_doctor(size: int, iterations: int, degraded_ratio: float,
               degraded_abs_ms: float, device: str) -> dict:
    report: dict = {"healthy": False, "link": "unknown"}

    _phase("importing torch + initializing the device")
    t0 = time.perf_counter()
    import torch

    from tpu_matmul_bench_torch.utils.device import (
        collect_device_info,
        resolve_devices,
    )

    devices = resolve_devices(device, 1)
    dev = devices[0]
    torch.empty(1, device=dev)  # creates the CUDA context on the card
    info = collect_device_info(devices)
    report["init_s"] = round(time.perf_counter() - t0, 3)
    report["platform"] = info.platform
    report["device_kind"] = info.device_kind
    print(f"[doctor] device up: {info.platform} / {info.device_kind} "
          f"({report['init_s']}s)", flush=True)

    from tpu_matmul_bench_torch.ops.matmul import random_operands
    from tpu_matmul_bench_torch.parallel.modes import (
        corner_validation,
        expected_corner,
    )
    from tpu_matmul_bench_torch.utils import timing

    _phase("measuring sync round-trip latency")
    probe = torch.ones((8, 8), dtype=torch.float32, device=dev)
    timing.sync(probe)
    # the same fixed cost of a synchronize every timed loop measures
    report["sync_roundtrip_ms"] = round(
        timing._measure_sync_overhead(probe, samples=5) * 1e3, 3)
    print(f"[doctor] sync round trip: {report['sync_roundtrip_ms']} ms",
          flush=True)

    _phase(f"running + validating a {size}x{size} bf16 matmul")
    a, b = random_operands(0, (size, size), torch.bfloat16, device=dev)
    mm = torch.matmul
    t0 = time.perf_counter()
    got = mm(a, b)
    timing.sync(got)
    report["first_matmul_s"] = round(time.perf_counter() - t0, 3)
    verdict = corner_validation(got[:8, :8], expected_corner(a, b, corner=8),
                                torch.bfloat16)
    err = verdict["validation_max_rel_err"]
    report["matmul_max_rel_err"] = err
    if verdict["validation"] != "ok":
        report["link"] = "numerics-failed"
        return report
    print(f"[doctor] matmul ok ({report['first_matmul_s']}s incl. first "
          f"call, rel err {err:.2e})", flush=True)

    _phase(f"launch path: dispatch vs fused protocol x{iterations}")
    t_disp = timing.time_jitted(mm, (a, b), iterations=iterations, warmup=2)
    t_fused = timing.time_fused(mm, (a, b), iterations=iterations, warmup=1)
    disp_ms, fused_ms = t_disp.avg_s * 1e3, t_fused.avg_s * 1e3
    report["dispatch_per_op_ms"] = round(disp_ms, 3)
    report["fused_per_op_ms"] = round(fused_ms, 3)
    ratio = t_disp.avg_s / t_fused.avg_s if t_fused.avg_s > 0 else float("inf")
    gap_ms = max(disp_ms - fused_ms, 0.0)
    report["dispatch_over_fused"] = round(ratio, 3)
    report["dispatch_gap_ms"] = round(gap_ms, 3)
    degraded = ratio > degraded_ratio and gap_ms > degraded_abs_ms
    report["link"] = "degraded" if degraded else "ok"
    report["healthy"] = report["link"] == "ok"
    print(f"[doctor] dispatch {disp_ms:.3f} ms/op vs fused {fused_ms:.3f} "
          f"ms/op (ratio {ratio:.2f}) -> link {report['link']}", flush=True)
    return report


def main(argv: Sequence[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__ or "device doctor")
    p.add_argument("--size", type=int, default=1024,
                   help="probe matmul size (default 1024: a device time "
                        "that can be measured, a first call that is fast)")
    p.add_argument("--iterations", type=int, default=20,
                   help="timed iterations per protocol (default 20)")
    p.add_argument("--degraded-ratio", type=float, default=1.5,
                   help="dispatch/fused per-op ratio above which the launch "
                        "path is reported degraded (default 1.5; must ALSO "
                        "exceed --degraded-abs-ms)")
    p.add_argument("--degraded-abs-ms", type=float, default=2.0,
                   help="minimum dispatch-minus-fused per-op gap (ms) for a "
                        "degraded verdict (default 2.0)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Where to run (default: cuda). With no CUDA device "
                        "the probe fails unless --device cpu is given.")
    p.add_argument("--json-out", type=str, default=None,
                   help="write the report as one JSON line ('-' = stdout)")
    args = p.parse_args(argv)

    try:
        report = run_doctor(args.size, args.iterations, args.degraded_ratio,
                            args.degraded_abs_ms, args.device)
    except Exception as e:  # noqa: BLE001 — the verdict must always print
        report = {"healthy": False, "link": "dead",
                  "error": f"{type(e).__name__}: {str(e)[:300]}"}
        print(f"[doctor] FAILED: {report['error']}", flush=True)

    line = json.dumps(report, sort_keys=True)
    if args.json_out == "-":
        print(line, flush=True)
    elif args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(line + "\n")
    verdict = ("HEALTHY" if report["healthy"]
               else f"NOT HEALTHY (link: {report['link']})")
    print(f"[doctor] verdict: {verdict}", flush=True)
    if not report["healthy"]:
        raise SystemExit(3 if report.get("link") == "degraded" else 1)
    return report


def cli_main(argv: Sequence[str] | None = None) -> None:
    """Process entry with a hard exit: a wedged CUDA context can block the
    interpreter's shutdown (the context's teardown waits on the device)
    after the verdict printed. `os._exit` after an explicit flush exits
    with the verdict's code at once. In-process callers (tests) use
    `main` and keep SystemExit semantics."""
    import os
    import sys

    code = 0
    try:
        main(argv)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    cli_main()
