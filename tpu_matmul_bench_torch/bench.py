"""Headline benchmark of the port: bf16 16384×16384 matmul TFLOPS on one card.

Port of the repository's root `bench.py`, the JAX package's headline
entry. Run from the repository root on a machine with an NVIDIA card:

    python -m tpu_matmul_bench_torch.bench

It prints JSON lines {"metric", "value", "unit", "vs_baseline", "backend",
"attempts", "impl", "by_impl", "device_kind"}; a reader takes the LAST
line. The baseline is the reference's headline number: ~140 TFLOPS for one
RTX 6000 Ada doing bf16 16384×16384 `torch.matmul` (reference README.md:43,
BASELINE.md). Each attempt follows the reference's protocol, 10 warmup and
50 timed iterations (run_scaling_benchmark.sh:16-19), under `--timing
fused`: 50 chained products captured in one CUDA graph, so the host's
launch rate cannot cap the number.

`impl` names the implementation that set the value: the library product
(`torch`, cuBLAS) or the hand-written kernel (`cuda`, csrc/matmul.cu). The
port's `auto` resolves by the tuning database and the H100 head-to-head
table (`ops/impl_select.py`), which send bf16 16384² to the library product
on the H100, so the ladder also times the kernel in a rung of its own and
`by_impl` holds the best TFLOPS of each (an `auto` record counts under the
impl it resolved to).

The parent process never imports torch and never touches the card: each
attempt is the port's matmul program in a child process writing
`--json-out` records, with a soft deadline. Before the first rung the
parent builds every kernel (`ops/_build.py`, which imports no torch), so no
rung's deadline absorbs the compile; a failed build ends the run with
`backend: "unavailable"` and the error on stderr, and no rung runs without
the kernels. A record above the card's datasheet peak, or one whose
`peak_efficiency_pct` exceeds 100, is a broken protocol, not a
measurement, and is rejected on stderr. Once a value landed, `backend`
reads "ok", or "partial" when a rung failed (`failed` names their impls).

The emit contract survives any termination:
  - a provisional 0.0 line prints at startup, so even SIGKILL leaves a
    parseable last line;
  - every time the best so far improves, a fresh line prints;
  - SIGTERM and SIGINT handlers re-emit the best line before exiting;
  - a JSON line is always last, each written with one `os.write`.

Environment: BENCH_TIMEOUT_S (the budget, default 1500 s), BENCH_HARD_CAP_S
(the grace drain's cap, default 2700 s), BENCH_ARTIFACT_DIR (keep the
attempts' JSONL files there) and BENCH_CHILD_CMD (a JSON argv that replaces
each child, "{out}" standing for its JSONL path and "{impl}" for its rung's
impl; the tests' hook, which also skips the build).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BASELINE_TFLOPS = 140.0  # reference README.md:43 — 1× RTX 6000 Ada, bf16 16k

# The NVIDIA H100 SXM's dense bf16 peak (`utils/metrics.py`, which imports
# torch, so the parent keeps its own copy): no real measurement exceeds it.
MAX_PLAUSIBLE_TFLOPS = 989.0

# Attempt ladder: (impl, iterations, warmup) per rung. The first rung is
# cheap (8 fused iterations) and lands a checked nonzero early; the full
# 50-iteration rungs then overwrite it whenever they read higher. `auto`
# is the router's choice, then each implementation in a rung of its own.
QUICK_ITERATIONS = 8
QUICK_WARMUP = 2
FULL_ITERATIONS = 50
FULL_WARMUP = 10
ATTEMPTS = (
    ("auto", QUICK_ITERATIONS, QUICK_WARMUP),   # the quick rung
    ("auto", FULL_ITERATIONS, FULL_WARMUP),
    ("torch", FULL_ITERATIONS, FULL_WARMUP),
    ("cuda", FULL_ITERATIONS, FULL_WARMUP),
)
SOFT_DEADLINE_S = 900.0   # a full attempt; a healthy one takes under a minute
QUICK_SOFT_DEADLINE_S = 300.0
STRAGGLER_GRACE_S = 300.0  # once one result landed, wait this long for more
MAX_SPAWNS = 8            # the ladder, then retries while nothing has landed
RETRY_BACKOFF_S = 30.0    # between retries when attempts fail fast
POLL_S = 10.0

_best = 0.0  # best TFLOPS seen so far; what every emit reports
_best_from: dict = {"impl": None, "device_kind": None}  # the record that set it
_by_impl: dict[str, float] = {}  # best TFLOPS of each implementation
# "pending" = no attempt finished yet, "unavailable" = the build or an
# attempt failed, "slow" = an attempt blew its soft deadline, "no_result" =
# an attempt exited cleanly without a record; once a measurement landed,
# "ok", or "partial" when an attempt exited nonzero (`failed` names the
# impls of those attempts)
_health = {"backend": "pending", "attempts": 0, "last_rc": None}
_failed: list[str] = []


def _emit() -> None:
    rec = {
        "metric": "bf16_matmul_16k_tflops_per_chip",
        "value": round(_best, 2),
        "unit": "TFLOPS",
        "vs_baseline": round(_best / BASELINE_TFLOPS, 4),
        "backend": (("partial" if _failed else "ok") if _best > 0.0
                    else _health["backend"]),
        "attempts": _health["attempts"],
        "impl": _best_from["impl"],
        "by_impl": {k: round(v, 2) for k, v in sorted(_by_impl.items())},
        "device_kind": _best_from["device_kind"],
    }
    if _best == 0.0 and _health["last_rc"] is not None:
        rec["last_rc"] = _health["last_rc"]
    if _failed:
        rec["failed"] = list(_failed)
    line = json.dumps(rec) + "\n"
    # one os.write of a line shorter than PIPE_BUF is atomic: a signal
    # handler's emit never interleaves with the main thread's
    try:
        try:
            sys.stdout.flush()
        except RuntimeError:
            pass  # a handler re-entered a buffered flush; os.write still lands
        os.write(sys.stdout.fileno(), line.encode())
    except (OSError, ValueError, AttributeError):
        # a captured pseudo-stdout without a real fd (test harnesses)
        try:
            print(line, end="", flush=True)
        except RuntimeError:
            pass


def _collect(outputs: list[tuple[str, str]]) -> list[tuple[float, str, str | None]]:
    """(TFLOPS, impl, device kind) of every plausible record in the
    children's JSONL files, given as (path, impl of the attempt). An `auto`
    record names the impl it resolved to. A half-written trailing line
    parses as invalid JSON and is skipped."""
    found = []
    for path, impl in outputs:
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            continue
        for line in lines:
            try:
                rec = json.loads(line)
                v = float(rec["tflops_per_device"])
            except (ValueError, KeyError, TypeError):
                continue
            peak_pct = rec.get("peak_efficiency_pct")
            if v > MAX_PLAUSIBLE_TFLOPS or (peak_pct is not None and peak_pct > 100):
                print(f"[bench] rejecting implausible {v:.1f} TFLOPS "
                      f"(peak_efficiency_pct {peak_pct}; ceiling "
                      f"{MAX_PLAUSIBLE_TFLOPS}) from {path}",
                      file=sys.stderr, flush=True)
                continue
            extras = rec.get("extras") or {}
            found.append((v, extras.get("matmul_impl_resolved", impl),
                          rec.get("device_kind")))
    return found


def _note_results(outputs: list[tuple[str, str]]) -> bool:
    """Re-scan the children's JSONL files and emit if the best improved.
    Returns True once at least one result has landed."""
    global _best
    found = _collect(outputs)
    for v, impl, _ in found:
        _by_impl[impl] = max(v, _by_impl.get(impl, 0.0))
    if found:
        v, impl, kind = max(found, key=lambda f: f[0])
        if v > _best:
            _best = v
            _best_from.update(impl=impl, device_kind=kind)
            _emit()
    return bool(found)


def _child_argv(impl: str, iters: int, warmup: int, out_path: str) -> list[str]:
    """The attempt: the port's matmul program at bf16 16384³ on one card,
    fused, or the BENCH_CHILD_CMD hook."""
    child_cmd = os.environ.get("BENCH_CHILD_CMD")
    if child_cmd:
        return [a.replace("{out}", out_path).replace("{impl}", impl)
                for a in json.loads(child_cmd)]
    return [sys.executable, "-m", "tpu_matmul_bench_torch", "matmul",
            "--sizes", "16384", "--dtype", "bfloat16",
            "--iterations", str(iters), "--warmup", str(warmup),
            "--num-devices", "1", "--timing", "fused",
            "--matmul-impl", impl, "--json-out", out_path]


def _build_kernels() -> bool:
    """Build every kernel before the first rung, so no rung's soft deadline
    absorbs the compile. False, with `backend: "unavailable"` emitted and
    the error on stderr, when the build fails: no rung runs without the
    kernels. The BENCH_CHILD_CMD hook needs no kernels."""
    if os.environ.get("BENCH_CHILD_CMD"):
        return True
    from tpu_matmul_bench_torch.ops import _build  # imports no torch

    print("[bench] building the kernels", file=sys.stderr, flush=True)
    try:
        _build.build()
    except (_build.KernelBuildError, OSError) as e:
        print(f"[bench] kernel build failed: {e}", file=sys.stderr, flush=True)
        _health["backend"] = "unavailable"
        _emit()
        return False
    return True


def _run_attempts(deadline: float,
                  outputs: list[tuple[str, str]] | None = None,
                  procs: list[subprocess.Popen] | None = None) -> None:
    """Spawn and drain attempts until `deadline`. `outputs` and `procs`,
    when given, are shared with the caller so its grace drain can keep
    collecting after the deadline."""
    artifact_dir = os.environ.get("BENCH_ARTIFACT_DIR")
    if artifact_dir:
        os.makedirs(artifact_dir, exist_ok=True)
        tmpdir = artifact_dir
    else:
        tmpdir = tempfile.mkdtemp(prefix="bench_")
    outputs = [] if outputs is None else outputs
    procs = [] if procs is None else procs

    # the ladder first; past it, retry only while no result has landed
    i = 0
    while (time.time() < deadline and i < MAX_SPAWNS
           and (i < len(ATTEMPTS) or not _note_results(outputs))):
        impl, iters, warmup = ATTEMPTS[i % len(ATTEMPTS)]
        quick = iters < FULL_ITERATIONS
        _health["attempts"] = i + 1
        out_path = os.path.join(tmpdir, f"attempt_{i}_{impl}.jsonl")
        outputs.append((out_path, impl))
        print(f"[bench] attempt {i}: {impl} x{iters}"
              + (" (quick rung)" if quick else ""),
              file=sys.stderr, flush=True)
        procs.append(subprocess.Popen(
            _child_argv(impl, iters, warmup, out_path), cwd=str(REPO),
            # the child's report goes to stderr: stdout holds the JSON lines
            stdout=sys.stderr, stderr=sys.stderr,
        ))
        soft_s = QUICK_SOFT_DEADLINE_S if quick else SOFT_DEADLINE_S
        attempt_deadline = time.time() + min(
            soft_s, max(0.0, deadline - time.time()))
        timed_out = False
        while True:
            try:
                procs[-1].wait(timeout=min(
                    POLL_S, max(0.0, attempt_deadline - time.time())))
                break
            except subprocess.TimeoutExpired:
                _note_results(outputs)
                if time.time() >= attempt_deadline:
                    timed_out = True
                    break
        has_result = _note_results(outputs)
        if timed_out:
            # left running: its late records are still collected below
            _health["backend"] = "slow"
            _health["last_rc"] = None  # this attempt has not exited
            _emit()
            print(f"[bench] attempt {i} ({impl}) slow — continuing",
                  file=sys.stderr, flush=True)
        else:
            if procs[-1].returncode != 0:
                _failed.append(impl)
                _health["backend"] = "unavailable"
                _health["last_rc"] = procs[-1].returncode
                _emit()
            elif not has_result:
                _health["backend"] = "no_result"
                _health["last_rc"] = None
                _emit()
            will_retry = (i + 1 >= len(ATTEMPTS)
                          and i + 1 < MAX_SPAWNS and time.time() < deadline
                          and not has_result)
            if procs[-1].returncode != 0 and will_retry:
                print(f"[bench] attempt {i} ({impl}) failed "
                      f"rc={procs[-1].returncode} — backing off "
                      f"{RETRY_BACKOFF_S:.0f}s before retry",
                      file=sys.stderr, flush=True)
                time.sleep(min(RETRY_BACKOFF_S,
                               max(0.0, deadline - time.time())))
        i += 1

    # drain: children left running may still land results
    first_result_t: float | None = None
    while time.time() < deadline:
        if _note_results(outputs) and first_result_t is None:
            first_result_t = time.time()
        if all(p.poll() is not None for p in procs):
            break
        if (first_result_t is not None
                and time.time() - first_result_t > STRAGGLER_GRACE_S):
            break
        time.sleep(POLL_S)
    _note_results(outputs)


def main() -> None:
    budget_s = float(os.environ.get("BENCH_TIMEOUT_S", "1500"))
    deadline = time.time() + budget_s - 30  # margin to emit and exit

    def _die(signum, frame):  # noqa: ARG001
        print(f"[bench] signal {signum} — emitting best so far and exiting",
              file=sys.stderr, flush=True)
        _emit()
        os._exit(0)

    signal.signal(signal.SIGTERM, _die)
    signal.signal(signal.SIGINT, _die)

    _emit()  # the provisional 0.0 line
    outputs: list[tuple[str, str]] = []
    procs: list[subprocess.Popen] = []
    try:
        if _build_kernels():
            _run_attempts(deadline, outputs, procs)
    except Exception as e:  # noqa: BLE001 — a JSON line must always be last
        print(f"[bench] harness error: {e!r}", file=sys.stderr, flush=True)
    _emit()
    # grace drain: while nothing landed and children still run, keep
    # collecting up to the hard cap
    hard_cap = time.time() + max(
        0.0, float(os.environ.get("BENCH_HARD_CAP_S", "2700")) - budget_s)
    while (_best == 0.0 and time.time() < hard_cap
           and any(p.poll() is None for p in procs)):
        time.sleep(POLL_S)
        _note_results(outputs)
    _emit()
    os._exit(0)


if __name__ == "__main__":
    main()
