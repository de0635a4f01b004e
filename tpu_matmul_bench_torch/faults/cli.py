"""`python -m tpu_matmul_bench_torch faults {run,audit,selftest}`.

Port of `tpu_matmul_bench/faults/cli.py`, with its subcommands, flags and
exit codes, and `audit --device`: where the serve cells' `serve selftest`
runs (the card unless `--device cpu` is asked for, as every port entry
point).

- `run` — execute one resumable chaos micro-workload (faults/workloads.py)
  in this process. This is what the certifier's child processes and the
  campaign chaos cells invoke; it is fault-oblivious — injection rides
  the TPU_BENCH_FAULT_PLAN env var through telemetry spans, never flags.
- `audit` — the crash-consistency certifier over a committed chaos
  matrix (`specs/chaos.toml`): every cell runs clean and
  faulted-then-resumed, and the durable artifacts must converge.
  Exits nonzero when any cell fails certification.
- `selftest` — in-process invariants CI runs on every push: fault-plan
  grammar round-trip, deterministic retry backoff, the circuit breaker's
  open/shed/half-open/recover cycle with obs-bus visibility, the
  FAULT-001/002 static audits (clean on the real tree, firing on seeded
  violations), chaos-matrix coverage, and an in-process
  tear-then-resume ledger convergence check. No subprocesses, no device.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

from tpu_matmul_bench_torch.utils import telemetry


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_matmul_bench_torch faults",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run one resumable chaos workload")
    run.add_argument("--workload", required=True,
                     choices=("ledger", "tune", "obs"))
    run.add_argument("--records", type=int, default=None,
                     help="ledger workload: measurement records to write")
    run.add_argument("--cells", type=int, default=None,
                     help="tune workload: tuning cells to append")
    run.add_argument("--snapshots", type=int, default=None,
                     help="obs workload: snapshots to emit")
    run.add_argument("--json-out", default=None,
                     help="ledger workload output (campaign injects this)")
    run.add_argument("--db", default=None,
                     help="tune workload DB path (default: "
                          "tune_db.jsonl beside --json-out or cwd)")
    run.add_argument("--obs-dir", default=None,
                     help="obs workload snapshot directory")
    run.add_argument("--trace-out", default=None,
                     help="Chrome trace (campaign injects this)")

    audit = sub.add_parser(
        "audit", help="certify crash consistency over a chaos matrix")
    audit.add_argument("--spec", required=True,
                       help="chaos matrix TOML (specs/chaos.toml)")
    audit.add_argument("--dir", default=None,
                       help="audit working directory (default: a fresh "
                            "temp dir; pass one to keep the evidence)")
    audit.add_argument("--smoke", action="store_true",
                       help="first direct cell per subsystem only (CI)")
    audit.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where the serve cells' `serve selftest` runs "
                            "(default: cuda)")

    sub.add_parser("selftest",
                   help="in-process fault-machinery invariants (CI)")
    return p


def _cmd_run(args) -> int:
    from tpu_matmul_bench_torch.faults.workloads import (
        DEFAULT_UNITS,
        run_ledger,
        run_obs,
        run_tune,
    )

    with telemetry.session(args.trace_out):
        if args.workload == "ledger":
            if not args.json_out:
                print("faults run --workload ledger needs --json-out",
                      file=sys.stderr)
                return 2
            return run_ledger(args.json_out,
                              records=args.records or DEFAULT_UNITS)
        if args.workload == "tune":
            db = args.db or (
                str(Path(args.json_out).with_name("tune_db.jsonl"))
                if args.json_out else "tune_db.jsonl")
            return run_tune(db, cells=args.cells or DEFAULT_UNITS)
        out_dir = args.obs_dir or (
            str(Path(args.json_out).parent) if args.json_out else ".")
        return run_obs(out_dir, snapshots=args.snapshots or DEFAULT_UNITS)


def _cmd_audit(args) -> int:
    from tpu_matmul_bench_torch.faults.audit import run_audit

    out_dir = args.dir or tempfile.mkdtemp(prefix="fault_audit_")
    print(f"fault audit: spec={args.spec} dir={out_dir}"
          + (" (smoke subset)" if args.smoke else ""))
    _results, ok = run_audit(args.spec, out_dir, smoke=args.smoke,
                             device=args.device)
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# selftest

def _check(ok: bool, what: str, problems: list[str]) -> None:
    status = "ok" if ok else "FAIL"
    print(f"  [{status}] {what}")
    if not ok:
        problems.append(what)


def _selftest_plan(problems: list[str]) -> None:
    from tpu_matmul_bench_torch.faults.plan import (
        FaultPlan,
        FaultPlanError,
        FaultSpec,
        parse_inline,
    )

    plan = FaultPlan(specs=(
        FaultSpec(kind="kill9", phase="w:record", occurrence=2),
        FaultSpec(kind="hang", phase="w:cell", delay_ms=1500),
        FaultSpec(kind="torn-write", phase="w:cell", glob="*.jsonl",
                  occurrence=3),
        FaultSpec(kind="transient-exc", phase="job:*",
                  errclass="transport"),
        FaultSpec(kind="disk-full", phase="w:snapshot", occurrence=2),
    ), seed=7)
    _check(parse_inline(plan.to_inline(), seed=7) == plan,
           "fault-plan inline grammar round-trips every kind", problems)
    rejected = []
    for bad in ("kill9", "meteor-strike@w:record", "hang@w:cell",
                "torn-write@w:cell", "kill9@w:record#0"):
        try:
            parse_inline(bad)
        except FaultPlanError:
            rejected.append(bad)
    _check(len(rejected) == 5, "malformed plans are rejected loudly",
           problems)


def _selftest_retry(problems: list[str]) -> None:
    from tpu_matmul_bench_torch.faults.retry import RetryBudget, RetryPolicy

    pol = RetryPolicy(base_s=30.0, jitter_pct=20.0, seed=11)
    twin = RetryPolicy(base_s=30.0, jitter_pct=20.0, seed=11)
    _check(all(pol.delay(a, k) == twin.delay(a, k)
               for a in (1, 2, 3) for k in ("error", "transport", "timeout"))
           and pol.delay(2, "error") != RetryPolicy(
               base_s=30.0, jitter_pct=20.0, seed=12).delay(2, "error"),
           "jittered backoff is deterministic for (seed, attempt, kind)",
           problems)
    _check(RetryPolicy().delay(1, "transport")
           >= RetryPolicy().transport_min_s,
           "transport failures get the re-rendezvous floor", problems)
    budget = RetryBudget(retries=2)
    spent = 0
    while budget.allow():
        budget.spend()
        spent += 1
    _check(spent == 2 and budget.attempts == 3,
           "retry budget spends exactly `retries` then stops", problems)


def _selftest_classify(problems: list[str]) -> None:
    from tpu_matmul_bench_torch.utils.errors import (
        OVERLOAD,
        PERMANENT,
        TRANSIENT,
        BreakerOpenError,
        QueueOverflowError,
        classify,
    )

    table = (
        (ConnectionResetError("Connection reset by peer"), TRANSIENT),
        (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), TRANSIENT),
        (OSError(28, "No space left on device"), TRANSIENT),
        (QueueOverflowError(8, 8), OVERLOAD),
        (BreakerOpenError(0, 8, bucket="256x256x256/f32"), OVERLOAD),
        (ValueError("shape mismatch"), PERMANENT),
    )
    _check(all(classify(exc) == want for exc, want in table),
           "failure taxonomy classifies the canonical table", problems)


def _selftest_breaker(problems: list[str]) -> None:
    from tpu_matmul_bench_torch.obs.registry import get_registry
    from tpu_matmul_bench_torch.serve.queue import Request
    from tpu_matmul_bench_torch.serve.scheduler import ContinuousScheduler
    from tpu_matmul_bench_torch.utils.errors import BreakerOpenError

    clock = [0.0]
    sched = ContinuousScheduler(breaker_threshold=3, breaker_cooldown_s=5.0,
                                clock=lambda: clock[0])
    bucket = sched.grid.bucket(256, 256, 256)
    for _ in range(3):
        sched.note_result(bucket, "float32", ok=False)
    label, st = next(iter(sched.stats()["breakers"].items()))
    _check(st["state"] == "open" and st["opens"] == 1,
           f"breaker opens after 3 consecutive failures ({label})",
           problems)
    try:
        sched.submit(Request(rid=0, m=256, k=256, n=256, dtype="float32"))
        shed = False
    except BreakerOpenError:
        shed = True
    _check(shed, "open breaker sheds at the door with its own reason",
           problems)
    clock[0] += 5.0
    probe = sched.submit(
        Request(rid=1, m=256, k=256, n=256, dtype="float32"))
    sched.take_batch()
    sched.note_result(probe.bucket, "float32", ok=True)
    st = sched.stats()["breakers"][label]
    _check(st["state"] == "closed",
           "half-open probe's success closes the breaker", problems)
    snap = get_registry().snapshot()
    counters = snap.get("counters", {})

    def _total(name: str) -> float:
        return sum(v for k, v in counters.items()
                   if k == name or k.startswith(name + "{"))

    _check(_total("serve_breaker_opens_total") >= 1
           and _total("serve_breaker_sheds_total") >= 1
           and _total("serve_breaker_recoveries_total") >= 1,
           "breaker lifecycle is visible on the obs bus", problems)


def _selftest_static(problems: list[str]) -> None:
    from tpu_matmul_bench_torch.faults.audit import static_findings

    real = static_findings()
    _check(not real,
           "FAULT-001/002 clean on the real tree "
           + (f"(violations: {[f.where for f in real]})" if real else ""),
           problems)
    with tempfile.TemporaryDirectory() as td:
        bad = Path(td) / "rogue.py"
        bad.write_text("import os, subprocess\n"
                       "subprocess" + ".run(['true'])\n"
                       "os" + ".fsync(3)\n")
        seeded = static_findings(td, spawn_allowlist={}, writer_registry={})
        rules = sorted({f.rule for f in seeded})
        _check(rules == ["FAULT-001", "FAULT-002"],
               f"seeded violations trip exactly FAULT-001+FAULT-002 "
               f"(got {rules})", problems)


def _selftest_chaos_spec(problems: list[str]) -> None:
    from tpu_matmul_bench_torch.faults.audit import (
        SUBSYSTEMS,
        lint_chaos_data,
        load_chaos_spec,
    )
    from tpu_matmul_bench_torch.faults.plan import KINDS

    spec_path = _package_spec_path()
    if not spec_path.exists():
        _check(False, f"chaos matrix missing at {spec_path}", problems)
        return
    spec = load_chaos_spec(spec_path)
    from tpu_matmul_bench_torch.campaign.spec import _parse_toml

    findings = lint_chaos_data(_parse_toml(spec_path.read_text()),
                               str(spec_path))
    _check(not findings,
           f"specs/chaos.toml lints clean ({len(spec.cells)} cells)",
           problems)
    kinds = {c.fault for c in spec.cells}
    subsystems = {c.subsystem for c in spec.cells}
    _check(kinds == set(KINDS),
           f"chaos matrix covers every fault kind (missing: "
           f"{sorted(set(KINDS) - kinds)})", problems)
    _check(subsystems == set(SUBSYSTEMS),
           f"chaos matrix covers every subsystem (missing: "
           f"{sorted(set(SUBSYSTEMS) - subsystems)})", problems)


def _selftest_ledger_convergence(problems: list[str]) -> None:
    """The certification contract in miniature, in-process: a torn ledger
    resumed must equal a clean run — without spawning anything."""
    from tpu_matmul_bench_torch.faults.audit import _ledger_state
    from tpu_matmul_bench_torch.faults.plan import tear_file
    from tpu_matmul_bench_torch.faults.workloads import run_ledger

    with tempfile.TemporaryDirectory() as td:
        clean = Path(td) / "clean.jsonl"
        torn = Path(td) / "torn.jsonl"
        run_ledger(str(clean), records=3)
        run_ledger(str(torn), records=2)  # "crashed" after 2 units
        tear_file(torn)  # ...mid-write of its last record
        run_ledger(str(torn), records=3)  # resume
        cp: list[str] = []
        tp: list[str] = []
        same = _ledger_state(clean, 3, cp) == _ledger_state(torn, 3, tp)
        _check(same and not cp and not tp,
               "torn ledger resumed converges to the clean run's state "
               f"(problems: {cp + tp})", problems)


def _package_spec_path() -> Path:
    return Path(__file__).resolve().parents[2] / "specs" / "chaos.toml"


def _cmd_selftest() -> int:
    print("faults selftest (in-process, no subprocesses, no device)")
    problems: list[str] = []
    _selftest_plan(problems)
    _selftest_retry(problems)
    _selftest_classify(problems)
    _selftest_breaker(problems)
    _selftest_static(problems)
    _selftest_chaos_spec(problems)
    _selftest_ledger_convergence(problems)
    if problems:
        print(f"faults selftest: {len(problems)} FAILED", file=sys.stderr)
        return 1
    print("faults selftest: all invariants hold")
    return 0


def main(argv: list[str] | None = None):
    args = _build_parser().parse_args(argv)
    if args.cmd == "run":
        rc = _cmd_run(args)
    elif args.cmd == "audit":
        rc = _cmd_audit(args)
    else:
        rc = _cmd_selftest()
    if rc:
        raise SystemExit(rc)
    return []


if __name__ == "__main__":
    main()
