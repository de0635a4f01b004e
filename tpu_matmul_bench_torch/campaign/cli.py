"""`python -m tpu_matmul_bench_torch campaign {run,resume,status,gate}`.

Port of `tpu_matmul_bench/campaign/cli.py`, with its flags and exit codes:
`run` executes a declarative spec into a campaign directory, `resume` finishes
a killed/interrupted one (re-running only unfinished fingerprints),
`status` reads the journal, and `gate` compares two campaigns (or a
campaign and a baseline snapshot) with a noise-aware threshold.

The parent process never initializes CUDA — the job children own the card
— so reporting is forced on (the same parent-off-the-device contract as
`compare --isolate`).

`run --lint` runs the contract auditor before any job, as a child on the
CPU (`python -m tpu_matmul_bench_torch lint --device cpu --fail-on error
--specs SPEC`, with no card visible to it), so that the campaign's parent
holds no device; a finding stops the campaign. `--no-hlo` with it skips
the lint's `sched`, `memory` and `fingerprint` groups. `gate --history` gates against the port's metric-history store
(`obs/history.py`, ``measurements/torch/history.jsonl``).

Exit codes: `run`/`resume` exit 1 if any job failed; `gate` exits 0 on
pass, 1 on regression (or a lost job), 2 on unusable input.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Sequence

from tpu_matmul_bench_torch.campaign import executor, gate as gate_mod, state
from tpu_matmul_bench_torch.campaign.spec import CampaignSpecError, load_spec
from tpu_matmul_bench_torch.campaign.store import CampaignStore
from tpu_matmul_bench_torch.utils import telemetry

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_matmul_bench_torch campaign",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="execute a campaign spec")
    run.add_argument("spec", help="spec file (.toml, or JSON)")
    run.add_argument("--dir", dest="campaign_dir", required=True,
                     help="campaign directory (journal, spec copy, "
                          "jobs/<id>.jsonl ledgers)")
    run.add_argument("--resume", action="store_true",
                     help="continue an existing campaign in --dir instead "
                          "of refusing to touch it")
    run.add_argument("--dry-run", action="store_true",
                     help="print the expanded job plan (id, fingerprint, "
                          "command) without executing")
    run.add_argument("--trace-out", default=None,
                     help="campaign-level Chrome-trace span timeline "
                          "('-' for stdout)")
    run.add_argument("--lint", action="store_true",
                     help="run the contract auditor (`lint --device cpu "
                          "--fail-on error --specs SPEC`, a CPU child) before "
                          "any job; a finding stops the campaign")
    run.add_argument("--no-hlo", action="store_true",
                     help="with --lint: skip the lint's memory group, which "
                          "runs every mode for its live bytes")

    res = sub.add_parser("resume", help="finish an interrupted campaign")
    res.add_argument("campaign_dir")
    res.add_argument("--trace-out", default=None)

    st = sub.add_parser("status", help="journal-derived job status table")
    st.add_argument("campaign_dir")

    gt = sub.add_parser("gate", help="pass/fail vs a baseline")
    gt.add_argument("campaign_dir")
    gt.add_argument("--baseline", default=None,
                    help="baseline campaign directory, or a snapshot JSON "
                         "written by --write-baseline (alternative: "
                         "--history)")
    gt.add_argument("--history", nargs="?", const="", default=None,
                    metavar="STORE",
                    help="gate against the metric-history store's "
                         "last-known-good per job instead of a lone "
                         "baseline file (optional value: a store path; "
                         "default measurements/torch/history.jsonl). Jobs "
                         "whose series has no prior round gate as 'new'; "
                         "lost jobs are only detectable with --baseline")
    gt.add_argument("--threshold-pct", type=float,
                    default=gate_mod.DEFAULT_THRESHOLD_PCT,
                    help="regression threshold (default %(default)s%%; "
                         "widened per job by measured sample noise, never "
                         f"tighter than ±{gate_mod.NOISE_FLOOR_PCT}%% drift)")
    gt.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="also snapshot THIS campaign's summary as a "
                         "baseline JSON (e.g. BASELINE_CAMPAIGN.json)")
    return p


def _load_spec_or_exit(path: str):
    try:
        return load_spec(path)
    except CampaignSpecError as e:
        raise SystemExit(f"campaign: bad spec: {e}")


def pre_campaign_lint(spec_path: str, no_hlo: bool = False) -> None:
    """The --lint gate: audit the spec and the code in a CPU child before
    any job spends card time. A child keeps the campaign's parent off the
    device (the executor's children must be able to claim the card), and
    it sees no card at all. A finding (or a crash) stops the campaign."""
    import os
    import subprocess

    env = dict(executor._campaign_env(None), CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "tpu_matmul_bench_torch", "lint", "--device", "cpu",
           "--fail-on", "error", "--specs", os.path.abspath(spec_path)]
    if no_hlo:
        cmd.append("--no-hlo")
    proc = subprocess.run(cmd, env=env)
    if proc.returncode:
        raise SystemExit("campaign: lint gate failed (run `python -m "
                         "tpu_matmul_bench_torch lint --device cpu` for details)")


def _cmd_run(args: argparse.Namespace) -> int:
    if getattr(args, "lint", False):
        pre_campaign_lint(args.spec, no_hlo=getattr(args, "no_hlo", False))
    spec = _load_spec_or_exit(args.spec)
    if args.dry_run:
        for job in spec.jobs:
            ledger, _ = executor.job_paths(args.campaign_dir, job)
            cmd = executor.job_command(job, args.campaign_dir, ledger)
            print(f"{job.fingerprint}  {job.job_id}\n    {' '.join(cmd)}")
        print(f"{len(spec.jobs)} jobs (dry run; nothing executed)")
        return 0
    try:
        with telemetry.session(args.trace_out):
            outcomes = executor.run_campaign(
                spec, args.campaign_dir,
                resume=getattr(args, "resume", False))
    except RuntimeError as e:  # e.g. refusing to restart a journaled dir
        raise SystemExit(f"campaign: {e}")
    failed = [o for o in outcomes if o.status == state.FAILED]
    done = [o for o in outcomes if o.status != state.FAILED]
    print(f"campaign: {len(done)}/{len(outcomes)} jobs done"
          + (f", {len(failed)} FAILED: "
             + ", ".join(o.job.job_id for o in failed) if failed else ""))
    merged = Path(args.campaign_dir) / executor.MERGED_TRACE_NAME
    if merged.exists():
        print(f"campaign: merged trace at {merged}")
    return 1 if failed else 0


def _cmd_resume(args: argparse.Namespace) -> int:
    spec_copy = Path(args.campaign_dir) / executor.SPEC_COPY_NAME
    if not spec_copy.exists():
        raise SystemExit(f"campaign: {args.campaign_dir} has no "
                         f"{executor.SPEC_COPY_NAME} to resume from")
    args.spec = str(spec_copy)
    args.resume, args.dry_run = True, False
    return _cmd_run(args)


def _cmd_status(args: argparse.Namespace) -> int:
    store = CampaignStore.load(args.campaign_dir)
    width = max((len(j.job_id) for j in store.jobs.values()), default=6)
    print(f"campaign {store.spec.name} in {store.campaign_dir}:")
    for fp, jl in store.jobs.items():
        n = len(jl.records)
        print(f"  {jl.job_id:<{width}}  {jl.status:<8} {fp}"
              + (f"  {n} records" if n else ""))
    counts = store.status_counts()
    print("  " + "  ".join(f"{k}={v}" for k, v in sorted(counts.items())))
    return 0


def _cmd_gate(args: argparse.Namespace) -> int:
    if (args.baseline is None) == (args.history is None):
        print("campaign gate: need exactly one of --baseline or "
              "--history")
        return gate_mod.EXIT_UNUSABLE
    try:
        current = gate_mod.load_summary(args.campaign_dir)
        if args.history is not None:
            baseline = gate_mod.history_baseline(args.campaign_dir,
                                                 args.history or None)
        else:
            baseline = gate_mod.load_summary(args.baseline)
    except (RuntimeError, FileNotFoundError) as e:
        print(f"campaign gate: {e}")
        return gate_mod.EXIT_UNUSABLE
    if args.write_baseline:
        gate_mod.write_baseline(current, args.write_baseline)
        print(f"baseline snapshot written to {args.write_baseline}")
    report = gate_mod.run_gate(current, baseline,
                               threshold_pct=args.threshold_pct)
    print(report.format())
    return report.exit_code


def main(argv: Sequence[str] | None = None) -> int:
    # the campaign parent must not initialize the card (children own it),
    # so the reporting gate cannot ask the device runtime
    from tpu_matmul_bench_torch.utils.reporting import (
        force_reporting_process,
        reporting_process_override,
    )

    prev = reporting_process_override()
    force_reporting_process(True)
    try:
        args = build_parser().parse_args(argv)
        rc = {"run": _cmd_run, "resume": _cmd_resume,
              "status": _cmd_status, "gate": _cmd_gate}[args.command](args)
    finally:
        force_reporting_process(prev)
    if rc:
        raise SystemExit(rc)
    return rc
