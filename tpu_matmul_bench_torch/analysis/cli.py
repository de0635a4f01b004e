"""`python -m tpu_matmul_bench_torch lint` — run the contract audits.

Port of `tpu_matmul_bench/analysis/cli.py`, with its flags and exit codes:
0 when no finding is at or above `--fail-on`, 1 when one is (the lint
completed: read the findings), above 1 when the linter itself crashed.
The findings ledger (`--json-out`) is schema-v2 JSONL: a manifest, one
`lint_finding` line a finding, a `lint_summary` trailer.

Deviations, on purpose:

- The audits run each program once and record it (`analysis/auditor.py`),
  on the card unless `--device cpu` is given; without a card and without
  that flag the lint exits 2, as `serve` and `obs selftest` do. JAX pins
  its lint to the CPU, where it only traces.
- The audit worlds of 4 and 8 ranks share one device: the CLI sets
  `TMB_RANKS_PER_CARD` to 8 when it is unset (JAX forces 8 host devices).
- `--no-hlo` skips JAX's HLO pass family, `sched`, `memory` and
  `fingerprint`, the groups that run their programs once more for their
  schedule, live bytes and fingerprint (the port has no compiled HLO).
- The default specs are the port's card specs, `specs/torch/*.toml`.

`lint conc selftest` and `lint schema selftest`, the source certifiers'
self-checks, dispatch before torch is imported, as JAX's dispatch before
jax: they parse the tree and never run it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import sys
from pathlib import Path
from typing import Iterator

#: the exit code of a refused subcommand (argparse's usage-error code)
EXIT_REFUSED = 2


def build_parser() -> argparse.ArgumentParser:
    from tpu_matmul_bench_torch.analysis.auditor import audit_groups

    parser = argparse.ArgumentParser(
        prog="lint",
        description="Contract auditor: every impl x mode run once and "
                    "recorded against its contract, plus offline spec "
                    "validation.",
        epilog="exit codes: 0 = no finding at or above --fail-on severity; "
               "1 = at least one such finding (lint completed — read the "
               "findings); 2 = no card without --device cpu, or a refused "
               "subcommand; >1 otherwise = the linter itself crashed.")
    parser.add_argument("--fail-on", choices=("warn", "error"), default="error",
                        help="lowest severity that fails the run (default: error)")
    parser.add_argument("--json-out", default=None,
                        help="write the findings ledger (schema-v2 JSONL)")
    parser.add_argument("--specs", nargs="*", default=None,
                        help="spec files to lint (default: specs/torch/*.toml "
                             "under the repo root)")
    parser.add_argument("--skip", nargs="*", default=(), choices=audit_groups(),
                        help="audit groups to skip (derived from the audit "
                             "registry — every registered group is skippable, "
                             "nothing else is)")
    parser.add_argument("--no-hlo", action="store_true",
                        help="skip the sched, memory and fingerprint groups, "
                             "which run their programs once more (JAX's HLO "
                             "pass family)")
    parser.add_argument("--mem-budget-gib", type=float, default=None,
                        help="per-device budget for the MEM-001 gate "
                             "(default: the device's own memory)")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress per-finding lines; print the summary only")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the audited programs run (default: the card)")
    return parser


def default_specs() -> list[str]:
    spec_dir = Path(__file__).resolve().parents[2] / "specs" / "torch"
    return sorted(str(p) for p in spec_dir.glob("*.toml"))


@contextlib.contextmanager
def audit_ranks() -> Iterator[None]:
    """`TMB_RANKS_PER_CARD` at the audits' 8 ranks a device while the
    block runs, unless the caller set it."""
    from tpu_matmul_bench_torch.analysis.auditor import AUDIT_RANKS
    from tpu_matmul_bench_torch.parallel.mesh import RANKS_PER_CARD_ENV

    if RANKS_PER_CARD_ENV in os.environ:
        yield
        return
    os.environ[RANKS_PER_CARD_ENV] = str(AUDIT_RANKS)
    try:
        yield
    finally:
        os.environ.pop(RANKS_PER_CARD_ENV, None)


def main(argv: list[str] | None = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # the source certifiers' self-checks (real tree clean, seeded rules
    # fire, deterministic findings, live declaration tables): torch-free,
    # so they dispatch before torch is imported
    if argv[:1] == ["conc"]:
        if argv[1:] != ["selftest"]:
            print("usage: lint conc selftest", file=sys.stderr)
            raise SystemExit(EXIT_REFUSED)
        from tpu_matmul_bench_torch.analysis.concurrency import run_conc_selftest

        return run_conc_selftest()
    if argv[:1] == ["schema"]:
        if argv[1:] != ["selftest"]:
            print("usage: lint schema selftest", file=sys.stderr)
            raise SystemExit(EXIT_REFUSED)
        from tpu_matmul_bench_torch.analysis.schema_flow import run_schema_selftest

        return run_schema_selftest()
    args = build_parser().parse_args(argv)

    import torch

    from tpu_matmul_bench_torch.analysis.auditor import HLO_AUDITS, audit_devices, run_groups
    from tpu_matmul_bench_torch.analysis.findings import should_fail, summarize, write_ledger

    if args.device == "cuda" and not torch.cuda.is_available():
        print("lint: no CUDA device is available; pass --device cpu to run the "
              "audits on the CPU", file=sys.stderr)
        raise SystemExit(EXIT_REFUSED)
    skip = list(args.skip)
    if args.no_hlo:
        skip.extend(g for g in HLO_AUDITS if g not in skip)
    spec_paths = args.specs if args.specs is not None else default_specs()
    with audit_ranks():
        devices = audit_devices(args.device)
        groups = run_groups(devices, spec_paths=spec_paths, skip=skip,
                            mem_budget_gib=args.mem_budget_gib)
        findings = [f for found, _ in groups.values() for f in found]
        peaks = None
        if args.json_out and "memory" not in skip:
            from tpu_matmul_bench_torch.analysis.memory_model import peak_report

            peaks = peak_report(devices)  # cached: the memory group ran these

    if not args.quiet:
        for f in findings:
            print(f"[{f.severity:5s}] {f.rule} {f.where}: {f.message}")
    counts = summarize(findings)
    print(f"lint: {counts['error']} error(s), {counts['warn']} warning(s), "
          f"{counts['info']} info")
    print("lint groups (s): " + ", ".join(f"{name} {seconds:.2f}"
                                           for name, (_, seconds) in groups.items()))
    if args.json_out:
        extra = {"fail_on": args.fail_on, "specs": [str(p) for p in spec_paths],
                 "skipped": skip, "device": args.device,
                 # each group's seconds and findings by rule and severity
                 "groups": {name: {"seconds": seconds,
                                   "findings": dict(collections.Counter(
                                       f"{f.rule}/{f.severity}" for f in found))}
                            for name, (found, seconds) in groups.items()}}
        if peaks is not None:
            extra["peak_memory"] = peaks
        write_ledger(args.json_out, findings, extra=extra, device=args.device)
        print(f"findings ledger written to {args.json_out}")
    if should_fail(findings, args.fail_on):
        raise SystemExit(1)
    return [f.to_record() for f in findings]


if __name__ == "__main__":
    main()
