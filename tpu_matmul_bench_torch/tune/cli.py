"""`python -m tpu_matmul_bench_torch tune
{show,prune,fill,promote,selftest,online,artifacts}`.

Port of `tpu_matmul_bench/tune/cli.py`, the tuning database's front end.
The measurement sweep itself is `benchmarks/cuda_tune.py`: an invocation
whose first argument is not a subcommand falls through to it verbatim, so
every `tune --sizes ... --candidates ...` spelling keeps working.

- `show`      — the live cells: problem, winner, provenance, staleness
                (`--stale-only`, `--provenance KIND` filter the listing;
                `--check-drift` recomputes every cell's program digest)
- `prune`     — rank the tile candidates with the cost models and print
                what would be measured (trials before → trials after)
- `fill`      — run the `specs/torch/tune.toml` measurement campaign over
                the pruned card tiles (campaign/), then promote the
                winners into the DB
- `promote`   — promote winners from existing tune ledgers into the DB
- `selftest`  — DB schema, provenance and drift consistency
- `online`    — the serve-time shadow-traffic explorer (tune/online.py):
                `online selftest` certifies the ε budget and the
                SLO-debt/breaker guards against a seeded adversarial
                stream
- `artifacts` — the kernel-library store (tune/artifacts.py): `artifacts
                show` lists the manifest, `artifacts verify` exits 1 on
                any integrity (ART-001-class) problem; `--check-drift`
                recomputes each library's program digest from `csrc/`
                (no card needed)

Exit codes, as the JAX package's: `selftest`, `online selftest` and
`artifacts verify` exit 1 on any problem; `fill`/`promote` exit 1 when the
campaign failed or nothing was promotable; `show`, `prune` and `artifacts
show` are informational and exit 0.
"""

from __future__ import annotations

import argparse
from typing import Sequence

SUBCOMMANDS = ("show", "prune", "fill", "promote", "selftest", "online",
               "artifacts")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_matmul_bench_torch tune",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    show = sub.add_parser("show", help="print the live tuning cells")
    show.add_argument("--db", default=None, help="DB path (default: the "
                      "committed measurements/torch/tune_db.jsonl)")
    show.add_argument("--check-drift", action="store_true",
                      help="also recompute every cell's program digest")
    show.add_argument("--stale-only", action="store_true",
                      help="list only stale cells (combine with "
                           "--check-drift for the digest recompute)")
    show.add_argument("--provenance", default=None, metavar="KIND",
                      help="list only cells of this provenance kind "
                           "(measured, analytic, measured-online)")

    prune = sub.add_parser(
        "prune", help="cost-model rank the tile candidates (no device time)")
    prune.add_argument("--size", type=int, action="append", default=[],
                       help="square problem size (repeatable)")
    prune.add_argument("--mkn", action="append", default=[],
                       help="rectangular problem as MxKxN (repeatable)")
    prune.add_argument("--dtype", default="bfloat16")
    prune.add_argument("--top-k", type=int, default=None,
                       help="candidates to keep (default: "
                            "tune.prune.DEFAULT_TOP_K)")
    prune.add_argument("--ring", default=None,
                       help="rank the ring's step problem instead (e.g. "
                            "cuda_ring_hbm, cuda_ring_bidir_rs_hbm)")
    prune.add_argument("--world", type=int, default=8,
                       help="ring size for --ring (default 8)")
    prune.add_argument("--emit-flags", action="store_true",
                       help="print the kept set as --block-m/n/k flag lines")

    fill = sub.add_parser(
        "fill", help="measure pruned candidates via a campaign, then "
                     "promote the winners")
    fill.add_argument("--dir", dest="campaign_dir", required=True,
                      help="campaign directory for the measurement jobs")
    fill.add_argument("--spec", default=None,
                      help="campaign spec (default: specs/torch/tune.toml)")
    fill.add_argument("--db", default=None,
                      help="DB path (default: the committed "
                           "measurements/torch/tune_db.jsonl)")
    fill.add_argument("--device-kind", default=None,
                      help="device kind the winners are promoted under "
                           "(default: tune.promote.H100)")
    fill.add_argument("--resume", action="store_true",
                      help="continue an interrupted fill campaign")
    fill.add_argument("--dry-run", action="store_true",
                      help="print the job plan; measure and promote "
                           "nothing")

    promote = sub.add_parser(
        "promote", help="promote winners from existing tune ledgers")
    promote.add_argument("ledgers", nargs="+",
                         help="tune JSONL ledgers (cuda_tune --json-out)")
    promote.add_argument("--db", default=None)
    promote.add_argument("--device-kind", default=None,
                         help="device kind the winners are promoted under "
                              "(default: tune.promote.H100)")
    promote.add_argument("--dry-run", action="store_true",
                         help="rank and report without writing cells")

    self_ = sub.add_parser(
        "selftest", help="DB schema + provenance consistency check")
    self_.add_argument("--db", default=None)
    self_.add_argument("--no-drift", action="store_true",
                       help="skip the program-digest recompute (schema + "
                            "provenance checks only)")

    online = sub.add_parser(
        "online", help="serve-time shadow-traffic explorer checks")
    online_sub = online.add_subparsers(dest="online_command", required=True)
    online_self = online_sub.add_parser(
        "selftest", help="certify ε budget + SLO/breaker guards against "
                         "a seeded adversarial stream")
    online_self.add_argument("--epsilon", type=float, default=0.1,
                             help="exploration budget under test "
                                  "(default %(default)s)")
    online_self.add_argument("--requests", type=int, default=4000,
                             help="stream length (default %(default)s)")
    online_self.add_argument("--seed", type=int, default=0)

    arts = sub.add_parser(
        "artifacts", help="kernel-library store maintenance")
    arts_sub = arts.add_subparsers(dest="artifacts_command", required=True)
    for name, helptext in (
            ("show", "list the manifest: problem, impl, size, staleness"),
            ("verify", "exit 1 on any integrity problem (ART-001 class); "
                       "staleness is reported but does not fail")):
        ap = arts_sub.add_parser(name, help=helptext)
        ap.add_argument("--store", default=None,
                        help="store root (default: build/artifacts)")
        ap.add_argument("--check-drift", action="store_true",
                        help="also recompute each library's program "
                             "digest from csrc/")
    return p


def _load_db(path):
    from tpu_matmul_bench_torch.tune.db import TuningDB

    return TuningDB.load(path)


def _cmd_show(args) -> int:
    from tpu_matmul_bench_torch.tune.db import cuda_torch_version, recomputed_digests

    db = _load_db(args.db)
    print(f"tuning DB {db.path}: {len(db)} live cells "
          f"({db.records_read} records)")
    for err in db.parse_errors:
        print(f"  PARSE: {err}")
    digests = recomputed_digests(db.cells()) if args.check_drift else None
    stale_total = shown = 0
    for cell in db.cells():
        reasons = db.stale_reasons(
            cell, digests=digests if digests is not None else {})
        stale_total += bool(reasons)
        if args.provenance and cell.provenance_kind != args.provenance:
            continue
        if args.stale_only and not reasons:
            continue
        shown += 1
        blocks = "x".join(str(b) for b in cell.blocks) if cell.blocks \
            else "-"
        flag = " STALE" if reasons else ""
        print(f"  {cell.fingerprint}  {cell.dtype:>8} "
              f"{cell.m}x{cell.k}x{cell.n:<6} {cell.device_kind:>4} "
              f"→ {cell.impl:<5} blocks={blocks:<12} "
              f"[{cell.provenance_kind}]{flag}")
        for r in reasons:
            print(f"      stale: {r}")
    if args.stale_only or args.provenance:
        filters = " ".join(
            f for f in (("stale-only" if args.stale_only else ""),
                        (f"provenance={args.provenance}"
                         if args.provenance else "")) if f)
        print(f"{shown} of {len(db)} cells match [{filters}]")
    current = cuda_torch_version() or "a CPU build of torch (no version check)"
    drift_note = "" if args.check_drift else \
        " (torch-version check only; --check-drift recomputes digests)"
    print(f"{stale_total} stale under {current}{drift_note}")
    return 0


def _cmd_prune(args) -> int:
    from tpu_matmul_bench_torch.tune.prune import DEFAULT_TOP_K, prune

    problems = [(s, s, s) for s in args.size]
    for spec in args.mkn:
        m, k, n = (int(v) for v in spec.lower().split("x"))
        problems.append((m, k, n))
    if not problems:
        problems = [(4096, 4096, 4096), (8192, 8192, 8192),
                    (16384, 16384, 16384)]
    top_k = args.top_k if args.top_k is not None else DEFAULT_TOP_K
    for m, k, n in problems:
        report = prune(m, k, n, args.dtype, top_k=top_k,
                       ring=args.ring, world=args.world)
        for line in report.log_lines():
            print(line)
        if args.emit_flags:
            for bm, bn, bk in report.kept:
                print(f"  --block-m {bm} --block-n {bn} --block-k {bk}")
    return 0


def _cmd_fill(args) -> int:
    import glob
    import os

    from tpu_matmul_bench_torch.campaign import cli as campaign_cli
    from tpu_matmul_bench_torch.tune import promote as promote_mod

    spec = args.spec
    if spec is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        spec = os.path.join(root, "specs", "torch", "tune.toml")
    cmd = ["run", spec, "--dir", args.campaign_dir]
    if args.resume:
        cmd.append("--resume")
    if args.dry_run:
        cmd.append("--dry-run")
    try:
        campaign_cli.main(cmd)
        campaign_rc = 0
    except SystemExit as e:
        campaign_rc = int(e.code or 0) if not isinstance(e.code, str) else 1
    if args.dry_run:
        return campaign_rc
    ledgers = sorted(glob.glob(
        os.path.join(args.campaign_dir, "jobs", "*.jsonl")))
    if not ledgers:
        print("tune fill: campaign produced no ledgers")
        return 1
    db = _load_db(args.db)
    result = promote_mod.promote(ledgers, db,
                                 device_kind=args.device_kind or promote_mod.H100)
    _print_promotions(db, result)
    # a partially failed campaign can still promote what it measured;
    # fail the fill if either stage failed outright
    return 1 if (campaign_rc and not result["promoted"]) else campaign_rc


def _print_promotions(db, result) -> None:
    for cell in result["promoted"]:
        blocks = "x".join(str(b) for b in cell.blocks) if cell.blocks \
            else "-"
        print(f"promoted {cell.dtype} {cell.m}x{cell.k}x{cell.n} → "
              f"{cell.impl} blocks={blocks}  ({cell.detail})")
    for reason in result["skipped"]:
        print(f"skipped  {reason}")
    print(f"{len(result['promoted'])} promoted, "
          f"{len(result['skipped'])} skipped → {db.path}")


def _cmd_promote(args) -> int:
    from tpu_matmul_bench_torch.tune import promote as promote_mod

    db = _load_db(args.db)
    result = promote_mod.promote(args.ledgers, db,
                                 device_kind=args.device_kind or promote_mod.H100,
                                 dry_run=args.dry_run)
    if args.dry_run:
        print("(dry run — nothing written)")
    _print_promotions(db, result)
    return 0 if result["promoted"] else 1


def _cmd_selftest(args) -> int:
    from tpu_matmul_bench_torch.tune.db import recomputed_digests

    db = _load_db(args.db)
    problems = db.validate()
    if not args.no_drift:
        digests = recomputed_digests(db.cells())
        for cell, reasons in db.stale_cells(digests=digests):
            problems.extend(f"{cell.label}: {r}" for r in reasons)
    checks = "schema + provenance" + \
        ("" if args.no_drift else " + drift recompute")
    if problems:
        print(f"tune selftest FAILED ({checks}) — {len(problems)} "
              f"problem(s) across {len(db)} cells in {db.path}:")
        for prob in problems:
            print(f"  {prob}")
        return 1
    print(f"tune selftest ok: {len(db)} cells in {db.path} "
          f"({checks} clean)")
    return 0


def _cmd_online(args) -> int:
    from tpu_matmul_bench_torch.tune.online import run_selftest

    return run_selftest(epsilon=args.epsilon, requests=args.requests,
                        seed=args.seed)


def _cmd_artifacts(args) -> int:
    from tpu_matmul_bench_torch.tune.artifacts import ArtifactStore, recomputed_digests
    from tpu_matmul_bench_torch.tune.db import cuda_torch_version

    store = ArtifactStore.load(args.store)
    print(f"artifact store {store.root}: {len(store)} live artifacts "
          f"({store.records_read} records)")
    digests = recomputed_digests(store.records()) if args.check_drift \
        else None
    stale_total = 0
    for rec in store.records():
        reasons = store.stale_reasons(
            rec, digests=digests if digests is not None else {})
        stale_total += bool(reasons)
        prob = rec.get("problem") or {}
        blocks = "x".join(str(b) for b in rec["blocks"]) \
            if rec.get("blocks") else "-"
        flag = " STALE" if reasons else ""
        print(f"  {rec.get('key', '?')[:16]}  {prob.get('dtype', '?'):>8} "
              f"{prob.get('m')}x{prob.get('k')}x{prob.get('n'):<6} "
              f"→ {rec.get('impl', '?'):<6} blocks={blocks:<14} "
              f"{rec.get('size_bytes', 0) / 1024:.0f} KiB "
              f"torch={rec.get('torch_version')}"
              + (f" {rec['mesh_spec']}" if rec.get("mesh_spec") else "") + flag)
        for r in reasons:
            print(f"      stale: {r}")
    current = cuda_torch_version() or "a CPU build of torch (no version check)"
    drift_note = "" if args.check_drift else \
        " (torch-version check only; --check-drift recomputes digests)"
    print(f"{stale_total} stale under {current}{drift_note}")
    if args.artifacts_command != "verify":
        return 0
    problems = store.validate()
    if problems:
        print(f"tune artifacts verify FAILED — {len(problems)} "
              f"problem(s):")
        for where, message in problems:
            print(f"  {where}: {message}")
        return 1
    print(f"tune artifacts verify ok: {len(store)} artifacts, digest "
          "chain closes (key ← fields, blob ← digest)")
    return 0


def main(argv: Sequence[str] | None = None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in SUBCOMMANDS:
        # flag-style invocation: the measurement sweep, unchanged
        from tpu_matmul_bench_torch.benchmarks import cuda_tune

        return cuda_tune.main(argv)
    args = build_parser().parse_args(argv)
    rc = {"show": _cmd_show, "prune": _cmd_prune, "fill": _cmd_fill,
          "promote": _cmd_promote,
          "selftest": _cmd_selftest, "online": _cmd_online,
          "artifacts": _cmd_artifacts}[args.command](args)
    if rc:
        raise SystemExit(rc)
    return rc


if __name__ == "__main__":
    main()
