"""`python -m tpu_matmul_bench_torch obs {status,selftest,ingest,history,detect,report}`.

Port of `tpu_matmul_bench/obs/cli.py`, with its flags and exit codes. What
differs, on purpose: `selftest` serves on the card unless `--device cpu`
is asked for (without a card and without it, exit 2), and under
`--matmul-impl cuda`, so its buckets run K1 and carry the kernels' cost
books (a library product keeps none); the store is
``measurements/torch/history.jsonl``, its default sources the card's
ledgers under ``measurements/torch/``, and its default spec
``specs/torch/history.toml``.

`status` reads the snapshot stream an instrumented run exports
(``--obs-dir`` on serve, automatic under ``campaign run``) and prints
the latest registry aggregate — usable **while the run is in flight**:
the exporter appends fsynced JSONL lines, so tailing is safe. `--follow`
keeps polling for new snapshots.

`selftest` is the CI hook proving the whole bus end-to-end: it runs a
real (tiny) serve bench with the exporter attached, then checks
that (1) at least one snapshot landed (OBS-002), (2) the snapshot's
counters reconcile with the ledger's ``extras["serve"]`` stats — the
registry and the compat views must be two views of one truth — and
(3) the ledger's ``cost_analysis`` block (the kernels' cost books)
agrees with the hand FLOPs model within tolerance (OBS-001). Exit 0 =
the bus is live and honest.

The perf-observatory quartet (DESIGN §19):

- `ingest [SOURCES...]` — append every new measurement in the given
  ledgers/round files (default: the card's ledgers under
  ``measurements/torch/``) to ``measurements/torch/history.jsonl`` as one
  ingest round. Idempotent:
  already-ingested (series, source-digest) identities are skipped, so a
  re-run leaves the store byte-identical.
- `history [show|selftest]` — store summary / CI validation (schema,
  fingerprint recompute, live sources, idempotency vs the tree).
- `detect` — noise-aware drift verdicts (HIST-001..004) over the store;
  ``--fail-on error`` is CI layer 9's regression gate.
- `report` — the markdown perf trajectory with per-mode sparklines that
  replaces hand-diffing ledgers.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Sequence

from tpu_matmul_bench_torch.obs import export as obs_export


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_matmul_bench_torch obs",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    status = sub.add_parser(
        "status", help="latest metrics snapshot of an instrumented run")
    status.add_argument("path", nargs="?", default=".",
                        help="snapshot file, its directory, or a "
                             "campaign/serve dir with an obs/ subdir "
                             "(default: .)")
    status.add_argument("--json", action="store_true",
                        help="print the raw snapshot record instead of "
                             "the table")
    status.add_argument("--follow", action="store_true",
                        help="keep polling and print each new snapshot")
    status.add_argument("--interval", type=float, default=0.5,
                        help="poll interval with --follow (default "
                             "%(default)s s)")
    status.add_argument("--timeout", type=float, default=None,
                        help="stop --follow after this many seconds "
                             "without a new snapshot (default: poll "
                             "until interrupted)")

    selftest = sub.add_parser(
        "selftest", help="end-to-end bus check on a tiny serve run")
    selftest.add_argument("--dir", default=None,
                          help="working directory for the run's ledger "
                               "and snapshots (default: a temp dir)")
    selftest.add_argument("--keep", action="store_true",
                          help="with --dir: leave the artifacts in place")
    selftest.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                          help="device to serve on (default %(default)s; "
                               "without a card the selftest stops unless "
                               "cpu is asked for)")

    def add_store(sp: argparse.ArgumentParser) -> None:
        sp.add_argument("--store", default=None,
                        help="history store path (default: "
                             "measurements/torch/history.jsonl at the "
                             "repo root)")

    ingest = sub.add_parser(
        "ingest", help="append new measurements to the history store "
                       "(idempotent)")
    ingest.add_argument("sources", nargs="*",
                        help="ledgers / BENCH_r*.json round files / "
                             "directories to sweep for .jsonl and .ndjson "
                             "ledgers (default: the card's ledgers under "
                             "measurements/torch/)")
    add_store(ingest)
    ingest.add_argument("--seq", type=int, default=None,
                        help="ingest-round number to stamp (default: "
                             "store max + 1)")
    ingest.add_argument("--dry-run", action="store_true",
                        help="report what would be appended, write "
                             "nothing")

    history = sub.add_parser(
        "history", help="summarize or validate the history store")
    history.add_argument("action", nargs="?", default="show",
                         choices=("show", "selftest"),
                         help="show: per-series summary; selftest: CI "
                              "validation (schema + identity recompute "
                              "+ idempotency vs the tree)")
    add_store(history)

    detect = sub.add_parser(
        "detect", help="noise-aware drift verdicts (HIST-*) over the "
                       "store")
    add_store(detect)
    detect.add_argument("--spec", default=None,
                        help="detection-window spec (default: "
                             "specs/torch/history.toml when present)")
    detect.add_argument("--detect-window", type=int, default=None,
                        help="most recent ingest rounds considered")
    detect.add_argument("--threshold-pct", type=float, default=None,
                        help="static regression threshold before noise "
                             "widening")
    detect.add_argument("--stale-rounds", type=int, default=None,
                        help="rounds without an ok reading before "
                             "HIST-003")
    detect.add_argument("--fail-on", default="error",
                        choices=("info", "warn", "error"),
                        help="exit non-zero at this severity "
                             "(default: %(default)s)")
    detect.add_argument("--json-out", default=None,
                        help="also write a schema-v2 findings ledger "
                             "here")

    report = sub.add_parser(
        "report", help="markdown perf trajectory with per-mode "
                       "sparklines")
    add_store(report)
    report.add_argument("--spec", default=None,
                        help="detection-window spec for the verdict "
                             "section (default: specs/torch/history.toml "
                             "when present)")
    report.add_argument("--out", default=None,
                        help="write the markdown here instead of stdout")
    return p


def _format_snapshot(snap: dict[str, Any]) -> list[str]:
    age = time.time() - float(snap.get("ts_unix") or 0)
    lines = [f"[obs] run={snap.get('run_id')} seq={snap.get('seq')} "
             f"age={age:.1f}s"]
    counters = snap.get("counters") or {}
    gauges = snap.get("gauges") or {}
    hists = snap.get("histograms") or {}
    if counters or gauges:
        width = max(len(k) for k in [*counters, *gauges])
        for key in sorted(counters):
            lines.append(f"  {key:<{width}}  {counters[key]:g}")
        for key in sorted(gauges):
            lines.append(f"  {key:<{width}}  {gauges[key]:g} (gauge)")
    if hists:
        # quantile ladder: one aligned row per histogram series, so the
        # admission→dispatch wait and latency distributions read as one
        # table while the run is in flight
        quants = ("p50", "p95", "p99", "max")
        hwidth = max(len(k) for k in hists)
        rows = {key: [_fmt_q(hists[key].get(q)) for q in quants]
                for key in sorted(hists)}
        cols = [max([len(q)] + [rows[k][i] and len(rows[k][i]) or 0
                                for k in rows])
                for i, q in enumerate(quants)]
        head = "  ".join(q.rjust(w) for q, w in zip(quants, cols))
        lines.append(f"  {'histogram':<{hwidth}}  {'n':>6}  {head}")
        for key in sorted(hists):
            cells = "  ".join(c.rjust(w) for c, w in zip(rows[key], cols))
            lines.append(
                f"  {key:<{hwidth}}  {hists[key].get('count', 0):>6}  "
                f"{cells}")
    if not (counters or gauges or hists):
        lines.append("  (no instruments recorded yet)")
    return lines


def _fmt_q(v: Any) -> str:
    return f"{v:g}" if isinstance(v, (int, float)) else "-"


def _cmd_status(args: argparse.Namespace) -> int:
    f = obs_export.find_snapshot_file(args.path)
    if f is None:
        print(f"obs status: no {obs_export.SNAPSHOT_NAME} under "
              f"{args.path!r} (is the run exporting? serve takes "
              "--obs-dir; campaign runs export under <dir>/obs/)",
              file=sys.stderr)
        return 2
    last_seq = None
    idle_since = time.monotonic()
    while True:
        snaps = obs_export.read_snapshots(f)
        if snaps and (last_seq is None
                      or snaps[-1].get("seq") != last_seq):
            last_seq = snaps[-1].get("seq")
            idle_since = time.monotonic()
            if args.json:
                print(json.dumps(snaps[-1], sort_keys=True))
            else:
                print("\n".join(_format_snapshot(snaps[-1])))
        elif not snaps and last_seq is None and not args.follow:
            print(f"obs status: {f} holds no snapshot records yet",
                  file=sys.stderr)
            return 2
        if not args.follow:
            return 0
        if args.timeout is not None \
                and time.monotonic() - idle_since > args.timeout:
            return 0
        time.sleep(args.interval)


SELFTEST_MIX = "96x96x96"
SELFTEST_QPS = 300.0
SELFTEST_DURATION_S = 0.3


#: the selftest's buckets run the hand-written kernel, whose launches carry
#: the cost books OBS-001 reads
SELFTEST_IMPL = "cuda"


def _selftest_findings(workdir: Path, device: str = "cuda") -> list:
    """The three selftest checks; returns lint Findings (empty = pass)."""
    from tpu_matmul_bench_torch.analysis.findings import Finding
    from tpu_matmul_bench_torch.obs import attribution
    from tpu_matmul_bench_torch.obs.registry import reset_registry
    from tpu_matmul_bench_torch.serve.service import ServeConfig, run_bench

    reset_registry()  # the reconciliation below needs a clean bus
    obs_dir = workdir / "obs"
    config = ServeConfig(
        mix=SELFTEST_MIX, qps=SELFTEST_QPS, duration_s=SELFTEST_DURATION_S,
        prewarm=True, json_out=str(workdir / "serve.jsonl"),
        obs_dir=str(obs_dir), matmul_impl=SELFTEST_IMPL, device=device)
    (rec,) = run_bench(config)
    serve = rec.extras["serve"]
    findings: list = []

    snaps = obs_export.read_snapshots(obs_dir / obs_export.SNAPSHOT_NAME)
    if not snaps:
        return [Finding(
            "OBS-002", "obs-selftest",
            "instrumented serve bench emitted no snapshot — the exporter "
            "never ticked and never flushed on stop")]
    snap = snaps[-1]
    counters = snap.get("counters") or {}
    hists = snap.get("histograms") or {}
    cache, queue = serve["cache"], serve["queue"]
    expectations = {
        "serve_requests_total": serve["requests"],
        'serve_cache_events{event="hit"}': cache["hits"],
        'serve_cache_events{event="miss"}': cache["misses"],
        'serve_queue_submitted_total': queue["submitted"],
    }
    for series, want in expectations.items():
        got = counters.get(series, 0)
        if got != want:
            findings.append(Finding(
                "OBS-002", f"obs-selftest:{series}",
                f"snapshot counter {series} = {got} does not reconcile "
                f"with the ledger's {want} — registry and compat view "
                "have diverged", severity="error",
                details={"snapshot": got, "ledger": want}))
    hist_count = sum(h.get("count", 0) for k, h in hists.items()
                     if k.startswith("serve_latency_ms"))
    if hist_count != serve["requests"]:
        findings.append(Finding(
            "OBS-002", "obs-selftest:serve_latency_ms",
            f"latency histogram holds {hist_count} observations for "
            f"{serve['requests']} served requests"))

    blocks = rec.extras.get("cost_analysis")
    if not blocks:
        findings.append(Finding(
            "OBS-001", "obs-selftest",
            "serve ledger carries no cost_analysis block — no executable "
            "recorded the kernels' cost books"))
    else:
        findings.extend(attribution.check_blocks(blocks, "obs-selftest"))
    return findings


def _cmd_selftest(args: argparse.Namespace) -> int:
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("obs selftest: no CUDA device is available; pass --device cpu "
              "to run on the CPU", file=sys.stderr)
        return 2
    if args.dir:
        workdir = Path(args.dir)
        workdir.mkdir(parents=True, exist_ok=True)
        findings = _selftest_findings(workdir, args.device)
    else:
        with tempfile.TemporaryDirectory(prefix="obs_selftest_") as tmp:
            findings = _selftest_findings(Path(tmp), args.device)
    for f in findings:
        print(f"[{f.severity:5s}] {f.rule} {f.where}: {f.message}",
              file=sys.stderr)
    if findings:
        print(f"obs selftest FAILED: {len(findings)} finding(s)",
              file=sys.stderr)
        return 1
    print("obs selftest ok: snapshot emitted, counters reconcile with "
          "the serve ledger, the kernels' cost books agree with the "
          "hand FLOPs model")
    return 0


# ------------------------------------------------------ perf observatory

def _history_sources(args: argparse.Namespace) -> list[str]:
    from tpu_matmul_bench_torch.obs import history as hist

    if not args.sources:
        return hist.default_sources()
    out: list[str] = []
    for src in args.sources:
        p = Path(src)
        if p.is_dir():
            out.extend(sorted(str(f) for pattern in hist.LEDGER_GLOBS
                              for f in p.rglob(pattern)
                              if f.name not in
                              hist._NON_MEASUREMENT_NAMES))
            out.extend(sorted(str(f) for f in p.glob("*.json")
                              if hist._ROUND_FILE_RE.search(f.name)))
        else:
            out.append(str(p))
    return out


def _cmd_ingest(args: argparse.Namespace) -> int:
    from tpu_matmul_bench_torch.obs import history as hist

    store = hist.HistoryStore.load(args.store)
    sources = _history_sources(args)
    added, skipped = hist.ingest(sources, store, seq=args.seq,
                                 dry_run=args.dry_run)
    verb = "would append" if args.dry_run else "appended"
    print(f"obs ingest: {verb} {added} point(s) from "
          f"{len(sources)} source(s) ({skipped} already present) -> "
          f"{store.path}")
    return 0


def _cmd_history(args: argparse.Namespace) -> int:
    from tpu_matmul_bench_torch.obs import history as hist

    store = hist.HistoryStore.load(args.store)
    if args.action == "selftest":
        problems = store.validate()
        if len(store) == 0:
            problems.append(f"{store.path}: store is empty or missing "
                            "(run python -m tpu_matmul_bench_torch.obs.regen)")
        # idempotency against the tree: every committed measurement must
        # already be ingested, and re-ingest must add nothing
        fresh, _ = hist.ingest(hist.default_sources(), store,
                               dry_run=True)
        if fresh:
            problems.append(
                f"{fresh} measurement point(s) in the tree are not in "
                "the store — run `obs ingest` (or python -m "
                "tpu_matmul_bench_torch.obs.regen) and commit")
        for msg in problems:
            print(f"[error] {msg}", file=sys.stderr)
        if problems:
            print(f"obs history selftest FAILED: {len(problems)} "
                  f"problem(s)", file=sys.stderr)
            return 1
        print(f"obs history selftest ok: {len(store)} point(s), "
              f"{len(store.series())} series, {store.max_seq()} ingest "
              "round(s); identities recompute, sources live, tree fully "
              "ingested")
        return 0
    print(f"store: {store.path}")
    print(f"points: {len(store)}  series: {len(store.series())}  "
          f"rounds: {store.max_seq()}")
    for sid, pts in store.series().items():
        ok = [p for p in pts if p.get("status") == "ok"]
        last = pts[-1]
        val = last.get("value")
        val_s = f"{val:.4g}" if isinstance(val, (int, float)) else "—"
        print(f"  {sid}  n={len(pts)} ok={len(ok)} "
              f"last_round={last.get('ingest_seq')} "
              f"last={val_s} {last.get('unit')}  "
              f"[{(last.get('labels') or {}).get('kind')}] "
              f"{last.get('metric')}")
    return 0


#: the port's detection-window spec, repo-root relative
DEFAULT_SPEC_RELPATH = Path("specs") / "torch" / "history.toml"


def _detect_config(args: argparse.Namespace):
    from tpu_matmul_bench_torch.obs import detect as det
    from tpu_matmul_bench_torch.obs import history as hist

    overrides: dict[str, Any] = {}
    for key in ("detect_window", "threshold_pct", "stale_rounds"):
        val = getattr(args, key, None)
        if val is not None:
            overrides[key] = val
    spec = getattr(args, "spec", None)
    if spec is None:
        default_spec = Path(hist.repo_root()) / DEFAULT_SPEC_RELPATH
        spec = str(default_spec) if default_spec.exists() else None
    if spec:
        return det.load_config(spec, overrides=overrides)
    return det.config_from_table(overrides)


def _resolve_store(cli_store: str | None, cfg) -> str | None:
    """--store wins; else the spec's store (repo-root-relative); else
    the default store path."""
    from tpu_matmul_bench_torch.obs import history as hist

    if cli_store:
        return cli_store
    if cfg.store:
        p = Path(cfg.store)
        return str(p if p.is_absolute()
                   else Path(hist.repo_root()) / p)
    return None


def _cmd_detect(args: argparse.Namespace) -> int:
    from tpu_matmul_bench_torch.analysis.findings import should_fail
    from tpu_matmul_bench_torch.obs import detect as det
    from tpu_matmul_bench_torch.obs import history as hist

    try:
        cfg = _detect_config(args)
    except (ValueError, OSError) as e:
        print(f"obs detect: bad spec: {e}", file=sys.stderr)
        return 2
    store = hist.HistoryStore.load(_resolve_store(args.store, cfg))
    findings = det.detect_findings(store, cfg)
    for f in findings:
        print(f"[{f.severity:5s}] {f.rule} {f.where}: {f.message}")
    if args.json_out:
        from tpu_matmul_bench_torch.analysis.findings import write_ledger

        write_ledger(args.json_out, findings)
    failed = should_fail(findings, args.fail_on)
    print(f"obs detect: {len(findings)} finding(s) over "
          f"{len(store.series())} series / {store.max_seq()} round(s) "
          f"-> {'FAIL' if failed else 'ok'} (--fail-on {args.fail_on})")
    return 1 if failed else 0


def _cmd_report(args: argparse.Namespace) -> int:
    from tpu_matmul_bench_torch.obs import history as hist
    from tpu_matmul_bench_torch.obs import report as rep

    try:
        cfg = _detect_config(args)
    except (ValueError, OSError) as e:
        print(f"obs report: bad spec: {e}", file=sys.stderr)
        return 2
    store = hist.HistoryStore.load(_resolve_store(args.store, cfg))
    text = rep.render(store, cfg)
    if args.out:
        Path(args.out).write_text(text)
        print(f"obs report: wrote {args.out}")
    else:
        print(text, end="")
    return 0


def main(argv: Sequence[str] | None = None):
    # obs runs from campaign parents and bare shells alike — reporting on
    from tpu_matmul_bench_torch.utils.reporting import (
        force_reporting_process,
        reporting_process_override,
    )

    prev = reporting_process_override()
    force_reporting_process(True)
    try:
        args = build_parser().parse_args(argv)
        rc = {"status": _cmd_status, "selftest": _cmd_selftest,
              "ingest": _cmd_ingest, "history": _cmd_history,
              "detect": _cmd_detect, "report": _cmd_report}[args.command](args)
    finally:
        force_reporting_process(prev)
    if rc:
        raise SystemExit(rc)
    return rc


if __name__ == "__main__":
    main()
