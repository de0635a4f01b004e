"""Regenerate the committed metric-history store from the tree.

    python -m tpu_matmul_bench_torch.obs.regen [--check]

Port of the JAX package's `scripts/regen_history.py`. Rebuilds
``measurements/torch/history.jsonl`` deterministically from the card's
ledgers the repo ships, one ingest round for each entry of `ROUNDS`, in
the order they were measured:

- round 1: the H100 runs of ``measurements/torch/card_pr18/*.ndjson`` —
  the job ledgers of `chip_smoke.py`'s campaign (`specs/torch/card.toml`: K1
  fused, the library product, K1b with `--ksplit 2`, and the `cuda` serve
  window with its `serve_span` lines) and the ledger of `obs selftest`'s
  serve run on the card.

The output is byte-deterministic (no wall clock anywhere in a point:
timestamps come only from ledger manifests), and `obs ingest` running
twice over the tree must leave it byte-identical.

  --check: regenerate to a temporary file and fail (exit 1) if it differs
           from the committed store, writing nothing in the repo.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import tempfile
from pathlib import Path

from tpu_matmul_bench_torch.obs import history as hist

REPO = Path(hist.repo_root())

#: the card's measurement directories, one ingest round a tuple, oldest
#: first (repo-relative)
ROUNDS = (
    ("measurements/torch/card_pr18",),
)


def round_sources(dirs: tuple[str, ...]) -> list[Path]:
    out: list[Path] = []
    for rel in dirs:
        base = REPO / rel
        if base.is_dir():
            out.extend(sorted(p for p in base.rglob(hist.SOURCES_GLOB)
                              if p.name not in hist._NON_MEASUREMENT_NAMES))
    return out


def regen(path: Path) -> hist.HistoryStore:
    if path.exists():
        path.unlink()
    store = hist.HistoryStore.load(str(path))
    for seq, dirs in enumerate(ROUNDS, start=1):
        added, _ = hist.ingest(round_sources(dirs), store, seq=seq,
                               root=str(REPO))
        print(f"  round {seq}: +{added} point(s)")
    return store


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--check", action="store_true",
                    help="verify the committed store regenerates "
                         "byte-identically; write nothing")
    args = ap.parse_args(argv)

    committed = REPO / hist.HISTORY_RELPATH
    with tempfile.TemporaryDirectory(prefix="history_regen_") as tmp:
        target = Path(tmp) / committed.name if args.check else committed
        store = regen(target)
        data = target.read_bytes()
    digest = hashlib.sha256(data).hexdigest()
    print(f"{len(store)} point(s), {len(store.series())} series, "
          f"{store.max_seq()} round(s); sha256 {digest}")
    if args.check:
        if not committed.exists() or committed.read_bytes() != data:
            print(f"STALE: {committed} does not match the tree — rerun "
                  "python -m tpu_matmul_bench_torch.obs.regen and commit",
                  file=sys.stderr)
            return 1
        print(f"ok: {committed} is current")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
