"""Fingerprint-keyed tuning database — the persistent routing store.

Port of `tpu_matmul_bench/tune/db.py`. Each **cell** answers one question
— "which impl and tile win C[m,n] = A[m,k]·B[k,n] of `dtype` on this
card?" — and is keyed by

  (problem fingerprint, device-kind token)

with the torch version and a *program digest* recorded beside it for
staleness detection. The problem fingerprint is the JAX package's, bit for
bit: a digest of a canonical problem record in which neither framework
appears, so one problem has one key in both stores. The program digest has
no jaxpr to hash here: a `cuda` cell hashes the route `gemm_route` takes,
the tile `effective_blocks` runs and the kernel library's key (its source,
headers and nvcc flags, `ops/_build.library_path`), so a change to a kernel
source or its flags marks exactly the affected `cuda` cells stale
(DRIFT-001's meaning); a `torch` cell hashes the library op, the dtype and
the shape.

Provenance is mandatory and typed: a ``measured`` cell cites a committed
ledger under measurements/, an ``analytic`` one states its prior, a
``measured-online`` one cites the serve ledger its samples came from.

Durability as in the JAX package: JSONL, one fsync'd line per cell,
append-only; the last record for a key wins, so a promotion never rewrites
history, and a torn tail is repaired before the next append.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
from typing import Any, Iterable

from tpu_matmul_bench_torch.utils.durable import repair_torn_tail

PROVENANCE_KINDS = ("measured", "analytic", "measured-online")
IMPLS = ("torch", "cuda")

CELL_SCHEMA = 1

#: repo-relative default store (committed: the shipped routing surface)
DB_RELPATH = os.path.join("measurements", "torch", "tune_db.jsonl")

#: the SXM H100's names share one token; the PCIe and NVL parts keep their
#: own (other power limits and clocks, other peak rows in utils/metrics.py)
_SHARED_TOKEN = "h100"
_OWN_KIND = ("pcie", "nvl")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def digest(record: dict[str, Any]) -> str:
    """Short stable digest of a canonical record: the JAX package's
    `analysis/fingerprint.digest`, copied (the port imports nothing of it)."""
    blob = json.dumps(record, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def default_path(root: str | None = None) -> str:
    """Absolute DB path; `root` defaults to the repository root."""
    return os.path.join(root or REPO_ROOT, DB_RELPATH)


def kind_token(device_kind: str) -> str:
    """Canonical device-kind key: every name of the SXM H100 ("NVIDIA H100
    80GB HBM3", ...) maps to "h100", so cells measured under one spelling
    serve all; the PCIe and NVL parts and unknown names are lowercased."""
    kind = (device_kind or "").lower().strip()
    if "h100" in kind and not any(part in kind for part in _OWN_KIND):
        return _SHARED_TOKEN
    return kind or "unknown"


def canonical_dtype(dtype: Any) -> str:
    """The dtype name a problem is keyed under. float16 shares the
    bfloat16 cells (same operand width, same route)."""
    from tpu_matmul_bench_torch.utils.metrics import dtype_name

    name = dtype_name(dtype)
    return "bfloat16" if name == "float16" else name


def torch_version() -> str:
    """The version axis of a cell: torch's version and the CUDA it was
    built for ("None" for a CPU build)."""
    import torch

    return f"{torch.__version__} cuda {torch.version.cuda}"


@functools.lru_cache(maxsize=4096)
def problem_fingerprint(m: int, k: int, n: int, dtype: Any,
                        comm_quant: str | None = None,
                        mesh: str | None = None,
                        stream_k: int | None = None) -> str:
    """Stable digest of one routing question, equal to the JAX package's
    for the same problem. A quantized wire format, a mesh factorization
    (canonicalized) and a K-streaming panel count join the record only when
    set, so such problems never alias the plain one.

    Memoised: `auto` resolves on every eager call here (the JAX package
    resolves once, at trace time), so the sha256 is paid once a problem."""
    record = {"op": "matmul_2d", "m": int(m), "k": int(k),
              "n": int(n), "dtype": canonical_dtype(dtype)}
    if comm_quant and comm_quant != "none":
        record["comm_quant"] = str(comm_quant)
    if mesh:
        from tpu_matmul_bench_torch.parallel.mesh import canonical_mesh_spec

        record["mesh"] = canonical_mesh_spec(mesh)
    if stream_k:
        record["stream_k"] = int(stream_k)
    return digest(record)


def program_digest(m: int, k: int, n: int, dtype: Any, impl: str,
                   blocks: tuple[int, int, int] | None = None) -> str:
    """Digest of the program a cell routes to, computable on the CPU.

    `cuda`: the route `gemm_route` takes for contiguous aligned operands of
    the problem, the tile `effective_blocks` resolves `blocks` to (the
    default tile when None), and the kernel library's key, which hashes
    csrc/matmul.cu, every csrc header and the nvcc flags. `torch`: the
    library op (`torch._int_mm` for int8, `torch.matmul` otherwise), the
    dtype and the shape."""
    from tpu_matmul_bench_torch.ops import _build
    from tpu_matmul_bench_torch.ops import cuda_matmul as cm

    dt = canonical_dtype(dtype)
    record: dict[str, Any] = {"impl": impl, "dtype": dt, "shape": [m, k, n],
                              "blocks": list(blocks) if blocks else None}
    if impl == "cuda":
        record["route"] = cm.gemm_route(dt, m, n, k, k, n, 0, 0)
        record["tile"] = list(cm.effective_blocks(
            m, n, k, *(blocks or cm.DEFAULT_TILE), dt))
        record["library"] = _build.library_path("matmul").name
    else:
        record["op"] = "torch._int_mm" if dt == "int8" else "torch.matmul"
    return digest(record)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One tuning decision: problem → winner, with typed provenance."""

    m: int
    k: int
    n: int
    dtype: str                 # canonical name (bfloat16/float32/int8)
    device_kind: str           # kind token (see kind_token)
    impl: str                  # "torch" | "cuda"
    provenance_kind: str       # "measured" | "analytic" | "measured-online"
    artifact: str              # committed evidence path(s)
    detail: str = ""           # prior / margin / sweep context
    blocks: tuple[int, int, int] | None = None
    tflops: float | None = None
    torch_version: str = ""
    program_digest: str = ""
    created_at: str = ""
    # the wire format, mesh factorization and K-streaming panel count the
    # problem ran under (None: full precision, flat, in core); folded into
    # the fingerprint so such cells never alias plain ones
    comm_quant: str | None = None
    mesh: str | None = None
    stream_k: int | None = None

    def __post_init__(self) -> None:
        if self.provenance_kind not in PROVENANCE_KINDS:
            raise ValueError(
                f"provenance kind {self.provenance_kind!r} not in "
                f"{PROVENANCE_KINDS}")
        if not self.artifact:
            raise ValueError("a cell without evidence is the gap this DB "
                             "exists to close — artifact is mandatory")

    @property
    def fingerprint(self) -> str:
        return problem_fingerprint(self.m, self.k, self.n, self.dtype,
                                   self.comm_quant, mesh=self.mesh,
                                   stream_k=self.stream_k)

    @property
    def key(self) -> tuple[str, str]:
        return (self.fingerprint, self.device_kind)

    @property
    def label(self) -> str:
        return f"{self.dtype}@{self.m}x{self.k}x{self.n}/{self.device_kind}"

    @property
    def provenance_str(self) -> str:
        """The ImplChoice.provenance a DB-backed route carries: the cell,
        its kind and its evidence path(s) verbatim."""
        text = (f"tune-db cell {self.fingerprint} "
                f"[{self.provenance_kind}]: {self.artifact}")
        return f"{text} — {self.detail}" if self.detail else text

    def to_record(self) -> dict[str, Any]:
        problem: dict[str, Any] = {"m": self.m, "k": self.k, "n": self.n,
                                   "dtype": self.dtype}
        if self.comm_quant and self.comm_quant != "none":
            problem["comm_quant"] = self.comm_quant
        if self.mesh:
            problem["mesh"] = self.mesh
        if self.stream_k:
            problem["stream_k"] = self.stream_k
        return {
            "record_type": "tune_cell",
            "schema": CELL_SCHEMA,
            "fingerprint": self.fingerprint,
            "device_kind": self.device_kind,
            "problem": problem,
            "impl": self.impl,
            "blocks": list(self.blocks) if self.blocks else None,
            "provenance": {"kind": self.provenance_kind,
                           "artifact": self.artifact,
                           "detail": self.detail},
            "tflops": self.tflops,
            "torch_version": self.torch_version,
            "program_digest": self.program_digest,
            "created_at": self.created_at,
        }

    @classmethod
    def from_record(cls, rec: dict[str, Any]) -> "Cell":
        prob = rec["problem"]
        prov = rec.get("provenance") or {}
        blocks = rec.get("blocks")
        return cls(
            m=int(prob["m"]), k=int(prob["k"]), n=int(prob["n"]),
            dtype=str(prob["dtype"]),
            device_kind=str(rec["device_kind"]),
            impl=str(rec["impl"]),
            provenance_kind=str(prov.get("kind", "")),
            artifact=str(prov.get("artifact", "")),
            detail=str(prov.get("detail", "")),
            blocks=tuple(int(b) for b in blocks) if blocks else None,
            tflops=rec.get("tflops"),
            torch_version=str(rec.get("torch_version", "")),
            program_digest=str(rec.get("program_digest", "")),
            created_at=str(rec.get("created_at", "")),
            comm_quant=prob.get("comm_quant"),
            mesh=prob.get("mesh"),
            stream_k=prob.get("stream_k"),
        )


class TuningDB:
    """The cell store: JSONL on disk, a superseding dict in memory.

    Append-only with one fsync per line: `put` never rewrites earlier
    records, and `load` keeps the LAST record per (fingerprint,
    device_kind); a promotion is an append, a rollback the append of the
    previous winner.
    """

    def __init__(self, path: str | None = None) -> None:
        self.path = path or default_path()
        self._cells: dict[tuple[str, str], Cell] = {}
        self.records_read = 0
        self.parse_errors: list[str] = []

    # -------------------------------------------------------------- load

    @classmethod
    def load(cls, path: str | None = None) -> "TuningDB":
        """Read the store (a missing file is an empty DB: every lookup falls
        through to the table, the documented fallback)."""
        db = cls(path)
        if not os.path.exists(db.path):
            return db
        with open(db.path) as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    # a torn trailing line from a crash is tolerated;
                    # selftest reports it
                    db.parse_errors.append(f"line {lineno}: unparseable")
                    continue
                if not isinstance(rec, dict) \
                        or rec.get("record_type") != "tune_cell":
                    continue  # manifest-style headers ride along
                try:
                    cell = Cell.from_record(rec)
                except (KeyError, ValueError, TypeError) as e:
                    db.parse_errors.append(f"line {lineno}: {e}")
                    continue
                db.records_read += 1
                stored = rec.get("fingerprint")
                if stored and stored != cell.fingerprint:
                    db.parse_errors.append(
                        f"line {lineno}: stored fingerprint {stored} != "
                        f"recomputed {cell.fingerprint}")
                    continue
                db._cells[cell.key] = cell
        return db

    # ------------------------------------------------------------- write

    def put(self, cell: Cell, *, fsync: bool = True) -> Cell:
        """Append one cell (fsync'd) and supersede it in memory, filling
        torch_version, program_digest and created_at where empty."""
        cell = self._complete(cell)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        # crash hygiene: never append after a torn (newline-less) tail
        repair_torn_tail(self.path)
        with open(self.path, "a") as fh:
            fh.write(json.dumps(cell.to_record()) + "\n")
            fh.flush()
            if fsync:
                os.fsync(fh.fileno())
        self._cells[cell.key] = cell
        return cell

    def _complete(self, cell: Cell) -> Cell:
        import datetime

        updates: dict[str, Any] = {}
        if not cell.torch_version:
            updates["torch_version"] = torch_version()
        if not cell.program_digest:
            updates["program_digest"] = program_digest(
                cell.m, cell.k, cell.n, cell.dtype, cell.impl, cell.blocks)
        if not cell.created_at:
            updates["created_at"] = datetime.datetime.now(
                datetime.timezone.utc).isoformat(timespec="seconds")
        return dataclasses.replace(cell, **updates) if updates else cell

    # ------------------------------------------------------------ lookup

    def lookup(self, m: int, k: int, n: int, dtype: Any,
               device_kind: str) -> Cell | None:
        """The live cell for this routing question, or None (the table
        answers). A dict probe behind a memoised fingerprint."""
        return self._cells.get(
            (problem_fingerprint(m, k, n, dtype), kind_token(device_kind)))

    def cells(self) -> list[Cell]:
        """Live (non-superseded) cells, deterministic order."""
        return [self._cells[key] for key in sorted(self._cells)]

    def __len__(self) -> int:
        return len(self._cells)

    def __contains__(self, key: tuple[str, str]) -> bool:
        return key in self._cells

    # --------------------------------------------------------- staleness

    def stale_reasons(self, cell: Cell, *,
                      torch_version: str | None = None,
                      digests: dict[tuple[str, str], str] | None = None,
                      ) -> list[str]:
        """Why this cell can no longer be trusted (empty list = fresh).

        Two independent axes:
        - the torch version (and with it the library's kernels) moved since
          the cell was written. Only a CUDA build of torch can run what a
          cell routes to, so a CPU build (`torch.version.cuda` None) checks
          no version: there is nothing there to re-measure;
        - the routed program no longer digests to what the cell recorded
          (a kernel source, header or flag changed).

        `digests` lets tests and batch audits inject recomputed digests
        keyed by (fingerprint, device_kind)."""
        reasons: list[str] = []
        current = torch_version if torch_version is not None \
            else cuda_torch_version()
        if current and cell.torch_version and cell.torch_version != current:
            reasons.append(
                f"torch {cell.torch_version} → {current} since the cell "
                "was written (re-measure or re-promote)")
        if cell.program_digest:
            if digests is not None:
                now = digests.get(cell.key)
            else:
                now = program_digest(cell.m, cell.k, cell.n, cell.dtype,
                                     cell.impl, cell.blocks)
            if now is not None and now != cell.program_digest:
                reasons.append(
                    f"program digest {cell.program_digest} → {now}: "
                    "the routed kernel's source, tile or flags changed "
                    "(DRIFT-style invalidation)")
        return reasons

    def stale_cells(self, **kwargs: Any) -> list[tuple[Cell, list[str]]]:
        """(cell, reasons) for every stale live cell."""
        out = []
        for cell in self.cells():
            reasons = self.stale_reasons(cell, **kwargs)
            if reasons:
                out.append((cell, reasons))
        return out

    # ---------------------------------------------------------- validate

    def validate(self, root: str | None = None) -> list[str]:
        """Schema and provenance problems (empty = healthy): parse errors,
        provenance typing, dead artifact paths, measured cells without a
        measurements/ ledger. The core of `tune selftest`."""
        root = root or REPO_ROOT
        problems = list(self.parse_errors)
        for cell in self.cells():
            label = cell.label
            # what this cell would serialize as must survive load()'s
            # filters, or the promotion vanishes on the next load
            rec = cell.to_record()
            if rec.get("record_type") != "tune_cell":
                problems.append(f"{label}: record_type "
                                f"{rec.get('record_type')!r} would be "
                                "dropped by load()")
            if rec.get("schema") != CELL_SCHEMA:
                problems.append(f"{label}: schema {rec.get('schema')!r} "
                                f"!= {CELL_SCHEMA}")
            if rec.get("fingerprint") != cell.fingerprint:
                problems.append(f"{label}: serialized fingerprint "
                                f"{rec.get('fingerprint')!r} does not "
                                "recompute — load() would reject it")
            if Cell.from_record(rec).key != cell.key:
                problems.append(f"{label}: record round-trip loses the "
                                "cell's (fingerprint, device) identity")
            if cell.impl not in IMPLS:
                problems.append(f"{label}: unknown impl {cell.impl!r}")
            if cell.impl == "cuda" and not cell.blocks:
                problems.append(f"{label}: cuda cell without blocks — "
                                "the winner's tile is the point")
            if cell.provenance_kind == "measured" \
                    and "measurements/" not in cell.artifact:
                problems.append(
                    f"{label}: measured cell cites no measurements/ "
                    f"ledger: {cell.artifact!r}")
            if cell.provenance_kind == "analytic" and not cell.detail:
                problems.append(
                    f"{label}: analytic cell without an explicit prior "
                    "in detail — 'analytic' must name its model")
            if cell.provenance_kind == "measured-online" \
                    and ".jsonl" not in cell.artifact:
                problems.append(
                    f"{label}: measured-online cell cites no serve "
                    f"ledger (.jsonl): {cell.artifact!r}")
            for path in artifact_paths(cell.artifact):
                if not os.path.exists(os.path.join(root, path)):
                    problems.append(f"{label}: artifact {path!r} does not "
                                    "exist in the repo")
            if not cell.program_digest:
                problems.append(f"{label}: no program digest — staleness "
                                "cannot be detected")
        return problems


def cuda_torch_version() -> str | None:
    import torch

    return torch_version() if torch.version.cuda else None


def artifact_paths(artifact: str) -> list[str]:
    """Repo-relative paths named in an artifact citation (comma or space
    separated; other words are ignored)."""
    return [token for token in artifact.replace(",", " ").split()
            if token.startswith("measurements/")]


def default_db() -> TuningDB:
    """The committed store, loaded once per process. Mutating callers
    (promote) load their own instance; `invalidate_default_db` resets the
    cache, and `install_default_db` puts an instance in its place."""
    global _DEFAULT_DB
    if _DEFAULT_DB is None:
        _DEFAULT_DB = TuningDB.load()
    return _DEFAULT_DB


def install_default_db(db: TuningDB | None) -> None:
    """Make `db` the process's default store (None: reload the committed
    one on next use), as a promotion in place would."""
    global _DEFAULT_DB
    _DEFAULT_DB = db


def invalidate_default_db() -> None:
    install_default_db(None)


_DEFAULT_DB: TuningDB | None = None


def recomputed_digests(cells: Iterable[Cell]) -> dict[tuple[str, str], str]:
    """Recompute program digests for `cells`, keyed for
    `stale_reasons(digests=...)`."""
    return {cell.key: program_digest(cell.m, cell.k, cell.n, cell.dtype,
                                     cell.impl, cell.blocks)
            for cell in cells}
