"""Content-addressed kernel-library store: a warm start without nvcc.

Port of `tpu_matmul_bench/tune/artifacts.py`. The tuning DB (tune/db.py)
remembers *which* program wins a routing question; this store remembers
what a fresh serving process would otherwise have to build before its
first warm dispatch. In the JAX package that is the AOT-compiled
executable, serialized. A CUDA graph cannot be serialized, and capturing
one costs milliseconds; what a fresh process really pays on the card is
nvcc, minutes on an empty `build/`. So the port's blob is the **kernel
library** a `cuda` executable launches: the shared library
`ops/_build.py library_path("matmul")` names. Importing an artifact checks
the blob's digest, puts the library into the build directory under that
name when it is not already there, loads it and captures the executable
(`serve/cache.py`): no nvcc.

`torch` entries launch cuBLAS, which ships with torch: they have no
library to store, are neither exported nor imported, and count as
compiled. On the CPU the wrappers run their plain versions and load no
library, so there is nothing to store there either.

Layout, as the JAX package's:

- **blobs/** — one file a payload, named by the SHA-256 of its bytes, so a
  blob can never silently change under its manifest record. The store is
  content-addressed: every key that uses the library shares one blob;
- **manifest.jsonl** — append-only, one fsync'd line an artifact, last
  record a key wins, a torn tail tolerated on load and repaired before the
  next append (`utils/durable.py`).

The **artifact key** digests what makes the library reusable: the tuning
DB's problem fingerprint, the torch and CUDA versions (in place of JAX's
version), the routed program's digest (`tune/db.py program_digest`, which
hashes the library's name and with it `csrc/`, every header and the nvcc
flags), the backend ("cuda") and the mesh shape, with the pod placement
label when set. Drift in any of these hashes to a different key, so a
stale library is a miss, never a wrong hit. A corrupt or truncated blob is
rejected at read time: the caller rebuilds from `csrc/`.

The default store lies under `build/artifacts/` at the repository root,
which `.gitignore` lists: no binary is committed.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import os
from pathlib import Path
from typing import Any, Iterable

from tpu_matmul_bench_torch.tune.db import REPO_ROOT, digest
from tpu_matmul_bench_torch.utils.durable import repair_torn_tail

ARTIFACT_RECORD_TYPE = "exec_artifact"
ARTIFACT_SCHEMA = 1

MANIFEST_NAME = "manifest.jsonl"
BLOBS_DIRNAME = "blobs"

#: repo-relative default store, under the ignored build directory
STORE_RELPATH = os.path.join("build", "artifacts")

#: the kernel library a `cuda` executable launches (csrc/matmul.cu)
LIBRARY = "matmul"
BACKEND = "cuda"


def default_root(root: str | None = None) -> str:
    """Absolute store root; `root` defaults to the repository root."""
    return os.path.join(root or REPO_ROOT, STORE_RELPATH)


def artifact_key(fingerprint: str, torch_version: str, program_digest: str,
                 backend: str, mesh_shape: tuple[int, ...],
                 mesh_spec: str = "") -> str:
    """Stable digest of one artifact identity. Every axis that makes a
    stored library non-reusable is part of the key, so staleness is a
    miss. `mesh_spec` (the pod placement label, serve/placement.py) joins
    the digest only when set: keys without it compute as before."""
    identity: dict[str, Any] = {
        "kind": ARTIFACT_RECORD_TYPE,
        "fingerprint": fingerprint,
        "torch_version": torch_version,
        "program_digest": program_digest,
        "backend": backend,
        "mesh_shape": list(mesh_shape),
    }
    if mesh_spec:
        identity["mesh_spec"] = mesh_spec
    return digest(identity)


def blob_digest(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


def pack_library(name: str = LIBRARY) -> bytes:
    """The bytes of the built kernel library `csrc/<name>.cu` (raises
    FileNotFoundError when it was never built in this checkout)."""
    from tpu_matmul_bench_torch.ops import _build

    return _build.library_path(name).read_bytes()


def install_library(blob: bytes, name: str = LIBRARY) -> Path:
    """Put a digest-checked library into the build directory under the name
    `library_path` gives it in this checkout, unless a library is already
    there (the name is its sources' and flags' hash). Written to a
    temporary file and renamed, so a loader never sees half a library."""
    from tpu_matmul_bench_torch.ops import _build

    path = _build.library_path(name)
    if path.is_file():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.import.tmp")
    with open(tmp, "wb") as fh:
        fh.write(blob)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return path


@dataclasses.dataclass(frozen=True)
class ArtifactMeta:
    """The identity and provenance fields of one stored library."""

    m: int
    k: int
    n: int
    dtype: str                 # canonical dtype name (tune.db convention)
    impl: str                  # resolved impl: "cuda"
    blocks: tuple[int, int, int] | None
    device_kind: str
    backend: str               # "cuda"
    mesh_shape: tuple[int, ...]
    fingerprint: str           # tune-DB problem fingerprint
    program_digest: str        # tune.db.program_digest of the routed program
    torch_version: str         # tune.db.torch_version(): torch and its CUDA
    mesh_spec: str = ""        # pod placement label ("" = single device)

    @classmethod
    def build(cls, m: int, k: int, n: int, dtype: Any, *, impl: str,
              blocks: tuple[int, int, int] | None = None,
              device_kind: str = "", backend: str = BACKEND,
              mesh_shape: tuple[int, ...] = (1,),
              mesh_spec: str = "") -> "ArtifactMeta":
        """The full identity of one `cuda` executable's library. A `torch`
        executable has no library to store: refused."""
        from tpu_matmul_bench_torch.tune.db import (
            canonical_dtype,
            problem_fingerprint,
            program_digest,
            torch_version,
        )

        if impl != "cuda":
            raise ValueError(f"a {impl!r} executable has no kernel library to "
                             "store; only `cuda` entries are artifacts")
        dt = canonical_dtype(dtype)
        return cls(
            m=int(m), k=int(k), n=int(n), dtype=dt, impl=impl,
            blocks=tuple(blocks) if blocks else None,
            device_kind=device_kind, backend=backend,
            mesh_shape=tuple(mesh_shape),
            fingerprint=problem_fingerprint(m, k, n, dt),
            program_digest=program_digest(m, k, n, dt, impl, blocks),
            torch_version=torch_version(),
            mesh_spec=mesh_spec,
        )

    @property
    def key(self) -> str:
        return artifact_key(self.fingerprint, self.torch_version,
                            self.program_digest, self.backend,
                            self.mesh_shape, self.mesh_spec)


class ArtifactStore:
    """The library store: blobs on disk, a superseding manifest dict in
    memory. `put` writes the blob (fsync, then rename) before the fsync'd
    manifest line, so a crash in between leaves an orphan blob, never a
    record without its bytes; `get_blob` verifies the digest on every
    read."""

    def __init__(self, root: str | None = None) -> None:
        self.root = root or default_root()
        self.manifest_path = os.path.join(self.root, MANIFEST_NAME)
        self.blobs_dir = os.path.join(self.root, BLOBS_DIRNAME)
        self._records: dict[str, dict[str, Any]] = {}
        self.records_read = 0
        self.parse_errors: list[str] = []
        self.rejected: list[str] = []  # digest-failed blob reads

    @classmethod
    def load(cls, root: str | None = None) -> "ArtifactStore":
        """Read the manifest (a missing store is empty: every lookup
        misses and the cache builds)."""
        store = cls(root)
        if not os.path.exists(store.manifest_path):
            return store
        with open(store.manifest_path) as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    # a torn trailing line from a crash, as every durable
                    # JSONL reader tolerates
                    store.parse_errors.append(f"line {lineno}: unparseable")
                    continue
                if not isinstance(rec, dict) \
                        or rec.get("record_type") != ARTIFACT_RECORD_TYPE:
                    continue
                key = rec.get("key")
                if not key:
                    store.parse_errors.append(f"line {lineno}: no key")
                    continue
                store.records_read += 1
                store._records[str(key)] = rec
        return store

    def put(self, meta: ArtifactMeta, blob: bytes, *,
            fsync: bool = True) -> dict[str, Any]:
        """Store one library for one key: the content-addressed blob first
        (once for every key that shares it; rewritten when the file there
        no longer hashes to its name), then the manifest line."""
        blob_hash = blob_digest(blob)
        os.makedirs(self.blobs_dir, exist_ok=True)
        blob_rel = os.path.join(BLOBS_DIRNAME, f"{blob_hash}.bin")
        blob_path = os.path.join(self.root, blob_rel)
        if not _holds(blob_path, blob_hash):  # absent, or corrupt: rewrite
            tmp = blob_path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(blob)
                fh.flush()
                if fsync:
                    os.fsync(fh.fileno())
            os.replace(tmp, blob_path)
        rec = {
            "record_type": ARTIFACT_RECORD_TYPE,
            "schema": ARTIFACT_SCHEMA,
            "key": meta.key,
            "fingerprint": meta.fingerprint,
            "problem": {"m": meta.m, "k": meta.k, "n": meta.n,
                        "dtype": meta.dtype},
            "impl": meta.impl,
            "blocks": list(meta.blocks) if meta.blocks else None,
            "device_kind": meta.device_kind,
            "backend": meta.backend,
            "mesh_shape": list(meta.mesh_shape),
            **({"mesh_spec": meta.mesh_spec} if meta.mesh_spec else {}),
            "torch_version": meta.torch_version,
            "program_digest": meta.program_digest,
            "blob_digest": blob_hash,
            "blob": blob_rel,
            "size_bytes": len(blob),
            "created_at": datetime.datetime.now(
                datetime.timezone.utc).isoformat(timespec="seconds"),
        }
        # crash hygiene: never append after a torn (newline-less) tail
        repair_torn_tail(self.manifest_path)
        with open(self.manifest_path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
            if fsync:
                os.fsync(fh.fileno())
        self._records[rec["key"]] = rec
        return rec

    def lookup(self, meta: ArtifactMeta) -> dict[str, Any] | None:
        """The live manifest record for this identity, or None. A stale
        library (torch or program drift) keys differently, so it misses."""
        return self._records.get(meta.key)

    def get_blob(self, rec: dict[str, Any]) -> bytes | None:
        """The record's blob bytes, digest-verified. A missing, truncated or
        corrupted blob returns None (remembered in `rejected`): the caller
        rebuilds from the sources and never loads bad bytes."""
        rel = rec.get("blob") or ""
        path = os.path.join(self.root, rel)
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError:
            self.rejected.append(f"{rel}: unreadable")
            return None
        if blob_digest(blob) != rec.get("blob_digest"):
            self.rejected.append(
                f"{rel}: content digest mismatch (corrupt or truncated)")
            return None
        return blob

    def records(self) -> list[dict[str, Any]]:
        """Live (non-superseded) manifest records, in key order."""
        return [self._records[k] for k in sorted(self._records)]

    def __len__(self) -> int:
        return len(self._records)

    def validate(self) -> list[tuple[str, str]]:
        """Integrity problems (JAX's ART-001 class) as (where, message)
        pairs, empty when every record's chain closes: each manifest row
        well-typed, the problem fingerprint and the key recomputing from
        the recorded fields, and the blob hashing to its digest."""
        from tpu_matmul_bench_torch.tune.db import problem_fingerprint

        problems: list[tuple[str, str]] = []
        for lineno_err in self.parse_errors:
            problems.append((self.manifest_path, lineno_err))
        for rec in self.records():
            where = f"artifact:{rec.get('key', '?')[:12]}"
            for key, kind in (("record_type", str), ("schema", int),
                              ("impl", str), ("device_kind", str),
                              ("blob_digest", str), ("size_bytes", int),
                              ("created_at", str),
                              ("blocks", (list, type(None)))):
                v = rec.get(key, None)
                if key not in rec or not isinstance(v, kind) \
                        or isinstance(v, bool):
                    problems.append(
                        (where, f"manifest row lacks a well-typed "
                                f"{key!r} (got {v!r})"))
            prob = rec.get("problem") or {}
            try:
                fp = problem_fingerprint(prob["m"], prob["k"], prob["n"],
                                         prob["dtype"])
            except (KeyError, TypeError, ValueError):
                problems.append((where, "malformed problem block"))
                continue
            if fp != rec.get("fingerprint"):
                problems.append(
                    (where, f"stored fingerprint {rec.get('fingerprint')} "
                            f"!= recomputed {fp}"))
            expect = artifact_key(
                str(rec.get("fingerprint", "")),
                str(rec.get("torch_version", "")),
                str(rec.get("program_digest", "")),
                str(rec.get("backend", "")),
                tuple(rec.get("mesh_shape") or ()),
                str(rec.get("mesh_spec") or ""))
            if expect != rec.get("key"):
                problems.append(
                    (where, f"manifest key {rec.get('key')} does not "
                            f"recompute from its fields ({expect})"))
            path = os.path.join(self.root, rec.get("blob") or "")
            if not os.path.exists(path):
                problems.append(
                    (where, f"blob {rec.get('blob')!r} missing on disk"))
            elif self.get_blob(rec) is None:
                problems.append(
                    (where, f"blob {rec.get('blob')!r} does not hash to "
                            f"its recorded digest"))
        return problems

    def stale_reasons(self, rec: dict[str, Any], *,
                      torch_version: str | None = None,
                      digests: dict[tuple, str] | None = None) -> list[str]:
        """Why this artifact can no longer be imported (empty = fresh),
        the axes of `tune/db.py stale_reasons`: torch moved (checked only
        under a CUDA build of torch, which is what can load the library),
        or the routed program re-digests differently (a kernel source,
        header or nvcc flag changed). `digests` injects recomputed digests
        keyed by (m, k, n, dtype, impl, blocks, device_kind)."""
        from tpu_matmul_bench_torch.tune.db import cuda_torch_version

        reasons: list[str] = []
        current = torch_version if torch_version is not None \
            else cuda_torch_version()
        if current and rec.get("torch_version") \
                and rec["torch_version"] != current:
            reasons.append(
                f"torch {rec['torch_version']} → {current} since export "
                "(the store will miss; re-export under the current torch)")
        dkey = _digest_key(rec)
        if rec.get("program_digest"):
            now = digests.get(dkey) if digests is not None \
                else _recompute_program_digest(dkey)
            if now is not None and now != rec["program_digest"]:
                reasons.append(
                    f"program digest {rec['program_digest']} → {now}: the "
                    "kernel library's sources or flags changed (DRIFT-style "
                    "invalidation)")
        return reasons


def _holds(path: str, blob_hash: str) -> bool:
    """Whether `path` holds bytes that hash to `blob_hash`."""
    try:
        with open(path, "rb") as fh:
            return blob_digest(fh.read()) == blob_hash
    except OSError:
        return False


def _digest_key(rec: dict[str, Any]) -> tuple:
    prob = rec.get("problem") or {}
    return (prob.get("m"), prob.get("k"), prob.get("n"), prob.get("dtype"),
            rec.get("impl"), tuple(rec.get("blocks") or ()) or None,
            rec.get("device_kind"))


def _recompute_program_digest(dkey: tuple) -> str | None:
    """The program digest recomputed from `csrc/` (no card needed); None
    when the recorded problem cannot be digested."""
    from tpu_matmul_bench_torch.tune.db import program_digest

    m, k, n, dtype, impl, blocks, _device_kind = dkey
    try:
        return program_digest(m, k, n, dtype, impl, blocks)
    except (TypeError, ValueError, KeyError):
        return None


def recomputed_digests(recs: Iterable[dict[str, Any]]) -> dict[tuple, str]:
    """Program digests recomputed once a distinct program, for
    `stale_reasons(digests=...)`."""
    out: dict[tuple, str] = {}
    for rec in recs:
        dkey = _digest_key(rec)
        if dkey not in out:
            now = _recompute_program_digest(dkey)
            if now is not None:
                out[dkey] = now
    return out
