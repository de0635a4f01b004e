"""The port's kernel-library store (`tpu_matmul_bench_torch/tune/artifacts.py`)
and its serve wiring, mirroring the JAX package's tests/test_artifacts.py.

The port stores the kernel library a `cuda` executable launches, not a
serialized executable; there is no nvcc here, so a few bytes written where
`ops/_build.py library_path` points (a build directory of the test's own)
stand in for a built library. Four families, all on the CPU:

- **round trip**: put, a fresh load's lookup and get_blob; every identity
  axis in the key; `mesh_spec` separating keys, keys without it computing
  as before; a put that is idempotent, last record winning;
- **corruption**: a truncated, byte-flipped or missing blob rejected at
  read time and recorded; a torn manifest tail tolerated, then repaired;
- **integrity and drift**: `validate` on a tampered key, a corrupt and a
  missing blob; `stale_reasons` on torch and program-digest drift; `tune
  artifacts verify` exiting 1 on a broken chain and `show` listing;
- **the cache**: a second cache instance imports the library into an
  empty build directory and counts a deserialize, a corrupt blob counts an
  `error` and the key is built, and the service exports nothing for
  `torch` keys or on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from tpu_matmul_bench_torch.__main__ import main as port_main
from tpu_matmul_bench_torch.ops import _build
from tpu_matmul_bench_torch.ops.matmul import matmul_2d
from tpu_matmul_bench_torch.tune import cli as tune_cli
from tpu_matmul_bench_torch.tune.artifacts import (
    ArtifactMeta,
    ArtifactStore,
    artifact_key,
    blob_digest,
    install_library,
    pack_library,
)

LIBRARY_BYTES = b"\x7fELF a kernel library stands here " * 64


def _meta(m: int = 16, k: int = 16, n: int = 16, **kw) -> ArtifactMeta:
    return ArtifactMeta.build(m, k, n, "bfloat16", impl="cuda", device_kind="h100", **kw)


@pytest.fixture
def store(tmp_path) -> ArtifactStore:
    return ArtifactStore.load(str(tmp_path / "store"))


@pytest.fixture
def built(tmp_path, monkeypatch) -> Path:
    """A build directory of the test's own, holding a 'built' library."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    path = _build.library_path("matmul")
    path.parent.mkdir(parents=True)
    path.write_bytes(LIBRARY_BYTES)
    return path


class TestRoundTrip:
    def test_pack_reads_the_built_library(self, built):
        assert pack_library() == LIBRARY_BYTES

    def test_pack_without_a_build_raises(self, tmp_path, monkeypatch):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "empty")
        with pytest.raises(FileNotFoundError):
            pack_library()

    def test_store_round_trip_across_fresh_load(self, store):
        meta = _meta()
        rec = store.put(meta, LIBRARY_BYTES)
        assert rec["key"] == meta.key and rec["blob_digest"] == blob_digest(LIBRARY_BYTES)
        fresh = ArtifactStore.load(store.root)
        assert len(fresh) == 1
        hit = fresh.lookup(meta)
        assert hit is not None and hit["key"] == meta.key
        assert fresh.get_blob(hit) == LIBRARY_BYTES

    def test_keys_that_share_the_library_share_one_blob(self, store):
        a, b = store.put(_meta(16, 16, 16), LIBRARY_BYTES), store.put(_meta(32, 32, 32),
                                                                      LIBRARY_BYTES)
        assert a["key"] != b["key"] and a["blob"] == b["blob"]
        assert len(list((Path(store.root) / "blobs").iterdir())) == 1

    def test_identity_axes_are_in_the_key(self):
        meta = _meta()
        for field, value in (("torch_version", "0.0.1 cuda 1.0"), ("program_digest", "feed"),
                             ("backend", "cpu"), ("mesh_shape", (8,)),
                             ("fingerprint", "0" * 16)):
            assert dataclasses.replace(meta, **{field: value}).key != meta.key, field

    def test_put_is_idempotent_last_wins(self, store):
        store.put(_meta(), LIBRARY_BYTES)
        store.put(_meta(), LIBRARY_BYTES)
        fresh = ArtifactStore.load(store.root)
        assert len(fresh) == 1 and fresh.records_read == 2

    def test_a_torch_executable_has_no_library(self):
        with pytest.raises(ValueError, match="no kernel library"):
            ArtifactMeta.build(16, 16, 16, "bfloat16", impl="torch")

    def test_the_program_digest_names_the_library(self, built):
        # the digest hashes the library's name, so a changed source keys
        # differently: `tune/db.py program_digest`'s `cuda` record
        from tpu_matmul_bench_torch.tune.db import program_digest

        assert _meta().program_digest == program_digest(16, 16, 16, "bfloat16", "cuda")


class TestCorruption:
    def test_truncated_blob_rejected_at_every_stride(self, store):
        rec = store.put(_meta(), LIBRARY_BYTES)
        path = Path(store.root) / rec["blob"]
        data = path.read_bytes()
        for cut in sorted({*range(0, len(data), max(1, len(data) // 64)), len(data) - 1}):
            path.write_bytes(data[:cut])
            store.rejected.clear()
            assert store.get_blob(rec) is None, f"cut at byte {cut}"
            assert store.rejected
        path.write_bytes(data)
        assert store.get_blob(rec) == LIBRARY_BYTES

    def test_flipped_byte_rejected_at_every_stride(self, store):
        rec = store.put(_meta(), LIBRARY_BYTES)
        path = Path(store.root) / rec["blob"]
        data = path.read_bytes()
        for pos in range(0, len(data), max(1, len(data) // 64)):
            garbled = bytearray(data)
            garbled[pos] ^= 0xFF
            path.write_bytes(bytes(garbled))
            assert store.get_blob(rec) is None, f"flip at byte {pos}"

    def test_missing_blob_is_a_recorded_miss(self, store):
        rec = store.put(_meta(), LIBRARY_BYTES)
        (Path(store.root) / rec["blob"]).unlink()
        assert store.get_blob(rec) is None
        assert any("unreadable" in r for r in store.rejected)

    def test_torn_manifest_tail_tolerated_then_repaired(self, store):
        store.put(_meta(16, 16, 16), LIBRARY_BYTES)
        store.put(_meta(32, 32, 32), LIBRARY_BYTES)
        manifest = Path(store.manifest_path)
        data = manifest.read_bytes()
        last_start = data[:-1].rfind(b"\n") + 1
        manifest.write_bytes(data[:last_start + (len(data) - 1 - last_start) // 2])
        torn = ArtifactStore.load(store.root)
        assert len(torn) == 1 and torn.parse_errors
        torn.put(_meta(64, 64, 64), LIBRARY_BYTES)
        healed = ArtifactStore.load(store.root)
        assert len(healed) == 2 and not healed.parse_errors


def _tamper(store: ArtifactStore, mutate) -> None:
    manifest = Path(store.manifest_path)
    recs = [json.loads(line) for line in manifest.read_text().splitlines()]
    manifest.write_text("".join(json.dumps(mutate(dict(r))) + "\n" for r in recs))


def _rekey(rec: dict) -> str:
    return artifact_key(rec["fingerprint"], rec["torch_version"], rec["program_digest"],
                        rec["backend"], tuple(rec["mesh_shape"]), rec.get("mesh_spec", ""))


class TestIntegrityAndDrift:
    def test_clean_and_absent_stores_validate(self, store, tmp_path):
        store.put(_meta(), LIBRARY_BYTES)
        assert ArtifactStore.load(store.root).validate() == []
        assert ArtifactStore.load(str(tmp_path / "nowhere")).validate() == []

    def test_tampered_key(self, store):
        store.put(_meta(), LIBRARY_BYTES)
        _tamper(store, lambda r: {**r, "key": "0" * 16})
        assert any("does not recompute" in m for _, m in ArtifactStore.load(store.root).validate())

    def test_blob_digest_mismatch(self, store):
        rec = store.put(_meta(), LIBRARY_BYTES)
        path = Path(store.root) / rec["blob"]
        path.write_bytes(path.read_bytes()[:-1] + b"\x00")
        assert any("hash" in m for _, m in ArtifactStore.load(store.root).validate())

    def test_missing_blob(self, store):
        rec = store.put(_meta(), LIBRARY_BYTES)
        (Path(store.root) / rec["blob"]).unlink()
        assert any("missing" in m for _, m in ArtifactStore.load(store.root).validate())

    def test_torch_drift_is_stale_not_broken(self, store):
        store.put(_meta(), LIBRARY_BYTES)
        _tamper(store, lambda r: {**r, "torch_version": "0.0.1 cuda 1.0",
                                  "key": _rekey({**r, "torch_version": "0.0.1 cuda 1.0"})})
        fresh = ArtifactStore.load(store.root)
        assert fresh.validate() == []
        (rec,) = fresh.records()
        assert any("torch 0.0.1" in r for r in fresh.stale_reasons(
            rec, torch_version="2.11.0 cuda 12.8", digests={}))

    def test_program_digest_drift(self, store):
        store.put(_meta(), LIBRARY_BYTES)
        _tamper(store, lambda r: {**r, "program_digest": "deadbeef",
                                  "key": _rekey({**r, "program_digest": "deadbeef"})})
        fresh = ArtifactStore.load(store.root)
        (rec,) = fresh.records()
        assert fresh.validate() == []
        assert any("digest" in r for r in fresh.stale_reasons(rec))

    def test_verify_cli_exits_1_on_a_broken_chain(self, store, capsys):
        store.put(_meta(), LIBRARY_BYTES)
        assert tune_cli.main(["artifacts", "verify", "--store", store.root]) == 0
        _tamper(store, lambda r: {**r, "key": "0" * 16})
        with pytest.raises(SystemExit) as exc:
            tune_cli.main(["artifacts", "verify", "--store", store.root])
        assert exc.value.code == 1
        assert "tune artifacts verify FAILED" in capsys.readouterr().out

    def test_show_lists_and_checks_drift(self, store, capsys):
        store.put(_meta(mesh_shape=(2, 2), mesh_spec="dcn:4,ici:2/g0=dcn:2,ici:2"),
                  LIBRARY_BYTES)
        assert port_main(["tune", "artifacts", "show", "--store", store.root,
                          "--check-drift"]) == 0
        out = capsys.readouterr().out
        assert "1 live artifacts" in out and "g0=dcn:2,ici:2" in out
        assert "0 stale" in out


def test_mesh_spec_distinguishes_artifact_keys():
    base = ("fp" * 6, "2.11.0 cuda 12.8", "pd" * 6, "cuda", (4,))
    g0 = artifact_key(*base, mesh_spec="dcn:2,ici:4/g0=ici:4")
    g1 = artifact_key(*base, mesh_spec="dcn:2,ici:4/g1=ici:4")
    plain = artifact_key(*base)
    assert len({g0, g1, plain}) == 3
    assert artifact_key(*base, mesh_spec="") == plain


def test_meta_carries_mesh_spec_into_key_and_record(store):
    meta = _meta(mesh_shape=(2, 2), mesh_spec="dcn:4,ici:2/g0=dcn:2,ici:2")
    other = _meta(mesh_shape=(2, 2), mesh_spec="dcn:4,ici:2/g1=dcn:2,ici:2")
    assert len({meta.key, other.key, _meta().key}) == 3
    rec = store.put(meta, LIBRARY_BYTES)
    assert rec["mesh_spec"] == meta.mesh_spec
    assert store.lookup(meta) is not None and store.lookup(other) is None


# ------------------------------------------------------------- the cache

def _cache(store, meta=lambda k: _meta(k.m, k.k, k.n)):
    from tpu_matmul_bench_torch.serve.cache import ExecutableCache, Program

    ops = (torch.ones(16, 16, dtype=torch.bfloat16), torch.ones(16, 16, dtype=torch.bfloat16))

    def build(key):
        # the stand-in for nvcc: a build leaves the library where
        # `library_path` points, as `_build.build` does on the card
        path = _build.library_path("matmul")
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(LIBRARY_BYTES)
        return Program(matmul_2d("cuda"), "cuda")

    return ExecutableCache(build, operands=lambda k: ops, artifacts=store,
                           artifact_meta=meta), ops


def _key():
    from tpu_matmul_bench_torch.serve.cache import ExecKey

    return ExecKey(16, 16, 16, "bfloat16", "cuda")


def test_second_cache_instance_imports_the_library(store, built, tmp_path, monkeypatch):
    first, _ = _cache(store)
    assert first.warm_start([_key()]) == 1
    s1 = first.stats()
    assert (s1["preload"]["compiled"], s1["preload"]["deserialized"]) == (1, 0)
    assert s1["artifacts"] == {"hits": 0, "misses": 1, "exports": 1, "errors": 0}
    assert s1["by_entry"][_key().label]["source"] == "compile"

    # a fresh process's empty build directory
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "fresh")
    second, ops = _cache(ArtifactStore.load(store.root))
    assert second.warm_start([_key()]) == 1
    s2 = second.stats()
    assert (s2["preload"]["compiled"], s2["preload"]["deserialized"]) == (0, 1)
    assert s2["preload"]["compile_ms"] == 0.0 and s2["preload"]["deserialize_ms"] > 0
    assert s2["artifacts"] == {"hits": 1, "misses": 0, "exports": 0, "errors": 0}
    entry = s2["by_entry"][_key().label]
    assert entry["source"] == "artifact" and entry["cold_compile_ms"] == 0.0
    assert "deserialize_ms" in entry
    assert _build.library_path("matmul").read_bytes() == LIBRARY_BYTES
    out = second.get(_key()).compiled(*ops)
    assert torch.equal(out, torch.full((16, 16), 16.0, dtype=torch.bfloat16))


def test_corrupt_blob_counts_an_error_and_builds(store, built, tmp_path, monkeypatch):
    first, _ = _cache(store)
    first.warm_start([_key()])
    (Path(store.root) / store.records()[0]["blob"]).write_bytes(b"junk")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "fresh")
    second, _ = _cache(ArtifactStore.load(store.root))
    assert second.warm_start([_key()]) == 1
    s = second.stats()
    assert (s["preload"]["compiled"], s["preload"]["deserialized"]) == (1, 0)
    assert s["artifacts"] == {"hits": 0, "misses": 0, "exports": 1, "errors": 1}
    assert s["by_entry"][_key().label]["source"] == "compile"
    # the bad bytes never landed: the library is the build's, and the
    # export put its bytes back under the blob's name
    assert _build.library_path("matmul").read_bytes() == LIBRARY_BYTES
    healed = ArtifactStore.load(store.root)
    assert healed.get_blob(healed.records()[0]) == LIBRARY_BYTES


def test_install_keeps_a_library_already_built(built):
    assert install_library(b"other bytes") == built
    assert built.read_bytes() == LIBRARY_BYTES


def test_no_library_to_store_for_torch_keys_or_on_the_cpu():
    from tpu_matmul_bench_torch.serve.cache import ExecKey
    from tpu_matmul_bench_torch.serve.service import _artifact_meta_fn

    cuda_key = ExecKey(256, 256, 256, "bfloat16", "cuda")
    assert _artifact_meta_fn("NVIDIA H100 80GB HBM3", True)(cuda_key).impl == "cuda"
    assert _artifact_meta_fn("NVIDIA H100 80GB HBM3", False)(cuda_key) is None
    assert _artifact_meta_fn("NVIDIA H100 80GB HBM3", True)(
        dataclasses.replace(cuda_key, impl="torch")) is None
