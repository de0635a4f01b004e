"""The port's tuning database (tpu_matmul_bench_torch/tune/) against the JAX
package's (tpu_matmul_bench/tune/).

- Problem fingerprints are bitwise the JAX package's: every committed JAX
  cell recomputes, and so does each problem with a wire format, a mesh or
  a K-streaming plan.
- Load, put and validate behave as the JAX store does on the same seeded
  files (a torn tail, last-wins, a tampered fingerprint, a dead artifact,
  a kernel cell without its tile), the port's impls `torch`/`cuda` in the
  place of `xla`/`pallas`.
- `promote` picks what JAX `promote` picks on the same tune ledgers.
- `resolve_route` hits and misses the same rectangles for one cell (the
  (m, n, k) against (m, k, n) seam), and `auto` through a `cuda` cell runs
  the kernel's wrapper at the cell's tile, matching JAX's `xla` product.
- Prune keeps the measured winner and shrinks the grid; ring wire bytes
  equal JAX's.
- The committed store regenerates from the table and validates.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (  # noqa: F401 — single_torch_thread is a fixture
    TOLERANCE,
    as_numpy,
    numpy_operands,
    rel_err,
    single_torch_thread,
)

from tpu_matmul_bench.ops import impl_select as jax_select
from tpu_matmul_bench.ops.matmul import matmul_2d as jax_matmul_2d
from tpu_matmul_bench.tune import db as jax_db
from tpu_matmul_bench.tune import promote as jax_promote
from tpu_matmul_bench.tune import prune as jax_prune
from tpu_matmul_bench_torch.ops import _build
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops import impl_select
from tpu_matmul_bench_torch.ops.matmul import matmul_2d, operands_from_numpy
from tpu_matmul_bench_torch.tune import db, promote, prune, regen

pytestmark = pytest.mark.usefixtures("single_torch_thread")

REPO = Path(__file__).resolve().parent.parent
JAX_CELLS = [json.loads(line) for line in
             (REPO / "measurements" / "tune_db.jsonl").read_text().splitlines()
             if line.strip()]
H100 = "NVIDIA H100 80GB HBM3"
V5E = "TPU v5e"
LEDGER = "measurements/r4/tune_int8_16k_b.jsonl"  # exists; any ledger will do
# fully keyed, so neither store traces or hashes a program to complete a cell
KEYED = {"program_digest": "d" * 16, "created_at": "t"}

# the JAX package's impl names and the port's, position for position
IMPLS = {"jax": ("xla", "pallas"), "port": ("torch", "cuda")}


def _cell(pkg, m=512, k=1024, n=2048, dtype="bfloat16", kernel=True,
          blocks=(128, 256, 64), artifact=LEDGER, **kw):
    mod = jax_db if pkg == "jax" else db
    version = {"jax_version": "v"} if pkg == "jax" else {"torch_version": "v"}
    return mod.Cell(m=m, k=k, n=n, dtype=dtype,
                    device_kind=mod.kind_token(V5E if pkg == "jax" else H100),
                    impl=IMPLS[pkg][kernel], provenance_kind="measured",
                    artifact=artifact, blocks=blocks, **KEYED, **version, **kw)


def _store(pkg, path):
    return (jax_db if pkg == "jax" else db).TuningDB(path=str(path))


# ---------------------------------------------------------- fingerprints

@pytest.mark.parametrize("rec", JAX_CELLS,
                         ids=[f"{r['problem']['dtype']}@{r['problem']['m']}x"
                              f"{r['problem']['k']}x{r['problem']['n']}" for r in JAX_CELLS])
def test_fingerprint_recomputes_every_jax_cell(rec):
    p = rec["problem"]
    assert db.problem_fingerprint(p["m"], p["k"], p["n"], p["dtype"]) == rec["fingerprint"]


VARIANTS = [
    (512, 1024, 2048, "bfloat16", None, None, None),
    (512, 1024, 2048, "float16", None, None, None),
    (4096, 4096, 4096, "int8", "int8-block:32", None, None),
    (4096, 4096, 4096, "bfloat16", "fp8", None, None),
    (4096, 4096, 4096, "bfloat16", "none", None, None),
    (8192, 8192, 8192, "bfloat16", None, "dcn:2,ici:4", None),
    (8192, 8192, 8192, "bfloat16", None, "dcn:4,ici:2", None),
    (8192, 8192, 8192, "bfloat16", None, "dcn:2 , ici:4", None),
    (32768, 32768, 32768, "bfloat16", None, None, 16),
    (32768, 32768, 32768, "float32", "fp8-block:128", "dcn:2,ici:2", 8),
]


@pytest.mark.parametrize("m, k, n, dtype, comm_quant, mesh, stream_k", VARIANTS)
def test_fingerprint_variants_match_jax(m, k, n, dtype, comm_quant, mesh, stream_k):
    want = jax_db.problem_fingerprint(m, k, n, dtype, comm_quant, mesh=mesh,
                                      stream_k=stream_k)
    assert db.problem_fingerprint(m, k, n, dtype, comm_quant, mesh=mesh,
                                  stream_k=stream_k) == want
    # a torch dtype keys as its name does
    assert db.problem_fingerprint(m, k, n, getattr(torch, dtype), comm_quant,
                                  mesh=mesh, stream_k=stream_k) == want


def test_fingerprint_is_memoised():
    db.problem_fingerprint.cache_clear()
    db.problem_fingerprint(96, 64, 32, torch.bfloat16)
    db.problem_fingerprint(96, 64, 32, torch.bfloat16)
    info = db.problem_fingerprint.cache_info()
    assert (info.hits, info.misses) == (1, 1)
    assert db.problem_fingerprint.__wrapped__(96, 64, 32, torch.bfloat16) == \
        db.problem_fingerprint(96, 64, 32, "bfloat16")


def test_digest_is_the_jax_packages():
    from tpu_matmul_bench.analysis.fingerprint import digest as jax_digest

    for record in ({"op": "matmul_2d", "m": 1}, {"b": [1, 2], "a": None, "é": 1.5}):
        assert db.digest(record) == jax_digest(record)


@pytest.mark.parametrize("name, token", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA H100", "h100"),
    ("NVIDIA H100 SXM5 80GB", "h100"), ("NVIDIA H100 PCIe", "nvidia h100 pcie"),
    ("NVIDIA H100 NVL", "nvidia h100 nvl"), ("TPU v5 lite", "tpu v5 lite"),
    ("cpu", "cpu"), ("", "unknown")])
def test_kind_token(name, token):
    assert db.kind_token(name) == token


def test_canonical_dtype_shares_bf16_cells():
    assert db.canonical_dtype(torch.float16) == db.canonical_dtype("bfloat16") \
        == jax_db.canonical_dtype(jnp.float16) == "bfloat16"
    assert db.canonical_dtype(torch.int8) == jax_db.canonical_dtype(jnp.int8) == "int8"


# ------------------------------------------------------ durability parity

def _torn_tail_last_wins(pkg, tmp_path):
    store = _store(pkg, tmp_path / "db.jsonl")
    store.put(_cell(pkg, blocks=(128, 128, 32)))
    store.put(_cell(pkg, blocks=(128, 256, 64)))  # supersedes, never rewrites
    with open(store.path, "a") as fh:
        fh.write('{"record_type": "tune_cell", "torn...')
    loaded = type(store).load(store.path)
    cell = loaded.lookup(512, 1024, 2048, "bfloat16", V5E if pkg == "jax" else H100)
    after = type(store)(path=store.path)
    after.put(_cell(pkg, m=64))  # repairs the torn tail before appending
    return (loaded.records_read, len(loaded), loaded.parse_errors, cell.blocks,
            len(type(store).load(store.path)), type(store).load(store.path).parse_errors)


def _fingerprint_mismatch(pkg, tmp_path):
    store = _store(pkg, tmp_path / "db.jsonl")
    store.put(_cell(pkg))
    rec = json.loads(Path(store.path).read_text().splitlines()[0])
    rec["fingerprint"] = "0" * 16
    Path(store.path).write_text(json.dumps(rec) + "\n")
    loaded = type(store).load(store.path)
    return len(loaded), [e.split(":")[0] for e in loaded.parse_errors], \
        ["stored fingerprint 0000000000000000" in e for e in loaded.parse_errors]


def _dead_artifact(pkg, tmp_path):
    store = _store(pkg, tmp_path / "db.jsonl")
    store.put(_cell(pkg, artifact="measurements/r999/never_measured.jsonl"))
    return [("does not exist" in p, "never_measured" in p) for p in store.validate()]


def _kernel_cell_without_blocks(pkg, tmp_path):
    store = _store(pkg, tmp_path / "db.jsonl")
    store.put(_cell(pkg, dtype="float32", blocks=None))
    store.put(_cell(pkg, m=64, kernel=False, blocks=None))
    return ["without blocks" in p for p in store.validate()]


def _provenance_mandatory(pkg, tmp_path):
    out = []
    for kw in ({"artifact": ""}, {"provenance_kind": "vibes"}):
        try:
            mod = jax_db if pkg == "jax" else db
            base = dict(m=1, k=1, n=1, dtype="int8", device_kind="x", impl=IMPLS[pkg][0],
                        provenance_kind="measured", artifact=LEDGER)
            mod.Cell(**{**base, **kw})
        except ValueError as e:
            out.append(str(e).split(" ")[0:3])
    return out


def _round_trip(pkg, tmp_path):
    store = _store(pkg, tmp_path / "db.jsonl")
    put = store.put(_cell(pkg, comm_quant="int8-block:32", mesh="dcn:2,ici:4", stream_k=8))
    loaded = type(store).load(store.path)
    (got,) = loaded.cells()
    rec = got.to_record()
    return (got == put, got.fingerprint, rec["problem"],
            sorted(k.replace("jax_", "torch_") for k in rec))


@pytest.mark.parametrize("scenario", [_torn_tail_last_wins, _fingerprint_mismatch,
                                      _dead_artifact, _kernel_cell_without_blocks,
                                      _provenance_mandatory, _round_trip],
                         ids=lambda f: f.__name__.strip("_"))
def test_store_behaves_as_jax(scenario, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert scenario("port", tmp_path / "port") == scenario("jax", tmp_path / "jax")


def test_validate_flags_the_port_impls(tmp_path):
    store = _store("port", tmp_path / "db.jsonl")
    store.put(_cell("port", m=64, dtype="int8", kernel=False, blocks=None))
    assert store.validate() == []
    store.put(db.Cell(**{**_cell("port").__dict__, "impl": "pallas"}))
    assert any("unknown impl 'pallas'" in p for p in store.validate())


def test_put_completes_the_cell(tmp_path):
    store = _store("port", tmp_path / "db.jsonl")
    cell = db.Cell(m=512, k=1024, n=2048, dtype="bfloat16", device_kind="h100",
                   impl="cuda", provenance_kind="measured", artifact=LEDGER,
                   blocks=(128, 256, 64))
    put = store.put(cell)
    assert put.torch_version == db.torch_version()
    assert put.program_digest == db.program_digest(512, 1024, 2048, "bfloat16", "cuda",
                                                   (128, 256, 64))
    assert put.created_at


# -------------------------------------------------------------- staleness

def test_program_digest_tracks_the_route_tile_and_library(monkeypatch):
    base = db.program_digest(4096, 4096, 4096, "bfloat16", "cuda", (128, 256, 64))
    # a request that resolves to the same tile digests alike
    assert db.program_digest(4096, 4096, 4096, "bfloat16", "cuda", (128, 256, 64)) == base
    assert db.program_digest(4096, 4096, 4096, "bfloat16", "cuda", (128, 128, 64)) != base
    assert db.program_digest(4096, 4096, 4096, "int8", "cuda", (128, 256, 64)) != base
    # a torch cell does not read the kernel library; a cuda cell does
    lib = db.program_digest(4096, 4096, 4096, "bfloat16", "torch")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert db.program_digest(4096, 4096, 4096, "bfloat16", "cuda", (128, 256, 64)) != base
    assert db.program_digest(4096, 4096, 4096, "bfloat16", "torch") == lib
    assert db.program_digest(4096, 4096, 2048, "bfloat16", "torch") != lib


def test_bumped_digest_stales_exactly_the_matching_cell(tmp_path):
    store = _store("port", tmp_path / "db.jsonl")
    a = store.put(db.Cell(m=512, k=1024, n=2048, dtype="bfloat16", device_kind="h100",
                          impl="cuda", provenance_kind="measured", artifact=LEDGER,
                          blocks=(128, 256, 64)))
    b = store.put(db.Cell(m=2048, k=1024, n=512, dtype="float32", device_kind="h100",
                          impl="torch", provenance_kind="measured", artifact=LEDGER))
    assert store.stale_cells() == []  # recomputed digests equal the stored ones
    digests = {a.key: a.program_digest, b.key: b.program_digest}
    digests[a.key] = "f" * 16
    stale = store.stale_cells(digests=digests)
    assert [c.key for c, _ in stale] == [a.key]
    assert "DRIFT-style" in stale[0][1][0]
    # the version axis is independent of the digest axis
    reasons = store.stale_reasons(b, torch_version="9.9 cuda 13.0", digests=digests)
    assert len(reasons) == 1 and "9.9 cuda 13.0" in reasons[0]
    # a CPU build of torch checks no version (nothing there to re-measure)
    assert torch.version.cuda is None
    assert store.stale_reasons(db.Cell(**{**b.__dict__, "torch_version": "old"})) == []


# -------------------------------------------------------------- promotion

def _tune_rec(pkg, tflops, bm, bn, bk, size=4096, dtype="bfloat16", mode="none", **extras):
    if mode != "none":
        mode = f"tune_{'pallas' if pkg == 'jax' else 'cuda'}_{mode}"
    return {"benchmark": "tune", "mode": mode if mode != "none" else "tune_none",
            "size": size, "dtype": dtype, "tflops_total": tflops,
            "extras": {"block_m": bm, "block_n": bn, "block_k": bk, **extras}}


PROMOTE_FIXTURES = {
    # JAX tests/test_tune_db.py's fixtures, and a ring sweep and a
    # confirm-flagged tie
    "winner": [[(100.0, 128, 256, 64), (90.0, 128, 128, 64)]],
    "discipline": [
        [(100.0, 128, 256, 64), (99.5, 128, 128, 64)],
        [(100.0, 128, 256, 64, {"size": 8192, "grid_order": "nmk"}),
         (80.0, 128, 128, 64, {"size": 8192})],
        [(120.0, 128, 256, 64, {"size": 16384}),
         (100.0, 256, 128, 32, {"size": 16384, "confirm_pass": True}),
         (90.0, 128, 256, 64, {"size": 16384, "confirm_pass": True})],
    ],
    "rect_int8": [[(300.0, 128, 256, 64, {"dtype": "int8", "size": 28672,
                                          "shape": "28672x4096x8192"}),
                   (250.0, 128, 128, 32, {"dtype": "int8", "size": 28672,
                                          "shape": "28672x4096x8192"})]],
    "ring_and_tie": [
        [(100.0, 128, 256, 64, {"mode": "ring_hbm"}), (50.0, 128, 128, 64, {"mode": "ring_hbm"})],
        [(100.0, 128, 256, 64, {"size": 2048, "confirm_pass": True, "tie_margin_pct": 0.4}),
         (99.6, 128, 128, 64, {"size": 2048, "confirm_pass": True, "tie_margin_pct": 0.4})],
        [(100.0, 128, 256, 64, {"size": 2048, "ksplit": 2}),
         (50.0, 128, 128, 64, {"size": 2048})],
    ],
}


def _promote(pkg, fixture, tmp_path, monkeypatch):
    ledgers = []
    for i, recs in enumerate(PROMOTE_FIXTURES[fixture]):
        path = tmp_path / f"ledger{i}.jsonl"
        lines = []
        for tflops, bm, bn, bk, *extra in recs:
            kw = dict(extra[0]) if extra else {}
            lines.append(json.dumps(_tune_rec(pkg, tflops, bm, bn, bk, **kw)))
        path.write_text("\n".join(lines) + "\n")
        ledgers.append(str(path))
    store = _store(pkg, tmp_path / "db.jsonl")
    if pkg == "jax":  # keep JAX from tracing a program digest
        monkeypatch.setattr(jax_db, "program_digest", lambda *a, **k: "d" * 16)
        result = jax_promote.promote(ledgers, store, device_kind=V5E)
    else:
        result = promote.promote(ledgers, store, device_kind=H100)
    cells = [(c.m, c.k, c.n, c.dtype, c.impl == IMPLS[pkg][1], c.blocks, c.tflops,
              c.provenance_kind, Path(c.artifact).name,
              c.detail.replace("pallas_tune", "cuda_tune")) for c in result["promoted"]]
    # each skip's class: the words after the label
    skips = [s.split(": ", 1)[1].split(" ")[0:2] for s in result["skipped"]]
    return cells, skips, len(type(store).load(store.path))


@pytest.mark.parametrize("fixture", list(PROMOTE_FIXTURES))
def test_promote_chooses_what_jax_chooses(fixture, tmp_path, monkeypatch):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    port = _promote("port", fixture, tmp_path / "port", monkeypatch)
    assert port == _promote("jax", fixture, tmp_path / "jax", monkeypatch)
    assert port[0] or port[1]


# ---------------------------------------------------------------- routing

# (m, n, k) routing questions around one cell at A[512,1024]·B[1024,2048]
ROUTES = [(512, 2048, 1024), (1024, 2048, 512), (512, 1024, 2048), (2048, 512, 1024),
          (2048, 1024, 512), (1024, 512, 2048), (512, 2048, 2048)]


@pytest.mark.parametrize("mnk", ROUTES, ids=lambda t: "x".join(map(str, t)))
def test_resolve_route_hits_what_jax_hits(mnk, tmp_path):
    jax_store = _store("jax", tmp_path / "jax.jsonl")
    jax_store.put(_cell("jax"))
    port_store = _store("port", tmp_path / "port.jsonl")
    port_store.put(_cell("port"))
    want, jax_cell = jax_select.resolve_route(*mnk, V5E, jnp.bfloat16, db=jax_store)
    got, cell = impl_select.resolve_route(*mnk, H100, torch.bfloat16, db=port_store)
    assert got.source == want.source
    assert (cell is None) == (jax_cell is None)
    if cell is not None:
        assert got.impl == "cuda" and got.blocks == want.blocks == (128, 256, 64)
        assert cell.fingerprint in got.provenance and got == impl_select.select_impl(
            *mnk, H100, torch.float16, db=port_store)


@pytest.fixture
def installed_db(tmp_path):
    """A store with one measured `cuda` cell at 96x64x128 bf16 on the H100,
    installed as the process's default, the committed one restored after."""
    store = _store("port", tmp_path / "db.jsonl")
    store.put(db.Cell(m=96, k=64, n=128, dtype="bfloat16", device_kind="h100",
                      impl="cuda", provenance_kind="measured", artifact=LEDGER,
                      blocks=(128, 128, 64)))
    db.install_default_db(store)
    yield store
    db.invalidate_default_db()


def test_auto_runs_the_cells_tile_and_matches_jax(installed_db, monkeypatch):
    seen = []
    real = cm.cuda_matmul

    def spy(a, b, **kw):
        seen.append(kw.get("blocks"))
        return real(a, b, **kw)

    monkeypatch.setattr(cm, "cuda_matmul", spy)
    a_np, b_np = numpy_operands(5, 96, 64, 128, "bfloat16")
    a, b = operands_from_numpy(a_np, b_np, device="cpu")
    got = matmul_2d("auto", device_kind=H100)(a, b)
    want = jax_matmul_2d("xla")(jnp.asarray(a_np), jnp.asarray(b_np))
    assert seen == [(128, 128, 64)]
    assert rel_err(as_numpy(got), np.asarray(want, np.float32)) <= TOLERANCE["bfloat16"]
    # an explicit tile wins over the cell's
    matmul_2d("auto", blocks=(64, 128, 32), device_kind=H100)(a, b)
    assert seen[-1] == (64, 128, 32)
    # another shape, and the same shape on the CPU, take the library
    matmul_2d("auto", device_kind=H100)(a[:, :32], b[:32])
    matmul_2d("auto")(a, b)
    assert len(seen) == 2


def test_auto_keys_on_the_operands_device_when_no_kind_is_named(installed_db, monkeypatch):
    kinds = []
    real = impl_select.select_impl
    monkeypatch.setattr(impl_select, "select_impl",
                        lambda *args, **kw: kinds.append(args[3]) or real(*args, **kw))
    a = torch.ones(8, 8)
    matmul_2d("auto")(a, a)
    assert kinds == ["cpu"]


# ------------------------------------------------------------------ prune

@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int8"])
def test_prune_keeps_the_measured_winner_and_shrinks_the_grid(dtype):
    report = prune.prune(16384, 16384, 16384, dtype)
    assert cm.DEFAULT_TILE in report.kept
    assert report.kept[0] == cm.DEFAULT_TILE
    assert report.trials_before == len(cm.TILES)
    assert report.trials_after == prune.DEFAULT_TOP_K < report.trials_before
    assert f"{len(cm.TILES)} candidates → {prune.DEFAULT_TOP_K} measured" in report.log_lines()[0]


def test_prune_fp32_measures_the_simt_tile_once():
    report = prune.prune(16384, 16384, 16384, "float32")
    assert report.route == "simt" and report.kept == [cm.SIMT_TILE]
    assert report.trials_before == len(cm.TILES) + 1


def test_prune_sinks_a_tile_that_does_not_fit(monkeypatch):
    monkeypatch.setattr(cm, "SMEM_PER_BLOCK", cm.wgmma_plan((128, 256, 32))["smem_bytes"])
    report = prune.prune(16384, 16384, 16384, "bfloat16")
    assert (128, 256, 64) not in report.kept
    assert [c.blocks for c in report.dropped_infeasible][:1] == [(128, 256, 64)]
    assert "shared memory" in report.dropped_infeasible[0].reason


def test_prune_intensity_reads_the_kernels_books():
    from tpu_matmul_bench_torch.obs.attribution import kernel_cost

    c = prune.score_candidate(4096, 2048, 1024, "bfloat16", (128, 256, 64))
    books = kernel_cost("wgmma", 4096, 1024, 2048, (128, 256, 64))
    assert c.hbm_bytes == books["bytes_accessed"]
    assert c.intensity == pytest.approx(2 * 4096 * 2048 * 1024 / books["bytes_accessed"])


@pytest.mark.parametrize("ring", ["ring_hbm", "ring_bidir_hbm", "ring_rs_hbm",
                                  "ring_bidir_rs_hbm"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_ring_wire_matches_jax(ring, dtype):
    port = prune.ring_wire(f"cuda_{ring}", 8, 16384, dtype)
    want = jax_prune.ring_wire(f"pallas_{ring}", 8, 16384, dtype)
    assert {k: v for k, v in port.items() if k != "ring"} == \
        {k: v for k, v in want.items() if k != "ring"}
    report = prune.prune(16384, 16384, 16384, dtype, ring=f"cuda_{ring}", world=8)
    assert (report.m, report.k, report.n) == (port["chunk_m"], port["chunk_k"], port["chunk_n"])


# ------------------------------------------------------ the committed DB

def test_seed_surface_is_the_jax_packages():
    assert promote.SEED_SIZES == jax_promote.SEED_SIZES
    assert promote.SEED_RECTS == jax_promote.SEED_RECTS
    assert promote.SEED_DTYPES == jax_promote.SEED_DTYPES
    assert promote.TIE_GATE_PCT == jax_promote.TIE_GATE_PCT


def test_committed_db_regenerates_from_the_table():
    cells = promote.seed_cells_from_table()
    assert len(cells) == 30
    assert regen.check(db.default_path(), cells) == []
    for cell in cells:
        assert cell.impl == impl_select.table_select(cell.m, cell.n, cell.k, H100,
                                                     cell.dtype).impl


def test_committed_db_cites_h100_ledgers_and_validates():
    store = db.TuningDB.load()
    assert len(store) == 30 and store.validate() == [] and store.stale_cells() == []
    for cell in store.cells():
        assert cell.device_kind == "h100" and cell.provenance_kind == "measured"
        paths = db.artifact_paths(cell.artifact)
        assert paths and all(p.startswith("measurements/torch/") for p in paths)
        assert all((REPO / p).is_file() for p in paths)
        assert cell.torch_version and "cuda None" not in cell.torch_version
        assert (cell.impl == "cuda") == (cell.blocks is not None)


def test_table_rows_follow_the_head_to_head():
    from tpu_matmul_bench_torch.tune import head_to_head

    for dtype in promote.SEED_DTYPES:
        ledger = REPO / "measurements" / "torch" / "h2h" / f"{dtype}.ndjson"
        rows = head_to_head.margins(str(ledger))
        assert len(rows) == 10
        for r in rows:
            assert r["runs"] == {"torch": 2, "cuda": 2}
            choice = impl_select.table_select(r["m"], r["n"], r["k"], H100, dtype)
            assert choice.impl == r["impl"]
            assert str(ledger.relative_to(REPO)) in choice.provenance


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "NVIDIA H100 NVL", "cpu",
                                  "NVIDIA A100-SXM4-80GB"])
def test_other_kinds_stay_unrouted(kind):
    choice = impl_select.select_impl(16384, 16384, 16384, kind, torch.bfloat16)
    assert choice.impl == "torch" and choice.source == "table"
    assert "unrouted" in choice.provenance
