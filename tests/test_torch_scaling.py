"""The port's scaling and distributed programs against the JAX package's.

The five parallel modes (`tpu_matmul_bench_torch/parallel/modes.py`) run on
ranks that share the CPU (`TMB_RANKS_PER_CARD` set per test), the JAX
package's on the conftest's 8-device CPU mesh. The same numpy operands go
through both; outputs are held to each other rank by rank and to a dense
float64 product, within `validation_tolerance` (1e-3 fp32, 3e-2 bf16,
exact int8). Also: the record formulas, the programs' CLIs, `make_bmm`,
the fused timing over sharded operands and the once-per-card psum.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import as_numpy, numpy_operands, rel_err, single_torch_thread  # noqa: F401

from tpu_matmul_bench.benchmarks import matmul_distributed_benchmark as jax_dist
from tpu_matmul_bench.benchmarks import matmul_scaling_benchmark as jax_scaling
from tpu_matmul_bench.ops.matmul import make_bmm as jax_make_bmm
from tpu_matmul_bench.parallel import modes as jax_modes
from tpu_matmul_bench.parallel.mesh import make_mesh as jax_make_mesh
from tpu_matmul_bench.utils.config import parse_config as jax_parse_config
from tpu_matmul_bench.utils.reporting import (
    attach_scaling_efficiency as jax_attach_scaling_efficiency,
)
from tpu_matmul_bench_torch import __main__ as port_main
from tpu_matmul_bench_torch.benchmarks import matmul_scaling_benchmark as scaling
from tpu_matmul_bench_torch.ops.matmul import make_bmm, operands_from_numpy
from tpu_matmul_bench_torch.parallel import collectives, mesh, modes
from tpu_matmul_bench_torch.parallel.mesh import Sharded, gather, shard_from_numpy
from tpu_matmul_bench_torch.utils import timing
from tpu_matmul_bench_torch.utils.config import parse_config
from tpu_matmul_bench_torch.utils.device import resolve_devices
from tpu_matmul_bench_torch.utils.reporting import attach_scaling_efficiency

pytestmark = pytest.mark.usefixtures("single_torch_thread")

ALL_MODES = {**modes.SCALING_MODES, **modes.DISTRIBUTED_MODES}
JAX_ALL_MODES = {**jax_modes.SCALING_MODES, **jax_modes.DISTRIBUTED_MODES}
SMALL = ["--sizes", "64", "--iterations", "2", "--warmup", "1"]
TOL = {"float32": 1e-3, "bfloat16": 3e-2, "int8": 0.0}


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def port_mesh(d: int) -> mesh.Mesh:
    return mesh.make_mesh(resolve_devices("cpu", d))


def _config(*extra, dtype="float32"):
    return parse_config([*SMALL, "--device", "cpu", "--dtype", dtype, *extra], "t",
                        modes=list(ALL_MODES), extra_dtypes=("int8",), fused_timing=True)


def _jax_config(*extra, dtype="float32"):
    return jax_parse_config([*SMALL, "--dtype", dtype, *extra], "t",
                            modes=list(JAX_ALL_MODES), extra_dtypes=("int8",),
                            fused_timing=True)


# ------------------------------------------------------- the modes' outputs

def _dense(mode: str, leg: str, a: np.ndarray, b: np.ndarray, d: int) -> np.ndarray:
    """The global output of a mode's leg as a float64 product of the global
    operands (stacked operands: d·lb matrices, rank j holding lb)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    if mode in ("independent", "batch_parallel", "data_parallel"):
        prods = np.einsum("bik,bkj->bij", a, b)
        if leg == "compute" or mode == "independent":
            return prods
        lb = prods.shape[0] // d  # slot l of every rank summed across ranks
        sums = prods.reshape(d, lb, *prods.shape[1:]).sum(axis=0)
        return np.concatenate([sums] * d)
    if mode == "model_parallel" and leg == "compute":
        s = a.shape[1] // d
        return np.concatenate([a[:, j * s:(j + 1) * s] @ b[j * s:(j + 1) * s]
                               for j in range(d)], axis=1)
    return a @ b  # matrix_parallel both legs, model_parallel's psum


@functools.cache
def _jax_setup(mode: str, dtype_name: str, d: int, size: int = 64):
    """The JAX package's setup on the first d devices of the conftest's mesh
    (built once: the parity and record tests share it)."""
    import jax

    return JAX_ALL_MODES[mode](_jax_config(dtype=dtype_name),
                               jax_make_mesh(jax.devices()[:d]), size)


def _rank_views(global_np: np.ndarray, spec: tuple, d: int) -> list[np.ndarray]:
    """The block of a global array each rank holds under `spec`."""
    if mesh.AXIS not in spec:
        return [global_np] * d
    return np.split(global_np, d, axis=spec.index(mesh.AXIS))


MODE_CASES = [(m, dt) for m in ALL_MODES for dt in ("float32", "bfloat16")] + [
    ("independent", "int8"), ("data_parallel", "int8")]


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("mode,dtype_name", MODE_CASES)
def test_mode_outputs_match_jax_and_dense(devices, ranks8, mode, dtype_name, d):
    jsetup = _jax_setup(mode, dtype_name, d)
    psetup = ALL_MODES[mode](_config("--matmul-impl", "cuda", dtype=dtype_name),
                             port_mesh(d), 64)
    assert psetup.mode == jsetup.mode == mode
    np_ops = [np.asarray(x) for x in jsetup.operands]
    ops = tuple(shard_from_numpy(x, p.spec, port_mesh(d))
                for x, p in zip(np_ops, psetup.operands))
    tol = TOL[dtype_name]
    for leg in ("compute", "full"):
        jprog = getattr(jsetup, leg)
        if jprog is None:
            assert psetup.full is None
            continue
        want = np.asarray(jprog(*jsetup.operands)).astype(np.float64)
        got = getattr(psetup, leg)(*ops)
        assert isinstance(got, Sharded) and len(got) == d
        for r, (g, w) in enumerate(zip(got, _rank_views(want, got.spec, d))):
            assert tuple(g.shape) == w.shape, (leg, r)
            assert rel_err(as_numpy(g), w) <= tol, (leg, r)
        dense = _dense(mode, leg, *np_ops, d)
        assert rel_err(as_numpy(gather(got)), dense) <= tol, leg


@pytest.mark.parametrize("mode", list(ALL_MODES))
def test_validation_corner_is_ok(ranks8, mode):
    cfg = _config("--validate", "--matmul-impl", "cuda", dtype="bfloat16")
    rec = modes.run_mode_benchmark(ALL_MODES[mode](cfg, port_mesh(4), 128), cfg)
    assert rec.extras["validation"] == "ok", rec.extras
    assert rec.extras["validation_tolerance"] == 3e-2


# ------------------------------------------------------- the record formulas

FAKE = timing.Timing(total_s=0.02, iterations=2)
FAKE_FULL = timing.Timing(total_s=0.03, iterations=2)


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("mode", list(ALL_MODES))
def test_record_formulas_match_jax(devices, ranks8, mode, d):
    jsetup = _jax_setup(mode, "float32", d)
    psetup = ALL_MODES[mode](_config(), port_mesh(d), 64)
    full = FAKE_FULL if jsetup.full is not None else None
    jrec = jsetup.build_record(FAKE, full, 0.005)
    rec = psetup.build_record(FAKE, full, 0.005)
    cards = rec.extras["cards"]
    assert cards == 1 and rec.extras["ranks_per_card"] == d
    assert rec.tflops_total == pytest.approx(jrec.tflops_total, rel=1e-12)
    assert rec.tflops_per_device == pytest.approx(jrec.tflops_per_device * d / cards,
                                                  rel=1e-12)
    assert (rec.avg_time_s, rec.compute_time_s, rec.comm_time_s) == \
        (jrec.avg_time_s, jrec.compute_time_s, jrec.comm_time_s)
    assert set(rec.extras) == set(jrec.extras) | {"cards", "ranks_per_card"}
    for key in jrec.extras:
        assert rec.extras[key] == jrec.extras[key]
    assert (rec.benchmark, rec.mode, rec.world) == (jrec.benchmark, jrec.mode, jrec.world)
    assert rec.device_kind == "cpu"


def test_efficiency_counts_cards(devices, ranks8):
    # four ranks on one card: a perfect run reads 100%, not 25%
    rec = ALL_MODES["independent"](_config(), port_mesh(4), 64).build_record(FAKE, None, 0.0)
    single = rec.tflops_total  # the card did as much as one product alone
    attach_scaling_efficiency(rec, single)
    assert rec.scaling_efficiency_pct == pytest.approx(100.0)
    jrec = _jax_setup("independent", "float32", 4).build_record(FAKE, None, 0.0)
    jax_attach_scaling_efficiency(jrec, single)
    assert jrec.scaling_efficiency_pct == pytest.approx(25.0)


def test_one_rank_per_card_reduces_to_jax(devices, monkeypatch):
    # four ranks on four cards: per-device figures and efficiency are JAX's
    jrec = _jax_setup("independent", "float32", 4).build_record(FAKE, None, 0.0)
    world = mesh.Mesh(tuple(mesh.Rank(i, torch.device("cuda", i)) for i in range(4)))
    monkeypatch.setattr(modes, "mesh_device_kind", lambda m: "NVIDIA H100 80GB HBM3")
    rec = modes._mode_record(_config(), "scaling", "independent", 64, world, FAKE,
                             jrec.tflops_total, avg_time_s=FAKE.avg_s)
    assert rec.extras == {"cards": 4, "ranks_per_card": 1}
    assert rec.tflops_per_device == pytest.approx(jrec.tflops_per_device, rel=1e-12)
    attach_scaling_efficiency(rec, 0.5 * jrec.tflops_per_device)
    jax_attach_scaling_efficiency(jrec, 0.5 * jrec.tflops_per_device)
    assert rec.scaling_efficiency_pct == pytest.approx(jrec.scaling_efficiency_pct)
    assert rec.scaling_efficiency_pct == pytest.approx(200.0)


def test_matrix_parallel_world_one_is_independent_renamed(devices, ranks8):
    jsetup = JAX_ALL_MODES["matrix_parallel"](_jax_config(), jax_make_mesh(devices[:1]), 64)
    psetup = ALL_MODES["matrix_parallel"](_config(), port_mesh(1), 64)
    assert psetup.mode == jsetup.mode == "matrix_parallel"
    assert psetup.full is None and jsetup.full is None
    rec, jrec = psetup.build_record(FAKE, None, 0.0), jsetup.build_record(FAKE, None, 0.0)
    assert rec.mode == jrec.mode == "independent"
    assert rec.tflops_total == pytest.approx(jrec.tflops_total)


def test_batch_parallel_global_batch_note(devices, ranks8):
    jrec = _jax_setup("batch_parallel", "float32", 8).build_record(FAKE, FAKE_FULL, 0.005)
    rec = ALL_MODES["batch_parallel"](_config(), port_mesh(8), 64).build_record(
        FAKE, FAKE_FULL, 0.005)
    assert rec.extras["note"] == jrec.extras["note"] == \
        "global batch grown from 4 to 8 to cover 8 devices"
    assert (rec.extras["global_batch"], rec.extras["local_batch"]) == (8, 1)


def test_memory_estimate_counts_the_psum_buffers():
    cfg = _config(dtype="bfloat16")
    half = 16384 * 16384 * 2 / 2**30  # one bf16 16384² matrix, GiB
    # A, B, C, the psum's result, and its fp32 accumulator (two halves)
    assert modes.estimate_memory_gib("data_parallel", cfg, 4, 16384) == \
        pytest.approx(6 * half)
    assert modes.estimate_memory_gib("batch_parallel", cfg, 4, 16384) == \
        pytest.approx(6 * half)
    assert modes.estimate_memory_gib("matrix_parallel", cfg, 4, 16384) == \
        pytest.approx(2.5 * half)
    assert modes.estimate_memory_gib("model_parallel", cfg, 4, 16384) == \
        pytest.approx(4.5 * half)
    assert modes.estimate_memory_gib("independent", cfg, 4, 16384) == \
        pytest.approx(3 * half)
    assert modes.estimate_memory_gib("matrix_parallel", cfg, 1, 16384) == \
        pytest.approx(3 * half)


# ------------------------------------------------------------------ the CLIs

def _ledger(path):
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def test_cli_defaults(ranks8):
    recs = port_main.main(["scaling", *SMALL, "--device", "cpu", "--dtype", "float32"])
    assert [r.mode for r in recs] == ["independent"] and recs[0].world == 8
    recs = port_main.main(["distributed", *SMALL, "--device", "cpu", "--dtype", "float32"])
    assert [r.mode for r in recs] == ["data_parallel"]
    assert recs[0].benchmark == "distributed"


@pytest.mark.parametrize("program,mode", [
    ("scaling", "independent"), ("scaling", "batch_parallel"),
    ("scaling", "matrix_parallel"), ("distributed", "data_parallel"),
    ("distributed", "model_parallel")])
def test_cli_record_schema_matches_jax(ranks8, tmp_path, program, mode):
    jax_main = (jax_scaling if program == "scaling" else jax_dist).main
    argv = [*SMALL, "--mode", mode, "--dtype", "float32", "--validate"]
    jax_main([*argv, "--json-out", str(tmp_path / "jax.jsonl")])
    port_main.main([program, *argv, "--device", "cpu",
                    "--json-out", str(tmp_path / "port.jsonl")])
    (jrec,), (rec,) = _ledger(tmp_path / "jax.jsonl")[1:], _ledger(tmp_path / "port.jsonl")[1:]
    assert set(rec) == set(jrec)
    assert set(rec["extras"]) == set(jrec["extras"]) | {"cards", "ranks_per_card"}
    assert rec["extras"]["validation"] == "ok"
    assert (rec["mode"], rec["benchmark"], rec["world"]) == (mode, program, 8)
    assert (rec["scaling_efficiency_pct"] is None) == (jrec["scaling_efficiency_pct"] is None)


def test_baseline_runs_under_the_runs_impl_and_timing(ranks8, monkeypatch):
    seen = []

    def fake_bench_single(config, size, kind, device):
        seen.append((config.matmul_impl, config.timing, size, str(device), kind))
        return type("R", (), {"tflops_per_device": 1.0})()

    from tpu_matmul_bench_torch.benchmarks import matmul_benchmark

    monkeypatch.setattr(matmul_benchmark, "_bench_single", fake_bench_single)
    monkeypatch.setattr(scaling, "_BASELINE_CACHE", {})
    argv = [*SMALL, "--device", "cpu", "--dtype", "float32", "--num-devices", "4",
            "--matmul-impl", "cuda", "--timing", "fused"]
    (rec,) = port_main.main(["scaling", "--mode", "batch_parallel", *argv])
    port_main.main(["scaling", "--mode", "batch_parallel", *argv])  # cached
    assert seen == [("cuda", "fused", 64, "cpu", "cpu")]
    assert rec.scaling_efficiency_pct == pytest.approx(rec.tflops_total * 100)
    assert rec.extras["timing"] == "fused"


# ---------------------------------------------------------------- make_bmm

@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int8"])
def test_make_bmm_matches_jax(dtype_name):
    pairs = [numpy_operands(s, 24, 40, 16, dtype_name) for s in range(3)]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    want = np.asarray(jax_make_bmm()(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = operands_from_numpy(a, b, device="cpu")
    got = make_bmm()(ta, tb)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    tol = {"float32": 1e-5, "bfloat16": 1e-2, "int8": 0.0}[dtype_name]
    assert rel_err(as_numpy(got), want.astype(np.float64)) <= tol


# ---------------------------------------- fused timing over sharded operands

def _operands(d: int, spec: tuple):
    g = torch.randn(d * 4, d * 4)
    g[0, 0] = 5.0  # outside the chain's [0, 1] bound, so a write shows
    return mesh.shard_tensor(g, spec, port_mesh(d))


@pytest.mark.parametrize("spec", [mesh.ROWS, mesh.COLS, mesh.REPLICATED])
def test_fused_chain_writes_global_first_element_of_clones(ranks8, spec):
    a, b = _operands(4, spec), _operands(4, mesh.COLS)
    before = [s.clone() for s in a]
    seen = []

    def program(x: Sharded, y: Sharded) -> Sharded:
        seen.append(x)
        return Sharded([xr + yr.sum() for xr, yr in zip(x, y)], mesh.ROWS)

    state = {}
    timing.fuse_iterations(program, 3, chain_state=state)(a, b)
    assert state == {"chain": "operand"}
    assert all(torch.equal(s, t) for s, t in zip(a, before))  # the caller's
    clone = seen[-1]
    assert clone is not a and all(c is not s for c, s in zip(clone, a))
    written = range(4) if spec == mesh.REPLICATED else [0]
    for r, (c, s) in enumerate(zip(clone, before)):
        first = float(c.reshape(-1)[0])
        if r in written:
            assert 0.0 <= first <= 1.0  # the bounded scalar, not 5.0
            assert torch.equal(c.reshape(-1)[1:], s.reshape(-1)[1:])
        else:
            assert torch.equal(c, s)


def test_fused_chain_reports_none_when_nothing_is_chained(ranks8):
    one = Sharded([torch.ones(1) for _ in range(4)], mesh.ROWS)
    state = {}
    timing.fuse_iterations(lambda x: Sharded([torch.ones(2) for _ in x], mesh.ROWS), 3,
                           chain_state=state)(one)
    assert state == {"chain": "none"}


@pytest.mark.parametrize("mode", ["independent", "batch_parallel", "model_parallel"])
def test_mode_record_under_fused_reads_operand_chain(ranks8, mode):
    cfg = _config("--timing", "fused", "--validate")
    rec = modes.run_mode_benchmark(ALL_MODES[mode](cfg, port_mesh(4), 64), cfg)
    assert (rec.extras["timing"], rec.extras["chain"]) == ("fused", "operand")
    assert rec.extras["validation"] == "ok"
    dispatch = _config()
    rec = modes.run_mode_benchmark(ALL_MODES[mode](dispatch, port_mesh(4), 64), dispatch)
    assert "chain" not in rec.extras and "timing" not in rec.extras


def test_mode_record_under_fused_reads_none_without_chainable_operands(ranks8):
    cfg = _config("--timing", "fused")
    one = Sharded([torch.ones(1) for _ in range(4)], mesh.ROWS)
    setup = modes.ModeSetup(
        "probe", (one,), lambda x: Sharded([torch.ones(2) for _ in x], mesh.ROWS), None,
        lambda t, f, c: modes._record_base(cfg, "scaling", "probe", 64, 4, t,
                                           avg_time_s=t.avg_s, tflops_per_device=1.0,
                                           tflops_total=1.0),
        memory_gib_per_device=0.0)
    assert modes.run_mode_benchmark(setup, cfg).extras["chain"] == "none"


# ------------------------------------------------- the psum, once a card

def _per_rank_sums(shards):
    """The psum as it was: each rank's own fp32 (int32) sum in rank order."""
    acc_dtype = torch.int32 if shards[0].dtype == torch.int8 else torch.float32
    out = []
    for _ in shards:
        acc = None
        for s in shards:
            part = s.to(acc_dtype)
            acc = part if acc is None else acc + part
        out.append(acc.to(shards[0].dtype))
    return out


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int8"])
def test_psum_once_a_card_is_bit_identical(ranks8, dtype_name):
    world = port_mesh(8)
    shards = [operands_from_numpy(numpy_operands(r, 32, 48, 1, dtype_name)[0],
                                  device="cpu")[0] for r in range(8)]
    got = collectives.psum_over(world)(shards)
    want = _per_rank_sums(shards)
    assert all(torch.equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want))
    assert len({g.data_ptr() for g in got}) == 8  # each rank its own copy
    if dtype_name != "int8":
        mean = collectives.pmean_over(world)(shards)
        want_mean = [(w.float() / 8).to(w.dtype) for w in want]
        assert all(torch.equal(m, w) for m, w in zip(mean, want_mean))
        assert len({m.data_ptr() for m in mean}) == 8


def test_collectives_still_verify(ranks8):
    assert collectives.verify_collectives(port_mesh(8), verbose=False)
