"""The port's bidirectional ring matmuls (`ops/cuda_ring.py`: K4 all-gather,
K5 reduce-scatter) against the JAX package's.

The same numpy operands go through the JAX kernels
(`pallas_ring_bidir_hbm.py`, `pallas_ring_bidir_rs_hbm.py`) in interpret
mode on the conftest's 8-device CPU mesh (sliced to D devices), and through
the port's rings on D ranks that share the CPU (`TMB_RANKS_PER_CARD=8`, set
per test). On the CPU every product runs its plain version and every hop is
a `copy_`, over the same half-chunk, slot and homing schedule the card
runs. The cases of the JAX kernels' own tests follow, then the overlap
program's two modes end to end.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from torch_port_util import (  # noqa: F401 — single_torch_thread is a fixture
    TOLERANCE,
    as_numpy,
    numpy_operands,
    rel_err,
    single_torch_thread,
)

from tpu_matmul_bench.ops.pallas_ring_bidir_hbm import (
    ring_allgather_matmul_bidir_hbm as jax_ag,
)
from tpu_matmul_bench.ops.pallas_ring_bidir_rs_hbm import (
    ring_reduce_scatter_matmul_bidir_hbm as jax_rs,
)
from tpu_matmul_bench.parallel import mesh as jax_mesh
from tpu_matmul_bench.parallel.modes import run_mode_benchmark as jax_run_mode
from tpu_matmul_bench.parallel.overlap import OVERLAP_MODES as JAX_MODES
from tpu_matmul_bench.utils.config import parse_config as jax_parse_config
from tpu_matmul_bench_torch.benchmarks import matmul_overlap_benchmark as overlap
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops import cuda_ring as cr
from tpu_matmul_bench_torch.ops.matmul import operands_from_numpy
from tpu_matmul_bench_torch.parallel import mesh, modes
from tpu_matmul_bench_torch.parallel.mesh import COLS, ROWS, gather, shard_from_numpy
from tpu_matmul_bench_torch.parallel.overlap import OVERLAP_MODES
from tpu_matmul_bench_torch.utils.config import parse_config
from tpu_matmul_bench_torch.utils.device import resolve_devices

pytestmark = pytest.mark.usefixtures("single_torch_thread")

# (m, k, n, blocks): several blocks per half chunk in every dim, and uneven
# ones (the JAX tests use (4, 8, 8) and (8, 64, 32): smaller blocks run the
# same arithmetic in more interpreted steps)
CASES = [(64, 32, 64, (16, 32, 16)), (128, 128, 128, (16, 64, 32))]
RANKS = [1, 2, 4, 8]
SMALL = ["--sizes", "64", "--iterations", "2", "--warmup", "1", "--dtype", "float32"]
BIDIR = {"cuda_ring_bidir_hbm": "pallas_ring_bidir_hbm",
         "cuda_ring_bidir_rs_hbm": "pallas_ring_bidir_rs_hbm"}


@pytest.fixture
def ranks8(monkeypatch):
    """Up to 8 ranks share the CPU, as the JAX tests' 8 virtual devices."""
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def port_mesh(d: int) -> mesh.Mesh:
    return mesh.make_mesh(resolve_devices("cpu", d))


def _jax_put(arr, jmesh, spec):
    return jax.device_put(jnp.asarray(arr), NamedSharding(jmesh, P(*spec)))


def _specs(reduce_scatter):
    return (COLS, ROWS) if reduce_scatter else (ROWS, COLS)


def _port(reduce_scatter, d, x_np, w_np, **blocks):
    pmesh = port_mesh(d)
    x_spec, w_spec = _specs(reduce_scatter)
    build = (cr.ring_reduce_scatter_matmul_bidir_hbm if reduce_scatter
             else cr.ring_allgather_matmul_bidir_hbm)
    return build(pmesh, **blocks)(shard_from_numpy(x_np, x_spec, pmesh),
                                  shard_from_numpy(w_np, w_spec, pmesh))


def _jax(devices, reduce_scatter, d, x_np, w_np, **blocks):
    jmesh = jax_mesh.make_mesh(devices[:d])
    x_spec, w_spec = _specs(reduce_scatter)
    build = jax_rs if reduce_scatter else jax_ag
    return build(jmesh, **blocks)(_jax_put(x_np, jmesh, x_spec), _jax_put(w_np, jmesh, w_spec))


def _parity(devices, reduce_scatter, m, k, n, blocks, dtype_name, d):
    x_np, w_np = numpy_operands(51 + d, m, k, n, dtype_name)
    bm, bn, bk = blocks
    kw = {"block_m": bm, "block_n": bn, "block_k": bk}
    want = _jax(devices, reduce_scatter, d, x_np, w_np, **kw)
    got = _port(reduce_scatter, d, x_np, w_np, **kw)
    assert len(got) == d and got.spec == (ROWS if reduce_scatter else COLS)
    y = gather(got)
    assert str(y.dtype).removeprefix("torch.") == want.dtype.name
    if dtype_name == "float32":
        # the JAX tests' own tolerance for these kernels
        np.testing.assert_allclose(as_numpy(y), np.asarray(want), rtol=1e-4, atol=1e-4)
    else:
        assert rel_err(as_numpy(y), want) <= TOLERANCE[dtype_name]


@pytest.mark.parametrize("d", RANKS)
@pytest.mark.parametrize("dtype_name", list(TOLERANCE))
@pytest.mark.parametrize("m,k,n,blocks", CASES)
def test_bidir_allgather_ring_matches_jax(devices, ranks8, m, k, n, blocks, dtype_name, d):
    _parity(devices, False, m, k, n, blocks, dtype_name, d)


@pytest.mark.parametrize("d", RANKS)
@pytest.mark.parametrize("dtype_name", list(TOLERANCE))
@pytest.mark.parametrize("m,k,n,blocks", CASES)
def test_bidir_reduce_scatter_ring_matches_jax(devices, ranks8, m, k, n, blocks,
                                               dtype_name, d):
    _parity(devices, True, m, k, n, blocks, dtype_name, d)


# --- the JAX tests' own cases (test_pallas_ring_bidir_hbm.py,
# test_pallas_ring_bidir_rs_hbm.py)

@pytest.mark.parametrize("reduce_scatter", [False, True], ids=["ag", "rs"])
def test_odd_half_split(devices, ranks8, reduce_scatter):
    # 72 rows / 8 ranks = 9-row chunks: forward half 4 rows, backward 5
    # (default blocks: each half is one block in the JAX kernel)
    x_np, w_np = numpy_operands(52, 72, 72, 72, "float32")
    got = gather(_port(reduce_scatter, 8, x_np, w_np)).numpy()
    np.testing.assert_allclose(got, np.asarray(_jax(devices, reduce_scatter, 8, x_np, w_np)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, x_np @ w_np, rtol=1e-4, atol=1e-4)


def test_chunk_placement(ranks8):
    # distinct per-rank X chunks + identity W: each chunk's top half (forward
    # ring) and bottom half (backward ring) land in origin order
    d, m, k = 8, 64, 64
    x = np.repeat(np.arange(d, dtype=np.float32), m // d)[:, None] * np.ones((1, k), np.float32)
    got = gather(_port(False, d, x, np.eye(k, dtype=np.float32),
                       block_m=4, block_n=32, block_k=16))
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-5, atol=1e-5)


def test_every_rank_contributes(ranks8):
    # W = identity blocks: Y row block r is the sum over ranks of X's rows
    # of chunk r, so a dropped hop in either direction loses a rank's share
    d, m = 8, 64
    x = np.repeat(2.0 ** np.arange(d), 64)[None, :] * np.ones((m, 1))
    w = np.tile(np.eye(64), (d, 1))
    got = gather(_port(True, d, x.astype(np.float32), w.astype(np.float32),
                       block_m=4, block_n=32, block_k=16))
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reduce_scatter", [False, True], ids=["ag", "rs"])
def test_int8_exact(ranks8, reduce_scatter):
    size = 64
    xi = (np.arange(size * size).reshape(size, size) % 13 - 6).astype(np.int8)
    wi = (np.arange(size * size).reshape(size, size) % 7 - 3).astype(np.int8)
    y = gather(_port(reduce_scatter, 8, xi, wi, block_m=4, block_n=8, block_k=8))
    assert y.dtype == torch.int32  # exact int32 partials on every hop
    np.testing.assert_array_equal(y.numpy(), xi.astype(np.int32) @ wi.astype(np.int32))


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("reduce_scatter", [False, True], ids=["ag", "rs"])
def test_sub_rings(ranks8, reduce_scatter, d):
    # the counter-rotation on a smaller ring than the 8 ranks
    x_np, w_np = numpy_operands(0, 64, 64, 64, "float32")
    got = gather(_port(reduce_scatter, d, x_np, w_np, block_m=8, block_n=16, block_k=16))
    np.testing.assert_allclose(got.numpy(), x_np @ w_np, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("reduce_scatter,match", [(False, "2 rows"), (True, "2 output rows")],
                         ids=["ag", "rs"])
def test_single_row_shard_rejected(devices, ranks8, reduce_scatter, match):
    # a 1-row chunk (or output chunk) cannot split into two halves, in
    # either package
    x_np, w_np = numpy_operands(3, 8, 64, 64, "float32")
    with pytest.raises(ValueError, match=match):
        _jax(devices, reduce_scatter, 8, x_np, w_np)
    with pytest.raises(ValueError, match=match):
        _port(reduce_scatter, 8, x_np, w_np)


def test_one_rank_ring_takes_two_half_products(ranks8):
    # D = 1: no hop, the two halves of the one chunk are two products
    x_np, w_np = numpy_operands(4, 9, 16, 8, "float32")
    for reduce_scatter in (False, True):
        got = gather(_port(reduce_scatter, 1, x_np, w_np))
        np.testing.assert_allclose(got.numpy(), x_np @ w_np, rtol=1e-5, atol=1e-5)


def _hop_by_hop_bidir(x, w, d):
    """K5's sums by hand: the top half of chunk c starts at rank c+1 and
    walks right, the bottom half starts at rank c−1 and walks left; each
    bf16 sum is rounded after every rank's contribution."""
    mshard = x[0].shape[0] // d
    h = mshard // 2
    chunks = []
    for c in range(d):
        halves = []
        for row0, row1, step in ((0, h, 1), (h, mshard, -1)):
            acc = None
            for j in range(1, d + 1):
                q = (c + step * j) % d
                part = x[q][c * mshard + row0:c * mshard + row1].float() @ w[q].float()
                acc = (part if acc is None else part + acc.float()).to(torch.bfloat16)
            halves.append(acc)
        chunks.append(torch.cat(halves))
    return torch.cat(chunks)


def test_bidir_reduce_scatter_plain_rounds_every_hop(ranks8):
    d = 8
    x_np, w_np = numpy_operands(53, 8 * 9, 128, 128, "bfloat16")  # odd halves
    pmesh = port_mesh(d)
    x, w = shard_from_numpy(x_np, COLS, pmesh), shard_from_numpy(w_np, ROWS, pmesh)
    plain = gather(cr.ring_reduce_scatter_matmul_bidir_plain(x, w))
    assert torch.equal(plain, _hop_by_hop_bidir(x, w, d))
    assert torch.equal(gather(cr.ring_reduce_scatter_matmul_bidir_hbm(pmesh)(x, w)), plain)
    # the unidirectional ring's order is another result
    assert not torch.equal(plain, gather(cr.ring_reduce_scatter_matmul_plain(x, w)))


def test_bidir_allgather_is_the_dense_product(ranks8):
    d = 4
    x_np, w_np = numpy_operands(54, 4 * 7, 48, 32, "bfloat16")
    pmesh = port_mesh(d)
    x, w = shard_from_numpy(x_np, ROWS, pmesh), shard_from_numpy(w_np, COLS, pmesh)
    a, b = operands_from_numpy(x_np, w_np, device="cpu")
    assert torch.equal(gather(cr.ring_allgather_matmul_bidir_hbm(pmesh)(x, w)),
                       cm.matmul_plain(a, b))


def test_cpu_bidir_rings_launch_nothing(ranks8):
    x_np, w_np = numpy_operands(1, 32, 32, 32, "bfloat16")
    counts = (cr.RING_STEPS, cr.HOP_LAUNCHES, cm.LAUNCHES, cm.ACC_LAUNCHES)
    _port(False, 4, x_np, w_np)
    _port(True, 4, x_np, w_np)
    assert (cr.RING_STEPS, cr.HOP_LAUNCHES, cm.LAUNCHES, cm.ACC_LAUNCHES) == counts


def test_bidir_wres_rule(ranks8):
    pmesh = port_mesh(2)
    for build in (cr.ring_allgather_matmul_bidir_hbm, cr.ring_reduce_scatter_matmul_bidir_hbm):
        with pytest.raises(ValueError, match="wres=True but the W-resident layout"):
            build(pmesh, wres=True)
    x_np, w_np = numpy_operands(3, 16, 16, 16, "float32")
    got = gather(_port(True, 2, x_np, w_np, wres=False))
    np.testing.assert_allclose(got.numpy(), x_np @ w_np, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_ring_perm_rev_matches_jax(n):
    assert mesh.ring_perm_rev(n) == jax_mesh.ring_perm_rev(n)


# --- the overlap program's two modes

def test_every_ring_mode_is_ported():
    # every one of the JAX suite's twelve modes, `pallas_` → `cuda_`, is a
    # mode of the port's overlap program
    assert len(JAX_MODES) == len(OVERLAP_MODES) == 12
    assert set(OVERLAP_MODES) == {name.replace("pallas_", "cuda_") for name in JAX_MODES}


def _config(*extra):
    return parse_config([*SMALL, "--device", "cpu", *extra], "t",
                        modes=list(OVERLAP_MODES), default_mode="cuda_ring_hbm",
                        extra_dtypes=("int8",), fused_timing=True)


@pytest.mark.parametrize("port_mode", list(BIDIR))
def test_bidir_record_extras_match_jax(mesh, ranks8, port_mode):
    jcfg = jax_parse_config([*SMALL, "--validate"], "t", modes=list(JAX_MODES))
    jrec = jax_run_mode(JAX_MODES[BIDIR[port_mode]](jcfg, mesh, 64), jcfg).finalize()
    cfg = _config("--validate")
    rec = modes.run_mode_benchmark(OVERLAP_MODES[port_mode](cfg, port_mesh(8), 64),
                                   cfg).finalize()
    assert set(rec.extras) == set(jrec.extras) | {"cards", "ranks_per_card", "wres_reason"}
    for key in ("baseline", "validation", "validation_tolerance"):
        assert rec.extras[key] == jrec.extras[key]
    assert rec.extras["kernel"].startswith("CUDA bidirectional HBM ring")
    assert rec.world == jrec.world == 8 and rec.mode == port_mode
    assert rec.extras["wres_engaged"] is False


@pytest.mark.parametrize("port_mode", list(BIDIR))
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int8"])
def test_bidir_baseline_and_ring_agree(ranks8, port_mode, dtype_name):
    cfg = _config("--dtype", dtype_name, "--block-m", "8", "--block-n", "8",
                  "--block-k", "8", "--matmul-impl", "cuda")
    setup = OVERLAP_MODES[port_mode](cfg, port_mesh(4), 64)
    x, w = setup.operands
    base, ring = gather(setup.compute(x, w)), gather(setup.full(x, w))
    assert base.dtype == ring.dtype and base.shape == ring.shape == (64, 64)
    err = (base.double() - ring.double()).abs().max() / base.double().abs().max()
    assert float(err) <= modes.validation_tolerance(dtype_name)
    assert setup.fusable is False


@pytest.mark.parametrize("port_mode", list(BIDIR))
def test_bidir_program_runs_end_to_end(ranks8, tmp_path, capsys, port_mode):
    out = tmp_path / "o.jsonl"
    (rec,) = overlap.main([*SMALL, "--device", "cpu", "--mode", port_mode,
                           "--num-devices", "4", "--validate", "--matmul-impl", "cuda",
                           "--json-out", str(out)])
    with open(out) as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    assert lines[0]["record_type"] == "manifest" and len(lines) == 2
    assert lines[1]["mode"] == port_mode and lines[1]["benchmark"] == "overlap"
    assert lines[1]["extras"]["validation"] == "ok"
    assert (rec.world, rec.extras["cards"], rec.extras["ranks_per_card"]) == (4, 1, 4)
    assert "4 ranks; cards: 1, ranks_per_card: 4" in capsys.readouterr().out
