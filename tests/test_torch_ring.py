"""The port's ring matmuls (`ops/cuda_ring.py`: K2 all-gather, K3
reduce-scatter) and their world of ranks, against the JAX package.

The same numpy operands go through the JAX ring kernels, in interpret mode
on the conftest's 8-device CPU mesh (sliced to D devices), and through the
port's rings on D ranks that share the CPU (`TMB_RANKS_PER_CARD=8`, set per
test). On the CPU every product runs its plain version and every hop is a
`copy_`, over the same slot, chunk and homing schedule the card runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import NamedSharding, PartitionSpec as P
from torch_port_util import (  # noqa: F401 — single_torch_thread is a fixture
    TOLERANCE,
    as_numpy,
    numpy_operands,
    rel_err,
    single_torch_thread,
)

from tpu_matmul_bench.ops.pallas_ring_hbm import ring_allgather_matmul_hbm as jax_ag
from tpu_matmul_bench.ops.pallas_ring_rs_hbm import _rs_acc_kernel
from tpu_matmul_bench.ops.pallas_ring_rs_hbm import (
    ring_reduce_scatter_matmul_hbm as jax_rs,
)
from tpu_matmul_bench.parallel import collectives as jax_coll
from tpu_matmul_bench.parallel import mesh as jax_mesh
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops import cuda_ring as cr
from tpu_matmul_bench_torch.ops.matmul import operands_from_numpy
from tpu_matmul_bench_torch.parallel import collectives, mesh
from tpu_matmul_bench_torch.parallel.mesh import COLS, ROWS, gather, shard_from_numpy
from tpu_matmul_bench_torch.utils.device import resolve_devices

pytestmark = pytest.mark.usefixtures("single_torch_thread")

# (m, k, n, blocks): several blocks per chunk in every dim, and uneven ones
CASES = [(64, 32, 64, (8, 8, 8)), (128, 128, 128, (16, 64, 32))]
RANKS = [1, 2, 4, 8]


@pytest.fixture
def ranks8(monkeypatch):
    """Up to 8 ranks share the CPU, as the JAX tests' 8 virtual devices."""
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def port_mesh(d: int) -> mesh.Mesh:
    return mesh.make_mesh(resolve_devices("cpu", d))


def _jax_put(arr, jmesh, spec):
    return jax.device_put(jnp.asarray(arr), NamedSharding(jmesh, P(*spec)))


def _ring_parity(devices, ranks8, reduce_scatter, m, k, n, blocks, dtype_name, d):
    x_np, w_np = numpy_operands(31 + d, m, k, n, dtype_name)
    x_spec, w_spec = (COLS, ROWS) if reduce_scatter else (ROWS, COLS)
    jmesh = jax_mesh.make_mesh(devices[:d])
    jax_build, port_build = (jax_rs, cr.ring_reduce_scatter_matmul_hbm) \
        if reduce_scatter else (jax_ag, cr.ring_allgather_matmul_hbm)
    bm, bn, bk = blocks
    want = jax_build(jmesh, block_m=bm, block_n=bn, block_k=bk)(
        _jax_put(x_np, jmesh, x_spec), _jax_put(w_np, jmesh, w_spec))
    pmesh = port_mesh(d)
    got = port_build(pmesh, block_m=bm, block_n=bn, block_k=bk)(
        shard_from_numpy(x_np, x_spec, pmesh), shard_from_numpy(w_np, w_spec, pmesh))
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
def test_allgather_ring_matches_jax(devices, ranks8, m, k, n, blocks, dtype_name, d):
    _ring_parity(devices, ranks8, False, m, k, n, blocks, dtype_name, d)


@pytest.mark.parametrize("d", RANKS)
@pytest.mark.parametrize("dtype_name", list(TOLERANCE))
@pytest.mark.parametrize("m,k,n,blocks", CASES)
def test_reduce_scatter_ring_matches_jax(devices, ranks8, m, k, n, blocks,
                                         dtype_name, d):
    _ring_parity(devices, ranks8, True, m, k, n, blocks, dtype_name, d)


def _hop_by_hop(x, w, d):
    """K3's sum by hand: chunk c starts at rank c+1, and the bf16 sum is
    rounded after every rank's contribution."""
    mshard = x[0].shape[0] // d
    chunks = []
    for c in range(d):
        acc = None
        for j in range(1, d + 1):
            q = (c + j) % d
            part = x[q][c * mshard:(c + 1) * mshard].float() @ w[q].float()
            acc = (part if acc is None else part + acc.float()).to(torch.bfloat16)
        chunks.append(acc)
    return torch.cat(chunks)


def test_reduce_scatter_plain_rounds_every_hop(ranks8):
    d = 8
    x_np, w_np = numpy_operands(41, 128, 128, 128, "bfloat16")
    pmesh = port_mesh(d)
    x, w = shard_from_numpy(x_np, COLS, pmesh), shard_from_numpy(w_np, ROWS, pmesh)
    plain = gather(cr.ring_reduce_scatter_matmul_plain(x, w))
    assert torch.equal(plain, _hop_by_hop(x, w, d))
    assert torch.equal(gather(cr.ring_reduce_scatter_matmul_hbm(pmesh)(x, w)), plain)
    a, b = operands_from_numpy(x_np, w_np, device="cpu")
    once = (a.float() @ b.float()).to(torch.bfloat16)
    assert not torch.equal(plain, once)  # one rounding is another result


def test_allgather_plain_is_the_dense_product(ranks8):
    d = 4
    x_np, w_np = numpy_operands(42, 64, 48, 32, "bfloat16")
    pmesh = port_mesh(d)
    x, w = shard_from_numpy(x_np, ROWS, pmesh), shard_from_numpy(w_np, COLS, pmesh)
    a, b = operands_from_numpy(x_np, w_np, device="cpu")
    want = cm.matmul_plain(a, b)
    assert torch.equal(gather(cr.ring_allgather_matmul_plain(x, w)), want)
    assert torch.equal(gather(cr.ring_allgather_matmul_hbm(pmesh)(x, w)), want)


def _jax_rs_acc(a, b, accin, blocks):
    """`_rs_acc_kernel` itself, run by `pallas_call` in interpret mode."""
    bm, bn, bk = blocks
    (m, k), n = a.shape, b.shape[1]
    acc = jnp.int32 if jnp.issubdtype(a.dtype, jnp.integer) else jnp.float32
    return pl.pallas_call(
        _rs_acc_kernel, grid=(m // bm, n // bn, k // bk),
        in_specs=[pl.BlockSpec((bm, bk), lambda i, j, kk: (i, kk)),
                  pl.BlockSpec((bk, bn), lambda i, j, kk: (kk, j)),
                  pl.BlockSpec((bm, bn), lambda i, j, kk: (i, j))],
        out_specs=pl.BlockSpec((bm, bn), lambda i, j, kk: (i, j)),
        out_shape=jax.ShapeDtypeStruct((m, n), accin.dtype),
        scratch_shapes=[pltpu.VMEM((bm, bn), acc)], interpret=True)(a, b, accin)


@pytest.mark.parametrize("dtype_name", list(TOLERANCE))
def test_matmul_acc_matches_the_pickup_kernel(dtype_name):
    a_np, b_np = numpy_operands(43, 64, 96, 32, dtype_name)
    c_np, _ = numpy_operands(44, 64, 32, 1, dtype_name)
    if dtype_name == "int8":
        c_np = c_np.astype(np.int32) * 37  # accin is int32, as the products
    want = _jax_rs_acc(jnp.asarray(a_np), jnp.asarray(b_np), jnp.asarray(c_np),
                       (16, 16, 32))
    a, b, c = operands_from_numpy(a_np, b_np, c_np, device="cpu")
    before = cm.ACC_LAUNCHES
    got = cm.cuda_matmul_acc(a, b, c)
    assert cm.ACC_LAUNCHES == before  # the CPU launches nothing
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    assert torch.equal(got, cm.matmul_acc_plain(a, b, c))
    assert rel_err(as_numpy(got), want) <= TOLERANCE[dtype_name]


def test_matmul_acc_takes_strided_accin_and_out():
    a_np, b_np = numpy_operands(45, 16, 24, 8, "float32")
    a, b = operands_from_numpy(a_np, b_np, device="cpu")
    wide = torch.randn(16, 20)
    accin, out = wide[:, 2:10], torch.zeros(16, 20)
    got = cm.cuda_matmul_acc(a, b, accin, out[:, 4:12])
    assert got.data_ptr() == out[:, 4:12].data_ptr()
    torch.testing.assert_close(out[:, 4:12], a @ b + accin)
    with pytest.raises(ValueError, match="accin must be"):
        cm.cuda_matmul_acc(a, b, torch.zeros(16, 8, dtype=torch.float16))
    with pytest.raises(ValueError, match="unit column stride"):
        cm.cuda_matmul_acc(a, b, wide[:, ::2][:, :8])


def test_cuda_matmul_writes_into_out():
    a_np, b_np = numpy_operands(46, 8, 16, 12, "bfloat16")
    a, b = operands_from_numpy(a_np, b_np, device="cpu")
    y = torch.zeros(24, 12, dtype=torch.bfloat16)
    cm.cuda_matmul(a, b, out=y[8:16])
    assert torch.equal(y[8:16], cm.matmul_plain(a, b))
    assert not y[:8].any() and not y[16:].any()
    with pytest.raises(ValueError, match="contiguous"):  # rows 20 apart
        cm.cuda_matmul(a, b, out=torch.zeros(8, 20, dtype=torch.bfloat16)[:, :12])


# --- the JAX tests' own cases (test_pallas_ring_hbm.py, test_pallas_ring_rs_hbm.py)

def test_chunk_placement(ranks8):
    # distinct per-rank X chunks + identity W: rows land in origin order
    d, m, k = 8, 64, 64
    x = np.repeat(np.arange(d, dtype=np.float32), m // d)[:, None] * np.ones((1, k), np.float32)
    pmesh = port_mesh(d)
    fn = cr.ring_allgather_matmul_hbm(pmesh, block_m=8, block_n=32, block_k=16)
    got = gather(fn(shard_from_numpy(x, ROWS, pmesh),
                    shard_from_numpy(np.eye(k, dtype=np.float32), COLS, pmesh)))
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-5, atol=1e-5)


def test_every_rank_contributes(ranks8):
    # X's column block j holds 2**j, W = I: a dropped hop changes the sums
    d, size = 8, 64
    x = np.repeat(2.0 ** np.arange(d), size // d)[None, :] * np.ones((size, 1))
    x = x.astype(np.float32)
    pmesh = port_mesh(d)
    got = gather(cr.ring_reduce_scatter_matmul_hbm(pmesh, block_m=8, block_n=8, block_k=8)(
        shard_from_numpy(x, COLS, pmesh),
        shard_from_numpy(np.eye(size, dtype=np.float32), ROWS, pmesh)))
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reduce_scatter", [False, True], ids=["ag", "rs"])
def test_int8_exact(ranks8, reduce_scatter):
    size = 64
    xi = (np.arange(size * size).reshape(size, size) % 13 - 6).astype(np.int8)
    wi = (np.arange(size * size).reshape(size, size) % 7 - 3).astype(np.int8)
    pmesh = port_mesh(8)
    build = cr.ring_reduce_scatter_matmul_hbm if reduce_scatter else cr.ring_allgather_matmul_hbm
    x_spec, w_spec = (COLS, ROWS) if reduce_scatter else (ROWS, COLS)
    y = gather(build(pmesh, block_m=8, block_n=8, block_k=8)(
        shard_from_numpy(xi, x_spec, pmesh), shard_from_numpy(wi, w_spec, pmesh)))
    assert y.dtype == torch.int32  # exact int32 partials on every hop
    np.testing.assert_array_equal(y.numpy(), xi.astype(np.int32) @ wi.astype(np.int32))


@pytest.mark.parametrize("d", [1, 2, 4])
def test_small_rings(ranks8, d):
    x_np, w_np = numpy_operands(0, 64, 64, 64, "float32")
    pmesh = port_mesh(d)
    for reduce_scatter in (False, True):
        build = cr.ring_reduce_scatter_matmul_hbm if reduce_scatter else cr.ring_allgather_matmul_hbm
        x_spec, w_spec = (COLS, ROWS) if reduce_scatter else (ROWS, COLS)
        got = gather(build(pmesh, block_m=16, block_n=16, block_k=16)(
            shard_from_numpy(x_np, x_spec, pmesh), shard_from_numpy(w_np, w_spec, pmesh)))
        np.testing.assert_allclose(got.numpy(), x_np @ w_np, rtol=1e-4, atol=1e-4)


def test_cpu_rings_launch_nothing(ranks8):
    x_np, w_np = numpy_operands(1, 32, 32, 32, "bfloat16")
    pmesh = port_mesh(4)
    counts = (cr.RING_STEPS, cr.HOP_LAUNCHES, cm.LAUNCHES, cm.ACC_LAUNCHES)
    cr.ring_allgather_matmul_hbm(pmesh)(shard_from_numpy(x_np, ROWS, pmesh),
                                        shard_from_numpy(w_np, COLS, pmesh))
    cr.ring_reduce_scatter_matmul_hbm(pmesh)(shard_from_numpy(x_np, COLS, pmesh),
                                             shard_from_numpy(w_np, ROWS, pmesh))
    assert (cr.RING_STEPS, cr.HOP_LAUNCHES, cm.LAUNCHES, cm.ACC_LAUNCHES) == counts


def test_ring_checks_its_shards(ranks8):
    x_np, w_np = numpy_operands(2, 32, 32, 32, "float32")
    pmesh = port_mesh(4)
    fn = cr.ring_allgather_matmul_hbm(pmesh)
    x, w = shard_from_numpy(x_np, ROWS, pmesh), shard_from_numpy(w_np, COLS, pmesh)
    with pytest.raises(ValueError, match="3 X and 4 W shards"):
        fn(x[:3], w)
    with pytest.raises(ValueError, match="contiguous"):
        fn([s.t().contiguous().t() for s in x], w)
    with pytest.raises(TypeError, match="one dtype"):
        fn(x, [s.double() for s in w])
    with pytest.raises(ValueError, match="row chunks"):
        cr.ring_reduce_scatter_matmul_hbm(pmesh)(
            [torch.zeros(6, 8)] * 4, [torch.zeros(8, 8)] * 4)


def test_wres_rule(ranks8):
    engaged, reason = cr.resolve_wres(None, 4, 1 << 27)
    assert engaged is False and "no W-resident kernel" in reason
    assert f"({1 << 27} B)" in reason
    assert cr.resolve_wres(False, 1, 100) == (False, "rings need >= 2 ranks")
    with pytest.raises(ValueError, match="wres=True but the W-resident layout"):
        cr.resolve_wres(True, 4, 1 << 27)
    pmesh = port_mesh(2)
    for build in (cr.ring_allgather_matmul_hbm, cr.ring_reduce_scatter_matmul_hbm):
        with pytest.raises(ValueError, match="unavailable"):
            build(pmesh, wres=True)
    x_np, w_np = numpy_operands(3, 16, 16, 16, "float32")
    fn = cr.ring_allgather_matmul_hbm(pmesh, wres=False)
    y = fn(shard_from_numpy(x_np, ROWS, pmesh), shard_from_numpy(w_np, COLS, pmesh))
    np.testing.assert_allclose(as_numpy(gather(y)), x_np @ w_np, rtol=1e-5, atol=1e-5)


# --- the world of ranks

def test_ranks_fill_each_device_and_name_the_count(monkeypatch):
    monkeypatch.delenv(mesh.RANKS_PER_CARD_ENV, raising=False)
    assert resolve_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="--num-devices 4: 1 available"):
        resolve_devices("cpu", 4)
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")
    assert resolve_devices("cpu") == [torch.device("cpu")] * 8
    assert resolve_devices("cpu", 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="9: 8 available"):
        resolve_devices("cpu", 9)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "2")
    assert mesh.place_ranks(cards, 3) == [cards[0], cards[0], cards[1]]
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "zero")
    with pytest.raises(ValueError, match="positive integer"):
        mesh.ranks_per_card()


def test_mesh_counts_cards_and_ranks(ranks8):
    pmesh = port_mesh(4)
    assert mesh.world_size(pmesh) == 4 and pmesh.shape == {"x": 4}
    assert pmesh.cards == [torch.device("cpu")] and pmesh.ranks_per_card == 4
    assert [r.index for r in pmesh.ranks] == [0, 1, 2, 3]
    assert mesh.mesh_device_kind(pmesh) == "cpu"
    with pytest.raises(ValueError, match="both the CPU and the card"):
        mesh.make_mesh([torch.device("cpu"), torch.device("cuda", 0)])


@pytest.mark.parametrize("spec", [ROWS, COLS], ids=["rows", "cols"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_shard_from_numpy_gives_jax_shards(devices, ranks8, spec, d):
    arr, _ = numpy_operands(5, 16, 24, 1, "bfloat16")
    jmesh = jax_mesh.make_mesh(devices[:d])
    jarr = _jax_put(arr, jmesh, spec)
    by_device = {s.device: np.asarray(s.data) for s in jarr.addressable_shards}
    shards = shard_from_numpy(arr, spec, port_mesh(d))
    for dev, shard in zip(jmesh.devices.flat, shards):
        np.testing.assert_array_equal(as_numpy(shard), np.asarray(by_device[dev], np.float32))
    assert torch.equal(gather(shards).float(), torch.from_numpy(np.asarray(arr, np.float32)))
    block = mesh.global_block(shards, 5, 7)
    np.testing.assert_array_equal(as_numpy(block), np.asarray(arr, np.float32)[:5, :7])


def test_sharded_normal_cuts_one_global_array(ranks8):
    pmesh = port_mesh(4)
    x, w = mesh.sharded_normal(3, (16, 8), torch.bfloat16, pmesh, ROWS)
    assert [tuple(s.shape) for s in x] == [(4, 8)] * 4 and x.spec == ROWS
    assert not torch.equal(gather(x), gather(w))
    (again,) = mesh.sharded_normal(3, (16, 8), torch.bfloat16, port_mesh(2), COLS, count=1)
    assert torch.equal(gather(again), gather(x))  # the same global array
    (i8,) = mesh.sharded_normal(0, (8, 8), torch.int8, pmesh, COLS, count=1)
    assert i8[0].dtype == torch.int8 and int(gather(i8).abs().max()) <= 8


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_ring_perms_match_jax(n):
    assert mesh.ring_perm(n) == jax_mesh.ring_perm(n)


@pytest.mark.parametrize("d", [2, 8])
def test_collectives_match_jax(devices, ranks8, d):
    arr = np.arange(d * 6, dtype=np.float32).reshape(d * 2, 3)
    jmesh = jax_mesh.make_mesh(devices[:d])
    pmesh = port_mesh(d)
    shards = shard_from_numpy(arr, ROWS, pmesh)
    want = np.asarray(jax_coll.all_gather_over(jmesh)(_jax_put(arr, jmesh, ROWS)))
    for got in collectives.all_gather_over(pmesh)(shards):
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax_coll.psum_over(jmesh)(_jax_put(arr, jmesh, ROWS)))
    got = torch.cat(collectives.psum_over(pmesh)(shards))
    np.testing.assert_array_equal(got.numpy(), want)
    full = [torch.from_numpy(arr) * (r + 1) for r in range(d)]
    scattered = torch.cat(collectives.psum_scatter_over(pmesh)(full))
    np.testing.assert_array_equal(scattered.numpy(), arr * d * (d + 1) / 2)
    shifted = collectives.ppermute(pmesh, shards, mesh.ring_perm(d))
    assert torch.equal(shifted[1], shards[0]) and torch.equal(shifted[0], shards[-1])


def test_verify_collectives_passes_at_eight_ranks(ranks8, capsys):
    assert collectives.verify_collectives(port_mesh(8))
    out = capsys.readouterr().out
    for name in ("psum (all_reduce SUM)", "pmean (all_reduce AVG)", "all_gather",
                 "ppermute (ring shift)"):
        assert f"  - {name}: PASSED" in out
