"""The reduce-scatter rings' store into the reader's slot and their
persistent pickup GEMM (K3, K5), on the CPU.

On ranks that share one card, each step of `ops/cuda_ring.py`'s
reduce-scatter schedule writes its partial sum straight into the reader's
receive slot (t+1) mod 2: no staging slot and no hop. The product is
`cuda_matmul.cuda_matmul_rs`, which takes the persistent pickup GEMM of
`csrc/ring_rs.cu` on the card where `rs_route` says so. The kernel runs
only on the card (`chip_smoke.py` holds it against its plain version);
here run the schedule's slot arithmetic with the plain products, the
wrapper against the JAX pickup kernel in interpret mode, and the pure rules
that decide and size the kernel before a launch.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ring import _jax_rs_acc
from torch_port_util import (  # noqa: F401 — single_torch_thread is a fixture
    TOLERANCE,
    as_numpy,
    numpy_operands,
    rel_err,
    single_torch_thread,
)

import chip_smoke
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops import cuda_ring as cr
from tpu_matmul_bench_torch.ops.matmul import operands_from_numpy
from tpu_matmul_bench_torch.parallel import mesh
from tpu_matmul_bench_torch.parallel.mesh import COLS, ROWS, gather, shard_from_numpy
from tpu_matmul_bench_torch.utils.device import resolve_devices

pytestmark = pytest.mark.usefixtures("single_torch_thread")

SOURCE = Path(cm.__file__).resolve().parent.parent / "csrc" / "ring_rs.cu"
BF16 = torch.bfloat16


@pytest.fixture
def ranks8(monkeypatch):
    """Up to 8 ranks share the CPU, as the JAX tests' 8 virtual devices."""
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def _ring(d: int, bidir: bool, seed: int = 3, mshard: int = 5, n: int = 8):
    """A reduce-scatter ring over d ranks on the CPU and bf16 shards of X
    (m × k, column-sharded) and W (k × n, row-sharded); mshard = 5 rows a
    rank gives K5 halves of 2 and 3 rows."""
    pmesh = mesh.make_mesh(resolve_devices("cpu", d))
    x_np, w_np = numpy_operands(seed, mshard * d, 4 * d, n, "bfloat16")
    build = (cr.ring_reduce_scatter_matmul_bidir_hbm if bidir
             else cr.ring_reduce_scatter_matmul_hbm)
    x, w = shard_from_numpy(x_np, COLS, pmesh), shard_from_numpy(w_np, ROWS, pmesh)
    plain = (cr.ring_reduce_scatter_matmul_bidir_plain if bidir
             else cr.ring_reduce_scatter_matmul_plain)
    return build(pmesh), x, w, plain


def _instrument(monkeypatch):
    """Record every slot set the ring allocates and every product it runs
    (its out and accin), in issue order; a hop fails the test."""
    slot_sets, products = [], []
    allocate, product = cr.RingMatmul._slots, cm.cuda_matmul_rs

    def slots(self, ways, n, dtype):
        got = allocate(self, ways, n, dtype)
        slot_sets.append(got)
        return got

    def rs(a, b, accin, out, **kw):
        products.append((out, accin))
        return product(a, b, accin, out, **kw)

    def hop(*_):
        raise AssertionError("a ring on one card hopped")

    monkeypatch.setattr(cr.RingMatmul, "_slots", slots)
    monkeypatch.setattr(cm, "cuda_matmul_rs", rs)
    monkeypatch.setattr(cr, "_hop", hop)
    return slot_sets, products


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same memory: base pointer, shape and strides."""
    return (a.data_ptr(), a.shape, a.stride()) == (b.data_ptr(), b.shape, b.stride())


@pytest.mark.parametrize("bidir", [False, True], ids=["k3", "k5"])
@pytest.mark.parametrize("d", [1, 2, 3, 8])
def test_partials_land_in_the_readers_slot(ranks8, monkeypatch, d, bidir):
    fn, x, w, plain = _ring(d, bidir)
    assert cr.rs_transfer(fn.mesh) == "store"
    slot_sets, products = _instrument(monkeypatch)
    y = fn(x, w)
    # one set of slots, the receive slots; no staging slot
    assert len(slot_sets) == (1 if d > 1 else 0)
    recv = slot_sets[0] if d > 1 else {}
    ways = fn._ways(x[0].shape[0] // d)
    assert len(products) == d * d * len(ways)
    calls = iter(products)
    for t in range(d):
        for r in range(d):
            for way in ways:
                out, accin = next(calls)
                _, reader = way.neighbours(d, r)
                if t + 1 < d:
                    assert _same(out, recv[way.name][reader][(t + 1) % 2]), (t, r, way.name)
                else:
                    assert _same(out, y[r][way.lo:way.hi]), (t, r, way.name)
                if t == 0:
                    assert accin is None
                else:
                    assert _same(accin, recv[way.name][r][t % 2]), (t, r, way.name)
    assert torch.equal(gather(y), gather(plain(x, w)))


@pytest.mark.parametrize("bidir", [False, True], ids=["k3", "k5"])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_hop_transfer_stages_and_hops_every_partial(ranks8, monkeypatch, d, bidir):
    # the route of ranks on several cards, driven here on the CPU's ranks
    fn, x, w, plain = _ring(d, bidir, seed=4)
    hops = []
    real = cr._hop

    def hop(sched, r, dst, src, which=cr._COPY, reader=None):
        hops.append((r, which))
        real(sched, r, dst, src, which, reader)

    monkeypatch.setattr(cr, "_hop", hop)
    y = fn._reduce_scatter(fn._schedule(False), x, w, "hop")
    ways = 2 if bidir else 1
    assert len(hops) == ways * d * (d - 1)
    assert torch.equal(gather(y), gather(plain(x, w)))


def test_transfer_is_chosen_from_the_mesh():
    cuda = [torch.device("cuda", 0)] * 4
    assert cr.rs_transfer(mesh.make_mesh(cuda)) == "store"
    two_cards = [torch.device("cuda", i // 2) for i in range(4)]
    assert cr.rs_transfer(mesh.make_mesh(two_cards)) == "hop"
    assert cr.rs_transfer(mesh.make_mesh([torch.device("cpu")] * 8)) == "store"


@pytest.mark.parametrize("label", ["ring_rs", "ring_rs_bidir"])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_chip_smoke_expects_no_hops_on_one_card(label, d):
    ways = 2 if label.endswith("_bidir") else 1
    assert chip_smoke.per_call(label, d) == (ways * d * d, 0, 0)
    # the all-gather rings forward each chunk in the product: no hop either
    assert chip_smoke.per_call(label.replace("_rs", "_ag"), d) == (ways * d * d, 0, 0)


def test_cpu_rs_rings_launch_nothing(ranks8):
    before = (cr.RING_STEPS, cr.HOP_LAUNCHES, dict(cr.RS_TRANSFERS), cm.LAUNCHES,
              cm.ACC_LAUNCHES, cm.RS_LAUNCHES, dict(cm.LAUNCHES_BY_ROUTE))
    for bidir in (False, True):
        fn, x, w, _ = _ring(4, bidir)
        fn(x, w)
    a = torch.ones(64, 32, dtype=BF16)
    b = torch.ones(32, 16, dtype=BF16)
    cm.cuda_matmul_rs(a, b, None, torch.empty(64, 16, dtype=BF16))
    assert (cr.RING_STEPS, cr.HOP_LAUNCHES, dict(cr.RS_TRANSFERS), cm.LAUNCHES,
            cm.ACC_LAUNCHES, cm.RS_LAUNCHES, dict(cm.LAUNCHES_BY_ROUTE)) == before


# ------------------------------------------------------------ the wrapper

@pytest.mark.parametrize("dtype_name", list(TOLERANCE))
def test_rs_step_matches_the_pickup_kernel(dtype_name):
    a_np, b_np = numpy_operands(61, 64, 96, 32, dtype_name)
    c_np, _ = numpy_operands(62, 64, 32, 1, dtype_name)
    if dtype_name == "int8":
        c_np = c_np.astype(np.int32) * 37  # accin is int32, as the products
    want = _jax_rs_acc(jnp.asarray(a_np), jnp.asarray(b_np), jnp.asarray(c_np),
                       (16, 16, 32))
    a, b, c = operands_from_numpy(a_np, b_np, c_np, device="cpu")
    out = torch.empty(64, 40, dtype=c.dtype)[:, 4:36]  # rows 40 apart
    got = cm.cuda_matmul_rs(a, b, c, out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, cm.matmul_acc_plain(a, b, c))
    assert rel_err(as_numpy(got), want) <= TOLERANCE[dtype_name]


@pytest.mark.parametrize("dtype_name", list(TOLERANCE))
def test_rs_first_step_is_the_product(dtype_name):
    a_np, b_np = numpy_operands(63, 24, 40, 16, dtype_name)
    a, b = operands_from_numpy(a_np, b_np, device="cpu")
    dtype = cm.matmul_plain(a, b).dtype
    y = torch.zeros(72, 16, dtype=dtype)
    cm.cuda_matmul_rs(a, b, None, y[24:48])
    assert torch.equal(y[24:48], cm.matmul_plain(a, b))
    assert not y[:24].any() and not y[48:].any()


def test_rs_step_checks_its_operands():
    a = torch.ones(8, 16, dtype=BF16)
    b = torch.ones(16, 4, dtype=BF16)
    with pytest.raises(ValueError, match="out must be"):
        cm.cuda_matmul_rs(a, b, None, torch.empty(8, 5, dtype=BF16))
    with pytest.raises(ValueError, match="accin must be"):
        cm.cuda_matmul_rs(a, b, torch.zeros(8, 4), torch.empty(8, 4, dtype=BF16))
    with pytest.raises(ValueError, match="unit column stride"):
        cm.cuda_matmul_rs(a, b, None, torch.empty(8, 8, dtype=BF16)[:, ::2])


# -------------------------------------------------------- the route rule

@pytest.mark.parametrize("case", chip_smoke.RS_ROUTE_CASES, ids=lambda c: c[0])
def test_rs_route(case):
    label, route = case[0], case[-1]
    assert cm.step_route(*chip_smoke.route_args(case)) == route, label


def test_rs_route_cases_cover_every_outcome():
    routes = [case[-1] for case in chip_smoke.RS_ROUTE_CASES]
    assert set(routes) == {"wgmma_persistent", "wgmma", "wmma", "simt"}
    # a first step (no accin), an unaligned dest and an unaligned accin
    labels = " ".join(case[0] for case in chip_smoke.RS_ROUTE_CASES)
    for word in ("first step", "dest", "accin", "tile"):
        assert word in labels


def test_rs_route_refuses_what_the_source_refuses():
    # the C check refuses a base off 16 bytes, a row stride off 16 bytes, a
    # tile it does not instantiate, other dtypes and empty dimensions
    text = SOURCE.read_text()
    check = text[text.index("cudaError_t check(const Step& s"):]
    check = check[:check.index("\n}\n")]
    for clause in ("in_dtype != kBF16 && in_dtype != kF16", "s.k < 1",
                   "!instantiated(bm, bn, bk)", "cudaErrorMisalignedAddress",
                   "tma_describable(s.c, s.ldc)", "tma_describable(s.accin, s.ldacc)"):
        assert clause in check, clause


# --------------------------------------------------- the persistent grid

@pytest.mark.parametrize("tm, tn, sms, per_sm", [
    (32, 64, 132, 1),   # a K3 step at 16384² over 4 ranks: 2048 tiles
    (16, 64, 132, 1),   # a K5 half step: 1024 tiles
    (1, 1, 132, 1), (5, 3, 4, 2), (13, 17, 7, 1), (9, 2, 132, 1), (8, 8, 64, 1),
])
@pytest.mark.parametrize("m_slow", [True, False])
def test_persistent_walk_visits_every_tile_once(tm, tn, sms, per_sm, m_slow):
    tiles = tm * tn
    grid = min(tiles, sms * per_sm)  # csrc/ring_rs.cu launch_tile's grid
    walks = [cm.persistent_tiles(b, grid, tm, tn, m_slow) for b in range(grid)]
    assert all(walks)  # no block without a tile
    visited = [tile for walk in walks for tile in walk]
    assert len(visited) == tiles and set(visited) == {
        (i, j) for i in range(tm) for j in range(tn)}
    # each block's k-th tile is the raster's tile b + k·grid
    for b, walk in enumerate(walks):
        assert walk == [cm.raster(t, tm, tn, m_slow) for t in range(b, tiles, grid)]


@pytest.mark.parametrize("tile", cm.PERSISTENT_TILES, ids=lambda t: "x".join(map(str, t)))
def test_persistent_plan_fits_a_block(tile):
    plan = cm.wgmma_plan(tile, persistent=True)
    bm, bn, _ = tile
    assert plan["epilogue_bytes"] == bm * bn * 2
    assert 3 <= plan["stages"] <= 5
    assert plan["smem_bytes"] <= cm.SMEM_PER_BLOCK == 232448
    # the same warpgroup split as the GEMM's
    base = cm.wgmma_plan(tile)
    assert {k: plan[k] for k in ("wg_m", "wg_n", "wm", "wn", "mi")} == {
        k: base[k] for k in ("wg_m", "wg_n", "wm", "wn", "mi")}


def test_persistent_plan_mirrors_the_source():
    text = SOURCE.read_text()
    macro = re.search(r"#define TMB_RS_TILES\(X\)(.*)", text).group(1)
    listed = tuple(tuple(int(v) for v in t.split(","))
                   for t in re.findall(r"X\(([\d, ]+)\)", macro))
    assert listed == cm.PERSISTENT_TILES
    assert all(t in cm.TILES for t in cm.PERSISTENT_TILES)
    assert re.search(r"constexpr int kRsBudget = ([^;]+);", text).group(1) == "212 * 1024"
    assert cm._RS_BUDGET == 212 * 1024
    pinned = re.search(r"RsTile<128, 256, 64>::STAGES == (\d+) && "
                       r"RsTile<128, 256, 64>::SMEM_BYTES == (\d+)", text)
    plan = cm.wgmma_plan((128, 256, 64), persistent=True)
    assert (plan["stages"], plan["smem_bytes"]) == tuple(map(int, pinned.groups()))
