"""The all-gather rings' forwarding step (K2, K4) on the CPU.

On ranks that share one card, each step of `ops/cuda_ring.py`'s all-gather
schedule stores the chunk it multiplies into the reader's receive slot
(t+1) mod 2 in the product's own launch: no hop and no copy stream. The
product is `cuda_matmul.cuda_matmul_ag`, which takes the persistent GEMM of
`csrc/ring_rs.cu` in its forwarding mode on the card where `step_route` says
so. The kernel runs only on the card (`chip_smoke.py` holds it against its
plain version); here run the schedule with the plain products against the
JAX rings in interpret mode, both transfers, and the pure rules that decide
and shape the kernel's work before a launch.
"""

import re
from pathlib import Path

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

import chip_smoke
from tpu_matmul_bench.ops.pallas_ring_bidir_hbm import (
    ring_allgather_matmul_bidir_hbm as jax_k4,
)
from tpu_matmul_bench.ops.pallas_ring_hbm import ring_allgather_matmul_hbm as jax_k2
from tpu_matmul_bench.parallel import mesh as jax_mesh
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops import cuda_ring as cr
from tpu_matmul_bench_torch.ops.matmul import operands_from_numpy
from tpu_matmul_bench_torch.parallel import mesh
from tpu_matmul_bench_torch.parallel.mesh import COLS, ROWS, gather, shard_from_numpy
from tpu_matmul_bench_torch.utils.device import resolve_devices

pytestmark = pytest.mark.usefixtures("single_torch_thread")

SOURCE = Path(cm.__file__).resolve().parent.parent / "csrc" / "ring_rs.cu"
BF16 = torch.bfloat16
# (m, k, n) and the JAX kernels' blocks: 8 rows a rank at d = 8, K4 halves
# of 4 rows; several blocks per chunk in every dimension
M, K, N, BLOCKS = 64, 32, 64, (4, 16, 8)


@pytest.fixture
def ranks8(monkeypatch):
    """Up to 8 ranks share the CPU, as the JAX tests' 8 virtual devices."""
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def _operands(d: int, dtype_name: str = "bfloat16"):
    return numpy_operands(70 + d, M, K, N, dtype_name)


def _port_ring(d: int, bidir: bool, x_np, w_np):
    pmesh = mesh.make_mesh(resolve_devices("cpu", d))
    build = cr.ring_allgather_matmul_bidir_hbm if bidir else cr.ring_allgather_matmul_hbm
    bm, bn, bk = BLOCKS
    fn = build(pmesh, block_m=bm, block_n=bn, block_k=bk)
    return fn, shard_from_numpy(x_np, ROWS, pmesh), shard_from_numpy(w_np, COLS, pmesh)


def _jax_ring(devices, d: int, bidir: bool, x_np, w_np) -> np.ndarray:
    jmesh = jax_mesh.make_mesh(devices[:d])
    bm, bn, bk = BLOCKS
    fn = (jax_k4 if bidir else jax_k2)(jmesh, block_m=bm, block_n=bn, block_k=bk)

    def put(arr, spec):
        return jax.device_put(jnp.asarray(arr), NamedSharding(jmesh, P(*spec)))

    return np.asarray(fn(put(x_np, ROWS), put(w_np, COLS)))


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same memory: base pointer, shape and strides."""
    return (a.data_ptr(), a.shape, a.stride()) == (b.data_ptr(), b.shape, b.stride())


def _instrument(monkeypatch):
    """Record every slot set the ring allocates and every all-gather step
    product it runs (its A, out and fwd), in issue order; a hop fails the
    test."""
    slot_sets, products = [], []
    allocate, product = cr.RingMatmul._slots, cm.cuda_matmul_ag

    def slots(self, ways, n, dtype):
        got = allocate(self, ways, n, dtype)
        slot_sets.append(got)
        return got

    def ag(a, b, out, fwd=None, **kw):
        products.append((a, out, fwd))
        return product(a, b, out, fwd, **kw)

    def hop(*_):
        raise AssertionError("a ring on one card hopped")

    monkeypatch.setattr(cr.RingMatmul, "_slots", slots)
    monkeypatch.setattr(cm, "cuda_matmul_ag", ag)
    monkeypatch.setattr(cr, "_hop", hop)
    return slot_sets, products


# ------------------------------------------------- the forwarding schedule

@pytest.mark.parametrize("bidir", [False, True], ids=["k2", "k4"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_each_step_forwards_into_the_readers_slot(devices, ranks8, monkeypatch, d, bidir):
    x_np, w_np = _operands(d)
    fn, x, w = _port_ring(d, bidir, x_np, w_np)
    assert cr.ag_transfer(fn.mesh) == "forward"
    slot_sets, products = _instrument(monkeypatch)
    y = fn(x, w)
    # one set of receive slots, and every product an all-gather step
    assert len(slot_sets) == 1
    slots = slot_sets[0]
    ways = fn._ways(x[0].shape[0])
    assert len(products) == d * d * len(ways)
    mshard = M // d
    calls = iter(products)
    for t in range(d):
        for r in range(d):
            for way in ways:
                a, out, fwd = next(calls)
                writer, reader = way.neighbours(d, r)
                held = x[r][way.lo:way.hi] if t == 0 else slots[way.name][r][t % 2]
                src = (r - way.step * t) % d
                assert _same(a, held), (t, r, way.name)
                assert _same(out, y[r][src * mshard + way.lo:src * mshard + way.hi])
                if t + 1 < d:
                    assert _same(fwd, slots[way.name][reader][(t + 1) % 2]), (t, r, way.name)
                else:
                    assert fwd is None
    got = gather(y)
    assert rel_err(as_numpy(got), _jax_ring(devices, d, bidir, x_np, w_np)) <= TOLERANCE["bfloat16"]
    assert torch.equal(got, gather(cr.ring_allgather_matmul_plain(x, w)))


@pytest.mark.parametrize("bidir", [False, True], ids=["k2", "k4"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_hop_transfer_hops_every_chunk(devices, ranks8, monkeypatch, d, bidir):
    # the schedule of ranks on several cards, driven here on the CPU's ranks
    x_np, w_np = _operands(d)
    fn, x, w = _port_ring(d, bidir, x_np, w_np)
    hops, forwarded = [], []
    real = cr._hop

    def hop(sched, r, dst, src, which=cr._COPY, reader=None):
        hops.append((r, which))
        real(sched, r, dst, src, which, reader)

    def ag(*args, **kw):
        forwarded.append(args)
        raise AssertionError("the hop schedule forwarded in a product")

    monkeypatch.setattr(cr, "_hop", hop)
    monkeypatch.setattr(cm, "cuda_matmul_ag", ag)
    y = fn._allgather(x, w, "hop")
    ways = 2 if bidir else 1
    assert len(hops) == ways * d * (d - 1) and not forwarded
    # each direction's hops on its own copy stream
    assert {which for _, which in hops} == ({cr._COPY, cr._COPY_BACK} if bidir else {cr._COPY})
    got = gather(y)
    assert rel_err(as_numpy(got), _jax_ring(devices, d, bidir, x_np, w_np)) <= TOLERANCE["bfloat16"]
    assert torch.equal(got, gather(cr.ring_allgather_matmul_plain(x, w)))


def test_transfer_is_chosen_from_the_mesh():
    cuda = [torch.device("cuda", 0)] * 4
    assert cr.ag_transfer(mesh.make_mesh(cuda)) == "forward"
    two_cards = [torch.device("cuda", i // 2) for i in range(4)]
    assert cr.ag_transfer(mesh.make_mesh(two_cards)) == "hop"
    assert cr.ag_transfer(mesh.make_mesh([torch.device("cpu")] * 8)) == "forward"


@pytest.mark.parametrize("bidir", [False, True], ids=["k2", "k4"])
@pytest.mark.parametrize("transfer, per_rank", [("forward", 1), ("hop", None)])
def test_copy_streams_only_where_the_ring_hops(monkeypatch, bidir, transfer, per_rank):
    # a stand-in for torch.cuda.Stream: the schedule's stream count a rank
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: object())
    cards = mesh.make_mesh([torch.device("cuda", 0)] * 4)
    fn = (cr.ring_allgather_matmul_bidir_hbm if bidir else cr.ring_allgather_matmul_hbm)(cards)
    sched = fn._schedule(True, transfer)
    want = per_rank or (3 if bidir else 2)
    assert [len(s) for s in sched.streams] == [want] * 4
    assert fn._schedule(True, transfer).streams is sched.streams  # made once
    assert fn._schedule(False, transfer).streams is None


def test_chip_smoke_expects_hops_only_where_a_step_cannot_forward():
    for label, ways in (("ring_ag", 1), ("ring_ag_bidir", 2)):
        assert chip_smoke.per_call(label, 4) == (ways * 16, 0, 0)
        assert chip_smoke.per_call(label, 4, forwards=False) == (ways * 16, ways * 12, 0)
    # bf16 and f16 at TMA-describable rows forward; int8, fp32 and a row
    # of 137 elements (274 bytes) do not
    for mkn in chip_smoke.RING_SHAPES:
        assert chip_smoke.ag_forwarding("bfloat16", mkn, 4)
        assert chip_smoke.ag_forwarding("float16", mkn, 2)
        assert not chip_smoke.ag_forwarding("int8", mkn, 4)
        assert not chip_smoke.ag_forwarding("float32", mkn, 4)
    assert not chip_smoke.ag_forwarding("bfloat16", chip_smoke.SPLIT_SHAPES[-1], 4)


def test_cpu_ag_rings_launch_nothing(ranks8):
    def counters():
        return (cr.RING_STEPS, cr.HOP_LAUNCHES, dict(cr.AG_TRANSFERS), cm.LAUNCHES,
                cm.AG_LAUNCHES, dict(cm.LAUNCHES_BY_ROUTE))

    before = counters()
    for bidir in (False, True):
        fn, x, w = _port_ring(4, bidir, *_operands(4))
        fn(x, w)
    a = torch.ones(64, 32, dtype=BF16)
    cm.cuda_matmul_ag(a, torch.ones(32, 16, dtype=BF16), torch.empty(64, 16, dtype=BF16),
                      torch.empty(64, 32, dtype=BF16))
    assert counters() == before


# ------------------------------------------------------------ the wrapper

@pytest.mark.parametrize("dtype_name", list(TOLERANCE))
def test_ag_step_plain_is_the_product_and_the_copy(dtype_name):
    a_np, b_np = numpy_operands(81, 40, 48, 24, dtype_name)
    a, b = operands_from_numpy(a_np, b_np, device="cpu")
    want = cm.matmul_plain(a, b)
    out = torch.zeros(40, 30, dtype=want.dtype)[:, 3:27]  # rows 30 apart
    room = torch.full((44, 56), 7, dtype=a.dtype)
    slot = room[2:42, 4:52]  # rows 56 apart, inside a larger buffer
    got = cm.cuda_matmul_ag(a, b, out, slot)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, want) and torch.equal(slot, a)
    assert (room[:2] == 7).all() and (room[42:] == 7).all()
    assert (room[:, :4] == 7).all() and (room[:, 52:] == 7).all()
    # a last step: the product alone
    y = torch.zeros(40, 24, dtype=want.dtype)
    cm.cuda_matmul_ag(a, b, y)
    assert torch.equal(y, want)


def test_ag_step_checks_its_operands():
    a = torch.ones(8, 16, dtype=BF16)
    b = torch.ones(16, 4, dtype=BF16)
    out = torch.empty(8, 4, dtype=BF16)
    with pytest.raises(ValueError, match="out must be"):
        cm.cuda_matmul_ag(a, b, torch.empty(8, 5, dtype=BF16))
    with pytest.raises(ValueError, match="fwd must be"):
        cm.cuda_matmul_ag(a, b, out, torch.empty(8, 15, dtype=BF16))
    with pytest.raises(ValueError, match="fwd must be"):
        cm.cuda_matmul_ag(a, b, out, torch.empty(8, 16))
    with pytest.raises(ValueError, match="unit column stride"):
        cm.cuda_matmul_ag(a, b, out, torch.empty(8, 32, dtype=BF16)[:, ::2])


# -------------------------------------------------------- the route rule

@pytest.mark.parametrize("case", chip_smoke.AG_ROUTE_CASES, ids=lambda c: c[0])
def test_ag_route(case):
    label, route = case[0], case[-1]
    assert cm.step_route(*chip_smoke.route_args(case), forward=True) == route, label


def test_ag_route_cases_cover_every_outcome():
    routes = [case[-1] for case in chip_smoke.AG_ROUTE_CASES]
    assert set(routes) == {"wgmma_persistent", "wgmma", "wmma", "simt"}
    # a step without a slot, an unaligned dest, an unaligned slot and slot
    # rows closer than k
    labels = " ".join(case[0] for case in chip_smoke.AG_ROUTE_CASES)
    for word in ("no slot", "dest off", "slot off", "slot rows", "narrower", "tile"):
        assert word in labels


def test_ag_route_refuses_what_the_source_refuses():
    # the C check refuses a slot off 16 bytes or with a row stride off 16
    # bytes, beside what it refuses for every step; tmb_ag_check and
    # tmb_ag_step hand it the slot
    text = SOURCE.read_text()
    check = text[text.index("cudaError_t check(const Step& s"):]
    check = check[:check.index("\n}\n")]
    for clause in ("in_dtype != kBF16 && in_dtype != kF16", "s.k < 1",
                   "!instantiated(bm, bn, bk)", "(fwd && !aligned(s.fwd))",
                   "tma_describable(s.c, s.ldc)", "tma_describable(s.fwd, s.ldfwd)",
                   "s.ldc < s.n", "s.ldfwd < s.k"):
        assert clause in check, clause
    for entry in ("int tmb_ag_check(", "int tmb_ag_step("):
        body = text[text.index(entry):]
        assert "c, m, n, k, lda, ldb, 0, ldc, fwd, ldfwd}" in body[:body.index("\n}\n")]


def test_ag_forwards_reads_the_tensors():
    a = torch.ones(32, 64, dtype=BF16)
    b = torch.ones(64, 32, dtype=BF16)
    out = torch.empty(32, 32, dtype=BF16)
    assert cm.ag_forwards(a, b, out, torch.empty(32, 64, dtype=BF16))
    assert not cm.ag_forwards(a, b, out, torch.empty(32, 68, dtype=BF16)[:, 1:65])
    assert not cm.ag_forwards(a, b, out, torch.empty(32, 64, dtype=BF16), blocks=(64, 128, 32))
    wide = torch.empty(32, 36, dtype=BF16)[:, :32]  # dest rows 72 bytes apart
    assert not cm.ag_forwards(a, b, wide, torch.empty(32, 64, dtype=BF16))


# ------------------------------------------------- the forwarded boxes

@pytest.mark.parametrize("tm, tn, ktiles", [
    (32, 16, 256),   # a K2 step at 16384² over 4 ranks: 16 boxes a tile
    (16, 16, 256),   # a K4 half step
    (5, 3, 7), (4, 9, 5), (1, 1, 4), (3, 2, 1), (2, 7, 7),
])
def test_every_box_is_forwarded_once(tm, tn, ktiles):
    grid = min(tm * tn, 132)
    stored = [box for b in range(grid) for mt, nt in cm.persistent_tiles(b, grid, tm, tn)
              for box in cm.forwarded_boxes(mt, nt, tn, ktiles)]
    assert len(stored) == tm * ktiles
    assert set(stored) == {(mt, kt) for mt in range(tm) for kt in range(ktiles)}
    # spread over a row of tiles: no tile stores more than its share
    share = -(-ktiles // tn)
    assert all(len(cm.forwarded_boxes(mt, nt, tn, ktiles)) <= share
               for mt in range(tm) for nt in range(tn))


def test_forwarded_boxes_mirror_the_source():
    text = SOURCE.read_text()
    assert "if (kt % tn == nt) {" in text
    assert "tmb::tma_store_2d(&fwd_map, st.a(pipe.stage), kt * BK, mt * BM);" in text
    # a stage is freed by the consumer warps and, when forwarding, the copier
    assert "tmb::kConsumerWarps + (FWD ? 1 : 0)" in text
