"""The port's fused ring matmul (`ops/cuda_ring_fused.py`, K6), its residency
cap and its overlap mode, against the JAX package's `pallas_ring`.

The same numpy operands go through the JAX kernel (`pallas_ring.py
ring_allgather_matmul`) in interpret mode on the conftest's 8-device CPU
mesh (sliced to D devices), and through the port's ring on D ranks that
share the CPU (`TMB_RANKS_PER_CARD=8`, set per test). On the CPU the ring
runs the kernel's step loop: each rank's two slots, `copy_` hops and plain
products. The CUDA kernel (`csrc/ring_fused.cu`) runs only on the card
(`chip_smoke.py`); here its rank limit and argument layout are held to the
wrapper's.
"""

import json
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

from tpu_matmul_bench.ops.pallas_ring import ring_allgather_matmul as jax_ring
from tpu_matmul_bench.parallel import mesh as jax_mesh
from tpu_matmul_bench.parallel.modes import run_mode_benchmark as jax_run_mode
from tpu_matmul_bench.parallel.overlap import OVERLAP_MODES as JAX_MODES
from tpu_matmul_bench.parallel.overlap import PALLAS_RING_VMEM_BUDGET, pallas_ring_max_size
from tpu_matmul_bench.utils.config import parse_config as jax_parse_config
from tpu_matmul_bench_torch.benchmarks import matmul_overlap_benchmark as overlap
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops import cuda_ring as cr
from tpu_matmul_bench_torch.ops import cuda_ring_fused as crf
from tpu_matmul_bench_torch.ops.matmul import operands_from_numpy
from tpu_matmul_bench_torch.parallel import mesh, modes
from tpu_matmul_bench_torch.parallel import overlap as port_overlap
from tpu_matmul_bench_torch.parallel.mesh import COLS, ROWS, gather, shard_from_numpy
from tpu_matmul_bench_torch.parallel.overlap import OVERLAP_MODES
from tpu_matmul_bench_torch.utils.config import parse_config
from tpu_matmul_bench_torch.utils.device import resolve_devices

pytestmark = pytest.mark.usefixtures("single_torch_thread")

SOURCE = Path(crf.__file__).resolve().parent.parent / "csrc" / "ring_fused.cu"
SHAPES = [(64, 32, 64), (128, 128, 128)]  # the JAX test's (m, k, n)
RANKS = [1, 2, 4, 8]
SMALL = ["--sizes", "64", "--iterations", "2", "--warmup", "1", "--dtype", "float32"]


@pytest.fixture
def ranks8(monkeypatch):
    """Up to 8 ranks share the CPU, as the JAX tests' 8 virtual devices."""
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def port_mesh(d: int) -> mesh.Mesh:
    return mesh.make_mesh(resolve_devices("cpu", d))


def _port(d, x_np, w_np):
    pmesh = port_mesh(d)
    return crf.ring_allgather_matmul(pmesh)(shard_from_numpy(x_np, ROWS, pmesh),
                                            shard_from_numpy(w_np, COLS, pmesh))


@pytest.mark.parametrize("d", RANKS)
@pytest.mark.parametrize("dtype_name", list(TOLERANCE))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_fused_ring_matches_jax(devices, ranks8, m, k, n, dtype_name, d):
    x_np, w_np = numpy_operands(61 + d, m, k, n, dtype_name)
    jmesh = jax_mesh.make_mesh(devices[:d])
    want = jax_ring(jmesh)(
        jax.device_put(jnp.asarray(x_np), NamedSharding(jmesh, P("x", None))),
        jax.device_put(jnp.asarray(w_np), NamedSharding(jmesh, P(None, "x"))))
    got = _port(d, x_np, w_np)
    assert len(got) == d and got.spec == COLS
    y = gather(got)
    assert str(y.dtype).removeprefix("torch.") == want.dtype.name
    if dtype_name == "float32":
        # the JAX test's own tolerance for this kernel
        np.testing.assert_allclose(as_numpy(y), np.asarray(want), rtol=1e-4, atol=1e-4)
    else:
        assert rel_err(as_numpy(y), want) <= TOLERANCE[dtype_name]


# --- the JAX test's own cases (test_pallas_ring.py), and the other rings'

def test_chunk_placement(ranks8):
    # distinct per-rank X chunks + identity W: rows land in origin order
    d, m, k = 8, 64, 64
    x = np.repeat(np.arange(d, dtype=np.float32), m // d)[:, None] * np.ones((1, k), np.float32)
    got = gather(_port(d, x, np.eye(k, dtype=np.float32)))
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-5, atol=1e-5)


def test_int8_exact(ranks8):
    size = 64
    xi = (np.arange(size * size).reshape(size, size) % 13 - 6).astype(np.int8)
    wi = (np.arange(size * size).reshape(size, size) % 7 - 3).astype(np.int8)
    y = gather(_port(8, xi, wi))
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), xi.astype(np.int32) @ wi.astype(np.int32))


@pytest.mark.parametrize("d", [2, 4])
def test_sub_rings(ranks8, d):
    x_np, w_np = numpy_operands(0, 4 * 7, 64, 64, "float32")  # odd chunks of 7 rows
    np.testing.assert_allclose(gather(_port(d, x_np, w_np)).numpy(), x_np @ w_np,
                               rtol=1e-4, atol=1e-4)


def test_fused_ring_rounds_each_chunk_once(ranks8):
    # one rounding per chunk's product: bit for bit K2's plain version
    d = 4
    x_np, w_np = numpy_operands(62, 64, 48, 32, "bfloat16")
    pmesh = port_mesh(d)
    x, w = shard_from_numpy(x_np, ROWS, pmesh), shard_from_numpy(w_np, COLS, pmesh)
    a, b = operands_from_numpy(x_np, w_np, device="cpu")
    got = gather(crf.ring_allgather_matmul(pmesh)(x, w))
    assert torch.equal(got, gather(cr.ring_allgather_matmul_plain(x, w)))
    assert torch.equal(got, cm.matmul_plain(a, b))


def test_cpu_fused_ring_launches_nothing(ranks8):
    x_np, w_np = numpy_operands(1, 32, 32, 32, "bfloat16")
    counts = (crf.FUSED_RING_LAUNCHES, cr.RING_STEPS, cr.HOP_LAUNCHES, cm.LAUNCHES)
    _port(4, x_np, w_np)
    assert (crf.FUSED_RING_LAUNCHES, cr.RING_STEPS, cr.HOP_LAUNCHES, cm.LAUNCHES) == counts


def test_world_across_cards_is_refused(monkeypatch):
    # one cooperative launch covers one card: a world on two is refused with
    # the reason, and so is a world beyond the launch's rank count
    two_cards = mesh.make_mesh([torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(ValueError, match="spans 2 cards"):
        crf.ring_allgather_matmul(two_cards)
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "9")
    with pytest.raises(ValueError, match="at most 8 ranks"):
        crf.ring_allgather_matmul(port_mesh(9))


def test_fused_ring_checks_its_shards(ranks8):
    x_np, w_np = numpy_operands(2, 32, 32, 32, "float32")
    pmesh = port_mesh(4)
    fn = crf.ring_allgather_matmul(pmesh)
    x, w = shard_from_numpy(x_np, ROWS, pmesh), shard_from_numpy(w_np, COLS, pmesh)
    with pytest.raises(ValueError, match="3 X and 4 W shards"):
        fn(x[:3], w)
    with pytest.raises(TypeError, match="one dtype"):
        fn(x, [s.double() for s in w])


def test_kernel_source_matches_the_wrapper():
    # the rank limit and the argument struct's fields, in order, as the
    # ctypes layout passes them
    text = SOURCE.read_text()
    (limit,) = re.findall(r"#define TMB_FUSED_MAX_RANKS (\d+)", text)
    assert int(limit) == crf.FUSED_MAX_RANKS
    body = text[text.index("struct TmbRingArgs {"):]
    body = body[:body.index("};")]
    fields = re.findall(r"\b(\w+)\[TMB_FUSED_MAX_RANKS\];", body)
    fields += re.findall(r"int ([\w, ]+);", body)[0].replace(" ", "").split(",")
    assert fields == [name for name, _ in crf._RingArgs._fields_]


# --- the residency cap

@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32", "int8"])
def test_cap_is_pallas_ring_max_size_at_the_vmem_budget(world, dtype_name):
    # at the JAX package's budget and one rank a device, the same rule
    got = port_overlap.cuda_ring_max_size(world, getattr(torch, dtype_name),
                                          PALLAS_RING_VMEM_BUDGET, 1)
    assert got == pallas_ring_max_size(world, jnp.dtype(dtype_name))


def test_cap_sums_the_ranks_on_a_card():
    l2 = 50 * 1024 * 1024
    # 4 bf16 ranks on one 50 MiB L2: size²·(4·2+2)/4 per rank, 4 ranks
    assert port_overlap.cuda_ring_max_size(4, torch.bfloat16, l2, 4) == 2048
    assert port_overlap.cuda_ring_max_size(4, torch.bfloat16, l2, 1) == 4096
    assert port_overlap.cuda_ring_max_size(1, torch.bfloat16, 1, 1) == 128  # at least one step


def test_mode_refuses_past_the_cap_on_the_card(ranks8, monkeypatch):
    # four ranks on a card of 50 MiB L2: 2048 is the cap, 4096 is refused
    # before any operand is made; the CPU has no cap
    monkeypatch.setattr(port_overlap, "l2_bytes", lambda device: 50 * 1024 * 1024)
    card = mesh.make_mesh([torch.device("cuda", 0)] * 4)
    cfg = _config("--dtype", "bfloat16")
    with pytest.raises(ValueError, match=r"L2-residency budget .*: 2048\); use --sizes 2048"):
        port_overlap.cuda_ring_mode(cfg, card, 4096)
    assert OVERLAP_MODES["cuda_ring"](cfg, port_mesh(4), 64).mode == "cuda_ring"


# --- the overlap program's mode

def _config(*extra):
    return parse_config([*SMALL, "--device", "cpu", *extra], "t",
                        modes=list(OVERLAP_MODES), default_mode="cuda_ring_hbm",
                        extra_dtypes=("int8",), fused_timing=True)


def test_fused_record_extras_match_jax(mesh, ranks8):
    jcfg = jax_parse_config([*SMALL, "--validate"], "t", modes=list(JAX_MODES))
    jrec = jax_run_mode(JAX_MODES["pallas_ring"](jcfg, mesh, 64), jcfg).finalize()
    cfg = _config("--validate")
    rec = modes.run_mode_benchmark(OVERLAP_MODES["cuda_ring"](cfg, port_mesh(8), 64),
                                   cfg).finalize()
    assert set(rec.extras) == set(jrec.extras) | {"cards", "ranks_per_card"}
    for key in ("baseline", "validation", "validation_tolerance"):
        assert rec.extras[key] == jrec.extras[key]
    assert rec.extras["superseded_by"] == "cuda_ring_hbm"
    assert jrec.extras["superseded_by"] == "pallas_ring_hbm"
    assert rec.extras["kernel"].startswith("CUDA fused ring")
    assert rec.world == jrec.world == 8 and rec.mode == "cuda_ring"


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int8"])
def test_fused_baseline_and_ring_agree(ranks8, dtype_name):
    cfg = _config("--dtype", dtype_name, "--matmul-impl", "cuda")
    setup = OVERLAP_MODES["cuda_ring"](cfg, port_mesh(4), 64)
    x, w = setup.operands
    base, ring = gather(setup.compute(x, w)), gather(setup.full(x, w))
    assert base.dtype == ring.dtype and base.shape == ring.shape == (64, 64)
    err = (base.double() - ring.double()).abs().max() / base.double().abs().max()
    assert float(err) <= modes.validation_tolerance(dtype_name)
    assert setup.fusable is False


def test_fused_program_runs_end_to_end(ranks8, tmp_path, capsys):
    out = tmp_path / "o.jsonl"
    (rec,) = overlap.main([*SMALL, "--device", "cpu", "--mode", "cuda_ring",
                           "--num-devices", "4", "--validate", "--matmul-impl", "cuda",
                           "--wres", "on", "--json-out", str(out)])
    with open(out) as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    assert lines[0]["record_type"] == "manifest" and len(lines) == 2
    assert lines[1]["mode"] == "cuda_ring" and lines[1]["benchmark"] == "overlap"
    assert lines[1]["extras"]["validation"] == "ok"
    assert lines[1]["extras"]["superseded_by"] == "cuda_ring_hbm"
    assert "wres" not in lines[1]["extras"]  # as pallas_ring: no W-resident option
    assert (rec.world, rec.extras["cards"], rec.extras["ranks_per_card"]) == (4, 1, 4)
    assert "4 ranks; cards: 1, ranks_per_card: 4" in capsys.readouterr().out
