"""The port's SUMMA (`tpu_matmul_bench_torch/parallel/summa.py`) against the
JAX package's `parallel/summa.py`.

The same numpy operands go to JAX's programs on the conftest's 8-device CPU
mesh and to the port's over 8 ranks on the CPU. Both legs' outputs are held
rank by rank on every grid (rows ∈ {1, 2, 4, 8}) and on both factorized
meshes: fp32 within 1e-5, int8 exactly. Each step's broadcast panels are
held bitwise to JAX's masked psum (the same step body under `shard_map`),
under exact collectives and under `int8-block:128`. Also the size gate and
its message, `summa_grid`, `summa_size_ok`, `summa_min_size`, the records'
extras and the CLI.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch_port_util import as_numpy, numpy_operands, rel_err, single_torch_thread  # noqa: F401

from tpu_matmul_bench.parallel import collectives as jcollectives
from tpu_matmul_bench.parallel import mesh as jmesh
from tpu_matmul_bench.parallel import summa as jsumma
from tpu_matmul_bench.utils.config import build_parser as jax_build_parser
from tpu_matmul_bench.utils.config import config_from_args as jax_config_from_args
from tpu_matmul_bench_torch import __main__ as port_main
from tpu_matmul_bench_torch.parallel import collectives, mesh, summa
from tpu_matmul_bench_torch.parallel.mesh import shard_from_numpy
from tpu_matmul_bench_torch.utils import timing
from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args
from tpu_matmul_bench_torch.utils.device import resolve_devices

pytestmark = pytest.mark.usefixtures("single_torch_thread")

TOL = {"float32": 1e-5, "int8": 0.0}
GRIDS = ["rows=1", "rows=2", "rows=4", "rows=8", "dcn:2,ici:4", "dcn:4,ici:2"]


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def _meshes(grid: str):
    devices, ranks = jax.devices()[:8], resolve_devices("cpu", 8)
    if grid.startswith("rows="):
        rows = int(grid[5:])
        return jsumma.make_summa_mesh(devices, rows), summa.make_summa_mesh(ranks, rows)
    return jmesh.make_factorized_mesh(devices, grid), mesh.make_factorized_mesh(ranks, grid)


@functools.cache
def _jax_programs(grid: str):
    jm, _ = _meshes(grid)
    return jm, jsumma.summa_programs(jm)


def _operands(jm, pm, size, dtype):
    a, b = numpy_operands(3, size, size, size, dtype)
    spec = tuple(jm.axis_names)
    return ((jax.device_put(a, NamedSharding(jm, P(*spec))),
             jax.device_put(b, NamedSharding(jm, P(*spec)))),
            (shard_from_numpy(a, spec, pm), shard_from_numpy(b, spec, pm)))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("grid", GRIDS)
def test_outputs_match_jax(ranks8, grid, dtype):
    size = 64
    jm, (jcompute, jfull) = _jax_programs(grid)
    _, pm = _meshes(grid)
    jops, pops = _operands(jm, pm, size, dtype)
    compute, full = summa.summa_programs(pm, "cuda")
    for jprog, prog in ((jcompute, compute), (jfull, full)):
        want = np.asarray(jprog(*jops))
        got = prog(*pops)
        blocks = shard_from_numpy(want, got.spec, pm)
        for r in range(8):
            assert got[r].dtype == blocks[r].dtype and got[r].shape == blocks[r].shape
            assert rel_err(as_numpy(got[r]), as_numpy(blocks[r])) <= TOL[dtype], r
    if dtype == "float32":  # the full leg is C itself
        c = mesh.gather(full(*pops)).double().numpy()
        a, b = (mesh.gather(x).double().numpy() for x in pops)
        assert rel_err(c, a @ b) <= TOL[dtype]


def _jax_step_panels(jm, t: int, comm_quant):
    """JAX's step body (`summa.py:302-312`) at step t, returning its two
    broadcast panels, under `shard_map`."""
    i_ax, j_ax = jm.axis_names
    r, c = jm.shape[i_ax], jm.shape[j_ax]
    s = math.lcm(r, c)
    psum = jcollectives.psum_impl(comm_quant, fuse_f32=True)

    def body(a_local, b_local):
        kb_a = a_local.shape[1] // (s // c)
        kb_b = b_local.shape[0] // (s // r)
        a_pan = lax.dynamic_slice_in_dim(a_local, (t % (s // c)) * kb_a, kb_a, axis=1)
        b_pan = lax.dynamic_slice_in_dim(b_local, (t % (s // r)) * kb_b, kb_b, axis=0)
        a_pan = psum(jnp.where(lax.axis_index(j_ax) == t // (s // c), a_pan, 0), j_ax)
        b_pan = psum(jnp.where(lax.axis_index(i_ax) == t // (s // r), b_pan, 0), i_ax)
        return a_pan, b_pan

    spec = P(i_ax, j_ax)
    return jmesh.smap(body, jm, in_specs=(spec, spec), out_specs=(spec, spec),
                      check_vma=False)


@pytest.mark.parametrize("comm_quant", [None, "int8-block:128"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid", ["rows=2", "dcn:4,ici:2"])
def test_broadcast_panels_are_jax_bits(ranks8, grid, dtype, comm_quant):
    size = 512  # panels 128 wide: the block of int8-block:128
    jm, pm = _meshes(grid)
    jops, pops = _operands(jm, pm, size, dtype)
    psum = collectives.psum_impl(comm_quant, fuse_f32=True)
    for t in range(math.lcm(*pm.dims)):
        ja, jb = (np.asarray(x) for x in _jax_step_panels(jm, t, comm_quant)(*jops))
        pa, pb = summa.step_panels(pm, *pops, t, psum)
        for want, got in ((ja, pa), (jb, pb)):
            blocks = shard_from_numpy(want, (pm.axis_names[0], pm.axis_names[1]), pm)
            for r in range(8):
                w, g = _bits(blocks[r]), _bits(got[r])
                assert w.dtype == g.dtype and np.array_equal(w, g), (t, r)


def _bits(t):
    """A tensor's bits as integers (bf16 and fp32 reinterpreted)."""
    import torch

    x = t.contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    if x.dtype == torch.float32:
        return x.view(torch.int32).numpy()
    return x.numpy()


def _configs(size, *extra):
    args = ["--sizes", str(size), "--dtype", "float32", "--iterations", "2", "--warmup", "1",
            *extra]
    return (config_from_args(build_parser("t", comm_quant=True, mesh=True).parse_args(
                [*args, "--device", "cpu"])),
            jax_config_from_args(jax_build_parser("t").parse_args(args)))


@pytest.mark.parametrize("extra", [(), ("--comm-quant", "int8-block:32"),
                                   ("--comm-quant", "dcn=int8-block:32,ici=none")])
@pytest.mark.parametrize("grid", ["rows=2", "dcn:2,ici:4", "dcn:4,ici:2"])
def test_record_extras_match_jax(ranks8, grid, extra):
    size = 256
    config, jconfig = _configs(size, *extra)
    jm, pm = _meshes(grid)
    fake, fake_full = timing.Timing(0.02, 2), timing.Timing(0.03, 2)
    jrec = jsumma.summa_mode(jconfig, jm, size).build_record(fake, fake_full, 0.005)
    rec = summa.summa_mode(config, pm, size).build_record(fake, fake_full, 0.005)
    assert set(rec.extras) == set(jrec.extras) | {"cards", "ranks_per_card"}
    for key in jrec.extras:
        assert rec.extras[key] == jrec.extras[key], key
    assert rec.tflops_total == pytest.approx(jrec.tflops_total, rel=1e-12)
    assert (rec.mode, rec.world, rec.avg_time_s) == (jrec.mode, jrec.world, jrec.avg_time_s)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_grid_and_size_gate_match_jax(n):
    for rows in (None, 1, 2, 3, 4, 5):
        try:
            want = jsumma.summa_grid(n, rows)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).replace("(", r"\(")):
                summa.summa_grid(n, rows)
            continue
        assert summa.summa_grid(n, rows) == want
        for floor in (1, 64, 100, 1000):
            assert summa.summa_min_size(n, floor, rows) == jsumma.summa_min_size(n, floor, rows)
        for size in (48, 64, 96, 256, 384):
            assert summa.summa_size_ok(n, size, rows) == jsumma.summa_size_ok(n, size, rows)


def test_size_gate_message_is_jax(ranks8, devices):
    config, jconfig = _configs(72)
    jm, pm = _meshes("rows=2")
    with pytest.raises(ValueError) as want:
        jsumma.summa_mode(jconfig, jm, 72)
    with pytest.raises(ValueError) as got:
        summa.summa_mode(config, pm, 72)
    assert str(got.value) == str(want.value)


def test_cli(ranks8, tmp_path, capsys):
    out = tmp_path / "s.jsonl"
    records = port_main.main(["summa", "--device", "cpu", "--num-devices", "8", "--rows", "4",
                              "--sizes", "64", "72", "--iterations", "2", "--warmup", "1",
                              "--validate", "--json-out", str(out)])
    # 72 does not split on the 4x2 grid: reported, skipped
    assert [r.size for r in records] == [64]
    rec = records[0]
    assert rec.extras["grid"] == "4x2" and rec.extras["k_panels"] == 4
    assert rec.extras["validation"] == "ok"
    text = capsys.readouterr().out
    assert "SUMMA 2-D Grid Benchmark" in text
    assert "size 72 must be divisible by r·lcm(r,c)=16 and c·lcm(r,c)=8" in text
    assert json.loads(out.read_text().splitlines()[-1])["mode"] == "summa"
    with pytest.raises(SystemExit) as e:
        port_main.main(["summa", "--device", "cpu", "--num-devices", "8", "--mesh", "ici:8",
                        "--sizes", "64"])
    assert e.value.code == 1
    assert "summa needs a two-axis --mesh" in capsys.readouterr().out
