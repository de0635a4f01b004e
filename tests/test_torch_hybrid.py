"""The port's hybrid dp×tp mode (`tpu_matmul_bench_torch/parallel/hybrid.py`)
against the JAX package's `parallel/hybrid.py`.

The same numpy operands go to JAX's programs on the conftest's 8-device CPU
mesh (`jax.device_put` under the mode's `NamedSharding`) and to the port's
over 8 ranks on the CPU (`shard_from_numpy`). Outputs are held rank by rank
at dp ∈ {1, 2, 4, 8}: fp32 within 1e-5, bf16 within `validation_tolerance`,
int8 exactly. The records' extras equal JAX's (the port adds `cards` and
`ranks_per_card`), on the flat ('dp', 'tp') mesh and on `--mesh
dcn:2,ici:4` and `dcn:4,ici:2` under a uniform and a per-link wire format,
where the runs also validate. Also the memory row and the CLI.
"""

import functools
import json

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch_port_util import as_numpy, numpy_operands, rel_err, single_torch_thread  # noqa: F401

from tpu_matmul_bench.parallel import hybrid as jhybrid
from tpu_matmul_bench.parallel import mesh as jmesh
from tpu_matmul_bench.utils.config import build_parser as jax_build_parser
from tpu_matmul_bench.utils.config import config_from_args as jax_config_from_args
from tpu_matmul_bench_torch import __main__ as port_main
from tpu_matmul_bench_torch.parallel import hybrid, mesh, modes
from tpu_matmul_bench_torch.parallel.mesh import shard_from_numpy
from tpu_matmul_bench_torch.utils import timing
from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args
from tpu_matmul_bench_torch.utils.device import resolve_devices

pytestmark = pytest.mark.usefixtures("single_torch_thread")

TOL = {"float32": 1e-5, "bfloat16": modes.validation_tolerance("bfloat16"), "int8": 0.0}
FAKE = timing.Timing(total_s=0.02, iterations=2)
FAKE_FULL = timing.Timing(total_s=0.03, iterations=2)


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def _args(size, dtype, extra):
    return ["--sizes", str(size), "--dtype", dtype, "--iterations", "2", "--warmup", "1",
            *extra]


def _config(size=64, dtype="float32", *extra):
    return config_from_args(build_parser("t", extra_dtypes=("int8",), comm_quant=True,
                                         mesh=True).parse_args(
        _args(size, dtype, ["--device", "cpu", *extra])))


def _jax_config(size=64, dtype="float32", *extra):
    return jax_config_from_args(jax_build_parser("t", extra_dtypes=("int8",)).parse_args(
        _args(size, dtype, list(extra))))


def _meshes(dp: int | None, spec: str | None = None):
    devices = jax.devices()[:8]
    ranks = resolve_devices("cpu", 8)
    if spec:
        return (jmesh.make_factorized_mesh(devices, spec),
                mesh.make_factorized_mesh(ranks, spec))
    return jhybrid.make_hybrid_mesh(devices, dp), hybrid.make_hybrid_mesh(ranks, dp)


@functools.cache
def _jax_programs(dp: int, dtype: str):
    jm, _ = _meshes(dp)
    return jm, jhybrid.hybrid_programs(jm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_outputs_match_jax(ranks8, dp, dtype):
    size, batch = 64, 4
    jm, (jcompute, jfull) = _jax_programs(dp, dtype)
    _, pm = _meshes(dp)
    g = max(batch // dp, 1) * dp
    x = np.stack([numpy_operands(10 + i, size, size, size, dtype)[0] for i in range(g)])
    (w, _) = numpy_operands(7, size, size, size, dtype)
    jx = jax.device_put(x, NamedSharding(jm, P("dp")))
    jw = jax.device_put(w, NamedSharding(jm, P(None, "tp")))
    px = shard_from_numpy(x, ("dp",), pm)
    pw = shard_from_numpy(w, (None, "tp"), pm)
    compute, full = hybrid.hybrid_programs(pm, "cuda")
    for jprog, prog in ((jcompute, compute), (jfull, full)):
        want = np.asarray(jprog(jx, jw))
        got = prog(px, pw)
        blocks = shard_from_numpy(want, got.spec, pm)
        assert len(got) == 8
        for r in range(8):
            assert got[r].dtype == blocks[r].dtype and got[r].shape == blocks[r].shape
            assert rel_err(as_numpy(got[r]), as_numpy(blocks[r])) <= TOL[dtype], r


def _records(config, jconfig, dp, spec=None, size=64):
    jm, pm = _meshes(dp, spec)
    jsetup = jhybrid.hybrid_mode(jconfig, jm, size)
    psetup = hybrid.hybrid_mode(config, pm, size)
    return (jsetup.build_record(FAKE, FAKE_FULL, 0.005),
            psetup.build_record(FAKE, FAKE_FULL, 0.005), psetup)


def _same_record(jrec, rec):
    assert set(rec.extras) == set(jrec.extras) | {"cards", "ranks_per_card"}
    for key in jrec.extras:
        assert rec.extras[key] == jrec.extras[key], key
    assert rec.extras["cards"] == 1 and rec.extras["ranks_per_card"] == 8
    assert rec.tflops_total == pytest.approx(jrec.tflops_total, rel=1e-12)
    # the total over the one card the 8 ranks share
    assert rec.tflops_per_device == pytest.approx(jrec.tflops_per_device * 8, rel=1e-12)
    assert (rec.benchmark, rec.mode, rec.world, rec.avg_time_s, rec.compute_time_s,
            rec.comm_time_s) == (jrec.benchmark, jrec.mode, jrec.world, jrec.avg_time_s,
                                 jrec.compute_time_s, jrec.comm_time_s)


@pytest.mark.parametrize("dp", [1, 2, 8])
def test_record_extras_match_jax(devices, ranks8, dp):
    jrec, rec, _ = _records(_config(), _jax_config(), dp)
    _same_record(jrec, rec)


QUANT = ["int8-block:128", "dcn=fp8-block:32,ici=none"]


@pytest.mark.parametrize("comm_quant", QUANT)
@pytest.mark.parametrize("spec", ["dcn:2,ici:4", "dcn:4,ici:2"])
def test_factorized_mesh_wire_records_match_jax_and_validate(devices, ranks8, spec,
                                                             comm_quant):
    size = 512
    extra = ["--mesh", spec, "--comm-quant", comm_quant]
    config = _config(size, "bfloat16", "--validate", *extra)
    jrec, rec, psetup = _records(config, _jax_config(size, "bfloat16", *extra), None,
                                 spec, size)
    _same_record(jrec, rec)
    assert rec.extras["mesh"] == spec and "per_link" in rec.extras["comm_quant"]
    verdict = psetup.validate()
    assert verdict["validation"] == "ok", verdict
    assert verdict["validation_tolerance"] == modes.quantized_tolerance(
        comm_quant, int(spec.split(",")[0][4:]) + 1)


def test_memory_row_is_pure_and_counts_the_port_buffers(monkeypatch):
    import torch

    def no_alloc(*a, **k):
        raise AssertionError("the estimate touched the allocator")

    monkeypatch.setattr(torch, "empty", no_alloc)
    monkeypatch.setattr(torch, "zeros", no_alloc)
    config = _config(dtype="bfloat16")
    n = 16384
    got = modes.estimate_memory_gib("hybrid", config, 4, n, batch=4, dp=2)
    unit = n * n * 2 / 2**30
    # X shard (2) + W shard (1/2) in; products (1) + gathered (2) + batch
    # sum and psum result (2) out; the psum's fp32 accumulator (2 units)
    assert got == pytest.approx(unit * (2 + 0.5) + unit * (1 + 2 + 2) + 2 * unit)


def test_cli(ranks8, tmp_path, capsys):
    out = tmp_path / "h.jsonl"
    records = port_main.main(["hybrid", "--device", "cpu", "--num-devices", "8", "--dp", "4",
                              "--sizes", "64", "--iterations", "2", "--warmup", "1",
                              "--validate", "--timing", "fused", "--json-out", str(out)])
    assert len(records) == 1
    rec = records[0]
    assert (rec.mode, rec.world, rec.extras["dp"], rec.extras["tp"]) == ("hybrid", 8, 4, 2)
    assert rec.extras["validation"] == "ok" and rec.extras["timing"] == "fused"
    assert rec.extras["chain"] == "operand"
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert lines[-1]["mode"] == "hybrid"
    assert "Hybrid 2-D Mesh Benchmark" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        port_main.main(["hybrid", "--device", "cpu", "--mesh", "ici:4,dcn:2"])
    with pytest.raises(SystemExit) as e:
        port_main.main(["hybrid", "--device", "cpu", "--num-devices", "8", "--mesh", "dcn:8",
                        "--sizes", "64"])
    assert e.value.code == 1
    assert "hybrid needs a two-axis --mesh" in capsys.readouterr().out
    with pytest.raises(ValueError, match="--dp 3 must divide the 8-device world"):
        port_main.main(["hybrid", "--device", "cpu", "--num-devices", "8", "--dp", "3",
                        "--sizes", "64"])
