"""The four quantizable modes under `--comm-quant`, against the JAX package's.

`batch_parallel`, `data_parallel` and `model_parallel` route their psum
through `collectives.psum_impl`, `matrix_parallel` its gather through
`allgather_impl`. The port's modes run on ranks that share the CPU, the JAX
package's on the conftest's 8-device mesh, from the same numpy operands.
The products on the two sides agree to fp32 rounding, and a wire format
may round a value one quantization step apart where they differ, so the
outputs are held to each other and to a float64 dense product within
`quantized_tolerance(spec, world)`, the JAX package's own rail for these
runs. Also: the records' `extras["comm_quant"]`, `quantized_tolerance`,
the inert labels (world 1, integer operands), the programs with the flag
unset (no key, today's outputs bit for bit), the CLI, and the build-time
refusal of a payload a format cannot cut.
"""

import functools
import itertools
import json

import jax
import numpy as np
import pytest
import torch
from torch_port_util import as_numpy, rel_err, single_torch_thread  # noqa: F401

from tpu_matmul_bench.benchmarks import matmul_distributed_benchmark as jax_dist
from tpu_matmul_bench.parallel import modes as jax_modes
from tpu_matmul_bench.parallel.mesh import make_mesh as jax_make_mesh
from tpu_matmul_bench.parallel.quantized import comm_quant_extra as jax_comm_quant_extra
from tpu_matmul_bench.utils.config import parse_config as jax_parse_config
from tpu_matmul_bench_torch import __main__ as port_main
from tpu_matmul_bench_torch.parallel import collectives, mesh, modes
from tpu_matmul_bench_torch.parallel.mesh import (
    REPLICATED,
    ROWS,
    Sharded,
    gather,
    shard_from_numpy,
)
from tpu_matmul_bench_torch.parallel.quantized import comm_quant_extra
from tpu_matmul_bench_torch.utils import timing
from tpu_matmul_bench_torch.utils.config import parse_config

pytestmark = pytest.mark.usefixtures("single_torch_thread")

QUANT_MODES = ["batch_parallel", "data_parallel", "matrix_parallel", "model_parallel"]
ALL_MODES = {**modes.SCALING_MODES, **modes.DISTRIBUTED_MODES}
JAX_ALL_MODES = {**jax_modes.SCALING_MODES, **jax_modes.DISTRIBUTED_MODES}
FORMATS = ["int8", "fp8", "int8-block:16", "fp8-block:16"]
SIZE = 128  # 16 columns a rank for matrix_parallel's gather at 8 ranks
SMALL = ["--iterations", "2", "--warmup", "1"]
FAKE = timing.Timing(total_s=0.02, iterations=2)
FAKE_FULL = timing.Timing(total_s=0.03, iterations=2)


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def port_mesh(d: int) -> mesh.Mesh:
    return mesh.make_mesh([torch.device("cpu")] * d)


def _config(spec=None, dtype="float32", size=SIZE, *extra):
    argv = ["--sizes", str(size), *SMALL, "--device", "cpu", "--dtype", dtype, *extra]
    if spec is not None:
        argv += ["--comm-quant", spec]
    return parse_config(argv, "t", modes=list(ALL_MODES), extra_dtypes=("int8",),
                        fused_timing=True, comm_quant=True)


def _jax_config(spec=None, dtype="float32", size=SIZE):
    argv = ["--sizes", str(size), *SMALL, "--dtype", dtype]
    if spec is not None:
        argv += ["--comm-quant", spec]
    return jax_parse_config(argv, "t", modes=list(JAX_ALL_MODES), extra_dtypes=("int8",),
                            fused_timing=True)


@functools.cache
def _jax_setup(mode: str, spec, d: int, dtype: str = "float32"):
    return JAX_ALL_MODES[mode](_jax_config(spec, dtype), jax_make_mesh(jax.devices()[:d]),
                               SIZE)


def _dense(mode: str, a: np.ndarray, b: np.ndarray, d: int) -> np.ndarray:
    """The full program's global output as a float64 product."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    if mode in ("batch_parallel", "data_parallel"):
        prods = np.einsum("bik,bkj->bij", a, b)
        lb = prods.shape[0] // d
        return np.concatenate([prods.reshape(d, lb, *prods.shape[1:]).sum(axis=0)] * d)
    return a @ b


def _rank_views(global_np: np.ndarray, spec: tuple, d: int) -> list[np.ndarray]:
    if mesh.AXIS not in spec:
        return [global_np] * d
    return np.split(global_np, d, axis=spec.index(mesh.AXIS))


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", [None, "none", "int8", "int8-tensor", "fp8", "int8-block:32",
                                  "fp8-block:16", "dcn=fp8,ici=int8-block:8", "dcn=none"])
def test_quantized_tolerance_matches_jax(spec, world):
    assert modes.quantized_tolerance(spec, world) == jax_modes.quantized_tolerance(spec, world)


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("spec", FORMATS)
@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quantized_modes_match_jax(devices, mode, spec, d):
    jsetup = _jax_setup(mode, spec, d)
    psetup = ALL_MODES[mode](_config(spec), port_mesh(d), SIZE)
    np_ops = [np.asarray(x) for x in jsetup.operands]
    ops = tuple(shard_from_numpy(x, p.spec, port_mesh(d))
                for x, p in zip(np_ops, psetup.operands))
    tol = modes.quantized_tolerance(spec, d)
    want = np.asarray(jsetup.full(*jsetup.operands)).astype(np.float64)
    collectives.WIRE_CALLS.clear()
    got = psetup.full(*ops)
    kind = "all_gather" if mode == "matrix_parallel" else "all_reduce"
    assert collectives.WIRE_CALLS == {("int8" if spec == "int8" else spec, kind): 1}
    assert isinstance(got, Sharded) and len(got) == d
    for r, (g, w) in enumerate(zip(got, _rank_views(want, got.spec, d))):
        assert tuple(g.shape) == w.shape, r
        assert rel_err(as_numpy(g), w) <= tol, r
    assert rel_err(as_numpy(gather(got)), _dense(mode, *np_ops, d)) <= tol


@pytest.mark.parametrize("spec", ["int8", "int8-block:16"])
@pytest.mark.parametrize("mode", ["data_parallel", "model_parallel"])
def test_bf16_quantized_modes_match_jax(devices, mode, spec):
    d = 4
    jsetup = _jax_setup(mode, spec, d, "bfloat16")
    psetup = ALL_MODES[mode](_config(spec, "bfloat16"), port_mesh(d), SIZE)
    ops = tuple(shard_from_numpy(np.asarray(x), p.spec, port_mesh(d))
                for x, p in zip(jsetup.operands, psetup.operands))
    want = np.asarray(jsetup.full(*jsetup.operands)).astype(np.float64)
    got = psetup.full(*ops)
    assert got[0].dtype == torch.bfloat16
    tol = modes.quantized_tolerance(spec, d)
    for g, w in zip(got, _rank_views(want, got.spec, d)):
        assert rel_err(as_numpy(g), w) <= tol


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("spec", FORMATS + ["int8-tensor"])
@pytest.mark.parametrize("mode", QUANT_MODES)
def test_records_match_jax(devices, mode, spec, d):
    jsetup = JAX_ALL_MODES[mode](_jax_config(spec), jax_make_mesh(jax.devices()[:d]), SIZE)
    psetup = ALL_MODES[mode](_config(spec), port_mesh(d), SIZE)
    jrec = jsetup.build_record(FAKE, FAKE_FULL, 0.005)
    rec = psetup.build_record(FAKE, FAKE_FULL, 0.005)
    assert set(rec.extras) == set(jrec.extras) | {"cards", "ranks_per_card"}
    for key in jrec.extras:
        assert rec.extras[key] == jrec.extras[key], key
    cq = rec.extras["comm_quant"]
    assert cq["spec"] == spec and cq["format"] == spec
    assert cq["payload_reduction_x"] == 4.0  # fp32 → a 1-byte wire


def test_bf16_record_halves_the_payload(devices):
    rec = ALL_MODES["model_parallel"](_config("int8-block:16", "bfloat16"), port_mesh(8),
                                      SIZE).build_record(FAKE, FAKE_FULL, 0.0)
    cq = rec.extras["comm_quant"]
    assert cq["block"] == 16 and cq["payload_reduction_x"] == 2.0
    assert 1.0 < cq["wire_reduction_x"] < cq["payload_reduction_x"]
    assert cq["wire_scale_bytes"] > 0


@pytest.mark.parametrize("spec", ["int8", "fp8", "int8-block:16"])
@pytest.mark.parametrize("mode", QUANT_MODES)
def test_validation_is_ok_within_the_quantized_tolerance(mode, spec):
    cfg = _config(spec, "bfloat16", SIZE, "--validate")
    rec = modes.run_mode_benchmark(ALL_MODES[mode](cfg, port_mesh(8), SIZE), cfg)
    assert rec.extras["validation"] == "ok", rec.extras
    assert rec.extras["validation_tolerance"] == modes.quantized_tolerance(spec, 8)


# ------------------------------------------------------ the inert labels

@pytest.mark.parametrize("quant", ["int8", "int8-tensor", "fp8", "int8-block:16",
                                   "fp8-block:16"])
def test_comm_quant_extra_flags_world_1(quant):
    cfg, jcfg = _config(quant), _jax_config(quant)
    assert comm_quant_extra(cfg, 1) == jax_comm_quant_extra(jcfg, 1) == \
        f"{quant} (inert at world=1)"
    assert comm_quant_extra(cfg, 8) == jax_comm_quant_extra(jcfg, 8) == quant


@pytest.mark.parametrize("quant", ["int8", "fp8", "int8-block:16"])
def test_comm_quant_extra_flags_integer_operands(quant):
    cfg, jcfg = _config(quant, "int8"), _jax_config(quant, "int8")
    assert comm_quant_extra(cfg, 8) == jax_comm_quant_extra(jcfg, 8)
    assert "inert" in comm_quant_extra(cfg, 8) and "integer" in comm_quant_extra(cfg, 8)


@pytest.mark.parametrize("quant", ["int8", "fp8-block:16"])
def test_comm_quant_extra_flags_degenerate_axes(quant):
    cfg, jcfg = _config(quant), _jax_config(quant)
    for dp, tp in ((1, 8), (8, 1), (2, 4)):
        assert comm_quant_extra(cfg, 8, dp=dp, tp=tp) == \
            jax_comm_quant_extra(jcfg, 8, dp=dp, tp=tp)


def test_matrix_parallel_world1_fallback_keeps_the_key(devices):
    cfg = _config("int8")
    rec = modes.run_mode_benchmark(ALL_MODES["matrix_parallel"](cfg, port_mesh(1), 64), cfg)
    jrec = jax_modes.run_mode_benchmark(
        JAX_ALL_MODES["matrix_parallel"](_jax_config("int8"), jax_make_mesh(devices[:1]), 64),
        _jax_config("int8"))
    assert rec.extras["comm_quant"] == jrec.extras["comm_quant"] == {
        "spec": "int8", "format": "int8 (inert at world=1)"}


def test_world1_batch_parallel_record_carries_the_flag(devices):
    cfg = _config("int8")
    rec = modes.run_mode_benchmark(ALL_MODES["batch_parallel"](cfg, port_mesh(1), 64), cfg)
    assert rec.extras["comm_quant"]["format"] == "int8 (inert at world=1)"
    assert "wire_payload_bytes" not in rec.extras["comm_quant"]


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_integer_operands_run_the_exact_program(mode):
    d = 4
    exact = ALL_MODES[mode](_config(None, "int8"), port_mesh(d), 64)
    quant = ALL_MODES[mode](_config("int8-block:16", "int8"), port_mesh(d), 64)
    collectives.WIRE_CALLS.clear()
    for g, w in zip(quant.full(*exact.operands), exact.full(*exact.operands)):
        assert torch.equal(g, w)
    assert collectives.WIRE_CALLS == {}
    label = quant.build_record(FAKE, FAKE_FULL, 0.0).extras["comm_quant"]["format"]
    assert label == "int8-block:16 (inert: integer operands take the exact collective)"


# -------------------------------------------------- the flag unset

def _todays_full(mode, pm):
    """The full program as it was before --comm-quant: the exact
    collectives called directly."""
    bmm = modes._stacked_mm(modes._mm(_config(), pm))
    mm = modes._mm(_config(), pm)
    return {"batch_parallel": modes._per_rank(bmm, ROWS, collectives.psum_over(pm)),
            "data_parallel": modes._per_rank(bmm, ROWS, collectives.psum_over(pm)),
            "matrix_parallel": modes._per_rank(
                mm, REPLICATED, collectives.all_gather_over(pm, gather_axis=1)),
            "model_parallel": modes._per_rank(mm, REPLICATED, collectives.psum_over(pm))}[mode]


@pytest.mark.parametrize("spec", [None, "none"])
@pytest.mark.parametrize("mode", QUANT_MODES)
def test_unset_flag_keeps_todays_program(mode, spec):
    pm = port_mesh(4)
    setup = ALL_MODES[mode](_config(spec, "bfloat16"), pm, 64)
    collectives.WIRE_CALLS.clear()
    got = setup.full(*setup.operands)
    want = _todays_full(mode, pm)(*setup.operands)
    assert got.spec == want.spec
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert collectives.WIRE_CALLS == {}
    assert "comm_quant" not in setup.build_record(FAKE, FAKE_FULL, 0.0).extras


def test_fused_timing_runs_the_wire(ranks8):
    cfg = _config("int8-block:16", "float32", SIZE, "--timing", "fused", "--validate")
    rec = modes.run_mode_benchmark(ALL_MODES["model_parallel"](cfg, port_mesh(4), SIZE), cfg)
    assert rec.extras["timing"] == "fused" and rec.extras["chain"] == "operand"
    assert rec.extras["validation"] == "ok"


def test_factorized_mesh_waits_for_a9():
    # A9 is in: on a factorized mesh the record's extra is JAX's per-link
    # one (the 2-D modes), or JAX's label alone where no two-level model
    # covers the mode
    from tpu_matmul_bench.parallel.collectives import (
        comm_quant_record_extra as jax_comm_quant_record_extra,
    )

    for spec, mesh_spec in itertools.product(
            ("int8", "int8-block:32", "dcn=fp8-block:32,ici=none"),
            ("dcn:2,ici:4", "dcn:4,ici:2")):
        for mode, kw in (("hybrid", {"dp": int(mesh_spec[4])}), ("summa", {}),
                         ("model_parallel", {})):
            got = collectives.comm_quant_record_extra(
                _config(spec, size=256), 8, mode=mode, size=256, mesh_spec=mesh_spec, **kw)
            want = jax_comm_quant_record_extra(
                _jax_config(spec, size=256), 8, mode=mode, size=256, mesh_spec=mesh_spec,
                **kw)
            assert got == want, (mesh_spec, mode)
            assert ("per_link" in got) == (mode != "model_parallel")


# ------------------------------------------- the build-time refusal, the CLI

@pytest.mark.parametrize("mode,spec", [("model_parallel", "int8-block:128"),
                                       ("matrix_parallel", "fp8-block:16"),
                                       ("batch_parallel", "int8-block:48")])
def test_a_payload_the_format_cannot_cut_fails_at_build(devices, mode, spec):
    d = 8
    jsetup = JAX_ALL_MODES[mode](_jax_config(spec, size=64), jax_make_mesh(devices[:d]), 64)
    with pytest.raises(ValueError) as want:
        jsetup.full(*jsetup.operands)
    with pytest.raises(ValueError) as got:
        ALL_MODES[mode](_config(spec, size=64), port_mesh(d), 64)
    assert str(got.value) == str(want.value)


def test_cli_model_parallel_int8_block_128_matches_jax(ranks8, tmp_path):
    argv = ["--mode", "model_parallel", "--comm-quant", "int8-block:128", "--num-devices",
            "8", "--sizes", "256", "--validate", *SMALL, "--dtype", "float32"]
    jax_dist.main([*argv, "--json-out", str(tmp_path / "jax.jsonl")])
    port_main.main(["distributed", *argv, "--device", "cpu",
                    "--json-out", str(tmp_path / "port.jsonl")])
    lines = {side: [json.loads(x) for x in (tmp_path / f"{side}.jsonl").read_text().splitlines()]
             for side in ("jax", "port")}
    (jrec,), (rec,) = lines["jax"][1:], lines["port"][1:]
    assert rec["extras"]["validation"] == "ok"
    assert rec["extras"]["comm_quant"] == jrec["extras"]["comm_quant"]
    assert rec["extras"]["validation_tolerance"] == jrec["extras"]["validation_tolerance"]


def test_cli_refuses_a_size_the_block_cannot_cut(ranks8, capsys):
    argv = ["--mode", "model_parallel", "--comm-quant", "int8-block:128", "--num-devices",
            "8", "--sizes", "64", "--validate", *SMALL, "--dtype", "float32"]
    assert port_main.main(["distributed", *argv, "--device", "cpu"]) == []
    assert ("--comm-quant int8-block:128: block size 128 must divide the collective "
            "payload's last dim (64)") in capsys.readouterr().out


@pytest.mark.parametrize("spec", ["int8-block:0", "fp16", "dcn=int8", "ici=fp8,ici=fp8"])
def test_cli_bad_spec_exits_2_with_jaxs_message(ranks8, capsys, spec):
    with pytest.raises(SystemExit) as jexit:
        jax_dist.main(["--comm-quant", spec])
    jerr = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as pexit:
        port_main.main(["distributed", "--device", "cpu", "--comm-quant", spec])
    err = capsys.readouterr().err.strip().splitlines()[-1]
    assert jexit.value.code == pexit.value.code == 2
    assert err.split("error: ", 1)[1] == jerr.split("error: ", 1)[1]


@pytest.mark.parametrize("program", ["overlap", "collectives", "matmul", "tune"])
def test_only_the_quantizable_programs_take_the_flag(program, capsys):
    with pytest.raises(SystemExit) as e:
        port_main.main([program, "--device", "cpu", "--comm-quant", "int8"])
    assert e.value.code == 2
    assert "unrecognized arguments: --comm-quant" in capsys.readouterr().err
