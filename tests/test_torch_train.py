"""The port's training step (`tpu_matmul_bench_torch/train/`) against the JAX
package's `train/`.

- One step: the JAX package's operands `(x, w0)` of `make_train_setup`
  cross to the port through numpy (`train_operands_from_numpy`, JAX's
  specs P(dp) and P(None, tp)), and the port's updated weights are held to
  JAX's step at fp32 within 1e-5 (relative Frobenius, both sum in fp32 in
  different orders), for dp and hybrid at zero 0 and 1.
- The drift series for fp8-block:16 and :128 against JAX's on the same
  operands: the wire's bits are JAX's (tests/test_torch_wire.py), so a
  point differs only through the fp32 products' summation order, which
  can move a gradient element across a quantization step, and the
  series' rounding to 10 decimals; each point is held within 0.1% of
  JAX's (1.75e-5 at most seen at 128² and 256²).
- The comms model's train half, the pure helpers and the record contract
  against JAX's; the call-log audit (JAX's TRAIN rules) clean on the tree
  and firing on seeded faults; the cumulative-prefix identity; the CLI,
  the selftest, and the `--matmul-impl cuda` refusal.
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import single_torch_thread  # noqa: F401

from tpu_matmul_bench.analysis import comms_model as jcm
from tpu_matmul_bench.parallel import mesh as jmesh
from tpu_matmul_bench.train import cli as jcli
from tpu_matmul_bench.train import harness as jharness
from tpu_matmul_bench.train import step as jstep
from tpu_matmul_bench.utils.reporting import BenchmarkRecord as JaxRecord
from tpu_matmul_bench_torch.analysis import comms_model as cm
from tpu_matmul_bench_torch.parallel import mesh
from tpu_matmul_bench_torch.parallel.mesh import gather
from tpu_matmul_bench_torch.train import audit, cli, harness, step
from tpu_matmul_bench_torch.utils.config import BenchConfig
from tpu_matmul_bench_torch.utils.device import resolve_devices
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord

pytestmark = pytest.mark.usefixtures("single_torch_thread")

SIZE = 128


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def _meshes(mode: str, spec: str | None = None):
    """(JAX mesh, port mesh) of 8 devices / ranks: the flat one for dp, a
    factorized one for hybrid (dcn:2,ici:4 unless `spec` says)."""
    devices, ranks = jax.devices()[:8], resolve_devices("cpu", 8)
    if mode == "dp" and spec is None:
        return jmesh.make_mesh(devices), mesh.make_mesh(ranks)
    spec = spec or "dcn:2,ici:4"
    return jmesh.make_factorized_mesh(devices, spec), mesh.make_factorized_mesh(ranks, spec)


def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except ValueError as e:
        return "ValueError", str(e)


def _frob(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_step(mode, zero, grad_quant=None, size=SIZE, spec=None):
    jm, pm = _meshes(mode, spec)
    js = jstep.make_train_setup(jm, mode, size, jnp.float32, zero=zero,
                                grad_quant=grad_quant)
    x, w0 = (np.asarray(t) for t in js.operands)
    ps = step.make_train_setup(pm, mode, size, torch.float32, zero=zero,
                               grad_quant=grad_quant)
    return js, ps, x, w0, step.train_operands_from_numpy(x, w0, pm, mode)


# ---------------------------------------------------------------- one step

@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("mode, spec", [("dp", None), ("hybrid", "dcn:2,ici:4"),
                                        ("hybrid", "dcn:4,ici:2")])
def test_step_matches_jax_at_fp32(ranks8, mode, spec, zero):
    js, ps, x, w0, (px, pw) = _jax_step(mode, zero, spec=spec)
    want = np.asarray(js.step(*js.operands))
    got = ps.step(px, pw)
    assert got.spec == pw.spec == (None, ps.tp_axis)
    assert _frob(gather(got).numpy(), want) <= 1e-5
    # and the dense references agree with each other
    assert _frob(ps.reference(px, pw).numpy(),
                 np.asarray(js.reference(*js.operands))) <= 1e-6


@pytest.mark.parametrize("mode", ["dp", "hybrid"])
def test_operands_cross_with_jax_shards(ranks8, mode):
    js, ps, x, w0, (px, pw) = _jax_step(mode, zero=False)
    jx, jw = js.operands
    for port, arr in ((px, jx), (pw, jw)):
        for r, dev in enumerate(arr.sharding.mesh.devices.flat):
            index = arr.sharding.devices_indices_map(arr.shape)[dev]
            np.testing.assert_array_equal(port[r].numpy(), np.asarray(arr)[index])


@pytest.mark.parametrize("block", [16, 128])
def test_drift_series_matches_jax(ranks8, block):
    jm, pm = _meshes("dp")
    jq = jstep.make_train_setup(jm, "dp", SIZE, jnp.float32, zero=True,
                                grad_quant=f"fp8-block:{block}")
    jx = jstep.make_train_setup(jm, "dp", SIZE, jnp.float32, zero=True)
    want = jharness.drift_series(jq, jx, 3)
    pq = step.make_train_setup(pm, "dp", SIZE, torch.float32, zero=True,
                               grad_quant=f"fp8-block:{block}")
    ops = step.train_operands_from_numpy(*(np.asarray(t) for t in jq.operands), pm, "dp")
    pq = dataclasses.replace(pq, operands=ops)
    px = step.make_train_setup(pm, "dp", SIZE, torch.float32, zero=True)
    got = harness.drift_series(pq, px, 3)
    assert harness.wire_active(pq)
    assert all(v > 0 for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_drift_grows_with_block(ranks8):
    _, pm = _meshes("dp")
    exact = step.make_train_setup(pm, "dp", SIZE, torch.float32, zero=True)
    finals = {}
    for block in (16, 128):
        q = step.make_train_setup(pm, "dp", SIZE, torch.float32, zero=True,
                                  grad_quant=f"fp8-block:{block}")
        series = harness.drift_series(q, exact, 3)
        assert series[-1] >= series[0] > 0
        finals[block] = series[-1]
    assert finals[128] >= finals[16]


def test_zero_equals_replicated_and_iterates(ranks8):
    _, pm = _meshes("hybrid", "dcn:4,ici:2")
    sz = step.make_train_setup(pm, "hybrid", SIZE, torch.float32, zero=True)
    sr = step.make_train_setup(pm, "hybrid", SIZE, torch.float32, zero=False)
    x, w = sz.operands
    assert harness._rel_err(sz.step(x, w), sr.step(x, w)) <= 1e-5
    for _ in range(2):
        w = sz.step(x, w)
    assert tuple(gather(w).shape) == (SIZE, SIZE)


def test_prefix_specs_and_shapes(ranks8):
    _, pm = _meshes("hybrid", "dcn:2,ici:4")
    s = step.make_train_setup(pm, "hybrid", 64, torch.float32, zero=True)
    outs = {p: s.prefixes[p](*s.operands) for p in step.PHASES}
    assert outs["fwd"].spec == ("dcn", None, "ici") and outs["fwd"][0].shape == (4, 64, 16)
    assert outs["bwd"].spec == ("dcn", "ici") and outs["bwd"][0].shape == (64, 16)
    for p in ("grad_comm", "update"):
        assert outs[p].spec == ("dcn", "ici") and outs[p][0].shape == (32, 16)
    assert outs["grad_comm"][0].dtype == torch.float32  # the sync hands on fp32
    assert outs["allgather"].spec == (None, "ici") and outs["allgather"][0].shape == (64, 16)


# ------------------------------------------------------- pure helpers vs JAX

def test_zero_shard_rows_match_jax():
    for size, r in ((256, 8), (256, 2), (64, 4), (12, 3)):
        assert step.zero_shard_rows(size, r) == jstep.zero_shard_rows(size, r)
    with pytest.raises(ValueError, match="must divide"):
        step.zero_shard_rows(100, 8)


def test_train_axes_match_jax(ranks8):
    for mode, spec in (("dp", None), ("hybrid", "dcn:2,ici:4"), ("dp", "ici:8"),
                       ("hybrid", "dcn:8")):
        jm, pm = _meshes(mode, spec)
        for m in ("dp", "hybrid", "pipeline"):
            assert _outcome(step.train_axes, pm, m) == _outcome(jstep.train_axes, jm, m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("gq", [None, "fp8-block:32", "int8-block:16",
                                "dcn=fp8-block:32,ici=none", "dcn=none,ici=int8-block:8"])
def test_train_tolerance_matches_jax(dtype, gq):
    for axis, world in (("dcn", 2), ("ici", 4), ("x", 8)):
        assert step.train_tolerance(dtype, gq, axis, world) == \
            jstep.train_tolerance(jnp.dtype(dtype), gq, axis, world)


@pytest.mark.parametrize("value", ["none", "fp8", "int8-block:32", "fp8-block:128",
                                   "dcn=fp8-block:32,ici=none", "int8", "int8-tensor",
                                   "int9", "fp8-block:0", "dcn=int8", "tor=fp8"])
def test_grad_quant_arg_matches_jax(value):
    def outcome(fn):
        try:
            return "ok", fn(value)
        except argparse.ArgumentTypeError as e:
            return "error", str(e)

    assert outcome(cli.grad_quant_arg) == outcome(jcli.grad_quant_arg)


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("mode, spec", [("dp", None), ("dp", "dcn:8"), ("dp", "ici:8"),
                                        ("hybrid", "dcn:2,ici:4"),
                                        ("hybrid", "dcn:4,ici:2"), ("hybrid", None),
                                        ("pipeline", None)])
def test_train_axis_collectives_match_jax(mode, spec, zero):
    for size in (256, 100):
        assert _outcome(cm.train_axis_collectives, mode, spec, 8, size, zero=zero) == \
            _outcome(jcm.train_axis_collectives, mode, spec, 8, size, zero=zero)


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("gq", [None, "fp8-block:32", "int8-block:128",
                                "dcn=fp8-block:32,ici=none", "dcn=none,ici=int8-block:16"])
@pytest.mark.parametrize("mode, spec", [("dp", None), ("hybrid", "dcn:2,ici:4"),
                                        ("hybrid", "dcn:4,ici:2")])
def test_train_expected_and_wire_bytes_match_jax(mode, spec, gq, zero):
    # at 256 a tp shard of dcn:2,ici:4 is 64 wide: int8-block:128 is
    # refused there by both, with the same message
    for dtype in ("bfloat16", "float32"):
        jdt = jnp.dtype(dtype)
        for port, ref in ((cm.train_expected_collectives, jcm.train_expected_collectives),
                          (cm.train_wire_bytes_summary, jcm.train_wire_bytes_summary)):
            assert _outcome(port, mode, spec, 8, 256, dtype, gq, zero=zero) == \
                _outcome(ref, mode, spec, 8, 256, jdt, gq, zero=zero)


def _record(cls, extras, world=8):
    return cls(benchmark="train", mode="dp", size=64, dtype="float32", world=world,
               iterations=2, warmup=1, avg_time_s=0.01, tflops_per_device=1.0,
               tflops_total=8.0, extras=extras)


def _train_block(**kw):
    block = {"zero": 1, "grad_quant": "none", "steps": 2, "lr": 0.01, "dp": 8, "tp": 1,
             "global_batch": 8, "local_batch": 1,
             "phases": {"fwd_s": 0.001, "bwd_s": 0.002, "grad_comm_s": 0.003,
                        "update_s": 0.0005, "allgather_s": 0.0005},
             "wall_s": 0.007, "update_drift": []}
    block.update(kw)
    return block


@pytest.mark.parametrize("case", [
    {}, {"train": "x"}, {"train": {}},
    {"train": _train_block()},
    {"train": _train_block(dp=4)},
    {"train": _train_block(global_batch=9)},
    {"train": _train_block(wall_s=0.5)},
    {"train": _train_block(phases={"fwd": 0.007})},
    {"train": _train_block(phases={})},
    {"train": _train_block(update_drift=[1e-6, 2e-6])},
    {"train": _train_block(update_drift=[1e-6, 2e-6], update_rel_err=2e-6)},
    {"train": _train_block(update_rel_err=2e-6)},
    {"train": _train_block(update_drift="x")},
    {"train": _train_block(wire=3)},
    {"train": _train_block(), "mesh": 5},
], ids=lambda c: json.dumps(c, sort_keys=True)[:60])
def test_validate_train_record_matches_jax(case):
    assert harness.validate_train_record(_record(BenchmarkRecord, case)) == \
        jharness.validate_train_record(_record(JaxRecord, case))


# ------------------------------------------------------------ the audit

def test_audit_clean_on_tree(ranks8):
    assert audit.audit_train(resolve_devices("cpu", 8)) == []


def test_audit_needs_eight_ranks():
    assert "not 8" in audit.audit_train(resolve_devices("cpu", 1))[0]


@pytest.mark.parametrize("gq", [None, "fp8-block:32"])
def test_call_log_is_the_model_and_not_the_other_zero(ranks8, gq):
    # the log of a ZeRO step is the ZeRO model's inventory, and differs
    # from the replicated model's: the check has teeth
    _, pm = _meshes("dp")
    s = step.make_train_setup(pm, "dp", 64, torch.bfloat16, batch=8, zero=True,
                              grad_quant=gq)
    with audit.record_collectives() as log:
        s.step(*s.operands)

    def model(zero):
        return sorted(e for e in cm.train_expected_collectives(
            "dp", None, 8, 64, torch.bfloat16, gq, batch=8, zero=zero))

    assert sorted(log) == model(True)
    assert sorted(log) != model(False)
    from tpu_matmul_bench_torch.parallel import collectives

    assert collectives.psum_over.__name__ == "psum_over"  # restored


def test_downcast_log_counts_float_narrowing_only():
    x = torch.ones(4, 4)
    with audit.record_downcasts() as log:
        x.to(torch.bfloat16)
        x.bfloat16().float()
        x.to(torch.int8)
        x.to(torch.float8_e4m3fn)
        torch.ones(2, dtype=torch.bfloat16) + x[0, :2]
    assert log == [("float32", "bfloat16"), ("float32", "bfloat16")]


def test_seeded_extra_downcast_fires_train_004(ranks8, monkeypatch):
    # a gradient sync that rounds the dequantized fp32 gradient to the
    # weight's dtype before the update breaks the one-downcast budget
    real = step.psum_impl

    def rounding_psum(spec, varying_out=False, fuse_f32=False):
        inner = real(spec, varying_out, fuse_f32)
        return lambda m, s: [t.to(torch.bfloat16).float() for t in inner(m, s)]

    monkeypatch.setattr(step, "psum_impl", rounding_psum)
    monkeypatch.setattr(audit, "TRAIN_CELLS", (("dp", None),))
    problems = audit.audit_train(resolve_devices("cpu", 8))
    assert problems and all(p.startswith("TRAIN-004") for p in problems)


# ---------------------------------------------------- record and programs

def _config(**kw):
    base = dict(sizes=[64], iterations=2, warmup=1, dtype_name="float32", device="cpu",
                num_devices=8, json_out=None, matmul_impl="auto", seed=0, mode="dp",
                validate=True)
    base.update(kw)
    return BenchConfig(**base)


@pytest.mark.parametrize("zero", [0, 1])
def test_record_telescopes_and_validates(ranks8, zero):
    _, pm = _meshes("dp")
    rec = harness.bench_one(_config(), pm, harness.TrainArgs(
        zero=bool(zero), grad_quant="fp8-block:16", steps=2), 64).finalize()
    assert harness.validate_train_record(rec) == []
    t = rec.extras["train"]
    assert t["phase_sum_s"] == pytest.approx(t["wall_s"], abs=1e-8)
    assert rec.avg_time_s == pytest.approx(t["wall_s"], abs=1e-9)
    assert len(t["update_drift"]) == 2 and t["update_rel_err"] == t["update_drift"][-1]
    assert t["wire"]["wire_format"] == "fp8-block:16"
    assert rec.extras["validation"] == "ok"
    assert (rec.extras["cards"], rec.extras["ranks_per_card"]) == (1, 8)
    assert rec.tflops_per_device == rec.tflops_total  # one card


def test_cuda_impl_refused_by_name(ranks8, capsys):
    with pytest.raises(ValueError, match="--matmul-impl cuda.*no backward"):
        harness.resolve_train_impl("cuda")
    assert harness.resolve_train_impl("auto") == harness.resolve_train_impl(None) == "torch"
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--device", "cpu", "--num-devices", "8", "--matmul-impl", "cuda"])
    assert e.value.code == 2
    assert "--matmul-impl cuda" in capsys.readouterr().err
    with pytest.raises(ValueError, match="no backward"):
        harness.bench_one(_config(matmul_impl="cuda"), _meshes("dp")[1],
                          harness.TrainArgs(), 64)


def test_bench_cli_writes_the_ledger(ranks8, tmp_path):
    out = tmp_path / "t.jsonl"
    recs = cli.main(["bench", "--device", "cpu", "--mode", "hybrid", "--mesh", "dcn:2,ici:4",
                     "--grad-quant", "dcn=fp8-block:16,ici=none", "--zero", "1",
                     "--steps", "2", "--sizes", "64", "--iterations", "2", "--warmup", "1",
                     "--validate", "--json-out", str(out)])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert lines[0]["record_type"] == "manifest" and len(lines) == 2
    rec = lines[1]
    assert rec["benchmark"] == "train" and rec["mode"] == "hybrid"
    assert rec["extras"]["mesh"] == "dcn:2,ici:4"
    assert rec["extras"]["train"]["wire"]["bottleneck_link"] == "dcn"
    assert rec["extras"]["validation"] == "ok"
    assert harness.validate_train_record(recs[0]) == []


@pytest.mark.parametrize("argv, msg", [
    (["--comm-quant", "int8"], "not --comm-quant"),
    (["--steps", "0"], "--steps must be"),
    (["--grad-quant", "int8"], "legacy control tier"),
    (["--zero", "2"], "invalid choice"),
])
def test_bench_cli_refusals(ranks8, capsys, argv, msg):
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--device", "cpu", *argv])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_bench_needs_the_card_unless_cpu_is_asked_for():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench", "--sizes", "64"])


def test_selftest_passes_over_eight_cpu_ranks(ranks8, capsys):
    cli.main(["selftest", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "train audit: 0 finding(s)" in out and "train selftest: OK" in out


def test_selftest_needs_eight_ranks(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["selftest", "--device", "cpu"])
    assert e.value.code == 1
    assert "needs 8 ranks" in capsys.readouterr().out


def test_usage_exit_codes(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    assert "bench" in capsys.readouterr().out
