"""The port's out-of-core K-streaming (`tpu_matmul_bench_torch/ops/
stream_k.py`, `parallel/stream_k.py`, `analysis/memory_model.py`,
`parallel/cli.py`) against the JAX package's.

- `StreamPlan`'s errors are JAX's, message for message.
- `stream_window_bytes` and `check_stream_budget` (MEM-003: rule, severity,
  where, text and details) equal JAX's on a table of cases, the two of
  `tests/test_lint.py` among them; with R ranks a device the gate
  certifies R times a rank's window; the default budget is the device's
  own memory (on the CPU, its physical memory).
- `host_operands` gives JAX's bits for a seed; the pinned-memory layout
  keeps each rank's window slab whole.
- `stream_matmul` against JAX's at 256 fp32 on `dcn:2,ici:4`, 8 panels
  (max relative error ≤ 1e-5, the JAX selftest's bound), and int8 exactly,
  under K1's pickup and under the library product.
- `parallel stream` over its budget exits 1, printing JAX's MEM GATE line,
  before `host_operands` is called; a run in budget validates and records
  the certificate; `parallel hier selftest --device cpu` exits 0.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_port_util import single_torch_thread  # noqa: F401

from tpu_matmul_bench.analysis import memory_model as jmm
from tpu_matmul_bench.ops import stream_k as jops
from tpu_matmul_bench.parallel import mesh as jmesh
from tpu_matmul_bench.parallel import stream_k as jstream
from tpu_matmul_bench.utils.config import build_parser as jax_build_parser
from tpu_matmul_bench.utils.config import config_from_args as jax_config_from_args
from tpu_matmul_bench_torch import __main__ as port_main
from tpu_matmul_bench_torch.analysis import memory_model as mm
from tpu_matmul_bench_torch.ops import stream_k as ops
from tpu_matmul_bench_torch.parallel import mesh
from tpu_matmul_bench_torch.parallel import stream_k as pstream
from tpu_matmul_bench_torch.utils.config import build_parser, config_from_args
from tpu_matmul_bench_torch.utils.device import resolve_devices

pytestmark = pytest.mark.usefixtures("single_torch_thread")


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except ValueError as e:
        return "ValueError", str(e)


PLANS = [(256, 8, 2, 8), (256, 0, 2, 1), (256, -4, 2, 1), (256, 3, 1, 1), (256, 8, 3, 1),
         (256, 8, 0, 1), (256, 8, 2, 3), (100, 4, 2, 8), (4096, 16, 2, 4)]


@pytest.mark.parametrize("plan", PLANS)
def test_plan_errors_match_jax(plan):
    size, panels, window, world = plan
    got = _outcome(ops.StreamPlan, size=size, panels=panels, window=window, world=world)
    want = _outcome(jops.StreamPlan, size=size, panels=panels, window=window, world=world)
    assert got[0] == want[0]
    if got[0] == "ok":
        assert (got[1].panel_k, got[1].num_windows) == (want[1].panel_k, want[1].num_windows)
        assert got[1].window_k == window * got[1].panel_k
    else:
        assert got[1] == want[1]


BUDGETS = [  # (size, dtype, world, panels, window, budget GiB)
    (4096, "bfloat16", 8, 4, 2, 0.001),  # tests/test_lint.py: trips MEM-003
    (1024, "bfloat16", 8, 8, 2, 1.0),    # tests/test_lint.py: certifies clean
    (32768, "bfloat16", 1, 16, 2, 5.5),
    (32768, "bfloat16", 1, 8, 2, 5.5),
    (32768, "float32", 1, 16, 2, 5.5),
    (8192, "int8", 4, 8, 2, 0.05),
    (8192, "float16", 2, 4, 2, 16.0),
]


@pytest.mark.parametrize("case", BUDGETS, ids=lambda c: "-".join(map(str, c)))
def test_window_bytes_and_gate_match_jax(case):
    size, dtype, world, panels, window, budget = case
    jdtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    assert mm.stream_window_bytes(size, dtype, world, panels, window) == \
        jmm.stream_window_bytes(size, jdtype, world, panels, window)
    assert mm.stream_window_bytes(size, getattr(torch, dtype), world, panels, window) == \
        jmm.stream_window_bytes(size, jdtype, world, panels, window)
    got = mm.check_stream_budget(size, dtype, world, panels, window, budget_gib=budget)
    want = jmm.check_stream_budget(size, jdtype, world, panels, window, budget_gib=budget)
    assert [(f.rule, f.severity, f.where, f.message, f.details) for f in got] == \
        [(f.rule, f.severity, f.where, f.message, f.details) for f in want]


def test_gate_counts_every_rank_on_a_device():
    one = mm.stream_window_bytes(32768, "bfloat16", 4, 16)
    assert mm.check_stream_budget(32768, "bfloat16", 4, 16, budget_gib=one / 2**30) == []
    (f,) = mm.check_stream_budget(32768, "bfloat16", 4, 16, budget_gib=one / 2**30,
                                  ranks_per_card=4)
    assert f.rule == "MEM-003" and f.severity == "error"
    assert f.details["resident_bytes"] == 4 * one and "(4 ranks)" in f.message
    with pytest.raises(ValueError, match="unknown rule id"):
        mm.Finding("MEM-999", "w", "m")


def test_default_budget_is_the_device_memory():
    import os

    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 2**30
    assert mm.default_budget_gib("cpu") == ram
    assert ram != jmm.DEFAULT_BUDGET_GIB


def _config(*extra, dtype="float32", size=256):
    return config_from_args(build_parser("t", extra_dtypes=("int8",), mesh=True,
                                         stream=True).parse_args(
        ["--sizes", str(size), "--dtype", dtype, "--device", "cpu", *extra]))


def _jax_config(dtype="float32", size=256):
    return jax_config_from_args(jax_build_parser("t", extra_dtypes=("int8",)).parse_args(
        ["--sizes", str(size), "--dtype", dtype]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8"])
def test_host_operands_are_jax_bits(dtype):
    a, b = pstream.host_operands(_config(dtype=dtype, size=64), 64)
    ja, jb = jstream.host_operands(_jax_config(dtype, 64), 64)
    for got, want in ((a, ja), (b, jb)):
        assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
        bits = got.view(torch.int16) if dtype == "bfloat16" else got
        wbits = want.view(np.int16) if dtype == "bfloat16" else want
        np.testing.assert_array_equal(bits.numpy(), wbits)


def test_host_layout_keeps_window_slabs_whole():
    plan = ops.StreamPlan(size=64, panels=8, window=2, world=4)
    a = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)
    host = ops.stage_host(a, a.t().contiguous(), plan, pin=False)
    assert host.a.shape == (4, 4, 16, 16) and host.a.is_contiguous()
    for r in range(4):
        for w in range(4):
            assert torch.equal(host.a[r, w], a[r * 16:(r + 1) * 16, w * 16:(w + 1) * 16])


@pytest.mark.parametrize("impl", ["cuda", "torch"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_stream_matmul_matches_jax(devices, ranks8, dtype, impl):
    size, spec = 256, "dcn:2,ici:4"
    plan = ops.StreamPlan(size=size, panels=8, window=2, world=8)
    ja, jb = jstream.host_operands(_jax_config(dtype, size), size)
    want = np.asarray(jax.device_get(jops.stream_matmul(
        ja, jb, jmesh.make_factorized_mesh(devices, spec), jops.StreamPlan(size, 8, 2, 8))))
    pm = mesh.make_factorized_mesh(resolve_devices("cpu", 8), spec)
    a, b = pstream.host_operands(_config(dtype=dtype, size=size), size)
    got = ops.stream_matmul(ops.stage_host(a, b, plan, pin=False), pm, impl)
    assert got.spec == (("dcn", "ici"), None) and len(got) == 8
    assert got[0].dtype == (torch.int32 if dtype == "int8" else torch.float32)
    full = mesh.gather(got).numpy()
    assert full.dtype == want.dtype
    if dtype == "int8":
        np.testing.assert_array_equal(full, want)
    else:
        exact = a.double().numpy() @ b.double().numpy()
        err = np.abs(full - want).max() / np.abs(want).max()
        assert err <= 1e-5
        assert np.abs(full - exact).max() / np.abs(exact).max() <= 1e-5


def test_stream_over_budget_exits_before_allocating(ranks8, monkeypatch, capsys):
    def no_operands(*a, **k):
        raise AssertionError("host_operands ran before the gate")

    monkeypatch.setattr(pstream, "host_operands", no_operands)
    with pytest.raises(SystemExit) as e:
        port_main.main(["parallel", "stream", "--device", "cpu", "--num-devices", "8",
                        "--sizes", "4096", "--stream-k", "4", "--mem-budget-gib", "0.001"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "MEM GATE [error] MEM-003 mem:stream_k@d8: streaming resident window" in out


def test_stream_program_certifies_and_validates(ranks8, tmp_path):
    out = tmp_path / "s.jsonl"
    records = port_main.main([
        "parallel", "--device", "cpu", "--num-devices", "8", "stream", "--mesh",
        "dcn:4,ici:2", "--sizes", "256", "--stream-k", "8", "--mem-budget-gib", "0.002",
        "--matmul-impl", "cuda", "--iterations", "2", "--validate", "--json-out", str(out)])
    (rec,) = records
    cert = rec.extras["stream_k"]
    assert (rec.benchmark, rec.mode, rec.world) == ("stream", "stream_k", 8)
    assert rec.extras["validation"] == "ok" and rec.extras["mesh"] == "dcn:4,ici:2"
    assert cert["budget_gib"] == 0.002 and cert["ranks_per_card"] == 8
    assert cert["resident_gib"] == round(
        mm.stream_window_bytes(256, "bfloat16", 8, 8) / 2**30, 4)
    # 8 ranks' in-core `independent` (3 matrices of 256² bf16 each) busts it
    assert cert["out_of_core"] and "independent" in cert["nonstreaming_over_budget"]
    assert set(cert) == set(jstream.stream_gate(_jax_config("bfloat16"), 256, 8)[1]) | {
        "ranks_per_card"}


def test_hier_selftest_is_refused_by_name(capsys):
    # the selftest is ported: on the CPU it certifies COLL-H, the MEM gate
    # both ways and the streamed product; only unknown subcommands refuse
    port_main.main(["parallel", "hier", "selftest", "--device", "cpu"])
    assert "hier selftest: OK" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        port_main.main(["parallel", "nonsense"])
    assert e.value.code == 2
