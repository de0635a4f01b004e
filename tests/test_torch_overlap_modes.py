"""The overlap program's seven library modes against the JAX package's.

`no_overlap`, `overlap` and `pipeline` (`parallel/overlap.py StepProgram`,
JAX `_steps_program`/`_fill_ring`/`overlap_mode`) and the four
collective-matmul rings (`CollectiveMatmul`, JAX `collective_matmul*`) run on
8 ranks that share the CPU (`TMB_RANKS_PER_CARD=8`), the JAX package's on
the conftest's 8-device CPU mesh. The same numpy operands, made from a seed,
go through both; the outputs are held to each other and to a float64
reference: fp32 within rtol = atol = 1e-4 (the JAX tests' own,
`tests/test_overlap.py`), bf16 within `modes.validation_tolerance`, int8
exactly. Also: the records against JAX's, the three-variant split, the
bidirectional guards, the memory rows, the default mode, fused timing, and
the streams' event order (the write-after-read hazard of the step rings).
"""

import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from torch_port_util import as_numpy, rel_err, single_torch_thread  # noqa: F401

from tpu_matmul_bench.benchmarks import matmul_overlap_benchmark as jax_overlap_bench
from tpu_matmul_bench.parallel import mesh as jax_mesh
from tpu_matmul_bench.parallel import modes as jax_modes
from tpu_matmul_bench.parallel import overlap as jax_ovl
from tpu_matmul_bench.utils.config import parse_config as jax_parse_config
from tpu_matmul_bench_torch.analysis.recording import record_schedule
from tpu_matmul_bench_torch.benchmarks import matmul_overlap_benchmark as overlap_bench
from tpu_matmul_bench_torch.ops import cuda_ring as cr
from tpu_matmul_bench_torch.parallel import mesh, modes
from tpu_matmul_bench_torch.parallel import overlap as ovl
from tpu_matmul_bench_torch.parallel.mesh import COLS, ROWS, gather, shard_from_numpy
from tpu_matmul_bench_torch.utils import timing
from tpu_matmul_bench_torch.utils.config import parse_config
from tpu_matmul_bench_torch.utils.device import resolve_devices

pytestmark = pytest.mark.usefixtures("single_torch_thread")

D = 8
N = 32  # the step programs' matrices
STEPS = 7  # past k + 1 for pipeline's k = 3, so every slot is written twice
DTYPES = ["float32", "bfloat16", "int8"]
STEP_MODES = ["no_overlap", "overlap", "pipeline"]
RING_MODES = ["collective_matmul", "collective_matmul_bidir", "collective_matmul_rs",
              "collective_matmul_bidir_rs"]
LIBRARY_MODES = STEP_MODES + RING_MODES
SMALL = ["--sizes", "64", "--iterations", "2", "--warmup", "1", "--dtype", "float32"]
NBUF = {"no_overlap": 1, "overlap": 2, "pipeline": 3}


@pytest.fixture
def ranks8(monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "8")


def port_mesh(d: int = D) -> mesh.Mesh:
    return mesh.make_mesh(resolve_devices("cpu", d))


def _jax_mesh(d: int = D):
    return jax_mesh.make_mesh(jax.devices()[:d])


def _jax_put(arr, jmesh, spec):
    return jax.device_put(jnp.asarray(arr), NamedSharding(jmesh, P(*spec)))


def _config(*extra):
    return parse_config([*SMALL, "--device", "cpu", *extra], "t",
                        modes=list(ovl.OVERLAP_MODES), default_mode="overlap",
                        extra_dtypes=("int8",), fused_timing=True)


def _jax_config(*extra):
    return jax_parse_config([*SMALL, *extra], "t", modes=list(jax_ovl.OVERLAP_MODES),
                            extra_dtypes=("int8",), fused_timing=True)


def _numpy(seed: int, shape: tuple, dtype_name: str) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype_name == "int8":
        return rng.integers(-8, 8, size=shape).astype(np.int8)
    np_dtype = ml_dtypes.bfloat16 if dtype_name == "bfloat16" else np.float32
    return rng.standard_normal(shape).astype(np_dtype)


def _assert_close(got: np.ndarray, want: np.ndarray, dtype_name: str) -> None:
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    elif dtype_name == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        assert rel_err(got, want) <= modes.validation_tolerance(dtype_name)


# ------------------------------------------------ the step programs' outputs

def _step_operands(variant: str, dtype_name: str):
    """a, b: [D·nbuf, N, N] (nbuf = 1, 2, 3 as each variant's mode has)."""
    base = variant.removesuffix("_nocomm")
    nbuf = NBUF.get(base, 1)
    return (_numpy(11, (D * nbuf, N, N), dtype_name),
            _numpy(12, (D * nbuf, N, N), dtype_name))


@functools.cache
def _jax_steps(variant: str, dtype_name: str) -> tuple[np.ndarray, np.ndarray | None]:
    """JAX's per-step scalars of one variant, and the ring it filled."""
    jmesh = _jax_mesh()
    a_np, b_np = _step_operands(variant, dtype_name)
    a, b = _jax_put(a_np, jmesh, ("x",)), _jax_put(b_np, jmesh, ("x",))
    ops = (a, b)
    base = variant.removesuffix("_nocomm")
    ring0 = None
    if base in ("overlap", "pipeline"):
        ring0 = np.asarray(jax_ovl._fill_ring(jmesh, NBUF[base])(a, b))
        ops = (a, b, _jax_put(ring0, jmesh, ("x",)))
    out = jax_ovl._steps_program(jmesh, variant, STEPS)(*ops)
    return np.asarray(out), ring0


def _dense_steps(variant: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The float64 reference: rank r's scalar of step i is (A·B)[0, 0] of
    its pair s (0, or i mod k for the rings), summed over the ranks where
    the variant sums."""
    base = variant.removesuffix("_nocomm")
    nbuf = a.shape[0] // D
    k = NBUF[base] if base in ("overlap", "pipeline") else 1
    corner = (a[:, 0, :].astype(np.float64) * b[:, :, 0].astype(np.float64)).sum(-1)
    corner = corner.reshape(D, nbuf)  # [rank, pair]
    out = np.empty((D, STEPS))
    for i in range(STEPS):
        s = (i % k) % nbuf
        summed = variant in ("no_overlap", "overlap", "pipeline")
        out[:, i] = corner[:, s].sum() if summed else corner[:, s]
    return out.reshape(-1)


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("variant", ovl.STEP_VARIANTS)
def test_steps_program_matches_jax_and_dense(devices, ranks8, variant, dtype_name):
    want, ring0 = _jax_steps(variant, dtype_name)
    a_np, b_np = _step_operands(variant, dtype_name)
    pmesh = port_mesh()
    ops = [shard_from_numpy(a_np, ROWS, pmesh), shard_from_numpy(b_np, ROWS, pmesh)]
    if ring0 is not None:
        ops.append(shard_from_numpy(ring0, ROWS, pmesh))
    dense = _dense_steps(variant, a_np, b_np)
    for impl in ("torch", "cuda"):
        out = ovl.StepProgram(pmesh, variant, STEPS, impl)(*ops)
        assert len(out) == D and out.spec == ROWS and out[0].shape == (STEPS,)
        got = as_numpy(gather(out))
        assert str(gather(out).dtype).removeprefix("torch.") == want.dtype.name
        _assert_close(got, want, dtype_name)
        if dtype_name == "bfloat16":  # products rounded to bf16 before the sum
            assert rel_err(got, dense) <= modes.validation_tolerance(dtype_name)
        else:
            _assert_close(got, dense.astype(want.dtype), dtype_name)


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("k", [2, 3])
def test_fill_ring_matches_jax(devices, ranks8, k, dtype_name):
    a_np, b_np = _numpy(21, (D * k, N, N), dtype_name), _numpy(22, (D * k, N, N), dtype_name)
    jmesh = _jax_mesh()
    want = np.asarray(jax_ovl._fill_ring(jmesh, k)(_jax_put(a_np, jmesh, ("x",)),
                                                   _jax_put(b_np, jmesh, ("x",))))
    pmesh = port_mesh()
    ring = ovl.fill_ring(pmesh, k)(shard_from_numpy(a_np, ROWS, pmesh),
                                   shard_from_numpy(b_np, ROWS, pmesh))
    assert ring.spec == ROWS and ring[0].shape == (k, N, N)
    _assert_close(as_numpy(gather(ring)), want, dtype_name)


def test_steps_leave_the_ring_and_repeat(ranks8):
    # ring0 is never written, so a second call gives the first call's answer
    pmesh = port_mesh(4)
    a_np, b_np = _numpy(31, (12, N, N), "float32"), _numpy(32, (12, N, N), "float32")
    a, b = shard_from_numpy(a_np, ROWS, pmesh), shard_from_numpy(b_np, ROWS, pmesh)
    ring0 = ovl.fill_ring(pmesh, 3)(a, b)
    before = [r.clone() for r in ring0]
    prog = ovl.StepProgram(pmesh, "pipeline", STEPS)
    first, second = gather(prog(a, b, ring0)), gather(prog(a, b, ring0))
    assert torch.equal(first, second)
    assert all(torch.equal(x, y) for x, y in zip(before, ring0))


def test_unknown_variant_raises():
    with pytest.raises(ValueError):
        ovl.StepProgram(port_mesh(1), "no_such_variant", STEPS)


# --------------------------------------- the collective-matmul rings' outputs

JAX_PROGRAMS = {
    "collective_matmul": lambda m: jax_ovl.collective_matmul_program(m, overlap=True),
    "collective_matmul_bidir": jax_ovl.collective_matmul_bidir_program,
    "collective_matmul_rs": lambda m: jax_ovl.collective_matmul_rs_program(m, overlap=True),
    "collective_matmul_bidir_rs": jax_ovl.collective_matmul_bidir_rs_program,
}
PORT_PROGRAMS = {
    "collective_matmul": lambda m, impl: ovl.collective_matmul_program(m, impl=impl),
    "collective_matmul_bidir": lambda m, impl: ovl.collective_matmul_bidir_program(m, impl),
    "collective_matmul_rs": lambda m, impl: ovl.collective_matmul_rs_program(m, impl=impl),
    "collective_matmul_bidir_rs": lambda m, impl: ovl.collective_matmul_bidir_rs_program(m, impl),
}


def _ring_specs(form: str) -> tuple[tuple, tuple]:
    return (COLS, ROWS) if form.endswith("_rs") else (ROWS, COLS)


@functools.cache
def _jax_ring(form: str, size: int, dtype_name: str) -> np.ndarray:
    jmesh = _jax_mesh()
    x_spec, w_spec = _ring_specs(form)
    x_np, w_np = _numpy(41, (size, size), dtype_name), _numpy(42, (size, size), dtype_name)
    return np.asarray(JAX_PROGRAMS[form](jmesh)(_jax_put(x_np, jmesh, x_spec),
                                                _jax_put(w_np, jmesh, w_spec)))


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("size", [64, 72])  # 72 / 8 = 9 rows a shard: odd halves
@pytest.mark.parametrize("form", RING_MODES)
def test_collective_matmul_matches_jax_and_dense(devices, ranks8, form, size, dtype_name):
    want = _jax_ring(form, size, dtype_name)
    x_np, w_np = _numpy(41, (size, size), dtype_name), _numpy(42, (size, size), dtype_name)
    dense = x_np.astype(np.float64) @ w_np.astype(np.float64)
    pmesh = port_mesh()
    x_spec, w_spec = _ring_specs(form)
    x, w = shard_from_numpy(x_np, x_spec, pmesh), shard_from_numpy(w_np, w_spec, pmesh)
    for impl in ("torch", "cuda"):
        y = PORT_PROGRAMS[form](pmesh, impl)(x, w)
        assert y.spec == (ROWS if form.endswith("_rs") else COLS)
        got = gather(y)
        assert tuple(got.shape) == (size, size)
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name
        _assert_close(as_numpy(got), want, dtype_name)
        if dtype_name == "bfloat16":
            assert rel_err(as_numpy(got), dense) <= modes.validation_tolerance(dtype_name)
        else:
            _assert_close(as_numpy(got), dense.astype(want.dtype), dtype_name)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("form", RING_MODES)
def test_collective_matmul_at_few_ranks(ranks8, form, d):
    # one rank (no hop), two, and an odd ring: the dense product each time
    size = 6 * d
    x_np, w_np = _numpy(43, (size, size), "float32"), _numpy(44, (size, size), "float32")
    pmesh = port_mesh(d)
    x_spec, w_spec = _ring_specs(form)
    y = PORT_PROGRAMS[form](pmesh, "cuda")(shard_from_numpy(x_np, x_spec, pmesh),
                                           shard_from_numpy(w_np, w_spec, pmesh))
    np.testing.assert_allclose(gather(y).numpy(), x_np @ w_np, rtol=1e-4, atol=1e-4)


def test_reduce_scatter_rounds_every_step_in_the_output_dtype(ranks8):
    # acc + mm(rows, w) in bf16 at each step, as JAX's form: the port's ring
    # equals a bf16 replay of that arithmetic bit for bit
    d, size = 4, 16
    x_np, w_np = _numpy(45, (size, size), "bfloat16"), _numpy(46, (size, size), "bfloat16")
    pmesh = port_mesh(d)
    y = ovl.collective_matmul_rs_program(pmesh)(shard_from_numpy(x_np, COLS, pmesh),
                                                shard_from_numpy(w_np, ROWS, pmesh))
    x = [torch.from_numpy(np.ascontiguousarray(s).view(np.int16)).view(torch.bfloat16)
         for s in np.split(x_np, d, axis=1)]
    w = [torch.from_numpy(np.ascontiguousarray(s).view(np.int16)).view(torch.bfloat16)
         for s in np.split(w_np, d, axis=0)]
    mshard = size // d
    for c in range(d):  # chunk c starts at rank c+1 and ends at rank c
        acc = torch.zeros(mshard, size, dtype=torch.bfloat16)
        for j in range(1, d + 1):
            q = (c + j) % d
            acc = acc + torch.matmul(x[q][c * mshard:(c + 1) * mshard], w[q])
        assert torch.equal(y[c], acc)


@pytest.mark.parametrize("form", RING_MODES)
def test_products_a_call(ranks8, form):
    # the products each form runs, in issue order: the bidirectional
    # all-gather form's step 0 is one full-height product a rank
    d, size = 4, 16
    mshard, h = size // d, size // d // 2
    pmesh = port_mesh(d)
    prog = PORT_PROGRAMS[form](pmesh, "torch")
    shapes = []
    real = prog.mm
    prog.mm = lambda a, b, out=None: shapes.append(tuple(a.shape)) or real(a, b, out=out)
    x_spec, w_spec = _ring_specs(form)
    y = prog(shard_from_numpy(_numpy(49, (size, size), "float32"), x_spec, pmesh),
             shard_from_numpy(_numpy(50, (size, size), "float32"), w_spec, pmesh))
    k = size if form in ("collective_matmul", "collective_matmul_bidir") else size // d
    halves = [(h, k), (mshard - h, k)]
    want = {"collective_matmul": [(mshard, k)] * d * d,
            "collective_matmul_bidir": [(mshard, k)] * d + halves * d * (d - 1),
            "collective_matmul_rs": [(mshard, k)] * d * d,
            "collective_matmul_bidir_rs": halves * d * d}[form]
    assert shapes == want
    assert len(y) == d


@pytest.mark.parametrize("form", ["collective_matmul_bidir", "collective_matmul_bidir_rs"])
def test_bidir_guards_match_jax(devices, ranks8, form):
    # one row a rank would leave the forward half empty: both refuse, with
    # JAX's message
    x_spec, w_spec = _ring_specs(form)
    x_np, w_np = _numpy(47, (D, D), "float32"), _numpy(48, (D, D), "float32")
    jmesh = _jax_mesh()
    with pytest.raises(ValueError) as jerr:
        JAX_PROGRAMS[form](jmesh)(_jax_put(x_np, jmesh, x_spec), _jax_put(w_np, jmesh, w_spec))
    pmesh = port_mesh()
    with pytest.raises(ValueError) as perr:
        PORT_PROGRAMS[form](pmesh, "torch")(shard_from_numpy(x_np, x_spec, pmesh),
                                            shard_from_numpy(w_np, w_spec, pmesh))
    assert str(perr.value) == str(jerr.value)
    assert "bidirectional" in str(perr.value)


# ----------------------------------------------------------------- records

@functools.cache
def _jax_record(mode: str):
    cfg = _jax_config("--validate")
    return jax_modes.run_mode_benchmark(
        jax_ovl.OVERLAP_MODES[mode](cfg, _jax_mesh(), 64), cfg).finalize()


@pytest.mark.parametrize("mode", LIBRARY_MODES)
def test_record_extras_match_jax(devices, ranks8, mode):
    jrec = _jax_record(mode)
    cfg = _config("--validate")
    rec = modes.run_mode_benchmark(ovl.OVERLAP_MODES[mode](cfg, port_mesh(), 64),
                                   cfg).finalize()
    # `timing_reliable` appears only where a timed window did not clear the
    # synchronize cost, which depends on the host's load, not on the mode
    keys, jkeys = set(rec.extras) - {"timing_reliable"}, set(jrec.extras) - {"timing_reliable"}
    assert keys == jkeys | {"cards", "ranks_per_card"}
    shared = keys & jkeys - {
        "baseline_time_ms", "overlap_speedup_x", "comm_overhead_vs_compute_pct",
        "overhead_time_s", "validation_max_rel_err"}
    for key in shared:
        assert rec.extras[key] == jrec.extras[key], key
    assert rec.mode == jrec.mode == mode and rec.world == jrec.world == D
    assert (rec.extras["cards"], rec.extras["ranks_per_card"]) == (1, D)
    assert rec.tflops_per_device == rec.tflops_total  # one card holds every rank
    if mode in STEP_MODES:
        assert rec.iterations % 8 == 0 and rec.extras["steps_per_program"] == 8
    else:
        assert rec.extras["validation"] == "ok"


@pytest.mark.parametrize("mode", STEP_MODES)
def test_step_record_formulas_match_jax(devices, ranks8, mode):
    # the same Timings through both builders give the same figures, the
    # port's per card over the cards (1 here), JAX's per device
    t_c, t_f = timing.Timing(0.8, 4), timing.Timing(1.0, 4)
    jsetup = jax_ovl.OVERLAP_MODES[mode](_jax_config(), _jax_mesh(), 64)
    psetup = ovl.OVERLAP_MODES[mode](_config(), port_mesh(), 64)
    jrec = jsetup.build_record(t_c, t_f, 0.1).finalize()
    rec = psetup.build_record(t_c, t_f, 0.1).finalize()
    for key in ("avg_time_s", "compute_time_s", "comm_time_s", "tflops_total",
                "iterations", "comm_overhead_pct"):
        assert getattr(rec, key) == pytest.approx(getattr(jrec, key)), key
    assert rec.tflops_per_device == pytest.approx(jrec.tflops_per_device * D)
    assert rec.extras["comm_overhead_vs_compute_pct"] == jrec.extras[
        "comm_overhead_vs_compute_pct"]
    assert psetup.steps_per_program == jsetup.steps_per_program == 8
    assert (psetup.nocomm is None) == (jsetup.nocomm is None) == (mode == "no_overlap")


def _fake_variants(avg: dict, reliable: dict | None = None):
    """A stand-in for `time_variants_n`: each program's Timing by name."""
    def fake(fns, args, **kw):
        names = [getattr(fn, "variant", None) or "compute_only" for fn in fns]
        return [timing.Timing(avg[n] * 2, 2, reliable=(reliable or {}).get(n, True),
                              chain="operand" if kw.get("protocol") == "fused" else None)
                for n in names]
    return fake


@pytest.mark.parametrize("mode", ["overlap", "pipeline"])
def test_three_variant_split(ranks8, monkeypatch, mode):
    setup = ovl.OVERLAP_MODES[mode](_config(), port_mesh(4), 64)
    assert (setup.compute.variant, setup.nocomm.variant, setup.full.variant) == (
        "compute_only", f"{mode}_nocomm", mode)
    avg = {"compute_only": 0.8, f"{mode}_nocomm": 0.88, mode: 1.0}
    monkeypatch.setattr(modes, "time_variants_n", _fake_variants(avg))
    rec = modes.run_mode_benchmark(setup, _config())
    assert rec.comm_time_s == pytest.approx(0.12 / 8)  # full − nocomm, a step
    assert rec.extras["overhead_time_s"] == pytest.approx(0.08 / 8)  # nocomm − compute
    assert rec.compute_time_s == pytest.approx(0.1) and rec.avg_time_s == pytest.approx(0.125)
    assert "timing_reliable" not in rec.extras
    # each difference is clamped at 0; an unreliable nocomm marks the record
    avg = {"compute_only": 1.0, f"{mode}_nocomm": 0.9, mode: 0.8}
    monkeypatch.setattr(modes, "time_variants_n",
                        _fake_variants(avg, {f"{mode}_nocomm": False}))
    rec = modes.run_mode_benchmark(setup, _config())
    assert rec.comm_time_s == 0.0 and rec.extras["overhead_time_s"] == 0.0
    assert rec.extras["timing_reliable"] is False


@pytest.mark.parametrize("mode", LIBRARY_MODES)
def test_split_on_a_real_run(ranks8, mode):
    rec = modes.run_mode_benchmark(ovl.OVERLAP_MODES[mode](_config(), port_mesh(4), 64),
                                   _config())
    if mode in ("overlap", "pipeline"):
        assert rec.extras["overhead_time_s"] >= 0.0
    else:
        assert "overhead_time_s" not in rec.extras
    if mode in STEP_MODES:
        assert rec.comm_time_s is not None and rec.comm_time_s >= 0.0
    else:
        assert rec.comm_time_s is None and rec.extras["overlap_speedup_x"] > 0


# ----------------------------------------------------------- memory rows

@pytest.mark.parametrize("mode", STEP_MODES)
@pytest.mark.parametrize("d", [1, 4, 8])
@pytest.mark.parametrize("dtype_name", ["bfloat16", "int8"])
def test_memory_rows(mode, d, dtype_name):
    args = ["--dtype", dtype_name]
    cfg = parse_config(args, "t", extra_dtypes=("int8",))
    got = modes.estimate_memory_gib(mode, cfg, d, 16384)
    item = 2 if dtype_name == "bfloat16" else 1
    out_item = 2 if dtype_name == "bfloat16" else 4
    gib = 16384 * 16384 / 1024**3
    nbuf = NBUF[mode]
    # nbuf A/B pairs; the products (one, or ring0's k and the k + 1 slots)
    # and the psum's result; its fp32 or int32 accumulator
    outputs = 2 if mode == "no_overlap" else 2 * nbuf + 2
    assert got == pytest.approx(gib * (2 * nbuf * item + outputs * out_item + 4))
    want = jax_modes.estimate_memory_gib(
        mode, jax_parse_config(args, "t", extra_dtypes=("int8",)), d, 16384)
    assert got >= want  # never under JAX's row


@pytest.mark.parametrize("mode", ["collective_matmul_bidir", "collective_matmul_bidir_rs"])
def test_memory_rows_of_the_bidir_rings_match_jax(mode):
    for d in (2, 8):
        want = jax_modes.estimate_memory_gib(mode, jax_parse_config([], "t"), d, 16384)
        assert modes.estimate_memory_gib(mode, parse_config([], "t"), d, 16384) == \
            pytest.approx(want)


# ----------------------------------------------------------- the program

def _ledger(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def test_default_mode_is_overlap(ranks8, tmp_path):
    out = tmp_path / "o.jsonl"
    (rec,) = overlap_bench.main(["--sizes", "32", "--iterations", "1", "--warmup", "1",
                                 "--device", "cpu", "--num-devices", "2",
                                 "--json-out", str(out)])
    assert rec.mode == "overlap" and _ledger(out)[1]["mode"] == "overlap"
    assert parse_config([], "t", modes=list(ovl.OVERLAP_MODES),
                        default_mode="overlap").mode == "overlap"
    assert "the default" in overlap_bench.__doc__ and "not ported" not in overlap_bench.__doc__


@pytest.mark.parametrize("mode", LIBRARY_MODES)
def test_program_runs_each_mode(ranks8, tmp_path, capsys, mode):
    out = tmp_path / "o.jsonl"
    (rec,) = overlap_bench.main([*SMALL, "--device", "cpu", "--mode", mode,
                                 "--num-devices", "4", "--validate", "--matmul-impl", "cuda",
                                 "--json-out", str(out)])
    lines = _ledger(out)
    assert lines[0]["record_type"] == "manifest" and len(lines) == 2
    assert lines[1]["mode"] == mode and lines[1]["benchmark"] == "overlap"
    want = "ok" if mode in RING_MODES else "n/a (program outputs per-step scalars)"
    assert lines[1]["extras"]["validation"] == want
    assert (rec.world, rec.extras["cards"], rec.extras["ranks_per_card"]) == (4, 1, 4)
    assert "4 ranks; cards: 1, ranks_per_card: 4" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["pipeline", "collective_matmul_bidir_rs"])
def test_program_record_fields_match_jax(ranks8, tmp_path, mode):
    jax_out, port_out = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jax_overlap_bench.main([*SMALL, "--mode", mode, "--num-devices", "4", "--validate",
                            "--json-out", str(jax_out)])
    overlap_bench.main([*SMALL, "--device", "cpu", "--mode", mode, "--num-devices", "4",
                        "--validate", "--json-out", str(port_out)])
    (jax_rec,), (port_rec,) = _ledger(jax_out)[1:], _ledger(port_out)[1:]
    assert set(jax_rec) == set(port_rec)
    assert set(port_rec["extras"]) == set(jax_rec["extras"]) | {"cards", "ranks_per_card"}


@pytest.mark.parametrize("mode", LIBRARY_MODES)
def test_fused_timing_runs_fused_and_chained(ranks8, mode):
    cfg = _config("--timing", "fused")
    setup = ovl.OVERLAP_MODES[mode](cfg, port_mesh(4), 64)
    assert setup.fusable is True  # the side streams join the capture
    rec = modes.run_mode_benchmark(setup, cfg)
    assert (rec.extras["timing"], rec.extras["chain"]) == ("fused", "operand")
    assert rec.warmup == cfg.iterations


def test_rings_across_cards_do_not_fuse(ranks8):
    # a hop between two cards is cudaMemcpyPeerAsync, which no CUDA graph
    # captures: such a ring demotes --timing fused to dispatch
    assert ovl.hops_capturable(port_mesh(4))
    two_cards = mesh.make_mesh([torch.device("cuda", 0), torch.device("cuda", 1)])
    assert not ovl.hops_capturable(two_cards)


def test_fused_variants_share_one_set_of_clones():
    # the variants chain, in turn, into one set of clones; the caller's
    # operands are untouched
    seen = []
    x = torch.full((4,), 0.25)

    def fn(a):
        seen.append(a.data_ptr())
        return a * 2

    timing.time_variants_n((fn, fn), (x,), iterations=3, warmup=1, repeats=1,
                           protocol="fused")
    assert len(set(seen)) == 1 and seen[0] != x.data_ptr()
    assert torch.equal(x, torch.full((4,), 0.25))


# -------------------------------------------- the streams' order of events

def _record_steps(variant: str, d: int = 2, steps: int = STEPS):
    """The schedule log (`analysis/recording.record_schedule`) of one call:
    every launch runs at once, as on the CPU, and the log keeps, in issue
    order, which stream each launch went to, its marks and its waits."""
    pmesh = port_mesh(d)
    nbuf = NBUF[variant.removesuffix("_nocomm")]
    a_np, b_np = _numpy(51, (d * nbuf, 8, 8), "float32"), _numpy(52, (d * nbuf, 8, 8), "float32")
    a, b = shard_from_numpy(a_np, ROWS, pmesh), shard_from_numpy(b_np, ROWS, pmesh)
    ops = [a, b] if nbuf == 1 else [a, b, ovl.fill_ring(pmesh, nbuf)(a, b)]
    prog = ovl.StepProgram(pmesh, variant, steps)
    with record_schedule() as log:
        prog(*ops)
    return log.entries


def _events(log, r, which):
    """For each launch on stream (r, which), in order: the event marked
    right after it (None when nothing marks it), and the events waited on
    before it."""
    tokens, waits, pending = [], [], set()
    for entry in log:
        if entry[0] == "launch" and entry[2:4] == (r, which):
            tokens.append(None)
            waits.append(pending)
            pending = set()
        elif entry[0] == "wait" and entry[1:3] == (r, which):
            pending |= set(entry[3])
        elif entry[0] == "mark" and entry[1:3] == (r, which) and not entry[4]:
            tokens[-1] = entry[3]
    return tokens, waits


@pytest.mark.parametrize("variant", ["overlap", "pipeline", "overlap_nocomm",
                                     "pipeline_nocomm"])
def test_ring_steps_wait_on_the_sum_that_read_their_slot(ranks8, variant):
    k = NBUF[variant.removesuffix("_nocomm")]
    log = _record_steps(variant)
    sums, sum_waits = _events(log, 0, ovl._COMM)
    assert len(sums) == STEPS
    assert None not in sums  # every sum is marked
    for r in range(2):
        products, product_waits = _events(log, r, cr._COMPUTE)
        assert len(products) == STEPS
        assert None not in products  # every product is marked
        for i in range(STEPS):
            # write-after-read: product i overwrites slot i mod (k+1), read
            # by the sum of step i−1; it must not wait on this step's sum
            assert (sums[i - 1] in product_waits[i]) == (i > k)
            assert sums[i] not in product_waits[i]
            # read-after-write: the sum of step i reads product i−k
            if i >= k:
                assert products[i - k] in sum_waits[i]


def test_no_overlap_serialises_each_step(ranks8):
    log = _record_steps("no_overlap")
    sums, sum_waits = _events(log, 0, ovl._COMM)
    for r in range(2):
        products, product_waits = _events(log, r, cr._COMPUTE)
        for i in range(STEPS):
            assert products[i] in sum_waits[i]
            assert (sums[i - 1] in product_waits[i]) == (i > 0)


def test_step_programs_keep_their_streams(ranks8):
    prog = ovl.StepProgram(port_mesh(2), "overlap", STEPS)
    assert isinstance(prog._schedule(False), cr._Schedule)
    assert prog._streams is None and prog.per_rank == 2
    assert ovl.StepProgram(port_mesh(2), "compute_only", STEPS).per_rank == 1
    ring = ovl.CollectiveMatmul(port_mesh(2), reduce_scatter=True, bidir=True)
    assert ring.per_rank == 3  # compute and one copy stream a direction
