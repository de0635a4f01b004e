"""The port's wire formats (`--comm-quant`) against the JAX package's.

`tpu_matmul_bench_torch/parallel/collectives.py` (`WireFormat`, its
grammar, `wire_psum`, `wire_reduce_scatter`, `wire_all_gather`, the impl
doors) and `parallel/quantized.py` (the legacy per-row tier) run on D ranks
that share the CPU; the JAX package's under `shard_map` on the first D
devices of the conftest's 8-device mesh. The same numpy operands, made from
a seed, go through both:

- the grammar: the same `WireFormat` fields and the same error text;
- `_wire_quantize` (and the legacy `_quantize`): payloads and scales
  bitwise equal to JAX's compiled ones, int8 and fp8, blocks 8-256 and per
  row;
- the collectives at D = 2, 4 and 8 in every format: within 1e-6 of
  max|exact sum| of JAX's outputs (the elements that differ are named);
- integer operands and one rank take the exact path;
- the seeded bounds of `tests/test_comm_quant_block.py:68-132`, held by the
  port alone.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_port_util import as_numpy, single_torch_thread  # noqa: F401

from tpu_matmul_bench.parallel import collectives as jcol
from tpu_matmul_bench.parallel import mesh as jmesh
from tpu_matmul_bench.parallel import quantized as jq
from tpu_matmul_bench_torch.parallel import collectives as col
from tpu_matmul_bench_torch.parallel import mesh, quantized
from tpu_matmul_bench_torch.parallel.mesh import ROWS, shard_from_numpy

pytestmark = pytest.mark.usefixtures("single_torch_thread")

FORMATS = ["int8", "fp8", "int8-block:32", "fp8-block:32"]
GOOD_SPECS = [None, "none", "int8", "int8-tensor", "fp8", "int8-block:8", "int8-block:1",
              "fp8-block:256", "dcn=fp8-block:32,ici=none", "ici=int8-block:16",
              "dcn=none", " dcn=fp8 , ici=fp8-block:4"]
BAD_SPECS = ["int8-block:0", "int8-block:-3", "int8-block:x", "int8-block", "fp16",
             "fp8-block:", "int4", "block:32", "dcn=int8", "ici=int8-tensor",
             "foo=fp8", "dcn=fp8,dcn=fp8", "ici=bogus", "dcn=fp8-block:32,ici",
             "=fp8"]


def port_mesh(d: int) -> mesh.Mesh:
    return mesh.make_mesh([torch.device("cpu")] * d)


def jax_run(body, x: np.ndarray, d: int) -> np.ndarray:
    """`body(shard, "x")` under shard_map over the first d devices, the
    global operand's rows cut over the axis; the per-device outputs stacked
    along axis 0 (out_specs P("x"))."""
    m = jmesh.make_mesh(jax.devices()[:d])
    f = jmesh.smap(lambda s: body(s, "x"), m, in_specs=P("x"), out_specs=P("x"),
                   check_vma=False)
    return np.asarray(f(jnp.asarray(x))).astype(np.float64)


def port_run(fn, x: np.ndarray, d: int) -> np.ndarray:
    """`fn(mesh, shards)` over d ranks, the same cut; the ranks' outputs
    stacked along axis 0."""
    pm = port_mesh(d)
    out = fn(pm, shard_from_numpy(x, ROWS, pm))
    return np.concatenate([as_numpy(o) for o in out]).astype(np.float64)


def assert_close_to_jax(got: np.ndarray, want: np.ndarray, exact: np.ndarray) -> None:
    """Within 1e-6 of max|exact| everywhere; the message names the elements
    that differ at all."""
    assert got.shape == want.shape
    differ = np.argwhere(got != want)
    limit = 1e-6 * float(np.abs(exact).max())
    worst = float(np.abs(got - want).max())
    assert worst <= limit, (f"{len(differ)} elements differ, first "
                            f"{differ[:8].tolist()}: max |diff| {worst} > {limit}")


def gaussian(seed: int, shape, dtype=np.float32) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


# --------------------------------------------------------------- the grammar

def _fields(fmt):
    return None if fmt is None else (fmt.spec, fmt.qtype, fmt.block, fmt.legacy)


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "raise", str(e)


@pytest.mark.parametrize("spec", [s for s in GOOD_SPECS + BAD_SPECS if s is None or "=" not in s])
def test_parse_wire_format_matches_jax(spec):
    got, want = _outcome(col.parse_wire_format, spec), _outcome(jcol.parse_wire_format, spec)
    assert got[0] == want[0]
    if got[0] == "ok":
        assert _fields(got[1]) == _fields(want[1])
        if got[1] is not None:
            assert got[1].qmax == want[1].qmax
            assert str(got[1].wire_dtype).removeprefix("torch.") == jnp.dtype(
                want[1].wire_dtype).name
    else:
        assert got[1] == want[1]


@pytest.mark.parametrize("spec", GOOD_SPECS + BAD_SPECS)
def test_link_grammar_matches_jax(spec):
    assert col.is_per_link_spec(spec) == jcol.is_per_link_spec(spec)
    assert _outcome(col.validate_comm_quant, spec) == _outcome(jcol.validate_comm_quant, spec)
    for axis in ("x", "dcn", "ici", "dp"):
        assert _outcome(col.link_format_spec, spec, axis) == _outcome(
            jcol.link_format_spec, spec, axis)
    if col.is_per_link_spec(spec):
        got, want = (_outcome(col.parse_link_formats, spec),
                     _outcome(jcol.parse_link_formats, spec))
        assert got[0] == want[0]
        if got[0] == "ok":
            assert {k: _fields(v) for k, v in got[1].items()} == {
                k: _fields(v) for k, v in want[1].items()}
        else:
            assert got[1] == want[1]


def test_link_classes_match_jax():
    assert mesh.LINK_CLASSES == jmesh.LINK_CLASSES
    for name in ("x", "dcn", "ici", "dp", "tp", "i", "j"):
        assert mesh.axis_link_class(name) == jmesh.axis_link_class(name)
    assert col.WIRE_DTYPES == jcol.WIRE_DTYPES


@pytest.mark.parametrize("spec,cols", [("int8-block:32", 256), ("int8-block:32", 48),
                                       ("fp8-block:7", 49), ("fp8", 10), ("int8", 3)])
def test_scale_blocks_matches_jax(spec, cols):
    assert _outcome(col.parse_wire_format(spec).scale_blocks, cols) == _outcome(
        jcol.parse_wire_format(spec).scale_blocks, cols)


# ------------------------------------------------------------ quantization

QUANT_SPECS = ["int8-block:8", "int8-block:16", "int8-block:32", "int8-block:64",
               "int8-block:128", "int8-block:256", "fp8", "fp8-block:8", "fp8-block:32",
               "fp8-block:128", "fp8-block:256"]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a


@pytest.mark.parametrize("spec", QUANT_SPECS)
def test_wire_quantize_is_bitwise_jax(spec):
    x = gaussian(0, (64, 256))
    x[:, 3] *= 1000.0  # an outlier column: some blocks far apart in scale
    x[5] = 0.0  # an all-zero row: the tiny scale floor
    jf = jcol.parse_wire_format(spec)
    q_j, s_j = jax.jit(lambda a: jcol._wire_quantize(a, jf))(x)
    q, s = col._wire_quantize(torch.from_numpy(x), col.parse_wire_format(spec))
    payload = q.view(torch.uint8).numpy() if q.dtype == torch.float8_e4m3fn else q.numpy()
    np.testing.assert_array_equal(payload, _bits(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    # and back: the dequantized values are JAX's too
    np.testing.assert_array_equal(col._wire_dequantize(q, s).numpy(),
                                  np.asarray(jax.jit(jcol._wire_dequantize)(q_j, s_j)))


def test_legacy_quantize_is_bitwise_jax():
    x = gaussian(1, (32, 96))
    q_j, s_j = jax.jit(jq._quantize)(x)
    q, s = quantized._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))


def test_fp8_payload_stays_in_range():
    # JAX's fp32 -> float8_e4m3fn cast gives NaN past 464: the clip keeps
    # every scaled value inside ±448, where both casts agree
    assert np.isnan(np.float32(470.0).astype(ml_dtypes.float8_e4m3fn))
    fmt = col.parse_wire_format("fp8")
    x = torch.tensor([[448.0, -1e30, 3.0], [1e-30, 0.0, -7.0]])
    q, s = col._wire_quantize(x, fmt)
    assert q.float().abs().max() <= 448.0
    assert torch.isfinite(col._wire_dequantize(q, s)).all()


# ------------------------------------------------------ the collectives

def _jax_psum(spec):
    fmt = jcol.parse_wire_format(spec)
    if fmt.legacy:
        return jq.quantized_psum
    return lambda s, a: jcol.wire_psum(s, a, fmt)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("spec", FORMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wire_psum_matches_jax(d, spec, dtype):
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    x = gaussian(2, (8 * d, 64)).astype(np_dtype)
    want = jax_run(_jax_psum(spec), x, d)
    got = port_run(col.psum_impl(spec), x, d)
    exact = np.tile(x.astype(np.float64).reshape(d, -1, 64).sum(0), (d, 1))
    assert_close_to_jax(got, want, exact)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("spec", ["fp8", "int8-block:32", "fp8-block:32"])
def test_wire_reduce_scatter_matches_jax(d, spec):
    x = gaussian(3, (8 * d, 64))
    jf = jcol.parse_wire_format(spec)
    want = jax_run(lambda s, a: jcol.wire_reduce_scatter(s, a, jf), x, d)
    got = port_run(col.reduce_scatter_impl(spec), x, d)
    exact = x.astype(np.float64).reshape(d, -1, 64).sum(0)
    assert_close_to_jax(got, want, exact)


@pytest.mark.parametrize("spec", ["int8", "int8-tensor"])
def test_reduce_scatter_refuses_the_legacy_tier(spec):
    with pytest.raises(ValueError) as got:
        col.reduce_scatter_impl(spec)
    with pytest.raises(ValueError) as want:
        jcol.reduce_scatter_impl(spec)
    assert str(got.value) == str(want.value)


def _jax_gather(spec, axis):
    fmt = jcol.parse_wire_format(spec)
    if fmt.legacy:
        return lambda s, a: jq.quantized_all_gather(s, a, axis=axis)
    return lambda s, a: jcol.wire_all_gather(s, a, fmt, axis=axis)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("spec", FORMATS)
@pytest.mark.parametrize("axis,shape", [(0, (4, 64)), (1, (4, 32)), (2, (2, 3, 32))])
def test_wire_all_gather_matches_jax(d, spec, axis, shape):
    x = gaussian(4, (d * shape[0],) + shape[1:])
    want = jax_run(_jax_gather(spec, axis), x, d)
    impl = col.allgather_impl(spec)
    got = port_run(lambda m, s: impl(m, s, axis=axis), x, d)
    exact = np.concatenate([np.concatenate(np.split(x, d), axis=axis)] * d)
    assert_close_to_jax(got, want, exact)


@pytest.mark.parametrize("spec", FORMATS)
def test_gather_axis_errors_match_jax(spec):
    x = gaussian(5, (8, 2, 4))
    pm = port_mesh(2)
    shards = shard_from_numpy(x, ROWS, pm)
    with pytest.raises(ValueError, match="unsupported gather axis 1 for rank 3"):
        col.allgather_impl(spec)(pm, shards, axis=1)
    with pytest.raises(ValueError, match="unsupported gather axis 1 for rank 3"):
        jax_run(_jax_gather(spec, 1), x, 2)


def test_all_to_all_matches_jax():
    d = 4
    x = gaussian(6, (d * 8, 16))
    want = jax_run(lambda s, a: jax.lax.all_to_all(s, a, 0, 0, tiled=True), x, d)
    got = port_run(lambda m, s: col.all_to_all_over(m)(s), x, d)
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------- inert and exact paths

@pytest.mark.parametrize("spec", FORMATS)
def test_integer_operands_take_the_exact_path(spec):
    d = 4
    x = np.random.default_rng(7).integers(-8, 8, size=(8 * d, 64)).astype(np.int32)
    col.WIRE_CALLS.clear()
    pm = port_mesh(d)
    shards = shard_from_numpy(x, ROWS, pm)
    for got, want in ((col.psum_impl(spec)(pm, shards), col.psum_over(pm)(shards)),
                      (col.allgather_impl(spec)(pm, shards, axis=1),
                       col.all_gather_over(pm, gather_axis=1)(shards))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == torch.int32
            assert torch.equal(g, w)
    if not col.parse_wire_format(spec).legacy:
        got = col.reduce_scatter_impl(spec)(pm, shards)
        for g, w in zip(got, col.psum_scatter_over(pm, scatter_dimension=0)(shards)):
            assert torch.equal(g, w)
    assert col.WIRE_CALLS == {}


@pytest.mark.parametrize("spec", FORMATS)
def test_one_rank_is_inert(spec):
    x = torch.from_numpy(gaussian(8, (16, 64)))
    pm = port_mesh(1)
    col.WIRE_CALLS.clear()
    impls = [col.psum_impl(spec), lambda m, s: col.allgather_impl(spec)(m, s, axis=1)]
    if not col.parse_wire_format(spec).legacy:
        impls.append(col.reduce_scatter_impl(spec))
    for impl in impls:
        (out,) = impl(pm, [x])
        assert out is x
    assert col.WIRE_CALLS == {}


def test_exact_spec_routes_to_the_exact_collectives():
    d = 4
    pm = port_mesh(d)
    x = gaussian(9, (8 * d, 64)).astype(ml_dtypes.bfloat16)
    shards = shard_from_numpy(x, ROWS, pm)
    for spec in (None, "none", "dcn=int8-block:32"):  # the flat world's axis is ici
        for g, w in zip(col.psum_impl(spec, varying_out=True)(pm, shards),
                        col.psum_over(pm)(shards)):
            assert torch.equal(g, w)
        for g, w in zip(col.allgather_impl(spec)(pm, shards, axis=1),
                        col.all_gather_over(pm, gather_axis=1)(shards)):
            assert torch.equal(g, w)
        for g, w in zip(col.reduce_scatter_impl(spec)(pm, shards),
                        col.psum_scatter_over(pm, scatter_dimension=0)(shards)):
            assert torch.equal(g, w)


def test_per_link_spec_resolves_to_the_ici_format():
    d = 4
    pm = port_mesh(d)
    x = gaussian(10, (8 * d, 64))
    shards = shard_from_numpy(x, ROWS, pm)
    col.WIRE_CALLS.clear()
    got = col.psum_impl("dcn=none,ici=int8-block:32")(pm, shards)
    want = col.wire_psum(pm, shards, col.parse_wire_format("int8-block:32"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert col.WIRE_CALLS == {("int8-block:32", "all_reduce"): 2}
    with pytest.raises(ValueError, match="link 'ici' repeats"):
        col.psum_impl("ici=fp8,ici=fp8")


def test_fuse_f32_keeps_the_fp32_sum():
    d = 4
    pm = port_mesh(d)
    x = gaussian(11, (8 * d, 64)).astype(ml_dtypes.bfloat16)
    shards = shard_from_numpy(x, ROWS, pm)
    fused = col.psum_impl("int8-block:32", fuse_f32=True)(pm, shards)
    plain = col.psum_impl("int8-block:32")(pm, shards)
    assert fused[0].dtype == torch.float32 and plain[0].dtype == torch.bfloat16
    assert torch.equal(fused[0].to(torch.bfloat16), plain[0])
    # the legacy tier downcasts at every collective whatever fuse_f32 says
    legacy = col.psum_impl("int8", fuse_f32=True)(pm, shards)
    assert legacy[0].dtype == torch.bfloat16
    gathered = col.allgather_impl("fp8-block:32", fuse_f32=True)(pm, shards, axis=0)
    assert gathered[0].dtype == torch.float32


def test_wire_calls_count_each_quantized_call():
    d = 2
    pm = port_mesh(d)
    shards = shard_from_numpy(gaussian(12, (8, 64)), ROWS, pm)
    col.WIRE_CALLS.clear()
    for _ in range(3):
        col.psum_impl("fp8-block:32")(pm, shards)
    col.psum_impl("int8-tensor")(pm, shards)
    col.allgather_impl("int8")(pm, shards, axis=1)
    col.reduce_scatter_impl("fp8")(pm, shards)
    assert col.WIRE_CALLS == {("fp8-block:32", "all_reduce"): 3, ("int8", "all_reduce"): 1,
                              ("int8", "all_gather"): 1, ("fp8", "reduce_scatter"): 1}


@pytest.mark.parametrize("collective,shape,spec", [
    ("all_reduce", (6, 64), "int8-block:32"), ("all_reduce", (8, 48), "int8-block:32"),
    ("all_reduce", (3, 2, 64), "fp8"), ("all_reduce", (8, 64), "int8"),
    ("reduce_scatter", (6, 64), "fp8"), ("all_gather", (8, 40), "fp8-block:16")])
def test_payload_check_raises_what_the_collective_raises(collective, shape, spec):
    d = 4
    pm = port_mesh(d)
    x = torch.from_numpy(gaussian(13, shape))
    call = {"all_reduce": lambda: col.psum_impl(spec)(pm, [x] * d),
            "reduce_scatter": lambda: col.reduce_scatter_impl(spec)(pm, [x] * d),
            "all_gather": lambda: col.allgather_impl(spec)(pm, [x] * d, axis=1)}[collective]
    outcome = _outcome(call)
    assert _outcome(col.check_wire_payload, spec, collective, shape, d,
                    torch.float32)[0] == outcome[0]
    if outcome[0] == "raise":
        with pytest.raises(ValueError) as checked:
            col.check_wire_payload(spec, collective, shape, d, torch.float32)
        assert str(checked.value) == outcome[1]
    # inert cases never raise
    col.check_wire_payload(spec, collective, shape, 1, torch.float32)
    col.check_wire_payload(spec, collective, shape, d, torch.int8)


def test_row_divisibility_message_matches_jax():
    d = 4
    x = gaussian(14, (d * 6, 64))  # 6 rows a rank: not a multiple of 4
    jf = jcol.parse_wire_format("int8-block:32")
    with pytest.raises(ValueError) as want:
        jax_run(lambda s, a: jcol.wire_psum(s, a, jf), x, d)
    with pytest.raises(ValueError) as got:
        port_run(col.psum_impl("int8-block:32"), x, d)
    assert str(got.value) == str(want.value)


# ------------------------------------ the seeded bounds, held by the port


@pytest.fixture(scope="module")
def seeded():
    pm = port_mesh(8)
    x = np.random.default_rng(0).normal(size=(64, 256)).astype(np.float32)
    return pm, x, _all_reduce(pm, x, lambda m, s: col.psum_over(m)(s))


def _all_reduce(pm, x, fn) -> np.ndarray:
    return as_numpy(fn(pm, shard_from_numpy(x, ROWS, pm))[0]).astype(np.float64)


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _wire_err(pm, x, exact, spec) -> float:
    fmt = col.parse_wire_format(spec)
    return _rel(_all_reduce(pm, x, lambda m, s: col.wire_psum(m, s, fmt)), exact)


def test_int8_block_error_grows_with_block_size(seeded):
    pm, x, exact = seeded
    errs = [_wire_err(pm, x, exact, f"int8-block:{b}") for b in (8, 16, 32, 64, 128, 256)]
    assert all(e < 0.02 for e in errs), errs
    assert errs == sorted(errs), errs


def test_block_cols_degenerates_to_the_per_row_control(seeded):
    pm, x, exact = seeded
    legacy = _rel(_all_reduce(pm, x, quantized.quantized_psum), exact)
    assert legacy < 0.02
    assert np.isclose(_wire_err(pm, x, exact, "int8-block:256"), legacy, rtol=1e-6)


def test_fp8_formats_bounded_and_blocks_help(seeded):
    pm, x, exact = seeded
    fp8 = _wire_err(pm, x, exact, "fp8")
    fp8_b32 = _wire_err(pm, x, exact, "fp8-block:32")
    assert fp8 < 0.08 and fp8_b32 < 0.08
    assert fp8_b32 < fp8


def test_outlier_rows_block_beats_per_row():
    pm = port_mesh(8)
    xo = np.random.default_rng(1).normal(size=(64, 256)).astype(np.float32)
    xo[:, 3] *= 1000.0
    exact = _all_reduce(pm, xo, lambda m, s: col.psum_over(m)(s))
    legacy = _all_reduce(pm, xo, quantized.quantized_psum)
    fmt = col.parse_wire_format("int8-block:32")
    block = _all_reduce(pm, xo, lambda m, s: col.wire_psum(m, s, fmt))
    assert _rel(block, exact) < 0.5 * _rel(legacy, exact)
    mask = np.ones(256, bool)
    mask[3] = False
    legacy_rest = _rel(legacy[:, mask], exact[:, mask])
    block_rest = _rel(block[:, mask], exact[:, mask])
    assert legacy_rest > 1.0
    assert block_rest < 0.5 * legacy_rest


def test_the_gather_leg_is_tighter_than_the_ring(seeded):
    pm, x, _ = seeded
    fmt = col.parse_wire_format("int8-block:32")
    got = as_numpy(col.wire_all_gather(pm, shard_from_numpy(x, ROWS, pm), fmt)[0])
    assert _rel(got, x) < 0.01
