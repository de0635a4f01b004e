"""The port's flat-world comms model (`tpu_matmul_bench_torch/analysis/
comms_model.py`) against the JAX package's `analysis/comms_model.py`.

For every mode of `mode_collective_shapes`, wire formats int8,
int8-block:32, fp8-block:32 and exact, D in {2, 4, 8}, float and integer
dtypes: the same collective shapes, inventories, wire inventories and byte
summaries, exactly, or the same ValueError where a block does not divide a
payload. Also the payload-reduction floor of `tests/test_comm_quant_block.py`
(≥ 2× over bf16 on every distributed mode at D = 8), held by the port alone,
and the module's own imports (numpy only). The hierarchical half
(`mode_axis_collectives`, `hier_mode_steps`, `hier_expected_collectives`,
`hier_wire_bytes_summary`) on both transposed factorizations and the
one-axis ones, every format and two per-link specs: equal, exactly.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from tpu_matmul_bench.analysis import comms_model as jcm
from tpu_matmul_bench_torch.analysis import comms_model as cm

MODES = {"independent": {}, "batch_parallel": {}, "data_parallel": {},
         "matrix_parallel": {}, "model_parallel": {}, "hybrid": {"dp": 2},
         "summa": {"rows": 2}}
SPECS = ["int8", "int8-block:32", "fp8-block:32", None]
DTYPES = {"bfloat16": jnp.bfloat16, "float32": jnp.float32, "int8": jnp.int8}


def _outcome(fn, *args, **kw):
    try:
        out = fn(*args, **kw)
    except (ValueError, ZeroDivisionError) as e:
        return type(e).__name__, str(e)
    if isinstance(out, list) and out and hasattr(out[0], "payload_bytes"):
        out = [(c.kind, c.payload_bytes) for c in out]
    return "ok", out


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", list(MODES))
def test_shapes_and_steps_match_jax(mode, d):
    for size in (64, 256):
        assert _outcome(cm.mode_collective_shapes, mode, d, size, **MODES[mode]) == \
            _outcome(jcm.mode_collective_shapes, mode, d, size, **MODES[mode])
        for dtype, jdtype in DTYPES.items():
            assert _outcome(cm.expected_collectives, mode, d, size, dtype, **MODES[mode]) \
                == _outcome(jcm.expected_collectives, mode, d, size, jdtype, **MODES[mode])
    assert cm.mode_steps(mode, d, rows=MODES[mode].get("rows")) == jcm.mode_steps(
        mode, d, rows=MODES[mode].get("rows"))


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("mode", list(MODES))
def test_wire_model_matches_jax(mode, spec, d):
    for size in (64, 256):
        for dtype, jdtype in DTYPES.items():
            args = (mode, d, size)
            assert _outcome(cm.wire_bytes_summary, *args, dtype, spec, **MODES[mode]) == \
                _outcome(jcm.wire_bytes_summary, *args, jdtype, spec, **MODES[mode])
            assert _outcome(cm.wire_collectives, *args, dtype, spec, **MODES[mode]) == \
                _outcome(jcm.wire_collectives, *args, jdtype, spec, **MODES[mode])


def test_unknown_mode_and_kind_raise_as_jax():
    assert _outcome(cm.mode_collective_shapes, "summa_x", 4, 64) == _outcome(
        jcm.mode_collective_shapes, "summa_x", 4, 64)
    assert _outcome(cm.mode_collective_shapes, "hybrid", 4, 64, dp=3) == _outcome(
        jcm.mode_collective_shapes, "hybrid", 4, 64, dp=3)
    from tpu_matmul_bench.parallel.collectives import parse_wire_format as jparse
    from tpu_matmul_bench_torch.parallel.collectives import parse_wire_format

    for kind, shape in (("ppermute", (8, 64)), ("all_reduce", (6, 64))):
        assert _outcome(cm._one_wire_entries, kind, 4, shape, parse_wire_format("fp8"), "m") \
            == _outcome(jcm._one_wire_entries, kind, 4, shape, jparse("fp8"), "m")


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_ring_factors_and_itemsizes_match_jax(d):
    assert set(cm.RING_WIRE_FACTOR) == set(jcm.RING_WIRE_FACTOR)
    for kind, f in cm.RING_WIRE_FACTOR.items():
        assert f(d) == jcm.RING_WIRE_FACTOR[kind](d)
    for name, jdtype in {**DTYPES, "float16": jnp.float16, "int32": jnp.int32}.items():
        assert cm.matmul_out_itemsize(name) == jcm.matmul_out_itemsize(jdtype)
        assert cm.matmul_out_itemsize(getattr(torch, name)) == jcm.matmul_out_itemsize(jdtype)


@pytest.mark.parametrize("mode", sorted(m for m in MODES if m != "independent"))
@pytest.mark.parametrize("spec", ["int8", "int8-block:32", "fp8-block:32"])
def test_payload_reduction_floor_every_distributed_mode(mode, spec):
    s = cm.wire_bytes_summary(mode, 8, 1024, "bfloat16", spec, **MODES[mode])
    assert s["payload_reduction_x"] >= 2.0, s
    assert s["wire_bytes"] == s["wire_payload_bytes"] + s["wire_scale_bytes"]
    assert 1.0 < s["wire_reduction_x"] <= s["payload_reduction_x"]


def test_the_module_imports_numpy_only():
    tree = ast.parse(Path(cm.__file__).read_text())
    top = [a.name for node in tree.body if isinstance(node, ast.Import) for a in node.names]
    top += [node.module for node in tree.body if isinstance(node, ast.ImportFrom)]
    assert set(top) <= {"__future__", "dataclasses", "math", "typing", "numpy"}, top


HIER_MESHES = ["dcn:2,ici:4", "dcn:4,ici:2", "ici:8", "dcn:8"]
HIER_SPECS = [None, "int8", "fp8", "int8-block:32", "fp8-block:32", "int8-block:128",
              "dcn=fp8-block:32,ici=none", "dcn=none,ici=int8-block:32"]


@pytest.mark.parametrize("mesh", HIER_MESHES)
@pytest.mark.parametrize("mode", ["hybrid", "summa", "batch_parallel", "model_parallel"])
def test_hier_inventory_matches_jax(mode, mesh):
    for size in (64, 512):
        for batch in (4, 8):
            assert _outcome(cm.mode_axis_collectives, mode, mesh, size, batch=batch) == \
                _outcome(jcm.mode_axis_collectives, mode, mesh, size, batch=batch)
    assert _outcome(cm.hier_mode_steps, mode, mesh) == _outcome(jcm.hier_mode_steps, mode, mesh)
    assert cm.LINK_WIRE_SECONDS == jcm.LINK_WIRE_SECONDS


@pytest.mark.parametrize("spec", HIER_SPECS)
@pytest.mark.parametrize("mesh", HIER_MESHES)
@pytest.mark.parametrize("mode", ["hybrid", "summa"])
def test_hier_wire_model_matches_jax(mode, mesh, spec):
    for size in (64, 512):
        for dtype, jdtype in DTYPES.items():
            args = (mode, mesh, size)
            assert _outcome(cm.hier_expected_collectives, *args, dtype, spec) == \
                _outcome(jcm.hier_expected_collectives, *args, jdtype, spec)
            assert _outcome(cm.hier_wire_bytes_summary, *args, dtype, spec) == \
                _outcome(jcm.hier_wire_bytes_summary, *args, jdtype, spec)


def test_per_link_reduction_is_charged_to_its_link_only():
    s = cm.hier_wire_bytes_summary("hybrid", "dcn:2,ici:4", 512, "bfloat16",
                                   "dcn=fp8-block:32,ici=none")
    assert s["bottleneck_link"] == "dcn" and s["mesh"] == "dcn:2,ici:4"
    assert s["per_link"]["dcn"]["payload_reduction_x"] == 2.0
    assert s["per_link"]["ici"]["payload_reduction_x"] == 1.0
