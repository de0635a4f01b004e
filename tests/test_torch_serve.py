"""The serving path on the CPU (`tpu_matmul_bench_torch/serve/`), against
the JAX package's `serve/`:

- the request streams (open loop, tenants' open loop, closed loop), the
  shape grid, the mix and tenant grammars: bitwise the JAX package's for
  the same seeds and specs, with the same errors;
- the executable cache: the same hit, miss and eviction sequence on one key
  stream, and each entry's product held to JAX's compiled product;
- the whole path: `serve selftest` and `serve trace selftest` on the CPU,
  a bench window's `extras["serve"]` keys against a JAX selftest record's,
  `serve explain` of a JAX ledger printing JAX's text, the JAX validator
  accepting a port record, the card needed unless `--device cpu`, and the
  pod and artifact options run on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch_port_util import (  # noqa: F401 — single_torch_thread is a fixture
    TOLERANCE,
    numpy_operands,
    rel_err,
    single_torch_thread,
)

from tpu_matmul_bench.serve import cache as jax_cache
from tpu_matmul_bench.serve import loadgen as jax_loadgen
from tpu_matmul_bench.serve import queue as jax_queue
from tpu_matmul_bench.serve import tenants as jax_tenants
from tpu_matmul_bench_torch.__main__ import main as port_main
from tpu_matmul_bench_torch.ops.matmul import matmul_2d, operands_from_numpy
from tpu_matmul_bench_torch.serve import cache, loadgen, queue, tenants
from tpu_matmul_bench_torch.serve.service import validate_serve_record
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord

pytestmark = pytest.mark.usefixtures("single_torch_thread")

MIXES = ["256,512:0.5", "1024x4096x4096:1,2048x4096x16384:1,8192:0.25",
         "128x64x32:3, 7 ,300x200x100:0.5"]
SEEDS = [0, 1, 7]
TENANT_TABLES = {
    "interactive": {"weight": 4, "priority": 0, "slo_ms": 50, "mix": "128,256:2",
                    "ramp": 0.5},
    "bulk": {"weight": 1, "priority": 1, "burst_x": 3.0, "burst_every_s": 0.5,
             "burst_for_s": 0.1, "share": 2},
    "batch": {"weight": 2, "priority": 1, "mix": "64x512x128"},
}


def _rows(requests) -> list[dict]:
    return [dataclasses.asdict(r) for r in requests]


def _outcome(fn, *args, **kw):
    """A call's value, or its exception's type name and message."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the error is the result compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mix", MIXES)
def test_open_loop_schedule_is_jaxs(mix, seed):
    kw = dict(qps=400.0, duration_s=1.5, dtype="bfloat16", seed=seed)
    port = loadgen.open_loop_schedule(loadgen.parse_mix(mix), **kw)
    ref = jax_loadgen.open_loop_schedule(jax_loadgen.parse_mix(mix), **kw)
    assert len(port) > 100
    assert _rows(port) == _rows(ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_tenant_open_loop_schedule_is_jaxs(seed):
    kw = dict(qps=300.0, duration_s=2.0, dtype="float32", seed=seed,
              default_mix="256,512:0.5")
    port = loadgen.tenant_open_loop_schedule(
        tenants.tenants_from_dict({"tenants": TENANT_TABLES}), **kw)
    ref = jax_loadgen.tenant_open_loop_schedule(
        jax_tenants.tenants_from_dict({"tenants": TENANT_TABLES}), **kw)
    assert {r.tenant for r in port} == set(TENANT_TABLES)
    assert _rows(port) == _rows(ref)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mix", MIXES)
def test_closed_loop_shapes_are_jaxs(mix, seed):
    take = 300

    def first(gen):
        return [dataclasses.asdict(next(gen)) for _ in range(take)]

    assert first(loadgen.closed_loop_shapes(loadgen.parse_mix(mix), dtype="int8",
                                            seed=seed)) == \
        first(jax_loadgen.closed_loop_shapes(jax_loadgen.parse_mix(mix), dtype="int8",
                                             seed=seed))
    specs = dict(default_mix=mix, dtype="int8", seed=seed)
    assert first(loadgen.tenant_closed_loop_shapes(
        tenants.tenants_from_dict({"tenants": TENANT_TABLES}), **specs)) == \
        first(jax_loadgen.tenant_closed_loop_shapes(
            jax_tenants.tenants_from_dict({"tenants": TENANT_TABLES}), **specs))


@pytest.mark.parametrize("points", [queue.DEFAULT_GRID, (100, 300, 1000)])
def test_shape_grid_buckets_are_jaxs(points):
    port, ref = queue.ShapeGrid(points), jax_queue.ShapeGrid(points)
    dims = sorted({1, 2, 63, 64, 99, 100, 101, 127, 128, 129, 255, 257, 999, 1000,
                   1001, 4095, 4096, 4097, 16383, 16384, 16385, 40000, 70001}
                  | set(range(1, 3000, 37)))
    assert [port.bucket_dim(d) for d in dims] == [ref.bucket_dim(d) for d in dims]
    shapes = [(d, dims[-1 - i], dims[i // 2]) for i, d in enumerate(dims)]
    assert [port.bucket(*s) for s in shapes] == [ref.bucket(*s) for s in shapes]
    for bad in (0, -3):
        assert _outcome(port.bucket_dim, bad) == _outcome(ref.bucket_dim, bad)
    for bad_points in ((), (0, 4)):
        assert _outcome(queue.ShapeGrid, bad_points) == _outcome(jax_queue.ShapeGrid,
                                                                 bad_points)


@pytest.mark.parametrize("spec", [*MIXES, "7", "8x9x10:2.5", " ,512, ", "", "0", "1x2",
                                  "64:0", "64:-1", "64:x", "axb", "1x2x3x4"])
def test_parse_mix_is_jaxs(spec):
    port, ref = _outcome(loadgen.parse_mix, spec), _outcome(jax_loadgen.parse_mix, spec)
    if port[0] == "ok":
        assert [dataclasses.asdict(e) for e in port[1]] == \
            [dataclasses.asdict(e) for e in ref[1]]
    else:
        assert port == ref


@pytest.mark.parametrize("spec", [None, "a", "interactive=4/0/250,bulk=1/1", "x=2",
                                  "a=1,A=2", "a=1/2/3/4", "a=", "a=x", "a=1/1.5",
                                  "a=-1", "a=1/-1", "a=1/0/0", " , ", "b=3/2/5.5, c"])
def test_parse_tenants_arg_is_jaxs(spec):
    port = _outcome(tenants.parse_tenants_arg, spec)
    ref = _outcome(jax_tenants.parse_tenants_arg, spec)
    if port[0] == "ok":
        assert [dataclasses.asdict(t) for t in port[1]] == \
            [dataclasses.asdict(t) for t in ref[1]]
    else:
        assert port == ref


@pytest.mark.parametrize("text", [
    '[tenants.a]\nweight = 2\nslo_ms = 100\nmix = "128"\n[tenants.b]\npriority = 1\n',
    '[tenants.a]\nweight = 0\n', '[tenants.a]\nramp = 1.5\n', '[tenants.a]\nmix = "q"\n',
    '[tenants.a]\nburst_x = 2\n', '[tenants.a]\nburst_every_s = 1\nburst_for_s = 2\n',
    '[tenants.A]\n[tenants.a]\n', 'tenants = 3\n', '[tenants\n'])
def test_tenant_files_are_jaxs(tmp_path, text):
    path = tmp_path / "t.toml"
    path.write_text(text)
    port = _outcome(tenants.parse_tenants_arg, str(path))
    ref = _outcome(jax_tenants.parse_tenants_arg, str(path))
    if port[0] == "ok":
        assert [dataclasses.asdict(t) for t in port[1]] == \
            [dataclasses.asdict(t) for t in ref[1]]
    else:
        assert port == ref


# ---------------------------------------------------------------- the cache

KEY_STREAM = [(64, 64, 64), (32, 64, 16), (64, 64, 64), (128, 32, 64), (32, 64, 16),
              (64, 64, 64), (128, 32, 64), (128, 32, 64), (16, 16, 16), (64, 64, 64)]


def _port_cache(dtype_name: str, impl: str = "torch", capacity: int = 2, seed: int = 0):
    operands = {}

    def ops(key):
        if (key.m, key.k, key.n) not in operands:
            operands[key.m, key.k, key.n] = operands_from_numpy(
                *numpy_operands(seed, key.m, key.k, key.n, key.dtype), device="cpu")
        return operands[key.m, key.k, key.n]

    def build(key):
        return cache.Program(matmul_2d(impl), impl)

    return cache.ExecutableCache(build, operands=ops, capacity=capacity), ops


def _jax_cache(capacity: int = 2):
    from tpu_matmul_bench.ops.matmul import matmul_2d as jax_matmul_2d

    return jax_cache.ExecutableCache(lambda key: jax_matmul_2d("xla"), capacity=capacity)


def _state(c) -> tuple:
    return (c.hits, c.misses, c.evictions, len(c),
            [k.label for k in c._entries], {e.key.label: e.hits for e in c._entries.values()})


def test_cache_hits_misses_and_evictions_are_jaxs():
    port, _ = _port_cache("float32")
    ref = _jax_cache()
    for i, (m, k, n) in enumerate(KEY_STREAM):
        if i == 5:  # a warm start mid-stream: resident keys skipped, fresh ones preloaded
            keys = [(64, 64, 64), (8, 8, 8), (16, 8, 8)]
            assert port.warm_start(cache.ExecKey(*s, "float32", "torch") for s in keys) == \
                ref.warm_start(jax_cache.ExecKey(*s, "float32", "torch") for s in keys)
            assert _state(port) == _state(ref)
        port.get(cache.ExecKey(m, k, n, "float32", "torch"))
        ref.get(jax_cache.ExecKey(m, k, n, "float32", "torch"))
        assert _state(port) == _state(ref)
    want = {k: v for k, v in ref.stats().items() if k != "by_entry"}
    got = {k: v for k, v in port.stats().items() if k != "by_entry"}
    for d in (want["preload"], got["preload"]):
        d.pop("total_ms"), d.pop("compile_ms")
    assert got == want
    assert {k: set(v) for k, v in port.stats()["by_entry"].items()} == \
        {k: set(v) for k, v in ref.stats()["by_entry"].items()}
    assert port.stats()["hits"] == 3 and port.stats()["evictions"] == 8
    with pytest.raises(ValueError, match="capacity"):
        cache.ExecutableCache(lambda k: None, operands=lambda k: None, capacity=0)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_cache_entry_products_are_jaxs(dtype_name, impl):
    import jax.numpy as jnp

    port, ops = _port_cache(dtype_name, impl=impl, capacity=4, seed=3)
    ref = _jax_cache(capacity=4)
    for m, k, n in [(64, 128, 32), (96, 64, 256)]:
        key = cache.ExecKey(m, k, n, dtype_name, impl)
        a_np, b_np = numpy_operands(3, m, k, n, dtype_name)
        want = np.asarray(ref.get(jax_cache.ExecKey(m, k, n, dtype_name, "xla"))
                          .compiled(jnp.asarray(a_np), jnp.asarray(b_np)), np.float64)
        entry = port.get(key)
        a, b = ops(key)
        got = entry.compiled(a, b).double().numpy()
        if dtype_name == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
        else:
            assert rel_err(got, want) <= TOLERANCE[dtype_name]
        assert entry.warm_dispatch_s > 0 and entry.source == "compile"
        # a `cuda` entry carries the kernel's cost books; the library none
        assert (entry.cost is not None) == (impl == "cuda")
        if impl == "cuda":
            assert entry.cost["hand_model_flops"] == 2.0 * m * n * k
        with pytest.raises(ValueError, match="executable built for"):
            entry.compiled(a[:, :-1], b)
    assert set(port.cost_analysis()) == ({f"64x128x32/{dtype_name}/cuda",
                                          f"96x64x256/{dtype_name}/cuda"}
                                         if impl == "cuda" else set())


def test_graph_executable_refuses_other_operands():
    a, b, out = torch.ones(4, 4), torch.ones(4, 4), torch.zeros(4, 4)

    class Replay:
        replays = 0

        def replay(self):
            Replay.replays += 1

    ex = cache.GraphExecutable(Replay(), a, b, out)
    assert ex(a, b) is out and Replay.replays == 1
    with pytest.raises(ValueError, match="captured over"):
        ex(a.clone(), b)
    assert Replay.replays == 1


# ----------------------------------------------------------- the whole path

@pytest.fixture(scope="module")
def jax_selftest_ledger(tmp_path_factory):
    """A ledger written by the JAX package's `serve selftest --device cpu`."""
    from tpu_matmul_bench.serve import cli as jax_serve_cli

    path = tmp_path_factory.mktemp("jax-serve") / "serve.jsonl"
    jax_serve_cli.main(["selftest", "--device", "cpu", "--json-out", str(path)])
    return path


def _serve_record(path) -> dict:
    (rec,) = [json.loads(line) for line in path.read_text().splitlines()
              if json.loads(line).get("benchmark") == "serve"]
    return rec


def _keys(d) -> dict:
    """The nested key set of a record's `extras["serve"]` block."""
    s = d["extras"]["serve"]
    return {"serve": set(s), "cache": set(s["cache"]), "preload": set(s["cache"]["preload"]),
            "queue": set(s["queue"]),
            "tenant_row": {k for row in s["tenants"].values() for k in row},
            "bucket_row": {k for row in s["buckets"].values() for k in row},
            "entry": {k for e in s["cache"]["by_entry"].values() for k in e}}


def test_selftest_on_the_cpu_exits_0_with_jaxs_keys(tmp_path, jax_selftest_ledger, capsys):
    path = tmp_path / "serve.jsonl"
    (rec,) = port_main(["serve", "selftest", "--device", "cpu", "--json-out", str(path)])
    assert "selftest ok: 1 executable warm-started, 10 requests" in capsys.readouterr().out
    assert validate_serve_record(rec) == []
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    jax_lines = [json.loads(line) for line in jax_selftest_ledger.read_text().splitlines()]
    assert [d.get("record_type") for d in lines] == [d.get("record_type") for d in jax_lines]
    assert set(lines[0]["serve_config"]) == set(jax_lines[0]["serve_config"])
    assert _keys(_serve_record(path)) == _keys(_serve_record(jax_selftest_ledger))
    spans = [d for d in lines if d.get("record_type") == "serve_span"]
    jax_spans = [d for d in jax_lines if d.get("record_type") == "serve_span"]
    assert [(d["rid"], d["tenant"], d["bucket"], d["state"], [s["name"] for s in d["spans"]])
            for d in spans] == \
        [(d["rid"], d["tenant"], d["bucket"], d["state"], [s["name"] for s in d["spans"]])
         for d in jax_spans]


def test_jax_validator_accepts_a_port_record(tmp_path):
    from tpu_matmul_bench.serve.service import (
        validate_serve_record as jax_validate_serve_record,
    )
    from tpu_matmul_bench.utils.reporting import BenchmarkRecord as JaxRecord

    path = tmp_path / "serve.jsonl"
    port_main(["serve", "selftest", "--device", "cpu", "--json-out", str(path)])
    rec = _serve_record(path)
    assert jax_validate_serve_record(JaxRecord.from_json(json.dumps(rec))) == []
    assert validate_serve_record(BenchmarkRecord.from_json(json.dumps(rec))) == []


def test_explain_prints_jaxs_text_for_a_jax_ledger(jax_selftest_ledger, capsys):
    from tpu_matmul_bench.serve import cli as jax_serve_cli

    for argv in (["--slowest", "3"], ["--slowest", "20"]):
        jax_serve_cli.main(["explain", "--ledger", str(jax_selftest_ledger), *argv])
        want = capsys.readouterr().out
        port_main(["serve", "explain", "--ledger", str(jax_selftest_ledger), *argv])
        assert capsys.readouterr().out == want
    trace = [json.loads(line) for line in jax_selftest_ledger.read_text().splitlines()
             if "serve_span" in line][4]["trace"]
    jax_serve_cli.main(["explain", "--ledger", str(jax_selftest_ledger), "--trace", trace])
    want = capsys.readouterr().out
    port_main(["serve", "explain", "--ledger", str(jax_selftest_ledger), "--trace", trace])
    assert capsys.readouterr().out == want
    with pytest.raises(SystemExit) as e:
        port_main(["serve", "explain", "--ledger", str(jax_selftest_ledger), "--trace", "x"])
    assert e.value.code == 1


def test_trace_selftest_on_the_cpu_exits_0(capsys):
    (rec,) = port_main(["serve", "trace", "selftest", "--device", "cpu"])
    assert "trace selftest ok: span coverage audit clean" in capsys.readouterr().out
    assert rec.extras["serve"]["cold_requests"] == 0


def test_bench_window_has_jaxs_keys(tmp_path, jax_selftest_ledger):
    path = tmp_path / "bench.jsonl"
    (rec,) = port_main(["serve", "bench", "--device", "cpu", "--mix", "128,64x128x256:0.5",
                        "--qps", "60", "--duration", "0.3", "--prewarm",
                        "--matmul-impl", "cuda", "--dtype", "bfloat16",
                        "--json-out", str(path)])
    s = rec.extras["serve"]
    assert validate_serve_record(rec) == [] and s["cold_requests"] == 0
    assert s["load_mode"] == "open" and s["offered_qps"] == 60.0
    got, want = _keys(_serve_record(path)), _keys(_serve_record(jax_selftest_ledger))
    assert got.pop("serve") - want.pop("serve") == {"offered_qps"}
    assert got == want
    # every `cuda` entry carries the kernel's cost books
    assert set(rec.extras["cost_analysis"]) == set(s["cache"]["by_entry"])
    assert {row["impl_source"] for row in s["buckets"].values()} == {"flag"}


def test_ab_writes_both_arms_and_a_verdict(tmp_path):
    path = tmp_path / "ab.jsonl"
    try:
        port_main(["serve", "ab", "--device", "cpu", "--mix", "128", "--qps", "80",
                   "--duration", "0.2", "--prewarm", "--json-out", str(path)])
    except SystemExit as e:  # a noisy CPU window may read as a regression
        assert e.code == 1
    recs = [json.loads(line) for line in path.read_text().splitlines()
            if json.loads(line).get("benchmark") == "serve"]
    assert [r["extras"]["serve"]["scheduler"] for r in recs] == ["fixed", "continuous"]
    verdict = recs[1]["extras"]["ab"]
    assert verdict["baseline"] == "fixed" and verdict["tolerance_pct"] >= 1.5
    for r in recs:
        assert validate_serve_record(BenchmarkRecord.from_json(json.dumps(r))) == []


def test_explore_stays_within_its_budget_on_the_cpu():
    (rec,) = port_main(["serve", "bench", "--device", "cpu", "--mix", "128", "--qps", "300",
                        "--duration", "0.3", "--prewarm", "--explore", "0.2"])
    ex = rec.extras["serve"]["explore"]
    assert ex["explored"] <= 0.2 * ex["seen"] and ex["seen"] == rec.extras["serve"]["requests"]
    # on the CPU `auto` takes the library; the explorer's runner-up is the kernel
    labels = rec.extras["serve"]["buckets"]
    assert set(labels) <= {"128x128x128/float32/auto", "128x128x128/float32/cuda"}
    if "128x128x128/float32/cuda" in labels:
        assert labels["128x128x128/float32/cuda"]["impl_source"] == "online"


def test_bench_needs_the_card_unless_the_cpu_is_asked_for():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["serve", "bench", "--mix", "64", "--duration", "0.1"])


LOAD = ["--mix", "64", "--qps", "40", "--duration", "0.2"]


@pytest.mark.parametrize("flags", [["bench", "--mesh", "dcn:2,ici:4"],
                                   ["bench", "--replica-groups", "2"],
                                   ["ab", "--comm-quant", "dcn=fp8-block:32,ici=none"],
                                   ["selftest", "--artifacts"],
                                   ["pod", "selftest"]])
def test_pod_and_artifact_options_run_on_the_cpu(flags, monkeypatch, capsys):
    from tpu_matmul_bench_torch.parallel.mesh import RANKS_PER_CARD_ENV

    # unset, restored afterwards: `--device cpu` places the mesh's ranks
    monkeypatch.setenv(RANKS_PER_CARD_ENV, "1")
    monkeypatch.delenv(RANKS_PER_CARD_ENV)
    argv = ["serve", *flags, "--device", "cpu", *(LOAD if flags[0] in ("bench", "ab") else [])]
    if flags == ["bench", "--replica-groups", "2"]:
        # as the JAX package: there is no pod to partition
        with pytest.raises(SystemExit, match="--replica-groups needs --mesh"):
            port_main(argv)
        return
    try:
        records = port_main(argv)
    except SystemExit as e:  # `ab`: a noisy CPU window may read as a regression
        assert flags[0] == "ab" and e.code == 1
        return
    s = records[-1].extras["serve"]
    assert all(validate_serve_record(r) == [] for r in records)
    if "--mesh" in flags or flags[0] == "pod":
        assert s["scheduler"] == "pod" and records[-1].world == 8
    if "--artifacts" in flags:
        # on the CPU nothing loads a library: nothing is imported or stored
        assert s["cache"]["artifacts"] == {"hits": 0, "misses": 0, "exports": 0, "errors": 0}
        assert "selftest ok" in capsys.readouterr().out


@pytest.mark.parametrize("flags, match", [(["--mix", "1x2"], "bad mix shape"),
                                          (["--tenants", "a=1,A=2"], "duplicate tenant"),
                                          (["--grid", "x"], "bad --grid"),
                                          (["--explore", "2"], "--explore must be in")])
def test_bad_flags_stop_before_the_device(flags, match):
    with pytest.raises(SystemExit, match=match):
        port_main(["serve", "bench", *flags])
