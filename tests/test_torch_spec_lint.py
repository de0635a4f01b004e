"""The port's spec lint (`tpu_matmul_bench_torch/analysis/spec_lint.py`)
against JAX's (`tpu_matmul_bench/analysis/spec_lint.py`).

On every shipped spec whose vocabulary both packages share (the
`specs/*.toml` that name no `pallas` impl) and on each seeded spec of
JAX's `tests/test_lint.py`, rebuilt here, the two give the same (rule,
where, severity) list. The port's own card specs lint clean.
"""

import json
from pathlib import Path

import pytest

from tpu_matmul_bench.analysis import spec_lint as jax_lint
from tpu_matmul_bench_torch.analysis import spec_lint
from tpu_matmul_bench_torch.analysis.cli import default_specs
from torch_port_util import single_torch_thread  # noqa: F401 — a fixture

pytestmark = pytest.mark.usefixtures("single_torch_thread")

REPO = Path(__file__).resolve().parent.parent
SHARED = [p for p in sorted((REPO / "specs").glob("*.toml"))
          if "pallas" not in p.read_text()]


def _triples(findings):
    return [(f.rule, f.where, f.severity) for f in findings]


def test_shared_vocabulary_is_most_of_the_shipped_specs():
    names = {p.name for p in SHARED}
    assert {"round.toml", "tune.toml"}.isdisjoint(names)
    assert {"serve.toml", "hier.toml", "train.toml", "chaos.toml", "history.toml"} <= names


@pytest.mark.parametrize("path", SHARED, ids=lambda p: p.name)
def test_shared_specs_lint_as_jax(path):
    assert _triples(spec_lint.lint_spec_file(path)) == _triples(jax_lint.lint_spec_file(path))


def test_card_specs_lint_clean():
    paths = default_specs()
    assert [Path(p).name for p in paths] == ["card.toml", "history.toml", "round.toml",
                                             "tune.toml"]
    assert spec_lint.lint_specs(paths) == []


def _serve(flags):
    return ('[campaign]\nname = "seeded"\n\n[[job]]\nid = "j1"\nprogram = "serve"\n'
            f'flags = {json.dumps(flags)}\n')


_BASE = ["bench", "--qps", "10", "--duration", "0.2", "--mix", "64"]

# JAX's seeded specs (tests/test_lint.py), plus one of each later family
SEEDED = {
    "bad_comm_quant": (
        '[campaign]\nname = "seeded"\n\n'
        '[[job]]\nid = "bad-grammar"\nprogram = "compare"\n'
        'flags = ["--mode", "data_parallel", "--sizes", "256",'
        ' "--num-devices", "8", "--comm-quant", "int7"]\n\n'
        '[[job]]\nid = "bad-block"\nprogram = "compare"\n'
        'flags = ["--mode", "matrix_parallel", "--sizes", "256",'
        ' "--num-devices", "8", "--comm-quant", "int8-block:48"]\n\n'
        '[[job]]\nid = "ok"\nprogram = "compare"\n'
        'flags = ["--mode", "model_parallel", "--sizes", "256",'
        ' "--num-devices", "8", "--comm-quant", "int8-block:32"]\n'),
    "unknown_key": (
        '[campaign]\nname = "seeded"\n\n[[job]]\nid = "j1"\nprogram = "matmul"\n'
        'timout_s = 60\nflags = ["--sizes", "64"]\n'),
    "collision": (
        '[campaign]\nname = "seeded"\n\n'
        '[[job]]\nid = "a"\nprogram = "matmul"\nflags = ["--sizes", "64"]\n\n'
        '[[job]]\nid = "b"\nprogram = "matmul"\nflags = ["--sizes", "64"]\n'),
    "unparseable": '[campaign\nname = "torn"\n',
    "indivisible": (
        '[campaign]\nname = "seeded"\n\n'
        '[[sweep]]\nid_prefix = "s"\nprogram = "distributed"\n'
        'sizes = [100]\nmodes = ["model_parallel"]\nnum_devices = [8]\n'),
    "tenant_key": '[tenants.interactive]\nweight = 2.0\nslo_mss = 250.0\n',
    "tenant_bounds": ('[tenants.negweight]\nweight = -1.0\n\n'
                      '[tenants.zeroslo]\nslo_ms = 0.0\n\n'
                      '[tenants.badmix]\nmix = "not-a-shape"\n'),
    "tenant_dup": ('[tenants.interactive]\nweight = 2.0\n\n'
                   '[tenants.INTERACTIVE]\nweight = 1.0\n'),
    "inline_dup": _serve(_BASE + ["--tenants", "a=1,A=2"]),
    "inline_bounds": _serve(_BASE + ["--tenants", "a=0/0"]),
    "inline_scheduler": _serve(_BASE + ["--scheduler", "quantum"]),
    "inline_clean": _serve(_BASE + ["--tenants", "a=2/0/250,b=1/1",
                                    "--scheduler", "continuous"]),
    "missing_tenants": _serve(["bench", "--mix", "64", "--tenants",
                               "no_such_tenants.toml"]),
    "serve_unknown_flag": _serve(_BASE + ["--no-such-flag", "1"]),
    "obs_bad_window": ('[campaign]\nname = "seeded"\n\n[[job]]\nid = "d"\n'
                       'program = "obs"\nflags = ["detect", "--detect-window", "0"]\n'),
    "hier_bad_mesh": ('[campaign]\nname = "seeded"\n\n[[job]]\nid = "h"\n'
                      'program = "hybrid"\nflags = ["--mesh", "dcn:3,ici:4", '
                      '"--num-devices", "8", "--sizes", "256"]\n'),
    "train_bad_zero": ('[campaign]\nname = "seeded"\n\n[[job]]\nid = "t"\n'
                       'program = "train"\nflags = ["bench", "--zero", "2", '
                       '"--sizes", "256"]\n'),
    "pod_groups": _serve(["bench", "--mesh", "dcn:2,ici:4", "--replica-groups", "3",
                          "--mix", "256"]),
    "chaos_key": '[chaos]\nseed = 1\nbogus = 2\n',
    "history_key": '[history]\nwindow = 3\n',
}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_specs_lint_as_jax(tmp_path, name):
    path = tmp_path / f"{name}.toml"
    path.write_text(SEEDED[name])
    got = _triples(spec_lint.lint_spec_file(path))
    assert got == _triples(jax_lint.lint_spec_file(path))
    if name != "inline_clean":
        assert got, "a seeded spec must fire"
