"""Program fingerprints and the drift gate of the port
(`tpu_matmul_bench_torch/analysis/fingerprint.py`, `regen_golden.py`).

The committed golden must be what a regen writes; two regens give the same
digests; a seeded extra cast moves a digest (DRIFT-001) and a dropped key
is DRIFT-002; and the key set is the JAX package's golden key set under the
renames the module states.
"""

import json
from pathlib import Path

import pytest
import torch

from tpu_matmul_bench_torch.analysis import fingerprint as fp
from tpu_matmul_bench_torch.analysis import regen_golden
from tpu_matmul_bench_torch.analysis.schedule import run_program
from tpu_matmul_bench_torch.parallel import mesh as pmesh
from tpu_matmul_bench_torch.utils.device import resolve_devices
from torch_port_util import single_torch_thread  # noqa: F401 — a fixture

pytestmark = pytest.mark.usefixtures("single_torch_thread")

REPO = Path(__file__).resolve().parent.parent
JAX_GOLDEN = REPO / "tests" / "golden" / "program_fingerprints.json"


@pytest.fixture(scope="module")
def cpu8():
    mp = pytest.MonkeyPatch()
    mp.setenv(pmesh.RANKS_PER_CARD_ENV, "8")
    yield resolve_devices("cpu", None)
    mp.undo()


@pytest.fixture(scope="module")
def current(cpu8):
    return fp.current_fingerprints(cpu8)


def test_regen_check_exits_0(capsys):
    assert regen_golden.main(["--check"]) == 0
    assert "up to date (63 programs)" in capsys.readouterr().out


def test_golden_is_jax_s_format_and_the_current_map(current):
    doc = json.loads(fp.golden_path().read_text())
    jax_doc = json.loads(JAX_GOLDEN.read_text())
    assert set(doc) == set(jax_doc) and doc["schema"] == jax_doc["schema"]
    assert doc["worlds"] == jax_doc["worlds"] == list(fp.FINGERPRINT_WORLDS)
    assert list(doc["fingerprints"]) == sorted(doc["fingerprints"])
    assert doc["fingerprints"] == current
    assert fp.golden_document(current) == fp.golden_path().read_text()


def test_two_runs_give_identical_digests(cpu8, current):
    assert fp.current_fingerprints(cpu8) == current


def test_key_set_is_jax_s_under_the_stated_renames(current):
    jax_keys = json.loads(JAX_GOLDEN.read_text())["fingerprints"]
    assert {fp.port_key(k) for k in jax_keys} | set(fp.PORT_ONLY_KEYS) == set(current)
    assert len({fp.port_key(k) for k in jax_keys}) == len(jax_keys)
    assert not set(fp.PORT_ONLY_KEYS) & {fp.port_key(k) for k in jax_keys}


def test_clean_tree_has_no_drift(current):
    assert fp.check_drift(current, fp.load_golden()) == []


def test_seeded_extra_cast_fires_drift001(cpu8, current):
    key = "impl:torch/bfloat16"
    build = fp.program_builds(cpu8, worlds=())[key]

    def with_cast():
        fn, ops = build()
        return (lambda a, b: fn(a, b).float().to(torch.bfloat16)), ops
    run = run_program(with_cast)
    moved = dict(current, **{key: fp.digest(fp.canonical_record(run.record, run.operands))})
    found = fp.check_drift(moved, fp.load_golden())
    assert [(f.rule, f.where) for f in found] == [("DRIFT-001", f"fingerprint:{key}")]


def test_seeded_schedule_change_fires_drift001(cpu8, current):
    # a ring whose hops wait on nothing: the same products and collectives,
    # another schedule
    from tpu_matmul_bench_torch.analysis import schedule as sc
    from tpu_matmul_bench_torch.ops import cuda_ring

    key = "ring:ag@d4"
    real_wait = cuda_ring._Schedule.wait
    try:
        cuda_ring._Schedule.wait = lambda self, r, which, *ev, reuse=False: real_wait(
            self, r, which, *([] if which != cuda_ring._COMPUTE else ev), reuse=reuse)
        run = run_program(sc.ring_build("ag", cpu8, 4))
    finally:
        cuda_ring._Schedule.wait = real_wait
    moved = dict(current, **{key: fp.digest(fp.canonical_record(run.record, run.operands,
                                                                run.log))})
    assert [f.rule for f in fp.check_drift(moved, fp.load_golden())] == ["DRIFT-001"]


def test_dropped_key_fires_drift002(current):
    golden = dict(fp.load_golden())
    dropped = sorted(golden)[0]
    del golden[dropped]
    found = fp.check_drift(current, golden)
    assert [(f.rule, f.severity, f.where) for f in found] == \
        [("DRIFT-002", "warn", f"fingerprint:{dropped}")]
    stale = dict(fp.load_golden(), **{"mode:gone@d4": "0" * 16})
    assert [f.rule for f in fp.check_drift(current, stale)] == ["DRIFT-002"]
    assert [f.rule for f in fp.check_drift(current, None)] == ["DRIFT-002"]


def test_records_hold_no_pointers_or_times(cpu8):
    builds = fp.program_builds(cpu8, worlds=(4,))
    for key in ("mode:model_parallel+fp8-block:32@d4", "overlap:pipeline@d4",
                "ring:rs_bidir@d4", "impl:cuda_ksplit/float32"):
        run = run_program(builds[key])
        record = fp.canonical_record(run.record, run.operands,
                                     run.log if key.startswith(("overlap", "ring")) else None)
        text = json.dumps(record)
        assert "0x" not in text and "data_ptr" not in text
        assert record["ops"], key
        products = record["ops"].get("cuda_matmul", 0) + record["ops"].get(
            "cuda_matmul_ksplit", 0)
        assert products > 0, key  # each K1 product is one primitive
