"""Ranks as processes: the port's world split over a two-process gloo group.

Mirrors `tests/test_multihost.py` for the port. Every spawn is a real group
of 2 processes on the CPU, each holding 2 of the world's 4 ranks
(`TMB_RANKS_PER_CARD=2`), on a fresh port, in a session of its own that is
killed whole at its timeout; a transport failure or a timeout reruns the
whole group, as `test_multihost.py:_run_launcher` does.

(a) the collectives across the processes, bitwise against JAX's on 4 host
    devices for the same numpy operands, at bf16 and int8, and the wire
    formats' (block int8 and fp8, the legacy int8) at bf16; each call's
    crossings and bytes from each process's counts (`TMB_COUNTS_OUT`);
(b) the programs through the launcher (`python -m
    tpu_matmul_bench_torch.multihost`) and torchrun, each validated, with
    `validation_max_rel_err` and the `comm_quant` extra equal to the
    one-process 4-rank run's, with and without --comm-quant;
(c) the refusals: an uneven world, K6 across processes, a rendezvous that
    fails;
and, in this process, the launcher's argument handling, the world's
layout over the processes, the wire's placeholders for another process's
ranks and the runner's fail-fast rule.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_matmul_bench.parallel import collectives as jax_coll
from tpu_matmul_bench.parallel import mesh as jax_mesh
from tpu_matmul_bench.parallel import quantized as jax_quant
from tpu_matmul_bench_torch import multihost
from tpu_matmul_bench_torch.parallel import collectives, group, mesh
from tpu_matmul_bench_torch.utils import errors

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_multiprocess_worker.py"
SPAWN_TIMEOUT_S = 90
SMALL = ["--sizes", "64", "--iterations", "2", "--warmup", "1"]
PER_LINK = "dcn=fp8-block:32,ici=none"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(tmp_path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "TMB_RANKS_PER_CARD", "MULTIHOST_PROGRAM",
                        "MULTIHOST_PROC_ID", "MULTIHOST_COORDINATOR")}
    env.update(PYTHONPATH=str(REPO), TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def _transient(out: subprocess.CompletedProcess) -> bool:
    """A timeout, a dropped transport, or a port taken between choosing it
    and binding it: the whole group is run again."""
    return (out.returncode == 124 or errors.is_transport_message(out.stderr)
            or "address already in use" in out.stderr.lower())


def _spawn(cmds: list[list[str]], envs: list[dict], attempts: int = 3
           ) -> list[subprocess.CompletedProcess]:
    """Run the commands together, each in a session of its own; kill every
    session at the timeout; rerun the whole set on a transport failure or
    a timeout."""
    outs: list[subprocess.CompletedProcess] = []
    for _ in range(attempts):
        procs = [subprocess.Popen(c, cwd=str(REPO), env=e, text=True,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  start_new_session=True)
                 for c, e in zip(cmds, envs)]
        outs = []
        for p in procs:
            try:
                stdout, stderr = p.communicate(timeout=SPAWN_TIMEOUT_S)
                rc = p.returncode
            except subprocess.TimeoutExpired:
                for q in procs:
                    try:
                        os.killpg(q.pid, signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        pass
                stdout, stderr = p.communicate()
                rc, stderr = 124, (stderr or "") + "\n[timed out; sessions killed]"
            outs.append(subprocess.CompletedProcess(p.args, rc, stdout or "",
                                                    stderr or ""))
        if not any(_transient(o) for o in outs):
            break
    return outs


def _launch(tmp_path, program: str, args: list[str]) -> subprocess.CompletedProcess:
    cmd = [sys.executable, "-m", "tpu_matmul_bench_torch.multihost", *args]
    (out,) = _spawn([cmd], [_env(tmp_path, MULTIHOST_PROGRAM=program)])
    return out


def _record(path: Path) -> dict:
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines[0]["record_type"] == "manifest"
    (rec,) = lines[1:]
    return rec


def _one_process(monkeypatch, program: str, argv: list[str]):
    """The same program in this process over 4 ranks on the CPU."""
    import importlib

    from tpu_matmul_bench_torch.__main__ import _PROGRAMS

    monkeypatch.setenv(mesh.RANKS_PER_CARD_ENV, "4")
    (rec,) = importlib.import_module(_PROGRAMS[program]).main(
        argv + ["--device", "cpu", "--num-devices", "4"])
    return rec


# ---------------------------------------------------------------------------
# (a) the collectives, bitwise against JAX's
# ---------------------------------------------------------------------------

def _jax_results(arr: np.ndarray, devices) -> dict[str, list[np.ndarray]]:
    """Each of JAX's collectives over 4 host devices, as per-device arrays."""
    jmesh = jax_mesh.make_mesh(devices[:4])
    x = jax.device_put(jnp.asarray(arr), NamedSharding(jmesh, P("x")))

    def smap(body):
        return jax_mesh.smap(body, jmesh, in_specs=P("x"), out_specs=P("x"))

    stacked = {
        "psum": jax_coll.psum_over(jmesh)(x),
        "psum_scatter": smap(lambda v: lax.psum_scatter(
            v, "x", scatter_dimension=0, tiled=True))(x),
        "ppermute": smap(lambda v: lax.ppermute(v, "x", jax_mesh.ring_perm(4)))(x),
        "all_to_all": smap(lambda v: lax.all_to_all(v, "x", 0, 0, tiled=True))(x),
    }
    out = {name: np.split(np.asarray(y), 4) for name, y in stacked.items()}
    whole = np.asarray(jax_coll.all_gather_over(jmesh)(x))
    out["all_gather"] = [whole] * 4
    return out


WIRE_SPECS = ("int8-block:8", "fp8-block:8", "int8")

# the counted calls' operand: [32, COUNTED_COLS] bf16 over 4 ranks, so a
# rank's shard holds N = 8 · COUNTED_COLS elements, and block 32
COUNTED_COLS, COUNTED_BLOCK = 64, 32


def _jax_wire_results(arr: np.ndarray, devices) -> dict[str, list[np.ndarray]]:
    """JAX's wire collectives of the same names over 4 host devices, as
    per-device arrays (the worker's `_wire_results`)."""
    jmesh = jax_mesh.make_mesh(devices[:4])
    x = jax.device_put(jnp.asarray(arr), NamedSharding(jmesh, P("x")))

    def run(body):
        f = jax_mesh.smap(lambda v: body(v, "x"), jmesh, in_specs=P("x"),
                          out_specs=P("x"), check_vma=False)
        return np.split(np.asarray(f(x)), 4)

    out = {}
    for spec in WIRE_SPECS:
        tag, fmt = spec.replace(":", ""), jax_coll.parse_wire_format(spec)
        if fmt.legacy:
            out[f"wire_psum_{tag}"] = run(jax_quant.quantized_psum)
        else:
            out[f"wire_psum_{tag}"] = run(lambda v, a: jax_coll.wire_psum(v, a, fmt))
            out[f"wire_rs_{tag}"] = run(
                lambda v, a: jax_coll.wire_reduce_scatter(v, a, fmt))
        for axis in (0, 1):
            out[f"wire_ag{axis}_{tag}"] = run(
                (lambda v, a: jax_quant.quantized_all_gather(v, a, axis=axis)) if fmt.legacy
                else (lambda v, a: jax_coll.wire_all_gather(v, a, fmt, axis=axis)))
    return out


@pytest.fixture(scope="module")
def worker_run(tmp_path_factory):
    """The worker's group of 2 processes, once a module: its operands, its
    output directory, its counts directory and each process's output."""
    tmp_path = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(21)
    operands = {
        "bfloat16": (rng.standard_normal((32, 24)) * 4).astype(ml_dtypes.bfloat16),
        "int8": rng.integers(-8, 8, size=(32, 24)).astype(np.int8),
    }
    counted = rng.standard_normal((32, COUNTED_COLS)).astype(ml_dtypes.bfloat16)
    np.savez(tmp_path / "in.npz", bfloat16=operands["bfloat16"].view(np.uint16),
             int8=operands["int8"], counted=counted.view(np.uint16))
    out_dir, counts = tmp_path / "out", tmp_path / "counts"
    cmds = [[sys.executable, str(WORKER), str(tmp_path / "in.npz"), str(out_dir)]] * 2
    for _ in range(3):  # a fresh port and fresh directories for each try
        for d in (out_dir, counts):
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir()
        port = str(_free_port())
        envs = [_env(tmp_path, WORLD_SIZE="2", RANK=str(i), LOCAL_RANK=str(i),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=port, TMB_RANKS_PER_CARD="2",
                     TMB_COUNTS_OUT=str(counts))
                for i in range(2)]
        outs = _spawn(cmds, envs, attempts=1)
        if not any(_transient(o) for o in outs):
            break
    return {"operands": operands, "out_dir": out_dir, "counts": counts, "outs": outs}


def _worker_ok(run: dict) -> None:
    for o in run["outs"]:
        assert o.returncode == 0, o.stderr[-3000:]


def _assert_results(run: dict, dtype: str, want: dict) -> None:
    for name, per_rank in want.items():
        for r in range(4):
            got = np.load(run["out_dir"] / f"p{r // 2}_{dtype}_{name}_r{r}.npy")
            expect = np.asarray(per_rank[r])
            if dtype == "bfloat16":
                expect = expect.view(np.uint16)
            assert got.shape == expect.shape, (dtype, name, r)
            assert np.array_equal(got, expect), (dtype, name, r)


def test_collectives_across_processes_are_jax_bitwise(worker_run, devices):
    _worker_ok(worker_run)
    said = "".join(o.stdout for o in worker_run["outs"])
    assert said.count("REPORTING") == 1 and said.count("WORKER") == 1, said
    assert said.count("2 local ranks, verify True") == 2, said
    for dtype, arr in worker_run["operands"].items():
        _assert_results(worker_run, dtype, _jax_results(arr, devices))


def test_wire_collectives_across_processes_are_jax_bitwise(worker_run, devices):
    """Every rank's result of each wire collective, in every format, equals
    JAX's bit for bit; the worker's wire arithmetic never met another
    process's placeholder (it would have raised)."""
    _worker_ok(worker_run)
    _assert_results(worker_run, "bfloat16",
                    _jax_wire_results(worker_run["operands"]["bfloat16"], devices))


def _counts(run: dict) -> dict[str, list[dict]]:
    """Each checkpoint's counts of both processes, by label, in order."""
    out = {}
    for d in sorted(p for p in run["counts"].iterdir() if p.is_dir()):
        out[d.name.split("-", 1)[1]] = [
            json.loads((d / f"counts.p{p}.json").read_text()) for p in range(2)]
    return out


def _wire(elements: int) -> dict[str, int]:
    """Bytes of `elements` values on a block-32 wire: 1-byte payload, one
    fp32 scale a block."""
    return {"payload": elements, "scales": elements // COUNTED_BLOCK * 4}


def test_wire_crosses_once_a_hop_with_payload_and_scales_only(worker_run):
    """Each process's crossings and received bytes a call, from its counts
    (`TMB_COUNTS_OUT`, written after each counted call). At D = 4 over 2
    processes and a shard of N elements a rank, chunk N/D: a wire psum
    crosses D − 1 + 1 = 4 times and receives (D − 1)·N/D (the hops) + 2·N/D
    (the gather of the other process's two chunks) payload bytes and their
    scales, (5/4)(1 + 4/B)·N, against the exact psum's 4·N (the other
    process's two bf16 shards): below 0.36× at B = 32. A reduce-scatter
    crosses D − 1 times, a gather once. Under dcn=fp8-block:32,ici=none on
    dcn:2,ici:2 the dcn groups cross processes and the ici groups do not:
    every byte that crosses is fp8 payload or fp32 scales."""
    _worker_ok(worker_run)
    counts = _counts(worker_run)
    labels = list(counts)
    assert labels == ["start", "exact_psum", "wire_psum_int8", "wire_psum_fp8",
                      "wire_rs_int8", "wire_ag_int8", "per_link_dcn", "per_link_ici"]
    n, d = 8 * COUNTED_COLS, 4
    chunk = _wire(n // d)
    want = {
        "exact_psum": (1, {"bfloat16": 2 * 2 * n}),
        "wire_psum_int8": (4, {"int8": 5 * chunk["payload"], "float32": 5 * chunk["scales"]}),
        "wire_psum_fp8": (4, {"float8_e4m3fn": 5 * chunk["payload"],
                              "float32": 5 * chunk["scales"]}),
        "wire_rs_int8": (3, {"int8": 3 * chunk["payload"], "float32": 3 * chunk["scales"]}),
        "wire_ag_int8": (1, {"int8": 2 * _wire(n)["payload"],
                             "float32": 2 * _wire(n)["scales"]}),
        # 2 dcn groups of 2 ranks, one in each process: one hop and one
        # gather of a half-shard chunk each
        "per_link_dcn": (4, {"float8_e4m3fn": 2 * 2 * _wire(n // 2)["payload"],
                             "float32": 2 * 2 * _wire(n // 2)["scales"]}),
        "per_link_ici": (0, {}),
    }
    for before, label in zip(labels, labels[1:]):
        crossings, by_dtype = want[label]
        for p in range(2):
            a, b = counts[before][p], counts[label][p]
            got = {k: v - a["crossing_bytes_in_by_dtype"].get(k, 0)
                   for k, v in b["crossing_bytes_in_by_dtype"].items()}
            got = {k: v for k, v in got.items() if v}
            assert b["crossings"] - a["crossings"] == crossings, (label, p)
            assert got == by_dtype, (label, p)
            assert b["crossing_bytes_in"] - a["crossing_bytes_in"] == sum(by_dtype.values())
            assert b["crossing_bytes_out"] - a["crossing_bytes_out"] == sum(by_dtype.values())
    wire_in = sum(want["wire_psum_int8"][1].values())
    assert wire_in == 5 / 4 * (1 + 4 / COUNTED_BLOCK) * n
    assert wire_in / sum(want["exact_psum"][1].values()) < 0.36
    # the wire calls, by format and collective, in the counts each process
    # writes as it exits: the worker's bf16 section and the counted calls
    final = [json.loads((worker_run["counts"] / f"counts.p{p}.json").read_text())
             for p in range(2)]
    calls = {f"{s},{c}": 1 for s in ("int8-block:8", "fp8-block:8")
             for c in ("all_reduce", "reduce_scatter")}
    calls.update({f"{s},all_gather": 2 for s in WIRE_SPECS})
    calls.update({"int8,all_reduce": 1, "int8-block:32,all_reduce": 1,
                  "int8-block:32,reduce_scatter": 1, "int8-block:32,all_gather": 1,
                  "fp8-block:32,all_reduce": 3})
    assert [f["wire_calls"] for f in final] == [calls, calls]


# ---------------------------------------------------------------------------
# (b) the programs through the launcher
# ---------------------------------------------------------------------------

# (program, the launcher's MODE, its extra flags, what the output must say
# beyond the common lines); the one-process run takes the same mode and flags
PROGRAMS = [
    ("scaling", "independent", [], "Results for 64x64 [independent]"),
    ("scaling", "batch_parallel", ["--timing", "fused"], "timing: fused"),
    ("distributed", "data_parallel", [], "Results for 64x64 [data_parallel]"),
    ("summa", "summa", [], "Grid: 2 (i) x 2 (j)"),
    ("hybrid", "hybrid", [], "Mesh: dp=2 x tp=2"),
    ("overlap", "collective_matmul_bidir", [],
     "Results for 64x64 [collective_matmul_bidir]"),
    ("overlap", "collective_matmul_bidir_rs", [],
     "Results for 64x64 [collective_matmul_bidir_rs]"),
    ("overlap", "cuda_ring_hbm", [], "Results for 64x64 [cuda_ring_hbm]"),
    ("overlap", "cuda_ring_bidir_rs_hbm", [], "Results for 64x64 [cuda_ring_bidir_rs_hbm]"),
    ("matmul", "matmul", [], "Total TFLOPS (4 ranks; cards: 1, ranks_per_card: 4)"),
    # the wire formats across the processes: block, legacy and per-link
    ("distributed", "model_parallel", ["--comm-quant", "int8-block:32"],
     "Results for 64x64 [model_parallel]"),
    ("distributed", "data_parallel", ["--comm-quant", "int8"], "'wire_format': 'int8'"),
    ("scaling", "matrix_parallel", ["--comm-quant", "fp8-block:16"],
     "Results for 64x64 [matrix_parallel]"),
    ("hybrid", "hybrid", ["--mesh=dcn:2,ici:2", "--comm-quant", PER_LINK],
     "Mesh: dp=2 x tp=2 (dcn x ici)"),
    ("summa", "summa", ["--mesh=dcn:2,ici:2", "--comm-quant", PER_LINK],
     "Grid: 2 (dcn) x 2 (ici)"),
]


def _program_id(program: str, mode: str, flags: list[str]) -> str:
    quant = flags[flags.index("--comm-quant") + 1] if "--comm-quant" in flags else None
    return f"{program}-{mode}" + (f"-{quant}" if quant else "")


@pytest.mark.parametrize("program,mode,flags,expect", PROGRAMS,
                         ids=[_program_id(*p[:3]) for p in PROGRAMS])
def test_launcher_runs_the_program(tmp_path, monkeypatch, program, mode, flags,
                                   expect):
    out_json = tmp_path / "rec.jsonl"
    out = _launch(tmp_path, program, ["2", mode, "bfloat16", "--device=cpu", *SMALL,
                                      "--validate", "--json-out", str(out_json),
                                      *flags])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Number of devices: 4" in out.stdout
    assert "Processes: 2 (this is process 0)" in out.stdout
    assert out.stdout.count("Results for") == 1, out.stdout
    assert "validation: ok" in out.stdout
    assert expect in out.stdout
    rec = _record(out_json)
    assert rec["world"] == 4 and rec["extras"]["cards"] == 1
    argv = [] if program in multihost.MODELESS else ["--mode", mode]
    one = _one_process(monkeypatch, program,
                       argv + flags + SMALL + ["--validate", "--dtype", "bfloat16"])
    assert rec["extras"]["validation_max_rel_err"] == \
        one.extras["validation_max_rel_err"]
    assert rec["extras"].get("comm_quant") == \
        json.loads(json.dumps(one.extras.get("comm_quant")))


def test_launcher_runs_the_curve_in_process_multiples(tmp_path):
    md = tmp_path / "curve.md"
    out = _launch(tmp_path, "curve", ["2", "independent", "bfloat16", "--device=cpu",
                                      *SMALL, "--markdown-out", str(md)])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "scaling curve: independent at 2 device(s)" in out.stdout
    assert "scaling curve: independent at 4 device(s)" in out.stdout
    assert "at 1 device(s)" not in out.stdout
    table = md.read_text()
    assert "| 2 |" in table and "| 4 |" in table
    assert out.stdout.count("| Devices | Total TFLOPS") == 1


def test_torchrun_runs_the_scaling_program(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-port", str(_free_port()), "-m", "tpu_matmul_bench_torch",
           "scaling", "--device", "cpu", *SMALL, "--validate"]
    (out,) = _spawn([cmd], [_env(tmp_path, TMB_RANKS_PER_CARD="2")])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Number of devices: 4" in out.stdout
    assert "Processes: 2 (this is process 0)" in out.stdout
    assert out.stdout.count("Results for 64x64 [independent]") == 1


def test_torchrun_runs_a_wire_format(tmp_path, monkeypatch):
    out_json = tmp_path / "rec.jsonl"
    flags = ["--mode", "model_parallel", "--comm-quant", "fp8-block:32", *SMALL,
             "--validate", "--dtype", "bfloat16"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-port", str(_free_port()), "-m", "tpu_matmul_bench_torch",
           "distributed", "--device", "cpu", *flags, "--json-out", str(out_json)]
    counts = tmp_path / "counts"
    (out,) = _spawn([cmd], [_env(tmp_path, TMB_RANKS_PER_CARD="2",
                                 TMB_COUNTS_OUT=str(counts))])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Processes: 2 (this is process 0)" in out.stdout
    assert "validation: ok" in out.stdout
    rec = _record(out_json)
    monkeypatch.setattr(collectives, "WIRE_CALLS", {})
    one = _one_process(monkeypatch, "distributed", flags)
    assert rec["extras"]["validation_max_rel_err"] == one.extras["validation_max_rel_err"]
    assert rec["extras"]["comm_quant"] == json.loads(json.dumps(one.extras["comm_quant"]))
    # each process wrote its counts as it exited (`python -m
    # tpu_matmul_bench_torch` under TMB_COUNTS_OUT), its wire calls those
    # of the one-process run
    want = {f"{spec},{kind}": n for (spec, kind), n in sorted(collectives.WIRE_CALLS.items())}
    assert want
    for p in range(2):
        got = json.loads((counts / f"counts.p{p}.json").read_text())
        assert got["process"] == p and got["wire_calls"] == want
        assert got["crossings"] > 0


# ---------------------------------------------------------------------------
# (c) the refusals
# ---------------------------------------------------------------------------

REFUSALS = [
    ("scaling", ["2", "independent", "bfloat16", "--device=cpu", *SMALL,
                 "--num-devices", "3"],
     "--num-devices 3 must be a multiple of the 2-process cluster size"),
    ("overlap", ["2", "cuda_ring", "bfloat16", "--device=cpu", *SMALL],
     "the fused ring (cuda_ring) runs every rank in one cooperative launch "
     "in one process"),
    # a wire collective that cannot run ends the group's run: nothing falls
    # back to the exact collective or to one process
    ("scaling", ["2", "matrix_parallel", "bfloat16", "--device=cpu", *SMALL,
                 "--comm-quant", "fp8-block:32"],
     "block size 32 must divide the collective payload's last dim (16)"),
]


@pytest.mark.parametrize("program,args,message", REFUSALS,
                         ids=["uneven-world", "fused-ring", "wire-block"])
def test_launcher_refuses_with_a_message(tmp_path, program, args, message):
    out = _launch(tmp_path, program, args)
    assert out.returncode == 1
    assert message in out.stderr, out.stderr[-3000:]
    assert "process 0 failed" in out.stderr
    assert "Results for" not in out.stdout


def test_a_failed_rendezvous_raises(tmp_path):
    cmd = [sys.executable, "-m", "tpu_matmul_bench_torch", "scaling", "--device",
           "cpu", *SMALL]
    env = _env(tmp_path, WORLD_SIZE="2", RANK="0", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               TMB_GROUP_TIMEOUT_S="3")
    (out,) = _spawn([cmd], [env], attempts=1)
    assert out.returncode != 0
    assert "process-group rendezvous at tcp://127.0.0.1:" in out.stderr
    assert "Results for" not in out.stdout


# ---------------------------------------------------------------------------
# (d) one group that runs several programs in turn (`chip_smoke.py
#     --process-plan`, the card's `processes` phase)
# ---------------------------------------------------------------------------

# (tag, program, mode, flags): each entry of the plan, and a launcher run
PLAN = [("batch_parallel", "scaling", "batch_parallel", []),
        ("cuda_ring_rs_hbm", "overlap", "cuda_ring_rs_hbm", []),
        ("summa-per-link", "summa", "summa",
         ["--mesh", "dcn:2,ici:2", "--comm-quant", PER_LINK])]
# the counts a plan entry and a launcher run must share, process by process
PLAN_COUNTS = ("k1_launches", "launches_by_route", "rs_launches", "ag_launches",
               "hop_launches", "cross_hops", "crossings", "crossing_bytes_out",
               "crossing_bytes_in", "crossing_bytes_in_by_dtype", "wire_calls")


def _plan_flags(flags: list[str]) -> list[str]:
    return ["--device", "cpu", *SMALL, "--validate", *flags]


def _run_plan(tmp_path, monkeypatch, entries: list[dict]) -> tuple[dict, int, str]:
    """The plan's group of 2 on the CPU, rerun on a transport failure."""
    import chip_smoke

    for k, v in _env(tmp_path).items():
        monkeypatch.setenv(k, v)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for attempt in range(3):
        where = tmp_path / f"try{attempt}"
        plan = chip_smoke.start_plan(
            [dict(e, after=None) for e in entries], str(where))
        rc, why = chip_smoke.finish_plan(plan, 3 * SPAWN_TIMEOUT_S)
        if rc == 0 or not (rc == 124 or errors.is_transport_message(why)
                           or "address already in use" in why.lower()):
            break
    return plan, rc, why


@pytest.fixture(scope="module")
def plan_group(tmp_path_factory):
    """PLAN run once a module by one group of 2 processes."""
    import chip_smoke

    tmp_path = tmp_path_factory.mktemp("plan")
    with pytest.MonkeyPatch.context() as mp:
        entries = [chip_smoke.plan_entry(tag, program, mode, _plan_flags(flags))
                   for tag, program, mode, flags in PLAN]
        plan, rc, why = _run_plan(tmp_path, mp, entries)
    return {"plan": plan, "rc": rc, "why": why}


@pytest.mark.parametrize("tag,program,mode,flags", PLAN, ids=[p[0] for p in PLAN])
def test_one_group_runs_each_program_as_a_launcher_run(plan_group, tmp_path, monkeypatch,
                                                       tag, program, mode, flags):
    import chip_smoke

    assert plan_group["rc"] == 0, plan_group["why"]
    entry = chip_smoke.plan_run(plan_group["plan"], tag)
    assert entry["rc"] == 0
    assert "Processes: 2 (this is process 0)" in entry["text"]
    assert entry["text"].count("Results for") == 1
    assert "validation: ok" in entry["text"]
    rec = entry["record"]
    assert rec["world"] == 4 and rec["extras"]["cards"] == 1
    # the same program as a launcher run of its own, its exit counts
    out_json, counts_dir = tmp_path / "rec.jsonl", tmp_path / "counts"
    cmd = [sys.executable, "-m", "tpu_matmul_bench_torch.multihost", "2", mode, "bfloat16",
           "--device=cpu", *SMALL, "--validate", "--json-out", str(out_json), *flags]
    (out,) = _spawn([cmd], [_env(tmp_path, MULTIHOST_PROGRAM=program,
                                 TMB_COUNTS_OUT=str(counts_dir))])
    assert out.returncode == 0, out.stderr[-3000:]
    alone = _record(out_json)
    assert alone["world"] == 4
    assert rec["extras"]["validation_max_rel_err"] == \
        alone["extras"]["validation_max_rel_err"]
    assert rec["extras"].get("comm_quant") == alone["extras"].get("comm_quant")
    for p in range(2):
        got = entry["counts"][p]
        want = json.loads((counts_dir / f"counts.p{p}.json").read_text())
        assert got["process"] == want["process"] == p
        assert {k: got[k] for k in PLAN_COUNTS} == {k: want[k] for k in PLAN_COUNTS}, tag
        assert got["crossings"] > 0
    # and the one-process run's validation error
    argv = [] if program in multihost.MODELESS else ["--mode", mode]
    one = _one_process(monkeypatch, program,
                       argv + flags + SMALL + ["--validate", "--dtype", "bfloat16"])
    assert rec["extras"]["validation_max_rel_err"] == one.extras["validation_max_rel_err"]


def test_a_failed_plan_entry_ends_both_processes_naming_it(tmp_path, monkeypatch):
    import chip_smoke

    # a block that does not divide the payload raises when the mode is built
    entries = [chip_smoke.plan_entry("batch_parallel", "scaling", "batch_parallel",
                                     _plan_flags([])),
               chip_smoke.plan_entry("bad-block", "scaling", "matrix_parallel",
                                     _plan_flags(["--comm-quant", "fp8-block:32"])),
               chip_smoke.plan_entry("never", "scaling", "independent", _plan_flags([]))]
    plan, rc, why = _run_plan(tmp_path, monkeypatch, entries)
    assert rc == 1
    assert "entry bad-block failed" in why
    assert all(p.returncode not in (None, 0) for p in plan["procs"])
    assert (Path(plan["dirs"]["batch_parallel"]) / "counts.p1.json").is_file()
    assert not Path(plan["dirs"]["never"]).exists()
    # the process log holds the entry's own error, and a program's error
    # is no reason to run the group again
    assert "ValueError" in why or "Error" in why
    assert not chip_smoke.plan_transient(plan)


def test_a_failed_process_ends_its_peer(tmp_path):
    import chip_smoke

    logs = [tmp_path / "p0.log", tmp_path / "p1.log"]
    cmds = [[sys.executable, "-c",
             "import sys; print('process 0: plan entry x failed'); sys.exit(1)"],
            [sys.executable, "-c", "import time; time.sleep(60)"]]
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT,
                                          start_new_session=True))
    t0 = time.monotonic()
    rc, why = chip_smoke.finish_plan({"procs": procs, "logs": [str(p) for p in logs]}, 50)
    assert rc == 1 and why.startswith("entry x failed")
    assert time.monotonic() - t0 < 20
    assert procs[0].returncode == 1 and procs[1].returncode == -signal.SIGTERM


_TRACE = "Traceback (most recent call last):\n  File \"x.py\", line 1, in <module>\n"


@pytest.mark.parametrize("text,want", [
    (_TRACE + "RuntimeError: [gloo] Connection closed by peer [127.0.0.1]:4242", True),
    (_TRACE + "RuntimeError: process-group rendezvous at tcp://127.0.0.1:1 failed "
              "for process 0 of 2: The server socket has failed to listen on any "
              "local network address. port: 1, useIpv6: 0, code: -98, name: EADDRINUSE, "
              "message: address already in use", True),
    (_TRACE + "ValueError: block 32 does not divide 48", False),
    # an earlier transport error handled, then the program's own
    (_TRACE + "RuntimeError: Connection reset by peer\n\nDuring handling of the above "
              "exception, another exception occurred:\n\n" + _TRACE
              + "AssertionError: launches differ", False),
    ("RuntimeError: Connection closed by peer, printed without a traceback", False),
    ("", False),
])
def test_a_transient_failure_is_the_last_errors_own(text, want):
    import chip_smoke

    assert chip_smoke.transient_failure(text) is want


@pytest.mark.parametrize("script,want", [
    ("print('Traceback (most recent call last):'); "
     "print('RuntimeError: [gloo] Connection closed by peer'); "
     "print('process 0: plan entry x failed'); sys.exit(1)", True),
    ("print('Traceback (most recent call last):'); print('KeyError: 3'); "
     "print('process 0: plan entry x failed'); sys.exit(1)", False),
    ("import os, signal; os.kill(os.getpid(), signal.SIGSEGV)", False),
], ids=["transport", "program", "signal"])
def test_only_a_group_that_failed_on_the_loopback_runs_again(tmp_path, script, want):
    import chip_smoke

    logs = [tmp_path / "p0.log", tmp_path / "p1.log"]
    cmds = [[sys.executable, "-c", f"import sys; {script}"],
            # the peer, killed once process 0 has failed, is not read
            [sys.executable, "-c", "import time; print('Connection reset by peer'); "
                                   "time.sleep(60)"]]
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT,
                                          start_new_session=True))
    plan = {"procs": procs, "logs": [str(p) for p in logs]}
    rc, _ = chip_smoke.finish_plan(plan, 50)
    assert rc == 1 and plan["codes"][0] != 0 and plan["codes"][1] is None
    assert chip_smoke.plan_transient(plan) is want


def test_a_timed_out_group_is_not_transient(tmp_path):
    import chip_smoke

    log = tmp_path / "p0.log"
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"],
                                stdout=fh, stderr=subprocess.STDOUT, start_new_session=True)
    plan = {"procs": [proc], "logs": [str(log)]}
    rc, why = chip_smoke.finish_plan(plan, 1)
    assert rc == 124 and "timed out" in why and plan["codes"] == [None]
    assert not chip_smoke.plan_transient(plan)


def test_a_failed_phase_is_reported_on_both_streams(capsys):
    import chip_smoke

    with pytest.raises(SystemExit) as e:
        chip_smoke.fail("processes", "the group's run (rc 1): entry x failed")
    assert e.value.code == 1
    out, err = capsys.readouterr()
    assert json.loads(out) == {"phase": "processes", "ok": False,
                               "error": "the group's run (rc 1): entry x failed"}
    assert err == ("chip_smoke: phase processes failed: the group's run (rc 1): "
                   "entry x failed\n")


@pytest.mark.parametrize("before,after,want", [
    ({"process": 1, "k1_launches": 5, "launches_by_route": {"wgmma": 5},
      "crossing_min_s": None, "wire_calls": {}},
     {"process": 1, "k1_launches": 9, "launches_by_route": {"wgmma": 7, "simt": 2},
      "crossing_min_s": 0.5, "wire_calls": {"int8,all_reduce": 3}},
     {"process": 1, "k1_launches": 4, "launches_by_route": {"wgmma": 2, "simt": 2},
      "crossing_min_s": 0.5, "wire_calls": {"int8,all_reduce": 3}}),
    ({"crossings": 3, "crossing_min_s": 0.1, "wire_calls": {"int8,all_reduce": 3}},
     {"crossings": 3, "crossing_min_s": float("inf"), "wire_calls": {"int8,all_reduce": 3}},
     {"crossings": 0, "crossing_min_s": None, "wire_calls": {}}),
])
def test_plan_counts_are_the_entrys_own(before, after, want):
    import chip_smoke

    assert chip_smoke.counts_since(before, after) == want


# ---------------------------------------------------------------------------
# in this process: the launcher's arguments, the world's layout, fail-fast
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,want", [
    (["2"], (2, None, "bfloat16", False, [])),
    (["4", "batch_parallel", "float32", "--device=cpu", "--sizes", "64"],
     (4, "batch_parallel", "float32", True, ["--sizes", "64", "--device", "cpu"])),
    (["2", "summa", "bfloat16", "--mesh=dcn:2,ici:2"],
     (2, "summa", "bfloat16", False, ["--mesh", "dcn:2,ici:2"])),
])
def test_launcher_parses_its_arguments(argv, want):
    assert multihost.parse(argv) == want


@pytest.mark.parametrize("program,mode,has_mode", [
    ("scaling", None, "independent"), ("distributed", None, "data_parallel"),
    ("overlap", None, "overlap"), ("collectives", None, "psum"),
    ("curve", None, "independent"), ("scaling", "batch_parallel", "batch_parallel"),
    ("summa", "summa", None), ("hybrid", None, None), ("matmul", None, None),
])
def test_launcher_builds_the_program_command(program, mode, has_mode):
    cmd = multihost.build_command(program, mode, "bfloat16", ["--sizes", "64"])
    assert cmd[1:4] == ["-m", "tpu_matmul_bench_torch", program]
    if has_mode is None:
        assert "--mode" not in cmd
    else:
        assert cmd[cmd.index("--mode") + 1] == has_mode
    assert cmd[-4:] == ["--dtype", "bfloat16", "--sizes", "64"]


def test_launcher_refuses_an_unknown_program(monkeypatch, capsys):
    monkeypatch.setenv("MULTIHOST_PROGRAM", "nope")
    assert multihost.main(["2"]) == 2
    assert "unknown MULTIHOST_PROGRAM 'nope'" in capsys.readouterr().err


@pytest.fixture
def two_processes(monkeypatch):
    """This process seen as process 1 of a group of 2 (no group is formed:
    the layout reads only these)."""
    monkeypatch.setattr(group, "active", lambda: True)
    monkeypatch.setattr(group, "process_index", lambda: 1)
    monkeypatch.setattr(group, "process_count", lambda: 2)
    monkeypatch.setattr(group, "ensure_group", lambda procs: None)
    monkeypatch.setattr(group, "process_cards", lambda: ["h/cuda/A", "h/cuda/A"])


def _world(n: int):
    import torch

    me = 1
    per = n // 2
    return [torch.device("cpu") if r // per == me else torch.device("meta")
            for r in range(n)]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_world_mesh_lays_ranks_over_the_processes(two_processes, n):
    m = mesh.make_mesh(_world(n))
    assert [r.process for r in m.ranks] == [r // (n // 2) for r in range(n)]
    assert [r.local for r in m.ranks] == [r >= n // 2 for r in range(n)]
    assert m.spans_processes and m.processes == [0, 1]
    # two processes on one card: one card, every rank on it
    assert m.card_count == 1 and m.ranks_per_card == n
    assert not m.shared_card  # the rings hop across processes
    assert [str(d) for d in m.cards] == ["cpu"]
    assert m.first_local.type == "cpu"


def test_world_mesh_counts_two_cards(two_processes, monkeypatch):
    monkeypatch.setattr(group, "process_cards", lambda: ["h/cuda/A", "h/cuda/B"])
    m = mesh.make_mesh(_world(4))
    assert m.card_count == 2 and m.ranks_per_card == 2


def test_world_mesh_refuses_a_misplaced_rank(two_processes):
    import torch

    with pytest.raises(ValueError, match="belongs to process 0"):
        mesh.make_mesh([torch.device("cpu"), torch.device("meta"),
                        torch.device("cpu"), torch.device("cpu")])


def test_sub_meshes_keep_their_processes(two_processes):
    m = mesh.make_mesh(_world(4), ("dp", "tp"), (2, 2))
    across = m.sub_mesh("dp", 0)  # ranks 0 and 2: one in each process
    within = m.sub_mesh("tp", 2)  # ranks 2 and 3: both in process 1
    assert across.spans_processes and [r.process for r in across.ranks] == [0, 1]
    assert not within.spans_processes and within.processes == [1]


def test_shards_of_another_process_are_placeholders(two_processes):
    import torch

    m = mesh.make_mesh(_world(4))
    g = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    shards = mesh.shard_tensor(g, mesh.ROWS, m)
    assert [s.device.type for s in shards] == ["meta", "meta", "cpu", "cpu"]
    assert all(s.shape == (2, 4) for s in shards)
    assert torch.equal(shards[3], g[6:])
    assert mesh.first_local_shard(shards) is shards[2]


@pytest.fixture
def fake_transport(two_processes, monkeypatch):
    """The group's transport replaced by one that hands this process (1 of
    2) zeros for whatever it receives, logging each exchange's moves and
    each all_gather; the wire's arithmetic raises on a placeholder."""
    import torch

    from tpu_matmul_bench_torch.parallel import collectives as col

    calls = []

    def exchange_pairs(moves):
        calls.append(("exchange", [(src, dst, t.dtype) for src, dst, t in moves]))
        return {i: torch.zeros(t.shape, dtype=t.dtype) for i, (src, dst, t)
                in enumerate(moves) if dst == 1 and src != 1}

    def all_gather_shards(owners, shards, processes=None):
        calls.append(("all_gather", [s.dtype for s in shards]))
        return [s if o == 1 else torch.zeros(s.shape, dtype=s.dtype)
                for o, s in zip(owners, shards)]

    monkeypatch.setattr(group, "exchange_pairs", exchange_pairs)
    monkeypatch.setattr(group, "all_gather_shards", all_gather_shards)
    for name in ("_wire_quantize", "_dequantize_add", "_wire_dequantize"):
        def guarded(*args, _real=getattr(col, name), _name=name):
            if any(isinstance(a, torch.Tensor) and a.is_meta for a in args):
                raise AssertionError(f"{_name} met another process's placeholder")
            return _real(*args)
        monkeypatch.setattr(col, name, guarded)
    return calls


# (collective, format): the legacy int8 has no reduce_scatter
WIRE_CASES = [(c, f) for c in ("psum", "reduce_scatter", "all_gather") for f in WIRE_SPECS
              if not (c == "reduce_scatter" and f == "int8")]


@pytest.mark.parametrize("collective,spec", WIRE_CASES)
def test_the_wire_computes_nothing_for_another_process(fake_transport, collective,
                                                       spec):
    """On process 1 of 2 (ranks 2 and 3 of 4), a wire collective quantizes,
    dequantizes and sums only its own ranks' values; ranks 0 and 1 get
    placeholders of the result's shape and dtype. Each hop moves its
    payload and its fp32 scales in one exchange, and the gather fetches
    both in one all_gather."""
    import torch

    from tpu_matmul_bench_torch.parallel import collectives as col

    fmt = col.parse_wire_format(spec)
    m = mesh.make_mesh(_world(4))
    g = torch.arange(32 * 24, dtype=torch.float32).reshape(32, 24).to(torch.bfloat16)
    shards = mesh.shard_tensor(g, mesh.ROWS, m)
    if collective == "psum":
        out, want, hops = col.psum_impl(spec)(m, shards), (8, 24), 3
    elif collective == "reduce_scatter":
        out, want, hops = col.reduce_scatter_impl(spec)(m, shards), (2, 24), 3
    else:
        out, want, hops = col.allgather_impl(spec)(m, shards, axis=1), (8, 96), 0
    assert [o.device.type for o in out] == ["meta", "meta", "cpu", "cpu"]
    assert all(tuple(o.shape) == want and o.dtype == torch.bfloat16 for o in out)
    wire = (fmt.wire_dtype, torch.float32)
    kinds = [kind for kind, _ in fake_transport]
    assert kinds == ["exchange"] * hops + (["all_gather"] if collective != "reduce_scatter"
                                           else [])
    for kind, moved in fake_transport:
        if kind == "exchange":  # the ring's 4 moves of payloads, then of scales
            assert [t for _, _, t in moved] == [wire[0]] * 4 + [wire[1]] * 4
        else:
            assert moved == [wire[0]] * 4 + [wire[1]] * 4


@pytest.mark.parametrize("impl", ["torch", "cuda", "auto"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_a_product_of_another_process_computes_nothing(impl, dtype):
    import torch

    from tpu_matmul_bench_torch.ops import cuda_matmul as cm
    from tpu_matmul_bench_torch.ops.matmul import matmul_2d

    dt = getattr(torch, dtype)
    before = cm.LAUNCHES
    a = torch.empty((64, 32), dtype=dt, device="meta")
    b = torch.empty((32, 16), dtype=dt, device="meta")
    c = matmul_2d(impl)(a, b)
    assert c.device.type == "meta" and c.shape == (64, 16)
    assert c.dtype == (torch.int32 if dtype == "int8" else dt)
    out = torch.empty((64, 16), dtype=c.dtype, device="meta")
    assert matmul_2d(impl)(a, b, out=out) is out
    assert cm.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cm.cuda_matmul(a, b)  # the kernel's wrapper itself still refuses


@pytest.mark.parametrize("message", [
    "[gloo/transport/tcp/pair.cc:553] Connection closed by peer [127.0.0.1]:4",
    "[gloo/transport/tcp/pair.cc:546] Read timeout [127.0.0.1]:1",
    "Gloo AllGather failed: Timed out waiting 300000ms for recv operation",
])
def test_gloo_transport_failures_are_recognised(message):
    assert errors.is_transport_message(message)


def test_a_failed_size_ends_a_group_run(monkeypatch):
    from tpu_matmul_bench_torch.benchmarks import runner
    from tpu_matmul_bench_torch.utils.config import parse_config

    monkeypatch.setattr(runner, "distributed_active", lambda: True)
    config = parse_config(["--device", "cpu", "--sizes", "64", "128"],
                          description="t", modes=["independent"],
                          default_mode="independent")
    seen = []

    def bench_one(size):
        seen.append(size)
        raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory (simulated)")

    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        runner.run_sizes(config, bench_one)
    assert seen == [64]  # no size skipped: the group's run ends here
