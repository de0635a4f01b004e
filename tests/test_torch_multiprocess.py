"""Ranks as processes: the port's world split over a two-process gloo group.

Mirrors `tests/test_multihost.py` for the port. Every spawn is a real group
of 2 processes on the CPU, each holding 2 of the world's 4 ranks
(`TMB_RANKS_PER_CARD=2`), on a fresh port, in a session of its own that is
killed whole at its timeout; a transport failure or a timeout reruns the
whole group, as `test_multihost.py:_run_launcher` does.

(a) the collectives across the processes, bitwise against JAX's on 4 host
    devices for the same numpy operands, at bf16 and int8;
(b) the programs through the launcher (`python -m
    tpu_matmul_bench_torch.multihost`) and torchrun, each validated, with
    `validation_max_rel_err` equal to the one-process 4-rank run's;
(c) the refusals: an uneven world, a wire format, K6 across processes, a
    rendezvous that fails;
and, in this process, the launcher's argument handling, the world's
layout over the processes and the runner's fail-fast rule.
"""

import json
import os
import signal
import socket
import subprocess
import sys
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
from tpu_matmul_bench_torch import multihost
from tpu_matmul_bench_torch.parallel import group, mesh
from tpu_matmul_bench_torch.utils import errors

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_multiprocess_worker.py"
SPAWN_TIMEOUT_S = 90
SMALL = ["--sizes", "64", "--iterations", "2", "--warmup", "1"]


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


def test_collectives_across_processes_are_jax_bitwise(tmp_path, devices):
    rng = np.random.default_rng(21)
    operands = {
        "bfloat16": (rng.standard_normal((32, 24)) * 4).astype(ml_dtypes.bfloat16),
        "int8": rng.integers(-8, 8, size=(32, 24)).astype(np.int8),
    }
    np.savez(tmp_path / "in.npz", bfloat16=operands["bfloat16"].view(np.uint16),
             int8=operands["int8"])
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    cmds = [[sys.executable, str(WORKER), str(tmp_path / "in.npz"), str(out_dir)]] * 2
    for _ in range(3):  # a fresh port for each try of the whole group
        port = str(_free_port())
        envs = [_env(tmp_path, WORLD_SIZE="2", RANK=str(i), LOCAL_RANK=str(i),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=port, TMB_RANKS_PER_CARD="2")
                for i in range(2)]
        outs = _spawn(cmds, envs, attempts=1)
        if not any(_transient(o) for o in outs):
            break
    for o in outs:
        assert o.returncode == 0, o.stderr[-3000:]
    said = "".join(o.stdout for o in outs)
    assert said.count("REPORTING") == 1 and said.count("WORKER") == 1, said
    assert said.count("2 local ranks, verify True") == 2, said
    for dtype, arr in operands.items():
        want = _jax_results(arr, devices)
        for name, per_rank in want.items():
            for r in range(4):
                got = np.load(out_dir / f"p{r // 2}_{dtype}_{name}_r{r}.npy")
                expect = np.asarray(per_rank[r])
                if dtype == "bfloat16":
                    expect = expect.view(np.uint16)
                assert got.shape == expect.shape, (dtype, name, r)
                assert np.array_equal(got, expect), (dtype, name, r)


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
]


@pytest.mark.parametrize("program,mode,flags,expect", PROGRAMS,
                         ids=[f"{p[0]}-{p[1]}" for p in PROGRAMS])
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


# ---------------------------------------------------------------------------
# (c) the refusals
# ---------------------------------------------------------------------------

REFUSALS = [
    ("scaling", ["2", "independent", "bfloat16", "--device=cpu", *SMALL,
                 "--num-devices", "3"],
     "--num-devices 3 must be a multiple of the 2-process cluster size"),
    ("scaling", ["2", "batch_parallel", "bfloat16", "--device=cpu", *SMALL,
                 "--comm-quant", "int8-block:32"],
     "over a mesh that spans processes [0, 1] is not ported"),
    ("overlap", ["2", "cuda_ring", "bfloat16", "--device=cpu", *SMALL],
     "the fused ring (cuda_ring) runs every rank in one cooperative launch "
     "in one process"),
]


@pytest.mark.parametrize("program,args,message", REFUSALS,
                         ids=["uneven-world", "wire-format", "fused-ring"])
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
