"""Multi-process launcher: NPROCS processes of one program in a gloo group.

Port of `run_multihost_benchmark.sh`, the JAX package's torchrun analogue
(reference `run_scaling_benchmark.sh:23-31` spawns one process a GPU with
`torch.distributed.run`). Each process gets torchrun's environment
(`WORLD_SIZE`, `RANK`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) on a
port checked free, and `OMP_NUM_THREADS=1`; the program joins the group
(`utils/device.py maybe_init_process_group`) and holds its share of the
world's ranks.

    python -m tpu_matmul_bench_torch.multihost NPROCS [MODE] [DTYPE] \\
        [--device=cpu] [--mesh=dcn:R,ici:C] [program flags...]

`MULTIHOST_PROGRAM` picks the program: scaling (default), distributed,
overlap, collectives, curve, summa, hybrid or matmul; MODE defaults as in
the JAX launcher (independent, data_parallel, overlap, psum, independent;
summa, hybrid and matmul take no --mode). With `--device=cpu` every
process holds 2 ranks on the CPU (`TMB_RANKS_PER_CARD=2`, the counterpart
of JAX's 2 forced devices a host); on the card the caller's
`TMB_RANKS_PER_CARD` applies, and process p takes card p mod the cards.
Process 0 runs in the foreground; the others write to log files. If
process 0 fails, the others get TERM, then KILL after a short grace, and
the launcher exits 1 naming the logs.

Every program flag passes through, `--comm-quant` included: the wire
formats cross the processes with the one-process world's bits, each ring
hop's payload and scales in one exchange (`parallel/collectives.py`).
With `--mesh=dcn:R,ici:C` and R = NPROCS the process boundary is the dcn
link, as in the JAX launcher, so `--comm-quant dcn=<fmt>,ici=none`
quantizes exactly what crosses. The fused ring `cuda_ring` (K6) and, on
the card, a `--timing fused` program whose calls cross processes exit
with a message.

Several hosts: run the launcher once a host with `MULTIHOST_PROC_ID` (the
host's process index) and `MULTIHOST_COORDINATOR=<host0>:<port>`; it then
runs one process that joins the group there. That form is not exercised
by the tests, which run every process on one machine.
"""

from __future__ import annotations

import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Sequence

PROGRAMS = ("scaling", "distributed", "overlap", "collectives", "curve",
            "summa", "hybrid", "matmul")
DEFAULT_MODES = {"distributed": "data_parallel", "overlap": "overlap",
                 "collectives": "psum", "curve": "independent"}
# the programs whose mode is the program itself (no --mode flag)
MODELESS = ("summa", "hybrid", "matmul")
# seconds a worker has after TERM before it is killed
GRACE_S = 2.0
# the launch time every process measures its start-up from
LAUNCH_T0_ENV = "TMB_LAUNCH_T0"


def free_port() -> int:
    """A port nothing listens on now (an occupied one would make the
    rendezvous wait until its timeout)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_command(program: str, mode: str | None, dtype: str,
                  extra: Sequence[str]) -> list[str]:
    cmd = [sys.executable, "-m", "tpu_matmul_bench_torch", program]
    if program not in MODELESS:
        cmd += ["--mode", mode or DEFAULT_MODES.get(program, "independent")]
    return cmd + ["--dtype", dtype, *extra]


def parse(argv: Sequence[str]) -> tuple[int, str | None, str, bool, list[str]]:
    """(nprocs, mode, dtype, cpu, program flags) from the launcher's
    arguments: positional NPROCS, MODE and DTYPE while they do not start
    with '-', then --device=cpu, --mesh=SPEC and the program's own flags."""
    args = list(argv)
    pos: list[str] = []
    while args and not args[0].startswith("-") and len(pos) < 3:
        pos.append(args.pop(0))
    nprocs = int(pos[0]) if pos else 2
    if nprocs < 1:
        raise SystemExit(f"NPROCS must be positive, got {nprocs}")
    mode = pos[1] if len(pos) > 1 else None
    dtype = pos[2] if len(pos) > 2 else "bfloat16"
    cpu, extra = False, []
    for a in args:
        if a == "--device=cpu":
            cpu = True
        elif a.startswith("--device="):
            raise SystemExit(f"{a}: the launcher takes --device=cpu or no --device")
        elif a.startswith("--mesh="):
            extra += ["--mesh", a.removeprefix("--mesh=")]
        else:
            extra.append(a)
    if cpu:
        extra += ["--device", "cpu"]
    return nprocs, mode, dtype, cpu, extra


def _reap(procs: list[subprocess.Popen]) -> None:
    """TERM every live worker, then KILL what is left after the grace (a
    worker inside a gloo read may not see TERM until the read returns)."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + GRACE_S
    for p in live:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def main(argv: Sequence[str] | None = None) -> int:
    nprocs, mode, dtype, cpu, extra = parse(sys.argv[1:] if argv is None else argv)
    program = os.environ.get("MULTIHOST_PROGRAM", "scaling")
    if program not in PROGRAMS:
        print(f"ERROR: unknown MULTIHOST_PROGRAM {program!r} (one of "
              f"{', '.join(PROGRAMS)})", file=sys.stderr)
        return 2
    cmd = build_command(program, mode, dtype, extra)
    env = dict(os.environ, WORLD_SIZE=str(nprocs), OMP_NUM_THREADS="1")
    if cpu:
        env["TMB_RANKS_PER_CARD"] = "2"
    proc_id = os.environ.get("MULTIHOST_PROC_ID")
    coordinator = os.environ.get("MULTIHOST_COORDINATOR")
    if proc_id is not None:
        if not coordinator:
            print("ERROR: MULTIHOST_PROC_ID is set but MULTIHOST_COORDINATOR is "
                  "not: every host must rendezvous at one <host0>:<port>",
                  file=sys.stderr)
            return 2
        host, _, port = coordinator.rpartition(":")
        env.update(RANK=proc_id, LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                   MASTER_ADDR=host, MASTER_PORT=port)
        print(f"Joining process group {coordinator} as process {proc_id}/{nprocs}",
              flush=True)
        os.execvpe(cmd[0], cmd, env)
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               LOCAL_WORLD_SIZE=str(nprocs), **{LAUNCH_T0_ENV: repr(time.time())})
    print(f"Running multi-process benchmark: {nprocs} processes, program="
          f"{program}, mode={mode or DEFAULT_MODES.get(program, '-')}, "
          f"dtype={dtype}, group=tcp://127.0.0.1:{env['MASTER_PORT']}", flush=True)
    logs = tempfile.mkdtemp(prefix="tmb_multihost_")
    workers: list[subprocess.Popen] = []
    try:
        for i in range(1, nprocs):
            with open(os.path.join(logs, f"worker{i}.log"), "w") as log:
                workers.append(subprocess.Popen(
                    cmd, env=dict(env, RANK=str(i), LOCAL_RANK=str(i)),
                    stdout=log, stderr=subprocess.STDOUT))
        rc = subprocess.call(cmd, env=dict(env, RANK="0", LOCAL_RANK="0"))
        if rc != 0:
            _reap(workers)
            print(f"process 0 failed (exit {rc}); worker logs in {logs}",
                  file=sys.stderr)
            return 1
        failed = [i + 1 for i, p in enumerate(workers) if p.wait() != 0]
    except BaseException:
        _reap(workers)
        raise
    if failed:
        print(f"worker(s) {failed} failed; logs kept in {logs}", file=sys.stderr)
        return 1
    shutil.rmtree(logs, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
