"""A process's launch, crossing and wire counters, for the caller of a
launcher run.

With `TMB_COUNTS_OUT=DIR` in its environment, a program started as
`python -m tpu_matmul_bench_torch <program>` (by the multihost launcher,
torchrun or by hand) writes `DIR/counts.p<process>.json` as it exits
(`__main__.py`); the caller reads the files after the processes have
exited. A process that joined no process group writes nothing. The
counters stay with the layers that count them (the kernels'
wrappers, `parallel/group.py`'s crossings, the wire's `WIRE_CALLS`); this
module only gathers them.
"""

from __future__ import annotations

import atexit
import json
import os

COUNTS_OUT_ENV = "TMB_COUNTS_OUT"


def counts() -> dict:
    """This process's counters: K1's launches (all and by route) and the
    ring steps' (`rs_launches`, `ag_launches`), the rings' hops within the
    card and between processes, the crossings with their seconds and bytes
    (`group.crossing_counts`), and the calls that put a quantized payload
    on the wire (`wire_calls`, "<format>,<collective>")."""
    from tpu_matmul_bench_torch.ops import cuda_matmul, cuda_ring
    from tpu_matmul_bench_torch.parallel import collectives, group

    return {"process": group.process_index(), "k1_launches": cuda_matmul.LAUNCHES,
            "launches_by_route": {k: v for k, v in
                                  cuda_matmul.LAUNCHES_BY_ROUTE.items() if v},
            "rs_launches": cuda_matmul.RS_LAUNCHES,
            "ag_launches": cuda_matmul.AG_LAUNCHES,
            "hop_launches": cuda_ring.HOP_LAUNCHES,
            "cross_hops": cuda_ring.CROSS_HOPS,
            **group.crossing_counts(),
            "wire_calls": {f"{spec},{collective}": n for (spec, collective), n
                           in sorted(collectives.WIRE_CALLS.items())}}


def write_counts(directory: str) -> str:
    """`counts()` as JSON in `directory`/counts.p<process>.json; returns
    the path."""
    now = counts()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"counts.p{now['process']}.json")
    with open(path, "w") as fh:
        json.dump(now, fh)
    return path


def write_at_exit() -> None:
    """Where `TMB_COUNTS_OUT` is set, write this process's counts there as
    it exits, if it joined a process group by then."""
    directory = os.environ.get(COUNTS_OUT_ENV)
    if directory:
        atexit.register(_write_in_group, directory)


def _write_in_group(directory: str) -> None:
    from tpu_matmul_bench_torch.parallel import group

    if group.active():
        write_counts(directory)
