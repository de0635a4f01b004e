"""One process of a two-process gloo group running the port's collectives.

Run under torchrun's environment (WORLD_SIZE=2, RANK, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) with TMB_RANKS_PER_CARD=2 and TMB_COUNTS_OUT=DIR:

    python tests/torch_multiprocess_worker.py IN.npz OUT_DIR

IN.npz holds global operands (`<dtype>` arrays, bfloat16 as its uint16
bits, and `counted`, bfloat16 bits). The world is 4 ranks on the CPU, 2 in
each process; each operand is cut by rows, and psum, all_gather,
psum_scatter, ppermute and all_to_all run over it, and on bfloat16 the wire
collectives in WIRE_SPECS. Each process writes its own ranks' results to
OUT_DIR/p<process>_<dtype>_<collective>_r<rank>.npy (bfloat16 as uint16)
and prints REPORTING or WORKER as `is_reporting_process` says. Then each
call of COUNTED runs on `counted` and is followed by this process's counts
(`counts.write_counts`) in DIR/<nn>-<label>, so that the caller reads each
call's crossings and bytes as the difference of two counts; the counts at
exit go to DIR, as a program's do. The wire's
arithmetic raises here if it meets another process's placeholder.
"""

import os
import sys
from pathlib import Path

import numpy as np
import torch

from tpu_matmul_bench_torch import counts
from tpu_matmul_bench_torch.parallel import collectives, group
from tpu_matmul_bench_torch.parallel.mesh import (
    ROWS,
    make_mesh,
    ring_perm,
    shard_tensor,
)
from tpu_matmul_bench_torch.utils.device import maybe_init_process_group, resolve_devices
from tpu_matmul_bench_torch.utils.reporting import is_reporting_process

# the wire formats run across the processes; the legacy int8 has no
# reduce_scatter
WIRE_SPECS = ("int8-block:8", "fp8-block:8", "int8")
PER_LINK = "dcn=fp8-block:32,ici=none"


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.astype(np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _refuse_placeholders() -> None:
    """The wire's arithmetic raises on a meta tensor: a rank of another
    process must get none."""
    for name in ("_wire_quantize", "_dequantize_add", "_wire_dequantize"):
        def guarded(*args, _real=getattr(collectives, name), _name=name):
            if any(isinstance(a, torch.Tensor) and a.is_meta for a in args):
                raise AssertionError(f"{_name} met another process's placeholder")
            return _real(*args)
        setattr(collectives, name, guarded)


def _wire_results(mesh, shards) -> dict:
    out = {}
    for spec in WIRE_SPECS:
        tag = spec.replace(":", "")
        out[f"wire_psum_{tag}"] = collectives.psum_impl(spec)(mesh, shards)
        if not collectives.parse_wire_format(spec).legacy:
            out[f"wire_rs_{tag}"] = collectives.reduce_scatter_impl(spec)(mesh, shards)
        for axis in (0, 1):
            out[f"wire_ag{axis}_{tag}"] = collectives.allgather_impl(spec)(
                mesh, shards, axis=axis)
    return out


def counted(mesh, mesh2) -> list:
    """(label, call) of each counted call, in order."""
    per_link = collectives.psum_impl(PER_LINK)
    return [
        ("exact_psum", lambda s: collectives.psum_over(mesh)(s)),
        ("wire_psum_int8", lambda s: collectives.psum_impl("int8-block:32")(mesh, s)),
        ("wire_psum_fp8", lambda s: collectives.psum_impl("fp8-block:32")(mesh, s)),
        ("wire_rs_int8", lambda s: collectives.reduce_scatter_impl("int8-block:32")(mesh, s)),
        ("wire_ag_int8", lambda s: collectives.allgather_impl("int8-block:32")(mesh, s)),
        ("per_link_dcn", lambda s: collectives.over_axis(mesh2, "dcn", s, per_link)),
        ("per_link_ici", lambda s: collectives.over_axis(mesh2, "ici", s, per_link)),
    ]


def main(inp: str, out_dir: str) -> None:
    counts.write_at_exit()  # as `python -m tpu_matmul_bench_torch` does
    assert maybe_init_process_group()
    _refuse_placeholders()
    devices = resolve_devices("cpu", 4)
    mesh = make_mesh(devices)
    mesh2 = make_mesh(devices, ("dcn", "ici"), (2, 2))
    me = group.process_index()
    arrays = np.load(inp)
    for dtype in ("bfloat16", "int8"):
        shards = shard_tensor(_tensor(arrays[dtype], dtype), ROWS, mesh)
        results = {
            "psum": collectives.psum_over(mesh)(shards),
            "all_gather": collectives.all_gather_over(mesh)(shards),
            "psum_scatter": collectives.psum_scatter_over(mesh)(shards),
            "ppermute": collectives.ppermute(mesh, shards, ring_perm(4)),
            "all_to_all": collectives.all_to_all_over(mesh)(shards),
        }
        if dtype == "bfloat16":
            results.update(_wire_results(mesh, shards))
        for name, outs in results.items():
            for rank, t in zip(mesh.ranks, outs):
                if rank.local:
                    np.save(Path(out_dir) / f"p{me}_{dtype}_{name}_r{rank.index}.npy",
                            _numpy(t))
    counts_dir = os.environ[counts.COUNTS_OUT_ENV]
    shards = shard_tensor(_tensor(arrays["counted"], "bfloat16"), ROWS, mesh)
    counts.write_counts(os.path.join(counts_dir, "00-start"))
    for i, (label, call) in enumerate(counted(mesh, mesh2), start=1):
        call(shards)
        counts.write_counts(os.path.join(counts_dir, f"{i:02d}-{label}"))
    print(f"{'REPORTING' if is_reporting_process() else 'WORKER'} "
          f"process {me} of {group.process_count()}, "
          f"{sum(r.local for r in mesh.ranks)} local ranks, "
          f"verify {collectives.verify_collectives(mesh, verbose=False)}", flush=True)
    group.barrier()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
