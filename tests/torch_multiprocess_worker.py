"""One process of a two-process gloo group running the port's collectives.

Run under torchrun's environment (WORLD_SIZE=2, RANK, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) with TMB_RANKS_PER_CARD=2:

    python tests/torch_multiprocess_worker.py IN.npz OUT_DIR

IN.npz holds global operands (`<dtype>` arrays, bfloat16 as its uint16
bits). The world is 4 ranks on the CPU, 2 in each process; each operand is
cut by rows, and psum, all_gather, psum_scatter, ppermute and all_to_all
run over it. Each process writes its own ranks' results to
OUT_DIR/p<process>_<dtype>_<collective>_r<rank>.npy (bfloat16 as uint16)
and prints REPORTING or WORKER as `is_reporting_process` says.
"""

import sys
from pathlib import Path

import numpy as np
import torch

from tpu_matmul_bench_torch.parallel import collectives, group
from tpu_matmul_bench_torch.parallel.mesh import ROWS, make_mesh, ring_perm, shard_tensor
from tpu_matmul_bench_torch.utils.device import maybe_init_process_group, resolve_devices
from tpu_matmul_bench_torch.utils.reporting import is_reporting_process


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.astype(np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def main(inp: str, out_dir: str) -> None:
    assert maybe_init_process_group()
    mesh = make_mesh(resolve_devices("cpu", 4))
    me = group.process_index()
    arrays = np.load(inp)
    for dtype in arrays.files:
        shards = shard_tensor(_tensor(arrays[dtype], dtype), ROWS, mesh)
        results = {
            "psum": collectives.psum_over(mesh)(shards),
            "all_gather": collectives.all_gather_over(mesh)(shards),
            "psum_scatter": collectives.psum_scatter_over(mesh)(shards),
            "ppermute": collectives.ppermute(mesh, shards, ring_perm(4)),
            "all_to_all": collectives.all_to_all_over(mesh)(shards),
        }
        for name, outs in results.items():
            for rank, t in zip(mesh.ranks, outs):
                if rank.local:
                    np.save(Path(out_dir) / f"p{me}_{dtype}_{name}_r{rank.index}.npy",
                            _numpy(t))
    print(f"{'REPORTING' if is_reporting_process() else 'WORKER'} "
          f"process {me} of {group.process_count()}, "
          f"{sum(r.local for r in mesh.ranks)} local ranks, "
          f"verify {collectives.verify_collectives(mesh, verbose=False)}", flush=True)
    group.barrier()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
