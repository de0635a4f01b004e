"""Device setup: which device runs the benchmark, and the matmul precision.

Port of `tpu_matmul_bench/utils/device.py`. The card is the default: with
no CUDA device, `resolve_devices` raises unless the CPU was asked for, so a
run never moves to the CPU unannounced. `resolve_devices` returns one
device per rank: `TMB_RANKS_PER_CARD` ranks may share each card
(`parallel/mesh.py`).

Ranks as processes: `maybe_init_process_group` joins this process to a
gloo group under torchrun's environment contract (`WORLD_SIZE` > 1,
`RANK`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`; ≙ JAX
`maybe_init_multihost`). Each process then holds `TMB_RANKS_PER_CARD`
ranks on card `LOCAL_RANK % device_count` (or on the CPU), and
`resolve_devices` lays the world out over the processes, a balanced block
of ranks each, a rank of another process on the meta device
(`parallel/group.py`). A rendezvous that fails raises: a process never
goes on alone. With `TMB_COUNTS_OUT=DIR` each process writes its kernel
launches and crossings to DIR as it exits (`counts.py`).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Sequence

import torch

from tpu_matmul_bench_torch.parallel import group

# torchrun's environment contract
_GROUP_ENV = ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# seconds a rendezvous or a collective may wait for the other processes
GROUP_TIMEOUT_ENV = "TMB_GROUP_TIMEOUT_S"


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    """Environment description for the banner."""

    platform: str  # 'cuda' | 'cpu'
    device_kind: str  # e.g. 'NVIDIA H100 80GB HBM3'
    num_devices: int  # ranks
    torch_version: str
    cuda_version: str | None
    memory_gib: float | None  # per-device memory, when known
    cards: int = 1  # distinct devices the ranks occupy
    ranks_per_card: int = 1  # the most ranks any one device holds
    num_processes: int = 1
    process_index: int = 0
    # each process's seconds from the launcher's start to the rendezvous
    startup_s: tuple[float, ...] | None = None


def apply_matmul_precision(precision: str | None) -> None:
    """--precision → torch's float32 matmul precision.

    "default" and "highest" keep true fp32 products; "high" lets float32
    products run in TF32. Reduced-precision reductions in cuBLAS's bf16 and
    fp16 products are switched off in every case, so the library baseline
    keeps the accumulate-in-fp32 contract of the kernel it is compared to.
    """
    torch.set_float32_matmul_precision("high" if precision == "high" else "highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def precision_extras() -> dict:
    """The matmul settings in force, for the record (see
    apply_matmul_precision)."""
    matmul = torch.backends.cuda.matmul
    return {
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "bf16_reduced_precision_reduction":
            matmul.allow_bf16_reduced_precision_reduction,
    }


def maybe_init_process_group() -> bool:
    """Join the gloo process group torchrun's environment describes (≙ JAX
    `utils/device.py:172-227`); True when this process is one of several.
    Idempotent. Without `WORLD_SIZE` > 1 nothing happens. A missing
    variable or a rendezvous that fails within `TMB_GROUP_TIMEOUT_S`
    (default 300) raises, where JAX warns and carries on as one process:
    a process that went on alone would measure a world it is not in."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    dist = torch.distributed
    if dist.is_initialized():
        return True
    missing = [v for v in _GROUP_ENV if v not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE={world} but {', '.join(missing)} "
                           "unset: launch with torchrun or "
                           "python -m tpu_matmul_bench_torch.multihost")
    rank = int(os.environ["RANK"])
    address = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    timeout = float(os.environ.get(GROUP_TIMEOUT_ENV, "300"))
    try:
        dist.init_process_group("gloo", init_method=address, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
    except Exception as e:  # noqa: BLE001 — re-raised with its context
        raise RuntimeError(f"process-group rendezvous at {address} failed "
                           f"for process {rank} of {world}: {e}") from e
    t0 = os.environ.get("TMB_LAUNCH_T0")  # set by the multihost launcher
    group.share_cards(group.card_id(_process_card()),
                      time.time() - float(t0) if t0 else None)
    return True


def _process_card() -> torch.device:
    """This process's card: `LOCAL_RANK % device_count`, or the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    index = int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def resolve_devices(device: str = "cuda",
                    num_devices: int | None = None) -> list[torch.device]:
    """The device of each rank: `device` is the --device flag value ('cuda'
    or 'cpu'), `num_devices` the --num-devices rank count (default: every
    place there is). Ranks fill each card in turn, `TMB_RANKS_PER_CARD` to
    a card (`parallel/mesh.py place_ranks`); asking for more raises a
    ValueError that names the count available.

    In a process group (`maybe_init_process_group`) the count is the
    world's: it must split evenly over the processes (JAX's balanced
    truncation, `utils/device.py:79-104`), each process holds a block of
    consecutive ranks on its own card, and the other processes' ranks are
    on the meta device here. A program that has not joined the group its
    environment names raises rather than run as one process."""
    from tpu_matmul_bench_torch.parallel.mesh import place_ranks, ranks_per_card

    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r}; choose 'cuda' or 'cpu'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run on the "
            "CPU (times taken there are not the card's)")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not group.active():
        raise RuntimeError(
            f"WORLD_SIZE={os.environ['WORLD_SIZE']}: this program does not "
            "run as processes in a group")
    if group.active():
        local = torch.device("cpu") if device == "cpu" else _process_card()
        nprocs, me = group.process_count(), group.process_index()
        per_proc = ranks_per_card()
        d = nprocs * per_proc if num_devices is None else num_devices
        if d % nprocs:
            raise ValueError(
                f"--num-devices {d} must be a multiple of the {nprocs}-process "
                "cluster size: every process must keep an equal share of the mesh")
        per = d // nprocs
        if per < 1 or per > per_proc:
            raise ValueError(
                f"requested {d} devices ({per} per process) but the {nprocs} "
                f"processes expose only {per_proc} each (set "
                "TMB_RANKS_PER_CARD to place more ranks on each device)")
        return [local if r // per == me else torch.device("meta")
                for r in range(d)]
    if device == "cpu":
        return place_ranks([torch.device("cpu")], num_devices)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return place_ranks(cards, num_devices)


def cluster_exit_barrier() -> None:
    """Every process waits for the others before it tears down (≙ JAX
    `matmul_scaling_benchmark.py:116-128`): a process that finished its
    half of the last collective and exited would close the transport
    under a peer still reading. No-op in one process."""
    group.barrier()


def device_kind_of(device: torch.device) -> str:
    """The kind routing keys on: the card's name, or 'cpu'."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def collect_device_info(devices: Sequence[torch.device]) -> DeviceInfo:
    from tpu_matmul_bench_torch.parallel.mesh import make_mesh

    first = next(d for d in devices if d.type != "meta")
    if first.type == "cuda":
        props = torch.cuda.get_device_properties(first)
        kind, memory = props.name, props.total_memory / (1024**3)
    else:
        kind, memory = "cpu", None
    mesh = make_mesh(devices)
    return DeviceInfo(
        platform=first.type,
        device_kind=kind,
        num_devices=len(devices),
        torch_version=torch.__version__,
        cuda_version=torch.version.cuda,
        memory_gib=memory,
        cards=mesh.card_count,
        ranks_per_card=mesh.ranks_per_card,
        num_processes=group.process_count(),
        process_index=group.process_index(),
        startup_s=group.startup_seconds(),
    )


def device_banner(info: DeviceInfo) -> str:
    """Environment banner: versions, device name, memory, and where the
    ranks sit when they share a device."""
    lines = [
        f"PyTorch version: {info.torch_version} (CUDA {info.cuda_version})",
        f"Backend platform: {info.platform}",
        f"Number of devices: {info.num_devices}",
        f"Device kind: {info.device_kind}",
        f"Processes: {info.num_processes} (this is process {info.process_index})",
    ]
    if info.startup_s:
        lines.append("Process start-up (s): "
                     + ", ".join(f"{t:.3f}" for t in info.startup_s))
    if info.cards != info.num_devices:
        lines.append(f"Ranks: {info.num_devices} on {info.cards} device(s), "
                     f"up to {info.ranks_per_card} per device")
    if info.memory_gib is not None:
        lines.append(f"Memory per device: {info.memory_gib:.2f} GiB")
    return "\n".join(lines)
