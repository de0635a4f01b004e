"""Device setup: which device runs the benchmark, and the matmul precision.

Port of `tpu_matmul_bench/utils/device.py`. The card is the default: with
no CUDA device, `resolve_devices` raises unless the CPU was asked for, so a
run never moves to the CPU unannounced. `resolve_devices` returns one
device per rank: `TMB_RANKS_PER_CARD` ranks may share each card
(`parallel/mesh.py`), all in one process.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


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


def resolve_devices(device: str = "cuda",
                    num_devices: int | None = None) -> list[torch.device]:
    """The device of each rank: `device` is the --device flag value ('cuda'
    or 'cpu'), `num_devices` the --num-devices rank count (default: every
    place there is). Ranks fill each card in turn, `TMB_RANKS_PER_CARD` to
    a card (`parallel/mesh.py place_ranks`); asking for more raises a
    ValueError that names the count available."""
    from tpu_matmul_bench_torch.parallel.mesh import place_ranks

    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r}; choose 'cuda' or 'cpu'")
    if device == "cpu":
        return place_ranks([torch.device("cpu")], num_devices)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run on the "
            "CPU (times taken there are not the card's)")
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return place_ranks(cards, num_devices)


def device_kind_of(device: torch.device) -> str:
    """The kind routing keys on: the card's name, or 'cpu'."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def collect_device_info(devices: Sequence[torch.device]) -> DeviceInfo:
    from tpu_matmul_bench_torch.parallel.mesh import make_mesh

    first = devices[0]
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
        cards=len(mesh.cards),
        ranks_per_card=mesh.ranks_per_card,
    )


def device_banner(info: DeviceInfo) -> str:
    """Environment banner: versions, device name, memory, and where the
    ranks sit when they share a device."""
    lines = [
        f"PyTorch version: {info.torch_version} (CUDA {info.cuda_version})",
        f"Backend platform: {info.platform}",
        f"Number of devices: {info.num_devices}",
        f"Device kind: {info.device_kind}",
    ]
    if info.cards != info.num_devices:
        lines.append(f"Ranks: {info.num_devices} on {info.cards} device(s), "
                     f"up to {info.ranks_per_card} per device")
    if info.memory_gib is not None:
        lines.append(f"Memory per device: {info.memory_gib:.2f} GiB")
    return "\n".join(lines)
