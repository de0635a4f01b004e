"""Device setup: which device runs the benchmark, and the matmul precision.

Port of `tpu_matmul_bench/utils/device.py`. The card is the default: with
no CUDA device, `resolve_devices` raises unless the CPU was asked for, so a
run never moves to the CPU unannounced. The port runs on one device until
the scaling slice brings process groups.
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
    num_devices: int
    torch_version: str
    cuda_version: str | None
    memory_gib: float | None  # per-device memory, when known


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
    """The devices to benchmark on: `device` is the --device flag value
    ('cuda' or 'cpu'), `num_devices` the --num-devices cap."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r}; choose 'cuda' or 'cpu'")
    if num_devices is not None and num_devices > 1:
        raise ValueError(
            f"--num-devices {num_devices}: the port runs on one device; "
            "multi-device comes with the scaling slice")
    if device == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run on the "
            "CPU (times taken there are not the card's)")
    return [torch.device("cuda", 0)]


def collect_device_info(devices: Sequence[torch.device]) -> DeviceInfo:
    first = devices[0]
    if first.type == "cuda":
        props = torch.cuda.get_device_properties(first)
        kind, memory = props.name, props.total_memory / (1024**3)
    else:
        kind, memory = "cpu", None
    return DeviceInfo(
        platform=first.type,
        device_kind=kind,
        num_devices=len(devices),
        torch_version=torch.__version__,
        cuda_version=torch.version.cuda,
        memory_gib=memory,
    )


def device_banner(info: DeviceInfo) -> str:
    """Environment banner: versions, device name, memory."""
    lines = [
        f"PyTorch version: {info.torch_version} (CUDA {info.cuda_version})",
        f"Backend platform: {info.platform}",
        f"Number of devices: {info.num_devices}",
        f"Device kind: {info.device_kind}",
    ]
    if info.memory_gib is not None:
        lines.append(f"Memory per device: {info.memory_gib:.2f} GiB")
    return "\n".join(lines)
