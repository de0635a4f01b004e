"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` for Hopper (sm_90a) into a shared
library with a plain C interface and loaded with `ctypes`: a few seconds
per source, where a PyTorch extension that includes PyTorch's headers
takes minutes. Libraries go to `build/kernels/` at the repository root,
named by a hash of the source and the flags, so an edited source is
rebuilt on its next use and an unchanged one is loaded as it is.

A missing `nvcc` or a failed compile raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    """`nvcc` on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise KernelBuildError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to: keyed by the source and flags."""
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes()
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start compiling `name` unless its library is already built."""
    lib = library_path(name)
    if lib.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, tmp, proc


def _finish(name: str, lib: Path, tmp: Path, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)  # atomic: a reader never sees a half-written file


def build(*names: str) -> dict[str, Path]:
    """Build the named sources (all of `csrc/` when none are named), one
    `nvcc` per source, all started together. Returns name -> library."""
    names = names or tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
    started = {name: _start(name) for name in names}
    for name, job in started.items():
        if job is not None:
            _finish(name, *job)
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]))
        _LOADED[name] = lib
    return lib
