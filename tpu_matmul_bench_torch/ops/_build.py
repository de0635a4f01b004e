"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` for Hopper (sm_90a) into a shared
library with a plain C interface and loaded with `ctypes`: a few seconds
per source, where a PyTorch extension that includes PyTorch's headers
takes minutes. Libraries go to `build/kernels/` at the repository root,
named by a hash of the source, every header in `csrc/` (`*.cuh`) and the
flags, so an edited source or header is rebuilt on its next use and an
unchanged one is loaded as it is. The CUDA driver API's
`cuTensorMapEncodeTiled` is reached through the runtime
(`cudaGetDriverEntryPoint`), so nothing links `-lcuda`.

`ptxas` reports each kernel's registers, stack and spill bytes (`-Xptxas
-v`), and warns where it serialises a kernel's `wgmma` instructions or
ignores its `setmaxnreg`; the report is kept beside the library, as
`<library>.ptxas.txt`, and `resource_usage` reads it back.

A missing `nvcc` or a failed compile raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
# nvcc processes this process started: a warm start from the kernel-library
# store (tune/artifacts.py) starts none
NVCC_RUNS = 0


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
    """Where `csrc/<name>.cu` builds to: keyed by the source, every header
    of `csrc/` (a source may include any of them) and the flags."""
    digest = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start compiling `name` unless its library is already built."""
    global NVCC_RUNS
    lib = library_path(name)
    if lib.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    NVCC_RUNS += 1
    return lib, tmp, proc


def _ptxas_log(lib: Path) -> Path:
    return lib.with_name(lib.name + ".ptxas.txt")


def _finish(name: str, lib: Path, tmp: Path, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{out}")
    # the report first, so that a built library always has one
    _ptxas_log(lib).write_text(out)
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


def _demangler() -> list[str] | None:
    """`cu++filt` beside nvcc, else `c++filt` on PATH."""
    try:
        cu = Path(nvcc_path()).with_name("cu++filt")
    except KernelBuildError:
        cu = None
    if cu is not None and cu.is_file():
        return [str(cu)]
    found = shutil.which("c++filt")
    return [found] if found else None


def short_name(readable: str) -> str:
    """A demangled kernel signature without its return type, anonymous
    namespace and argument list, e.g. `wmma_gemm<__nv_bfloat16, true, 128,
    128, 32>`."""
    s = readable.removeprefix("void ")
    for anonymous in ("(anonymous namespace)::", "<unnamed>::"):
        s = s.replace(anonymous, "")
    s = s.replace("(bool)1", "true").replace("(bool)0", "false")
    s = re.sub(r"\((?:unsigned )?int\)(?=-?\d)", "", s)  # cu++filt's "(int)128"
    lt, paren = s.find("<"), s.find("(")
    if lt != -1 and (paren == -1 or lt < paren):
        depth = 0
        for i in range(lt, len(s)):
            depth += {"<": 1, ">": -1}.get(s[i], 0)
            if depth == 0:
                return s[:i + 1]
    return s.split("(", 1)[0].strip()


def _demangle(names: list[str]) -> dict[str, str]:
    """Mangled -> `short_name`; a name that cannot be demangled stays as
    it is."""
    tool = _demangler()
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run(tool, input="\n".join(names), capture_output=True,
                         text=True, check=False).stdout.splitlines()
    if len(out) != len(names):
        return {n: n for n in names}
    return {mangled: short_name(readable) or mangled
            for mangled, readable in zip(names, out)}


_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?")
_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                     r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
# ptxas's warnings that cost a wgmma kernel most of its speed: its wgmma
# serialised (C7515 and kin), or its setmaxnreg ignored (C7508)
WARNINGS = {"wgmma_serialized": "wgmma.mma_async instructions are serialized",
            "setmaxnreg_ignored": "setmaxnreg ignored"}
_NAMED = re.compile(r"'(_Z[\w$]+)'")


def parse_ptxas(text: str) -> dict[str, dict[str, int | list[str]]]:
    """Per kernel (mangled name): registers per thread, stack frame and
    spill bytes, from `nvcc -Xptxas -v` output, and `warnings`, the keys of
    WARNINGS that ptxas raised for it (a warning that names a function goes
    to that function, any other to the entry being compiled)."""
    usage: dict[str, dict] = {}
    current = None
    for line in text.splitlines():
        kinds = [kind for kind, said in WARNINGS.items() if said in line]
        if kinds:
            named = _NAMED.search(line)
            owner = named.group(1) if named else current
            if owner is not None:
                have = usage.setdefault(owner, {}).setdefault("warnings", [])
                have.extend(k for k in kinds if k not in have)
        elif (m := _ENTRY.search(line)):
            current = m.group(1)
            usage.setdefault(current, {})
        elif current is not None and (m := _SPILLS.search(line)):
            usage[current].update(stack_bytes=int(m.group(1)),
                                  spill_store_bytes=int(m.group(2)),
                                  spill_load_bytes=int(m.group(3)))
        elif current is not None and (m := _REGS.search(line)):
            usage[current]["registers"] = int(m.group(1))
    return usage


def readable_usage(text: str) -> dict[str, dict]:
    """`parse_ptxas`, keyed by readable kernel name (`short_name`)."""
    usage = parse_ptxas(text)
    names = _demangle(sorted(usage))
    return {names[k]: v for k, v in sorted(usage.items())}


def resource_usage(name: str) -> dict[str, dict]:
    """Registers, stack and spill bytes, and ptxas's wgmma and setmaxnreg
    warnings, of every kernel in the built `csrc/<name>.cu`, keyed by
    readable kernel name (build it first)."""
    log = _ptxas_log(library_path(name))
    if not log.is_file():
        raise KernelBuildError(f"csrc/{name}.cu has no ptxas report; build it first")
    return readable_usage(log.read_text())
