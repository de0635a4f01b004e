"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` for Hopper (sm_90a) into a shared
library with a plain C interface and loaded with `ctypes`: a few seconds
per source, where a PyTorch extension that includes PyTorch's headers
takes minutes. A source may be split into units: `csrc/<name>.cu` and
every `csrc/<name>/*.cu` (K1's library, `matmul`, is nine units, one for
each tensor-core route, operand dtype and epilogue: its 108 kernels take
over two minutes in one nvcc, PERF.md). `build` starts one `nvcc -c` for
every unit of every source at once, each into an object named for this
process, then links each source's objects into its library. Libraries go
to `build/kernels/` at the repository root, named by a hash of the
source's units, every header in `csrc/` (`*.cuh`) and the flags, so an
edited unit or header is rebuilt on its next use and an unchanged one is
loaded as it is. The CUDA driver API's `cuTensorMapEncodeTiled` is reached
through the runtime (`cudaGetDriverEntryPoint`), so nothing links
`-lcuda`.

`ptxas` reports each kernel's registers, stack and spill bytes (`-Xptxas
-v`), and warns where it serialises a kernel's `wgmma` instructions or
ignores its `setmaxnreg`; the reports of a library's units are kept
beside it, as `<library>.ptxas.txt`, and `resource_usage` reads them back.

A missing `nvcc`, a failed unit or a failed link raises: nothing falls
back.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
# a unit compiles to an object (NVCC_FLAGS without -shared), and a source's
# objects link into its library
COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_LOADED: dict[str, ctypes.CDLL] = {}
# nvcc processes this process started (a unit's compile or a link): a warm
# start from the kernel-library store (tune/artifacts.py) starts none
NVCC_RUNS = 0


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a unit or a link."""


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


def units(name: str) -> list[Path]:
    """The units of source `name`: `csrc/<name>.cu`, then `csrc/<name>/*.cu`."""
    return [CSRC / f"{name}.cu", *sorted((CSRC / name).glob("*.cu"))]


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to: keyed by its units, every header of
    `csrc/` (a unit may include any of them) and the flags."""
    digest = hashlib.sha256()
    for path in (*units(name), *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.relative_to(CSRC).as_posix().encode() + b"\0"
                      + path.read_bytes())
    digest.update(" ".join((*NVCC_FLAGS, *LINK_FLAGS)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


@dataclasses.dataclass
class _Job:
    """One source's build in flight: each unit's nvcc and its object."""

    name: str
    lib: Path
    procs: list[tuple[Path, Path, subprocess.Popen]]  # (unit, object, nvcc)


def _start(name: str) -> _Job | None:
    """Start one `nvcc -c` for each unit of `name` unless its library is
    already built; each object is named for this process, so two processes
    that build at once write apart."""
    global NVCC_RUNS
    lib = library_path(name)
    if lib.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, procs = nvcc_path(), []
    for unit in units(name):
        stem = unit.relative_to(CSRC).with_suffix("").as_posix().replace("/", ".")
        obj = lib.with_name(f"{lib.stem}.{stem}.{os.getpid()}.o")
        proc = subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", str(obj), str(unit)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        NVCC_RUNS += 1
        procs.append((unit, obj, proc))
    return _Job(name, lib, procs)


def _ptxas_log(lib: Path) -> Path:
    return lib.with_name(lib.name + ".ptxas.txt")


def _finish(job: _Job) -> None:
    """Wait for every unit of `job`, then link its objects into the
    library; a failed unit or link raises, naming it."""
    global NVCC_RUNS
    reports, failed = [], []
    for unit, _, proc in job.procs:
        out, _ = proc.communicate()
        where = f"csrc/{unit.relative_to(CSRC).as_posix()}"
        reports.append(f"// {where}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {where} (exit {proc.returncode}):\n{out}")
    objects = [obj for _, obj, _ in job.procs]
    tmp = job.lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        if failed:
            raise KernelBuildError("\n".join(failed))
        link = subprocess.run([nvcc_path(), *LINK_FLAGS, "-o", str(tmp),
                               *map(str, objects)],
                              capture_output=True, text=True)
        NVCC_RUNS += 1
        if link.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed to link csrc/{job.name}.cu's units (exit "
                f"{link.returncode}):\n{link.stdout}{link.stderr}")
        # the report first, so that a built library always has one
        _ptxas_log(job.lib).write_text("".join(reports))
        os.replace(tmp, job.lib)  # atomic: a reader never sees a half-written file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)


def build(*names: str) -> dict[str, Path]:
    """Build the named sources (all of `csrc/` when none are named): one
    `nvcc -c` for every unit of every source, all started before any is
    waited on, then one link a source. Returns name -> library."""
    names = names or tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
    started = [_start(name) for name in names]
    for job in started:
        if job is not None:
            _finish(job)
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
