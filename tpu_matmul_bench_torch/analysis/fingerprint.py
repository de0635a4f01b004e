"""Program fingerprints and the golden-baseline drift gate (DRIFT-*).

Port of `tpu_matmul_bench/analysis/fingerprint.py`. Every program of the
audit surface is run once, recorded (`analysis/schedule.py run_program`,
`record(opaque=True)` with the stream schedule logged), canonicalized
into a stable record and digested to a short sha256:

- the primitive multiset: the operations outside any primitive, and each
  primitive (a collective door, a product's kernel wrapper or the library
  product, a plain version, a hop) once — as a `psum` or a `dot_general`
  is one equation of a jaxpr, so the record does not depend on the device
  or on the kernel's route and tile;
- the collectives by kind, per-rank payload bytes and dtype;
- the operands' shapes, dtypes and shardings;
- for the step and ring programs, the canonical schedule
  (`schedule.canonical`: launches by kind, rank, stream and step, and the
  data and reuse edges between them; no event ids, pointers or times);
- for the donation contracts, their storage-identity outcome (written in
  place, or not).

The golden baseline, `analysis/golden/program_fingerprints.json` in JAX's
format (`schema`, `worlds`, `fingerprints`, keys sorted), is written on
the CPU by `python -m tpu_matmul_bench_torch.analysis.regen_golden`; the
lint on the card holds the card's digests to it (one golden for every
device). The drift gate has JAX's three outcomes a program: digest matches
(silent), digest differs (DRIFT-001, error), program missing from the
baseline or baseline naming a program that no longer runs (DRIFT-002,
warn).

The inventory is JAX's: every mode at d = 4 and 8 (under `cuda`, the
audits' impl) with `int8`, `int8-block:32` and `fp8-block:32` on the four
quantizable modes; the three scan variants and the six rings (`sched`'s
programs); the impl matrix (`auditor._IMPL_MATRIX`, at `IMPL_SIZE`); and the
donation contracts. Its keys are JAX's golden keys but for these
differences (`port_key`, `PORT_ONLY_KEYS`):

- impls: `xla` -> `torch`, `pallas` -> `cuda`, `pallas_ksplit` ->
  `cuda_ksplit`;
- donation contracts, named as the port declares them
  (`auditor.donation_contracts`): JAX's `timing.fuse_iterations(xla-matmul,
  3)` is `timing.fuse_iterations(cuda-matmul, 3) chains operand 0`, its
  `ops.matmul_2d(xla) out-aliases A` is `ops.matmul_2d(torch) writes into
  out`, and `ops.matmul_2d(cuda) writes into out` is the port's own (JAX
  declares no alias on its Pallas product).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Callable, Sequence

import torch

from tpu_matmul_bench_torch.analysis.findings import Finding
from tpu_matmul_bench_torch.analysis.recording import Recording, ScheduleLog

#: the golden baseline, package-relative
GOLDEN_RELPATH = "analysis/golden/program_fingerprints.json"

FINGERPRINT_WORLDS = (4, 8)

GOLDEN_SCHEMA = 1

#: the impl matrix's operands: the `impls` group's 256 x 256, where JAX
#: traces its impls at 64 x 64 — at 64 the split-K is one pass
#: (`effective_ksplit`), and K1b would never run
IMPL_SIZE = 256

# quantized-wire variants are distinct programs (ppermute ring + wire and
# scale payloads): one format per wire family
QUANT_FORMATS = ("int8", "int8-block:32", "fp8-block:32")
QUANTIZABLE = ("batch_parallel", "data_parallel", "matrix_parallel", "model_parallel")

#: JAX's golden key -> the port's, where they differ (see the docstring)
_DONATION_RENAMES = {
    "donation:timing.fuse_iterations(xla-matmul, 3)":
        "donation:timing.fuse_iterations(cuda-matmul, 3) chains operand 0",
    "donation:ops.matmul_2d(xla) out-aliases A":
        "donation:ops.matmul_2d(torch) writes into out",
}
_IMPL_RENAMES = (("impl:xla/", "impl:torch/"), ("impl:pallas_ksplit/", "impl:cuda_ksplit/"),
                 ("impl:pallas/", "impl:cuda/"))
#: the port's keys with no JAX counterpart
PORT_ONLY_KEYS = ("donation:ops.matmul_2d(cuda) writes into out",)


def port_key(jax_key: str) -> str:
    """The port's key for one of JAX's golden keys."""
    if jax_key in _DONATION_RENAMES:
        return _DONATION_RENAMES[jax_key]
    for old, new in _IMPL_RENAMES:
        if jax_key.startswith(old):
            return new + jax_key[len(old):]
    return jax_key


def golden_path() -> Path:
    return Path(__file__).resolve().parents[1] / GOLDEN_RELPATH


# ------------------------------------------------------- canonicalization

def _operand(op: Any) -> dict[str, Any]:
    from tpu_matmul_bench_torch.analysis.recording import dtype_name
    from tpu_matmul_bench_torch.parallel.mesh import Sharded

    if isinstance(op, Sharded):
        return {"shards": len(op), "shape": list(op[0].shape),
                "dtype": dtype_name(op[0].dtype), "spec": repr(op.spec)}
    return {"shape": list(op.shape), "dtype": dtype_name(op.dtype)}


def canonical_record(rec: Recording, operands: Sequence[Any],
                     log: ScheduleLog | None = None) -> dict[str, Any]:
    """Stable, JSON-serializable structure summary of one recorded call."""
    from tpu_matmul_bench_torch.analysis.schedule import canonical

    ops: dict[str, int] = {}
    for name in rec.ops + rec.primitives:
        ops[name] = ops.get(name, 0) + 1
    out = {
        "ops": dict(sorted(ops.items())),
        "collectives": sorted([u.kind, u.payload_bytes, u.dtype] for u in rec.collectives),
        "inputs": [_operand(op) for op in operands],
    }
    if log is not None:
        out["schedule"] = canonical(log.entries)
    return out


def digest(record: dict[str, Any]) -> str:
    """Short stable digest of a canonical record."""
    blob = json.dumps(record, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ------------------------------------------------------------- inventory

def _mode_build(builder: Callable, config: Any, mesh: Any, size: int) -> Callable:
    def build():
        setup = builder(config, mesh, size)
        return (setup.full if setup.full is not None else setup.compute), setup.operands
    return build


def _impl_build(impl: str, dtype_name: str, device: torch.device) -> Callable:
    from tpu_matmul_bench_torch.analysis.auditor import _impl_fn, impl_operands

    return lambda: (_impl_fn(impl), impl_operands(dtype_name, device, IMPL_SIZE))


def program_builds(devices: Sequence[torch.device],
                   worlds=FINGERPRINT_WORLDS) -> dict[str, Callable]:
    """{key: build} for every program of the inventory the ranks can run;
    `build()` returns (fn, operands)."""
    from tpu_matmul_bench_torch.analysis import schedule
    from tpu_matmul_bench_torch.analysis.auditor import (
        _IMPL_MATRIX,
        AUDIT_IMPL,
        AUDIT_SIZE,
        _all_modes,
        _audit_config,
    )
    from tpu_matmul_bench_torch.parallel.mesh import make_mesh

    builds: dict[str, Callable] = {}
    config = _audit_config("bfloat16", AUDIT_IMPL, devices[0])
    for world in worlds:
        if world > len(devices):
            continue
        mesh = make_mesh(list(devices[:world]))
        for mode, builder in sorted(_all_modes().items()):
            builds[f"mode:{mode}@d{world}"] = _mode_build(builder, config, mesh, AUDIT_SIZE)
            if mode in QUANTIZABLE:
                for fmt in QUANT_FORMATS:
                    builds[f"mode:{mode}+{fmt}@d{world}"] = _mode_build(
                        builder, dataclasses.replace(config, comm_quant=fmt), mesh, AUDIT_SIZE)
    builds.update(schedule.inventory_builds(devices, worlds))
    for impl, dtype_name in _IMPL_MATRIX:
        builds[f"impl:{impl}/{dtype_name}"] = _impl_build(impl, dtype_name, devices[0])
    return builds


def program_inventory(devices: Sequence[torch.device],
                      worlds=FINGERPRINT_WORLDS) -> dict[str, dict]:
    """Canonical records for every program of the inventory."""
    from tpu_matmul_bench_torch.analysis.auditor import donation_contracts
    from tpu_matmul_bench_torch.analysis.schedule import run_counted, run_program

    records: dict[str, dict] = {}
    for key, build in program_builds(devices, worlds).items():
        run = run_program(build)
        scheduled = key.startswith(("overlap:", "ring:"))
        records[key] = canonical_record(run.record, run.operands,
                                        run.log if scheduled else None)
    for name, check in donation_contracts(devices[0]):
        records[f"donation:{name}"] = {"written_in_place": bool(run_counted(check)["ok"])}
    return records


def current_fingerprints(devices: Sequence[torch.device],
                         worlds=FINGERPRINT_WORLDS) -> dict[str, str]:
    """Digest map for the whole inventory."""
    return {key: digest(rec) for key, rec in program_inventory(devices, worlds).items()}


def golden_document(fingerprints: dict[str, str]) -> str:
    """The baseline file's text: JAX's format, keys sorted."""
    doc = {"schema": GOLDEN_SCHEMA, "worlds": list(FINGERPRINT_WORLDS),
           "fingerprints": dict(sorted(fingerprints.items()))}
    return json.dumps(doc, sort_keys=True, indent=2) + "\n"


# ------------------------------------------------------------ drift gate

def load_golden(path: str | Path | None = None) -> dict[str, str] | None:
    """The baseline's fingerprint map, or None when no baseline exists."""
    path = Path(path) if path is not None else golden_path()
    if not path.exists():
        return None
    return json.loads(path.read_text()).get("fingerprints", {})


_REGEN = "python -m tpu_matmul_bench_torch.analysis.regen_golden"


def check_drift(current: dict[str, str], golden: dict[str, str] | None) -> list[Finding]:
    """Diff current fingerprints against the golden map (pure — seeded
    tests feed perturbed baselines)."""
    if golden is None:
        return [Finding(
            "DRIFT-002", "fingerprint:baseline",
            f"no golden baseline at {GOLDEN_RELPATH} — run {_REGEN} and commit "
            "the result", details={"programs_recorded": len(current)})]
    findings: list[Finding] = []
    for key in sorted(current):
        if key not in golden:
            findings.append(Finding(
                "DRIFT-002", f"fingerprint:{key}",
                f"program missing from the golden baseline (regen: {_REGEN})",
                details={"digest": current[key]}))
        elif golden[key] != current[key]:
            findings.append(Finding(
                "DRIFT-001", f"fingerprint:{key}",
                f"fingerprint {current[key]} != golden {golden[key]} — recorded "
                f"structure changed without a baseline regen ({_REGEN})",
                details={"current": current[key], "golden": golden[key]}))
    for key in sorted(set(golden) - set(current)):
        findings.append(Finding(
            "DRIFT-002", f"fingerprint:{key}",
            "baseline names a program that no longer runs (stale entry — regen "
            "the baseline)", details={"golden": golden[key]}))
    return findings


def audit_fingerprints(devices: Sequence[torch.device], worlds=FINGERPRINT_WORLDS,
                       path: str | Path | None = None) -> list[Finding]:
    return check_drift(current_fingerprints(devices, worlds), load_golden(path))
