"""The audits: run every impl × mode once, record it, and diff the record
against the contract.

Port of `tpu_matmul_bench/analysis/auditor.py`. JAX traces each program
(`jax.make_jaxpr`) without running it; the port runs it once at the audit
size on the lint's device (the card unless `--device cpu`) while
`analysis/recording.py` records its collectives, float casts and host
round trips, or walks its live bytes. The collective inventory does not
depend on the impl, so the modes run under `cuda` (JAX audits under
`xla`), a deliberate deviation: on the card the record and the live bytes
are K1's own, with no cuBLAS workspace in them, and on the CPU K1's plain
version runs.

Each `audit_*` function takes the ranks' devices (`audit_devices`) and
returns a list of `Finding`s. `AUDITS` lists every one of JAX's groups in
JAX's order; JAX's `pallas` group is `cuda` here. `sched` reads the
recorded stream schedule where JAX reads optimized HLO
(`analysis/schedule.py`), `fingerprint` digests recorded runs where JAX
digests jaxprs (`analysis/fingerprint.py`), and `conc` and `schema` are
the source certifiers, which parse the port's own tree
(`analysis/concurrency.py`, `analysis/schema_flow.py`). `run_groups` and
`run_all` are the CLI's entry points.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Iterable, Sequence

import torch

from tpu_matmul_bench_torch.analysis.comms_model import (
    RING_WIRE_FACTOR,
    expected_collectives,
)
from tpu_matmul_bench_torch.analysis.findings import Finding
from tpu_matmul_bench_torch.analysis.recording import (
    Recording,
    record,
    storage_state,
    sync_debug_error,
    written_in_place,
)

# the representative problem: every mode's sharding divides it (256 % 8),
# and it runs in milliseconds
AUDIT_SIZE = 256
AUDIT_BATCH = 4
# two world sizes, so a payload that is world-independent (or quadratic)
# by mistake cannot pass by luck
AUDIT_WORLDS = (4, 8)
# the impl the mode programs run under (see the module docstring)
AUDIT_IMPL = "cuda"
# the device kinds the routing surface is audited at (JAX: "TPU v5e", cpu)
AUDIT_KINDS = ("NVIDIA H100 80GB HBM3", "cpu")
# the ranks the audits need on one device (JAX forces 8 host devices)
AUDIT_RANKS = 8

_WIRE = ("int8", "float8_e4m3fn")


def audit_devices(device: str) -> list[torch.device]:
    """The ranks' devices the audits run on: every rank `device` holds
    (`TMB_RANKS_PER_CARD` of them a card; the lint CLI sets 8)."""
    from tpu_matmul_bench_torch.utils.device import resolve_devices

    return resolve_devices(device, None)


def _all_modes() -> dict[str, Callable[..., Any]]:
    from tpu_matmul_bench_torch.parallel.modes import DISTRIBUTED_MODES, SCALING_MODES

    return {**SCALING_MODES, **DISTRIBUTED_MODES}


def _audit_config(dtype_name: str = "bfloat16", impl: str = AUDIT_IMPL,
                  device: torch.device | str = "cpu"):
    from tpu_matmul_bench_torch.utils.config import BenchConfig

    return BenchConfig(
        sizes=[AUDIT_SIZE], iterations=1, warmup=0, dtype_name=dtype_name,
        device=torch.device(device).type, num_devices=None, json_out=None,
        matmul_impl=impl, seed=0)


def run_recorded(fn: Callable[..., Any], *args: Any, card: bool = False) -> Recording:
    """Run `fn(*args)` once under `record(opaque=True)`; on the card run it
    again under the sync debug mode, whose refusal joins the host round
    trips."""
    with record(opaque=True) as rec:
        fn(*args)
    if card:
        msg = sync_debug_error(lambda: fn(*args))
        if msg:
            rec.host_syncs.append(f"sync debug mode: {msg.splitlines()[0]}")
    return rec


def _is_card(devices: Sequence[torch.device]) -> bool:
    return torch.device(devices[0]).type == "cuda"


def per_collective(rec: Recording, mesh: Any, steps: int = 1
                   ) -> list[tuple[str, str, int, str]]:
    """The recorded collectives as (kind, axis, payload bytes, dtype), once
    a collective of one step: the recorder logs one entry for each group of
    the axis a collective runs over, and every step of a loop (summa's k
    panels), where JAX's inventory holds one equation of the loop's body.
    A count that does not divide stays whole, so the mismatch shows."""
    counts = collections.Counter((u.kind, u.axis, u.payload_bytes, u.dtype)
                                 for u in rec.collectives)
    out = []
    for key, n in sorted(counts.items()):
        axis = key[1]
        per = steps * (mesh.size // mesh.shape[axis] if axis in mesh.shape else 1)
        out += [key] * (n // per if n % per == 0 else n)
    return out


def _dtype_findings(rec: Recording, where: str, world: int = 1) -> list[Finding]:
    """DTYPE-001/-002 for one recorded program: at most one float downcast
    a rank, and no narrow-then-widen round trip."""
    findings = []
    if len(rec.downcasts) > world:
        findings.append(Finding(
            "DTYPE-001", where,
            f"{len(rec.downcasts)} float downcasts over {world} rank(s) "
            "(expected at most one a rank: accumulate high, downcast once on "
            "store)",
            details={"downcasts": rec.downcasts}))
    for narrow, wide in rec.roundtrips:
        findings.append(Finding(
            "DTYPE-002", where,
            f"round-trip: value downcast to {narrow} then widened to {wide} "
            "— the narrowing loses precision and saves nothing",
            details={"narrow": narrow, "wide": wide}))
    return findings


def _purity_findings(rec: Recording, where: str) -> list[Finding]:
    if not rec.host_syncs:
        return []
    return [Finding(
        "PURE-001", where,
        f"host round trip(s) {sorted(set(rec.host_syncs))} inside a timed "
        "program — every iteration waits on the host",
        details={"host_syncs": rec.host_syncs})]


def _inventory_findings(observed: list, mode: str, world: int, size: int,
                        dtype: Any, where: str,
                        batch: int = AUDIT_BATCH) -> list[Finding]:
    """COLL-001/COLL-002: recorded collectives (`per_collective`) vs the
    analytic comms model."""
    expected = expected_collectives(mode, world, size, dtype, batch=batch)
    obs_kinds = sorted(u[0] for u in observed)
    exp_kinds = sorted(e.kind for e in expected)
    if obs_kinds != exp_kinds:
        return [Finding(
            "COLL-001", where,
            f"collective inventory {obs_kinds or '[]'} does not match the "
            f"comms model {exp_kinds or '[]'} for {mode} at d={world}",
            details={
                "observed": [{"kind": u[0], "axis": u[1], "payload_bytes": u[2]}
                             for u in observed],
                "expected": [{"kind": e.kind, "payload_bytes": e.payload_bytes}
                             for e in expected]})]
    findings = []
    for kind in sorted(set(exp_kinds)):
        obs_bytes = sorted(u[2] for u in observed if u[0] == kind)
        exp_bytes = sorted(e.payload_bytes for e in expected if e.kind == kind)
        if obs_bytes != exp_bytes:
            findings.append(Finding(
                "COLL-002", where,
                f"{kind} payload bytes {obs_bytes} != model {exp_bytes} "
                f"for {mode} at d={world}",
                details={"kind": kind, "observed_bytes": obs_bytes,
                         "expected_bytes": exp_bytes,
                         "ring_wire_factor": RING_WIRE_FACTOR[kind](world)}))
    return findings


def audit_modes(devices: Sequence[torch.device], worlds: Iterable[int] = AUDIT_WORLDS,
                dtype_name: str = "bfloat16", impl: str = AUDIT_IMPL) -> list[Finding]:
    """Run every parallel mode at every audit world and check its
    collective inventory, compute-leg purity and dtype discipline."""
    from tpu_matmul_bench_torch.parallel.mesh import make_mesh

    config = _audit_config(dtype_name, impl, devices[0])
    card = _is_card(devices)
    findings: list[Finding] = []
    for world in worlds:
        if world > len(devices):
            findings.append(Finding(
                "COLL-001", f"mesh:d{world}",
                f"cannot audit world={world}: only {len(devices)} ranks (set "
                "TMB_RANKS_PER_CARD to put more on one device)",
                severity="warn", details={"available": len(devices)}))
            continue
        mesh = make_mesh(devices[:world])
        for mode, builder in _all_modes().items():
            where = f"mode:{mode}@d{world}"
            setup = builder(config, mesh, AUDIT_SIZE)
            compute = run_recorded(setup.compute, *setup.operands, card=card)
            # compute legs must be comm-free: the compute/comm split the
            # records report depends on it
            if compute.collectives:
                findings.append(Finding(
                    "COLL-003", where,
                    f"compute-only program makes collectives "
                    f"{sorted({u.kind for u in compute.collectives})}",
                    details={"collectives": [u.entry() for u in compute.collectives]}))
            findings += _purity_findings(compute, where + "/compute")
            findings += _dtype_findings(compute, where + "/compute", world)
            full = compute
            if setup.full is not None:
                full = run_recorded(setup.full, *setup.operands, card=card)
                findings += _purity_findings(full, where + "/full")
                findings += _dtype_findings(full, where + "/full", world)
            findings += _inventory_findings(per_collective(full, mesh), mode, world,
                                            AUDIT_SIZE, config.dtype, where)
    return findings


# ---------------------------------------------------------------------------
# COLL-Q-* / DTYPE-Q-*: the quantized-wire collective contract
# ---------------------------------------------------------------------------

# every wire-format family: the legacy per-row tier, per-row fp8, and one
# block size of each block format (32 divides every audit payload width)
_COMM_QUANT_FORMATS = ("int8", "fp8", "int8-block:32", "fp8-block:32")
# the impls each quantizable mode is certified under: K1 everywhere, and
# the library product beside it on the modes JAX certifies under two
_COMM_QUANT_IMPLS = {
    "batch_parallel": ("cuda",),
    "data_parallel": ("cuda",),
    "matrix_parallel": ("cuda", "torch"),
    "model_parallel": ("cuda", "torch"),
}


def _comm_quant_cases(world: int, devices) -> list[tuple[str, str, dict, Any, Callable]]:
    """(mode, impl, model_kwargs, mesh, build(config) -> ModeSetup) for
    every quantizable program family at one world size."""
    from tpu_matmul_bench_torch.parallel.hybrid import hybrid_mode, make_hybrid_mesh
    from tpu_matmul_bench_torch.parallel.mesh import make_mesh
    from tpu_matmul_bench_torch.parallel.summa import make_summa_mesh, summa_grid, summa_mode

    mesh_1d = make_mesh(devices[:world])
    cases = []
    for mode, impls in _COMM_QUANT_IMPLS.items():
        builder = _all_modes()[mode]
        for impl in impls:
            cases.append((mode, impl, {}, mesh_1d,
                          lambda cfg, b=builder: b(cfg, mesh_1d, AUDIT_SIZE)))
    hmesh = make_hybrid_mesh(devices[:world], dp=2)
    cases.append(("hybrid", AUDIT_IMPL, {"dp": 2}, hmesh,
                  lambda cfg: hybrid_mode(cfg, hmesh, AUDIT_SIZE)))
    smesh = make_summa_mesh(devices[:world])
    cases.append(("summa", AUDIT_IMPL, {"rows": summa_grid(world)[0]}, smesh,
                  lambda cfg: summa_mode(cfg, smesh, AUDIT_SIZE)))
    return cases


def _scale_pairing_findings(uses: list, where: str) -> list[Finding]:
    """COLL-Q-001: every wire-dtype collective paired 1:1 (per kind) with
    an fp32 scale collective, and no collective of any other dtype."""
    wire, scale, stray = collections.Counter(), collections.Counter(), []
    for kind, _axis, _nbytes, dtype in uses:
        if dtype in _WIRE:
            wire[kind] += 1
        elif dtype == "float32":
            scale[kind] += 1
        else:
            stray.append(f"{kind}({dtype})")
    findings = []
    if wire != scale:
        findings.append(Finding(
            "COLL-Q-001", where,
            f"wire payload collectives {dict(wire)} are not 1:1 paired "
            f"with fp32 scale collectives {dict(scale)} — scales must "
            "travel with every quantized payload on the same lane",
            details={"wire": dict(wire), "scale": dict(scale)}))
    if stray:
        findings.append(Finding(
            "COLL-Q-001", where,
            f"collectives carrying non-wire, non-scale dtypes in a "
            f"quantized program: {stray} (a silent full-precision "
            "round-trip on the wire)",
            details={"stray": stray}))
    return findings


def _wire_inventory_findings(uses: list, mode: str, world: int, comm_quant: str,
                             where: str, **model_kw: Any) -> list[Finding]:
    """COLL-Q-002/COLL-Q-003: recorded quantized collectives vs the wire
    model, and the predicted payload reduction vs the 2x floor."""
    from tpu_matmul_bench_torch.analysis.comms_model import (
        wire_bytes_summary,
        wire_collectives,
    )

    observed = sorted((u[0], u[2]) for u in uses)
    expected = sorted((e.kind, e.payload_bytes) for e in wire_collectives(
        mode, world, AUDIT_SIZE, torch.bfloat16, comm_quant, batch=AUDIT_BATCH,
        **model_kw))
    findings = []
    if observed != expected:
        findings.append(Finding(
            "COLL-Q-002", where,
            f"quantized collective inventory differs from the wire model "
            f"({len(observed)} recorded vs {len(expected)} modeled)",
            details={"observed": observed, "expected": expected}))
    summary = wire_bytes_summary(mode, world, AUDIT_SIZE, torch.bfloat16, comm_quant,
                                 batch=AUDIT_BATCH, **model_kw)
    if summary.get("payload_reduction_x", 0.0) < 2.0:
        findings.append(Finding(
            "COLL-Q-003", where,
            f"predicted payload-byte reduction "
            f"{summary.get('payload_reduction_x')}x is below the 2x floor "
            "for a 1-byte wire format vs bf16",
            details=summary))
    return findings


def audit_comm_quant(devices: Sequence[torch.device],
                     worlds: Iterable[int] = AUDIT_WORLDS) -> list[Finding]:
    """The quantized-wire collective contract: for every quantizable mode ×
    wire format × impl × audit world, run the full program and check

    - COLL-Q-001: fp32 scales ride the same lane as every wire payload;
    - COLL-Q-002: the inventory is `comms_model.wire_collectives` exactly;
    - COLL-Q-003: the modeled payload reduction meets the 2x floor;
    - DTYPE-Q-001: a fused block format adds exactly one non-wire downcast
      a rank to the exact program (the legacy tier one a rank for each
      collective), and no round trip;
    - DTYPE-Q-002: integer operands and one-rank meshes short-circuit —
      integer programs record the exact program's operations, one-rank
      programs carry no wire dtype and no ring hop.
    """
    from tpu_matmul_bench_torch.analysis.comms_model import mode_steps
    from tpu_matmul_bench_torch.parallel.collectives import parse_wire_format

    card = _is_card(devices)
    findings: list[Finding] = []
    for world in worlds:
        if world > len(devices):
            continue  # audit_modes already reports the capacity warning
        for mode, impl, model_kw, mesh, build in _comm_quant_cases(world, devices):
            exact_cfg = _audit_config("bfloat16", impl, devices[0])
            s = build(exact_cfg)
            exact = run_recorded(s.full, *s.operands)
            # a recording runs summa's k-panel loop step by step, where
            # JAX's jaxpr holds its scan body once
            steps = mode_steps(mode, world, model_kw.get("rows"))
            # the legacy tier downcasts once a rank at every collective: a
            # recorded call over one group of an axis has that axis's ranks
            legacy_downs = sum(mesh.shape.get(u.axis, world) for u in exact.collectives)
            for fmt in _COMM_QUANT_FORMATS:
                where = f"comm_quant:{mode}+{fmt}/{impl}@d{world}"
                s = build(dataclasses.replace(exact_cfg, comm_quant=fmt))
                rec = run_recorded(s.full, *s.operands, card=card)
                uses = per_collective(rec, mesh, steps)
                findings += _scale_pairing_findings(uses, where)
                findings += _wire_inventory_findings(uses, mode, world, fmt, where,
                                                     **model_kw)
                findings += _purity_findings(rec, where)
                added = len(rec.downcasts) - len(exact.downcasts)
                if parse_wire_format(fmt).legacy:
                    want, doc = legacy_downs, "one a rank at each collective"
                else:
                    want, doc = steps * world, f"exactly one a rank a step ({steps})"
                if added != want:
                    findings.append(Finding(
                        "DTYPE-Q-001", where,
                        f"{added} non-wire downcasts over the exact program's "
                        f"{len(exact.downcasts)} (budget {doc}: {want}) — "
                        "accumulate high, downcast once",
                        details={"downcasts": rec.downcasts,
                                 "exact_count": len(exact.downcasts)}))
                if len(rec.roundtrips) != len(exact.roundtrips):
                    findings.append(Finding(
                        "DTYPE-Q-001", where,
                        f"{len(rec.roundtrips)} non-wire float round-trips vs "
                        f"{len(exact.roundtrips)} in the exact program — "
                        "dequantized values must stay in the fp32 accumulator",
                        details={"roundtrips": rec.roundtrips}))
        # DTYPE-Q-002a: integer operands take the exact collective — the
        # same operations, not merely close results
        for fmt in ("int8", "int8-block:32", "fp8-block:32"):
            for mode, impl, _kw, _mesh, build in _comm_quant_cases(world, devices):
                if impl != AUDIT_IMPL:
                    continue
                where = f"comm_quant:{mode}+{fmt}/int8-operands@d{world}"
                int_exact = _audit_config("int8", impl, devices[0])
                s_e = build(int_exact)
                s_q = build(dataclasses.replace(int_exact, comm_quant=fmt))
                rec_e = run_recorded(s_e.full, *s_e.operands)
                rec_q = run_recorded(s_q.full, *s_q.operands)
                if (rec_e.ops, rec_e.log) != (rec_q.ops, rec_q.log):
                    findings.append(Finding(
                        "DTYPE-Q-002", where,
                        "integer-operand program under --comm-quant does not "
                        "record the exact program's operations — the integer "
                        "inert short-circuit is broken",
                        details={"exact_ops": len(rec_e.ops),
                                 "quant_ops": len(rec_q.ops)}))
    findings += _world1_inert_findings(devices)
    return findings


def _world1_inert_findings(devices: Sequence[torch.device]) -> list[Finding]:
    """DTYPE-Q-002b: over one rank the quantized modes make no wire dtype,
    no wire cast and no ring hop (the d == 1 short-circuit)."""
    from tpu_matmul_bench_torch.parallel.mesh import make_mesh

    findings = []
    mesh1 = make_mesh(devices[:1])
    for mode in ("batch_parallel", "data_parallel", "model_parallel", "matrix_parallel"):
        builder = _all_modes()[mode]
        for fmt in _COMM_QUANT_FORMATS:
            where = f"comm_quant:{mode}+{fmt}@d1"
            cfg = dataclasses.replace(_audit_config("bfloat16", AUDIT_IMPL, devices[0]),
                                      comm_quant=fmt)
            setup = builder(cfg, mesh1, AUDIT_SIZE)
            rec = run_recorded(setup.full or setup.compute, *setup.operands)
            wire_ops = [u.kind for u in rec.collectives
                        if u.kind == "ppermute" or u.dtype in _WIRE]
            if wire_ops or rec.wire_casts:
                findings.append(Finding(
                    "DTYPE-Q-002", where,
                    "world-1 program still carries quantization artifacts "
                    f"(collectives {wire_ops}, casts {rec.wire_casts}) — the "
                    "d==1 short-circuit is broken",
                    details={"wire_ops": wire_ops, "wire_casts": rec.wire_casts}))
    return findings


# (impl, dtype) pairs every build must keep clean; the split-K rides along
# as the structurally distinct kernel path (K1b, two K slabs)
_IMPL_MATRIX = (
    ("torch", "bfloat16"), ("torch", "float32"), ("torch", "int8"),
    ("cuda", "bfloat16"), ("cuda", "float32"), ("cuda", "int8"),
    ("cuda_ksplit", "bfloat16"), ("cuda_ksplit", "float32"),
)


def _impl_fn(impl: str) -> Callable[..., Any]:
    from tpu_matmul_bench_torch.ops.matmul import matmul_2d

    if impl == "cuda_ksplit":
        from tpu_matmul_bench_torch.ops.cuda_matmul import cuda_matmul_ksplit

        return lambda a, b: cuda_matmul_ksplit(a, b, splits=2)
    return matmul_2d(impl)


def impl_operands(dtype_name: str, device: torch.device, size: int = AUDIT_SIZE):
    """The operands `audit_impls` runs each impl on (seed 0)."""
    from tpu_matmul_bench_torch.ops.matmul import random_operands
    from tpu_matmul_bench_torch.utils.metrics import as_dtype

    return random_operands(0, (size, size), as_dtype(dtype_name), device=device)


def audit_impls(devices: Sequence[torch.device], size: int = AUDIT_SIZE) -> list[Finding]:
    """Run every matmul impl at every benchmark dtype once and check its
    dtype discipline and timed-region purity (a product makes no
    collective)."""
    card = _is_card(devices)
    findings: list[Finding] = []
    for impl, dtype_name in _IMPL_MATRIX:
        where = f"impl:{impl}/{dtype_name}"
        a, b = impl_operands(dtype_name, devices[0], size)
        with record() as rec:
            _impl_fn(impl)(a, b)
        if card:
            msg = sync_debug_error(lambda: _impl_fn(impl)(a, b))
            if msg:
                rec.host_syncs.append(f"sync debug mode: {msg.splitlines()[0]}")
        findings += _dtype_findings(rec, where)
        findings += _purity_findings(rec, where)
        if rec.collectives:
            findings.append(Finding(
                "COLL-003", where,
                "single-device matmul impl makes collectives "
                f"{sorted({u.kind for u in rec.collectives})}",
                details={"collectives": rec.log}))
    return findings


def donation_contracts(device: torch.device) -> list[tuple[str, Callable[[], dict]]]:
    """(name, check) for every buffer-reuse contract the port declares;
    `check()` runs the contract once and returns what it saw (`ok` true
    when the buffer was written in place). The fused loop chains its calls
    by writing into operand 0 (`utils/timing.py _chain`, the carry JAX's
    loop donates); a product given `out=` writes there (the alias JAX's
    `matmul_2d` declares)."""
    from tpu_matmul_bench_torch.ops.matmul import matmul_2d
    from tpu_matmul_bench_torch.utils.timing import fuse_iterations

    def chained() -> dict:
        a, b = impl_operands("bfloat16", device)
        before = storage_state(a)
        fuse_iterations(matmul_2d(AUDIT_IMPL), 3, clone=False)(a, b)
        return {"ok": written_in_place(before, a), "before": before,
                "after": storage_state(a)}

    def into_out(impl: str) -> Callable[[], dict]:
        # a kernel writes through a raw pointer, which moves no version
        # counter: `out` starts as NaN and must hold the product after
        def check() -> dict:
            a, b = impl_operands("bfloat16", device)
            out = torch.full_like(a, float("nan"))
            before = storage_state(out)
            got = matmul_2d(impl)(a, b, out=out)
            written = bool(torch.isfinite(out).all())
            return {"ok": written and got.untyped_storage().data_ptr() == before[0],
                    "before": before, "after": storage_state(got), "written": written}
        return check

    return [
        (f"timing.fuse_iterations({AUDIT_IMPL}-matmul, 3) chains operand 0", chained),
        ("ops.matmul_2d(cuda) writes into out", into_out("cuda")),
        ("ops.matmul_2d(torch) writes into out", into_out("torch")),
    ]


def audit_donation(devices: Sequence[torch.device]) -> list[Finding]:
    """DONATE-001 for every declared reuse contract: the buffer must be
    written in its own storage."""
    findings = []
    for name, check in donation_contracts(devices[0]):
        seen = check()
        if not seen["ok"]:
            findings.append(Finding(
                "DONATE-001", f"donation:{name}",
                "the declared buffer was not written in place (storage "
                f"{seen['before']} -> {seen['after']} as (address, version)) "
                "— the declared reuse is dead",
                details={k: v for k, v in seen.items() if k != "ok"}))
    return findings


# ---------------------------------------------------------------------------
# PALLAS-*: K1's tiles (the group JAX names `pallas`)
# ---------------------------------------------------------------------------

_CUDA_AUDIT_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


def check_tile(where: str, tile: tuple[int, int, int], dtype: Any) -> list[Finding]:
    """PALLAS-001 for one tile the tuning surface names: it must be a tile
    csrc/matmul.cu instantiates for `dtype`'s route, which
    `effective_blocks` returns unchanged."""
    from tpu_matmul_bench_torch.ops.cuda_matmul import effective_blocks

    tile = tuple(tile)
    runs = effective_blocks(*(AUDIT_SIZE,) * 3, *tile, dtype)
    if runs == tile:
        return []
    return [Finding(
        "PALLAS-001", where,
        f"tile {'x'.join(map(str, tile))} is not instantiated for "
        f"{dtype}: effective_blocks runs {'x'.join(map(str, runs))}",
        details={"named": list(tile), "runs": list(runs)})]


def check_plan(where: str, tile: tuple[int, int, int], persistent: bool = False,
               smem_limit: int | None = None) -> list[Finding]:
    """PALLAS-002/003 for one tile's wgmma plan (`wgmma_plan`)."""
    from tpu_matmul_bench_torch.ops.cuda_matmul import SMEM_PER_BLOCK, wgmma_plan

    plan = wgmma_plan(tile, persistent=persistent)
    bad = [(name, value, rule) for name, value, rule, ok in (
        ("wm", plan["wm"], "a multiple of 64", plan["wm"] % 64 == 0),
        ("wn", plan["wn"], "a multiple of 8, at most 256",
         plan["wn"] % 8 == 0 and 0 < plan["wn"] <= 256),
        ("bk", tile[2], "a multiple of 16", tile[2] % 16 == 0),
        ("a_swizzle", plan["a_swizzle"], "32, 64 or 128 bytes",
         plan["a_swizzle"] in (32, 64, 128))) if not ok]
    findings = []
    if bad:
        findings.append(Finding(
            "PALLAS-002", where,
            "wgmma geometry broken: " + ", ".join(f"{n}={v} (must be {r})"
                                                  for n, v, r in bad),
            details={"plan": plan, "bad": [n for n, _, _ in bad]}))
    limit = min(SMEM_PER_BLOCK, smem_limit or SMEM_PER_BLOCK)
    if plan["smem_bytes"] > limit:
        findings.append(Finding(
            "PALLAS-003", where,
            f"shared memory {plan['smem_bytes']} B exceeds the {limit} B a "
            "block may use",
            details={"smem_bytes": plan["smem_bytes"], "limit_bytes": limit}))
    return findings


def audit_cuda_static(devices: Sequence[torch.device] = (),
                      kinds: Iterable[str] = AUDIT_KINDS, db: Any = None) -> list[Finding]:
    """K1's static contracts over the shipped tuning surface: every tile a
    route names at every audit size × dtype × device kind, and every
    `cuda` cell's tile in the tuning DB, is instantiated (PALLAS-001);
    every instantiated tensor-core tile's wgmma plan holds its geometry
    (PALLAS-002) and fits the shared memory a block may use (PALLAS-003),
    the card's opt-in limit too when the lint runs on a card."""
    from tpu_matmul_bench_torch.ops.cuda_matmul import (
        PERSISTENT_TILES,
        SMEM_PER_BLOCK,
        TILES,
    )
    from tpu_matmul_bench_torch.ops.impl_select import resolve_route
    from tpu_matmul_bench_torch.tune.db import default_db

    db = default_db() if db is None else db
    findings: list[Finding] = []
    for kind in kinds:
        for dtype_name in ("bfloat16", "float32", "int8"):
            for s in _CUDA_AUDIT_SIZES:
                choice, _cell = resolve_route(s, s, s, kind, dtype_name, db=db)
                if choice.impl == "cuda" and choice.blocks is not None:
                    findings += check_tile(f"cuda:{kind}/{dtype_name}@{s}",
                                           choice.blocks, dtype_name)
    for cell in db.cells():
        if cell.impl == "cuda" and cell.blocks is not None:
            findings += check_tile(
                f"cuda:db[{cell.device_kind}/{cell.dtype}@{cell.m}x{cell.k}x{cell.n}]",
                cell.blocks, cell.dtype)
    smem_limit = None
    if devices and _is_card(devices):
        smem_limit = torch.cuda.get_device_properties(
            devices[0]).shared_memory_per_block_optin
        if SMEM_PER_BLOCK > smem_limit:
            findings.append(Finding(
                "PALLAS-003", "cuda:SMEM_PER_BLOCK",
                f"SMEM_PER_BLOCK {SMEM_PER_BLOCK} B exceeds the card's opt-in "
                f"limit {smem_limit} B",
                details={"smem_per_block": SMEM_PER_BLOCK, "optin": smem_limit}))
    for tile in TILES:
        findings += check_plan(f"cuda:plan[{'x'.join(map(str, tile))}]", tile,
                               smem_limit=smem_limit)
    for tile in PERSISTENT_TILES:
        findings += check_plan(f"cuda:persistent[{'x'.join(map(str, tile))}]", tile,
                               persistent=True, smem_limit=smem_limit)
    return findings


# provenance substrings that count as a committed measurement artifact
_ARTIFACT_TOKENS = ("measurements/torch/",)

_REGISTRY_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
_REGISTRY_RECTS = ((8192, 28672, 4096), (28672, 8192, 4096))
_REGISTRY_DTYPES = ("bfloat16", "float16", "float32", "int8")
_REGISTRY_KIND = AUDIT_KINDS[0]


def _routes(db: Any = None):
    """(where, choice, cell) once for each distinct (impl, provenance) over
    the routing surface (JAX's shapes × dtypes at the H100's kind)."""
    from tpu_matmul_bench_torch.ops.impl_select import resolve_route

    shapes = [(s, s, s) for s in _REGISTRY_SIZES] + list(_REGISTRY_RECTS)
    seen, rows = set(), []
    for dtype_name in _REGISTRY_DTYPES:
        for m, n, k in shapes:
            choice, cell = resolve_route(m, n, k, _REGISTRY_KIND, dtype_name, db=db)
            if (choice.impl, choice.provenance) in seen:
                continue
            seen.add((choice.impl, choice.provenance))
            rows.append((f"{dtype_name}@{m}x{n}x{k}", choice, cell))
    return rows


def audit_registry(devices: Sequence[torch.device] = (), db: Any = None) -> list[Finding]:
    """REG-001/REG-002 over the routing surface of `ops/impl_select.py`:
    every tier that routes to the hand-written kernel cites a committed
    measurement; tie-policy extrapolations are surfaced (info)."""
    findings = []
    for where, choice, _cell in _routes(db):
        details = {"impl": choice.impl, "provenance": choice.provenance}
        if choice.impl == "cuda" and not any(t in choice.provenance
                                             for t in _ARTIFACT_TOKENS):
            findings.append(Finding(
                "REG-001", f"registry:{where}",
                f"tier routes to {choice.impl!r} citing no measurement "
                f"artifact: {choice.provenance!r}", details=details))
        if "tie" in choice.provenance.lower():
            findings.append(Finding(
                "REG-002", f"registry:{where}",
                "tie-policy tier with no tuning-DB cell behind it — promote a "
                "cell whose provenance cites a measured artifact or an "
                f"explicit analytic prior (tune promote): {choice.provenance!r}",
                details=details))
    return findings


def audit_tune(devices: Sequence[torch.device] = (), db: Any = None) -> list[Finding]:
    """TUNE-001/002/003 over the same surface against the tuning DB: every
    route resolves to a live cell or to a table tier citing a committed
    artifact; resolved cells are fresh (torch version, recomputed program
    digest); every measured-online cell cites its serve ledger. `db` is
    injectable for seeded tests; default the committed store."""
    from tpu_matmul_bench_torch.tune.db import default_db, recomputed_digests

    db = default_db() if db is None else db
    rows = _routes(db)
    digests = recomputed_digests(
        {cell.key: cell for _, _, cell in rows if cell is not None}.values())
    findings: list[Finding] = []
    for cell in db.cells():
        if cell.provenance_kind == "measured-online" and ".jsonl" not in cell.artifact:
            findings.append(Finding(
                "TUNE-003",
                f"tune:{cell.dtype}@{cell.m}x{cell.k}x{cell.n}/{cell.device_kind}",
                f"measured-online cell cites no serve ledger: {cell.artifact!r} "
                "— the shadow-traffic stream that measured it must be "
                "referenceable",
                details={"fingerprint": cell.fingerprint, "impl": cell.impl,
                         "artifact": cell.artifact}))
    for where, choice, cell in rows:
        if cell is None:
            if not any(t in choice.provenance for t in _ARTIFACT_TOKENS):
                findings.append(Finding(
                    "TUNE-001", f"tune:{where}",
                    f"route resolves to no DB cell and the {choice.impl!r} "
                    f"table tier declares no fallback artifact: "
                    f"{choice.provenance!r}",
                    details={"impl": choice.impl, "provenance": choice.provenance}))
            continue
        reasons = db.stale_reasons(cell, digests=digests)
        if reasons:
            findings.append(Finding(
                "TUNE-002", f"tune:{where}",
                f"DB cell {cell.fingerprint} is stale: " + "; ".join(reasons),
                details={"fingerprint": cell.fingerprint, "impl": cell.impl,
                         "reasons": reasons}))
    return findings


def audit_artifacts(devices: Sequence[torch.device] = (), store: Any = None) -> list[Finding]:
    """ART-001/ART-002 over the kernel-library store (`tune/artifacts.py`):
    every record's digest chain closes, and drifted records are surfaced.
    `store` is injectable; default the store under `build/artifacts`
    (missing: nothing to audit)."""
    from tpu_matmul_bench_torch.tune.artifacts import ArtifactStore, recomputed_digests

    store = ArtifactStore.load() if store is None else store
    findings = [Finding("ART-001", where, message) for where, message in store.validate()]
    digests = recomputed_digests(store.records())
    for rec in store.records():
        reasons = store.stale_reasons(rec, digests=digests)
        if reasons:
            prob = rec.get("problem") or {}
            findings.append(Finding(
                "ART-002", f"artifact:{rec.get('key', '?')[:12]}",
                f"stale library for {prob.get('dtype')}@{prob.get('m')}x"
                f"{prob.get('k')}x{prob.get('n')}/{rec.get('impl')}: "
                + "; ".join(reasons),
                details={"key": rec.get("key"), "blob": rec.get("blob"),
                         "reasons": reasons}))
    return findings


def audit_specs(spec_paths: Iterable[str]) -> list[Finding]:
    from tpu_matmul_bench_torch.analysis.spec_lint import lint_specs

    return lint_specs(list(spec_paths))


# the obs attribution audit's shapes (m, k, n): a square and a rectangle
_OBS_AUDIT_SHAPES = ((256, 256, 256), (256, 512, 128))


def audit_obs(devices: Sequence[torch.device]) -> list[Finding]:
    """OBS-001/OBS-002: K1's cost books (`obs/attribution.py`) of the
    launch `cuda_matmul` makes at two shapes against the hand FLOPs model,
    then the registry → snapshot → exposition round trip in process."""
    import json

    from tpu_matmul_bench_torch.obs import attribution, export
    from tpu_matmul_bench_torch.obs.registry import MetricsRegistry
    from tpu_matmul_bench_torch.ops.cuda_matmul import launch_plan
    from tpu_matmul_bench_torch.ops.matmul import random_operands

    blocks = {}
    for m, k, n in _OBS_AUDIT_SHAPES:
        a, = random_operands(0, (m, k), torch.float32, device=devices[0], count=1)
        b, = random_operands(1, (k, n), torch.float32, device=devices[0], count=1)
        route, tile, splits = launch_plan(a, b)
        blocks[f"{m}x{k}x{n}"] = attribution.attribution_block(
            route, m, n, k, tile, splits, dtype=torch.float32)
    findings = attribution.check_blocks(blocks, "obs:attribution")

    where = "obs:roundtrip"
    reg = MetricsRegistry()
    reg.counter("lint_probe_total", kind="audit").inc(3)
    reg.histogram("lint_probe_ms").observe(1.5)
    snap = export.snapshot_record(registry=reg, run_id="lint", seq=0)
    try:
        snap = json.loads(json.dumps(snap))
    except (TypeError, ValueError) as e:
        return findings + [Finding("OBS-002", where,
                                   f"snapshot record is not JSON-serializable: {e}")]
    if snap.get("counters", {}).get('lint_probe_total{kind="audit"}') != 3:
        findings.append(Finding(
            "OBS-002", where, "registry counter did not survive the snapshot round trip",
            details={"counters": snap.get("counters")}))
    prom = export.prometheus_text(snap)
    if "lint_probe_total" not in prom or "quantile=" not in prom:
        findings.append(Finding(
            "OBS-002", where, "prometheus exposition is missing the probe series or "
                              "the histogram quantile labels"))
    return findings


def audit_faults(devices: Sequence[torch.device] = ()) -> list[Finding]:
    """FAULT-001/002 (`faults/audit.py static_findings`)."""
    from tpu_matmul_bench_torch.faults.audit import static_findings

    return static_findings()


def audit_trace(devices: Sequence[torch.device] = ()) -> list[Finding]:
    """TRACE-001/002/003 (`serve/trace.py trace_findings`)."""
    from tpu_matmul_bench_torch.serve.trace import trace_findings

    return trace_findings()


def audit_pod(devices: Sequence[torch.device]) -> list[Finding]:
    """POD-001/002/003 (`serve/pod.py pod_findings`), each group's program
    under K1."""
    from tpu_matmul_bench_torch.serve.pod import pod_findings

    return pod_findings(devices, impl=AUDIT_IMPL)


# ---------------------------------------------------------------------------
# COLL-H-*: the hierarchical (dcn × ici) mesh contract
# ---------------------------------------------------------------------------

#: the two factorizations of the 8-rank world, transposed, so a model or a
#: mesh that swaps the dcn and ici roles cannot match both
HIER_FACTORIZATIONS = ("dcn:2,ici:4", "dcn:4,ici:2")
#: the per-link spec: dcn quantized, ici exact — where wrong-axis routing shows
HIER_QUANT = "dcn=fp8-block:32,ici=none"


def _hier_cases(spec: str, devices):
    """(mode, mesh, build(config) -> ModeSetup) for the 2-D modes on one
    factorization."""
    from tpu_matmul_bench_torch.parallel.hybrid import hybrid_mode
    from tpu_matmul_bench_torch.parallel.mesh import make_factorized_mesh
    from tpu_matmul_bench_torch.parallel.summa import summa_mode

    mesh = make_factorized_mesh(devices, spec)
    return [("hybrid", mesh, lambda cfg: hybrid_mode(cfg, mesh, AUDIT_SIZE,
                                                      batch=AUDIT_BATCH)),
            ("summa", mesh, lambda cfg: summa_mode(cfg, mesh, AUDIT_SIZE))]


def _hier_inventory_findings(uses: list, mode: str, spec: str, comm_quant: str | None,
                             where: str) -> list[Finding]:
    """COLL-H-001/COLL-H-002: the recorded per-axis inventory vs the
    two-level comms model."""
    from tpu_matmul_bench_torch.analysis.comms_model import hier_expected_collectives

    observed = sorted((k, a, n) for k, a, n, _ in uses)
    expected = sorted(hier_expected_collectives(
        mode, spec, AUDIT_SIZE, torch.bfloat16, comm_quant, batch=AUDIT_BATCH))
    obs_ka = sorted((k, a) for k, a, _ in observed)
    exp_ka = sorted((k, a) for k, a, _ in expected)
    if obs_ka != exp_ka:
        return [Finding(
            "COLL-H-001", where,
            f"per-axis collective inventory {obs_ka or '[]'} does not match "
            f"the two-level model {exp_ka or '[]'} for {mode} on {spec}",
            details={"observed": observed, "expected": expected})]
    if observed != expected:
        return [Finding(
            "COLL-H-002", where,
            f"per-axis payload bytes differ from the two-level model for "
            f"{mode} on {spec}",
            details={"observed": observed, "expected": expected})]
    return []


def _hier_routing_findings(uses: list, comm_quant: str, where: str) -> list[Finding]:
    """COLL-H-003: wire dtypes only on axes whose link class the per-link
    spec quantizes, and every quantized link carries one."""
    from tpu_matmul_bench_torch.parallel.collectives import (
        link_format_spec,
        parse_link_formats,
        parse_wire_format,
    )

    findings, quantized = [], set()
    for kind, axis, _nbytes, dtype in uses:
        if dtype not in _WIRE:
            continue
        quantized.add(axis)
        if parse_wire_format(link_format_spec(comm_quant, axis)) is None:
            findings.append(Finding(
                "COLL-H-003", where,
                f"wire dtype {dtype} on axis {axis!r}, whose link class "
                f"{comm_quant!r} leaves exact — per-link routing sent "
                "quantization to the wrong wire",
                details={"kind": kind, "axis": axis, "dtype": dtype}))
    for link, fmt in parse_link_formats(comm_quant).items():
        if fmt is not None and link not in quantized:
            findings.append(Finding(
                "COLL-H-003", where,
                f"--comm-quant names {link}={fmt.spec} but no collective on "
                f"the {link!r} axis carries a wire dtype — the quantized link "
                "runs full precision",
                details={"link": link, "format": fmt.spec}))
    return findings


def audit_hier(devices: Sequence[torch.device],
               factorizations: Iterable[str] = HIER_FACTORIZATIONS) -> list[Finding]:
    """The hierarchical-mesh contract: both 2-D modes at two transposed
    dcn × ici factorizations of the 8-rank world, exact and under
    `HIER_QUANT`, their full programs run and recorded:

    - COLL-H-001: the per-axis (kind, axis) inventory is the two-level
      comms model's (`hier_expected_collectives`);
    - COLL-H-002: so are the per-axis payload bytes;
    - COLL-H-003: under the per-link spec, wire dtypes ride the dcn axis
      only, and the dcn axis carries them.
    """
    from tpu_matmul_bench_torch.analysis.comms_model import hier_mode_steps

    if len(devices) < AUDIT_RANKS:
        return [Finding(
            "COLL-H-001", "mesh:hier",
            f"cannot audit factorized meshes: only {len(devices)} ranks (set "
            f"TMB_RANKS_PER_CARD to put {AUDIT_RANKS} on one device)",
            severity="warn", details={"available": len(devices)})]
    card = _is_card(devices)
    exact_cfg = _audit_config("bfloat16", AUDIT_IMPL, devices[0])
    findings: list[Finding] = []
    for spec in factorizations:
        for mode, mesh, build in _hier_cases(spec, devices[:AUDIT_RANKS]):
            where = f"hier:{mode}@{spec}"
            steps = hier_mode_steps(mode, spec)
            s = build(exact_cfg)
            uses = per_collective(run_recorded(s.full, *s.operands, card=card), mesh, steps)
            findings += _hier_inventory_findings(uses, mode, spec, None, where)
            s = build(dataclasses.replace(exact_cfg, comm_quant=HIER_QUANT))
            uses = per_collective(run_recorded(s.full, *s.operands, card=card), mesh, steps)
            q_where = f"{where}+{HIER_QUANT}"
            findings += _hier_inventory_findings(uses, mode, spec, HIER_QUANT, q_where)
            findings += _hier_routing_findings(uses, HIER_QUANT, q_where)
    return findings


def audit_train(devices: Sequence[torch.device]) -> list[Finding]:
    """TRAIN-001..005 (`train/audit.py audit_train`, whose problems are
    lines "RULE where: message"), as findings."""
    from tpu_matmul_bench_torch.train.audit import audit_train as train_problems

    if len(devices) < AUDIT_RANKS:
        return [Finding(
            "TRAIN-001", "train:mesh",
            f"cannot audit train meshes: only {len(devices)} ranks (set "
            f"TMB_RANKS_PER_CARD to put {AUDIT_RANKS} on one device)",
            severity="warn", details={"available": len(devices)})]
    findings = []
    for line in train_problems(list(devices)):
        rule, where, message = line.split(" ", 2)
        findings.append(Finding(rule, where.rstrip(":"), message))
    return findings


def _audit_memory(devices: Sequence[torch.device],
                  budget_gib: float | None = None) -> list[Finding]:
    from tpu_matmul_bench_torch.analysis.memory_model import audit_memory

    return audit_memory(devices, budget_gib=budget_gib, impl=AUDIT_IMPL)


def _audit_sched(devices: Sequence[torch.device]) -> list[Finding]:
    """SCHED-001..004 (`analysis/schedule.py audit_sched`)."""
    from tpu_matmul_bench_torch.analysis.schedule import audit_sched

    return audit_sched(devices)


def _audit_fingerprint(devices: Sequence[torch.device]) -> list[Finding]:
    """DRIFT-001/002 (`analysis/fingerprint.py audit_fingerprints`)."""
    from tpu_matmul_bench_torch.analysis.fingerprint import audit_fingerprints

    return audit_fingerprints(devices)


def audit_conc(devices: Sequence[torch.device] = ()) -> list[Finding]:
    """CONC-001..005 (`analysis/concurrency.py conc_findings`)."""
    from tpu_matmul_bench_torch.analysis.concurrency import conc_findings

    return conc_findings()


def audit_schema(devices: Sequence[torch.device] = ()) -> list[Finding]:
    """SCHEMA-001..005 (`analysis/schema_flow.py schema_findings`)."""
    from tpu_matmul_bench_torch.analysis.schema_flow import schema_findings

    return schema_findings()


AUDITS: dict[str, Callable[[Sequence[torch.device]], list[Finding]]] = {
    "modes": audit_modes,
    "impls": audit_impls,
    "donation": audit_donation,
    "cuda": audit_cuda_static,
    "registry": audit_registry,
    "tune": audit_tune,
    "artifacts": audit_artifacts,
    "obs": audit_obs,
    "comm_quant": audit_comm_quant,
    "hier": audit_hier,
    "train": audit_train,
    "sched": _audit_sched,
    "memory": _audit_memory,
    "fingerprint": _audit_fingerprint,
    "faults": audit_faults,
    "trace": audit_trace,
    "pod": audit_pod,
    "conc": audit_conc,
    "schema": audit_schema,
}

#: JAX's HLO pass family, the groups that run every program of their
#: inventory once more (its schedule, its live bytes, its fingerprint):
#: what `lint --no-hlo` skips
HLO_AUDITS = ("sched", "memory", "fingerprint")


def audit_groups() -> tuple[str, ...]:
    """Every skippable audit group, from the registry: the CLI's --skip
    choices come from here. "specs" rides along because `run_groups` runs
    it outside AUDITS (it takes the spec paths)."""
    return tuple(AUDITS) + ("specs",)


def run_groups(devices: Sequence[torch.device], spec_paths: Iterable[str] = (),
               skip: Iterable[str] = (), mem_budget_gib: float | None = None,
               ) -> dict[str, tuple[list[Finding], float]]:
    """{group: (findings, seconds)} for every group not skipped, in order."""
    skip_set = set(skip)
    out: dict[str, tuple[list[Finding], float]] = {}
    for name, audit in list(AUDITS.items()) + [("specs", None)]:
        if name in skip_set:
            continue
        t0 = time.perf_counter()
        if name == "specs":
            found = audit_specs(spec_paths)
        elif name == "memory":
            found = _audit_memory(devices, mem_budget_gib)
        else:
            found = audit(devices)
        out[name] = (found, time.perf_counter() - t0)
    return out


def run_all(devices: Sequence[torch.device], spec_paths: Iterable[str] = (),
            skip: Iterable[str] = (), mem_budget_gib: float | None = None) -> list[Finding]:
    return [f for found, _ in run_groups(devices, spec_paths, skip,
                                         mem_budget_gib).values() for f in found]
