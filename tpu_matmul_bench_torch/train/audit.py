"""The train step's contract, checked from a recorded run.

Port of JAX's `analysis/auditor.py audit_train` (`:1183-1249`), which
audits a traced jaxpr. PyTorch runs eagerly, so the port records what one
full step does (`analysis/recording.py record`): its collectives, as
(kind, axis, per-rank payload bytes), one entry per axis group; its float
downcasts, wire dtypes aside; and its host round trips.

`audit_train` holds these to the comms model for the flat dp mesh and both
transposed dcn×ici factorizations, at zero 0 and 1, exact and quantized:
the per-axis inventory and payloads against `train_expected_collectives`
(JAX's TRAIN-001/002), the ZeRO rows' disjoint tiling (TRAIN-003), the
downcasts (TRAIN-004: the quantized step makes no more than the exact
one, and the update makes exactly one a rank), and no host round trip
inside the step (TRAIN-005: an `.item()`, a copy to the host or a
synchronize, where JAX looks for a host callback primitive).
"""

from __future__ import annotations

import collections

import torch

from tpu_matmul_bench_torch.analysis.recording import (  # noqa: F401 (re-exported)
    record,
    record_collectives,
    record_downcasts,
)
from tpu_matmul_bench_torch.parallel.mesh import make_factorized_mesh, make_mesh

AUDIT_SIZE = 256
AUDIT_BATCH = 4
HIER_FACTORIZATIONS = ("dcn:2,ici:4", "dcn:4,ici:2")
# the wire each cell runs: per-link and asymmetric on the factorized
# meshes (a wrong-axis routing shows), uniform on the flat one
HIER_QUANT = "dcn=fp8-block:32,ici=none"
FLAT_QUANT = "fp8-block:32"
TRAIN_CELLS = (("dp", None),) + tuple(("hybrid", s) for s in HIER_FACTORIZATIONS)


def audit_train(devices: list[torch.device]) -> list[str]:
    """The train-step contract over 8 ranks: a list of problems, empty when
    every cell holds (see the module docstring)."""
    from tpu_matmul_bench_torch.analysis.comms_model import train_expected_collectives
    from tpu_matmul_bench_torch.train.step import (
        make_train_setup,
        train_axes,
        zero_shard_rows,
    )

    problems: list[str] = []
    if len(devices) < 8:
        return [f"cannot audit the train meshes: {len(devices)} ranks, not 8 "
                "(set TMB_RANKS_PER_CARD to put 8 on one device)"]
    for mode, spec in TRAIN_CELLS:
        mesh = make_factorized_mesh(devices[:8], spec) if spec else make_mesh(devices[:8])
        for zero in (False, True):
            downs: dict[str | None, int] = {}
            for gq in (None, HIER_QUANT if spec else FLAT_QUANT):
                where = f"train:{mode}@{spec or 'flat'}/zero={int(zero)}+{gq or 'exact'}"
                setup = make_train_setup(mesh, mode, AUDIT_SIZE, torch.bfloat16,
                                         batch=AUDIT_BATCH, zero=zero, grad_quant=gq)
                x, w = setup.operands
                with record() as rec:
                    setup.step(x, w)
                log, down = rec.log, rec.downcasts
                if rec.host_syncs:
                    problems.append(f"TRAIN-005 {where}: host round trip(s) "
                                    f"{sorted(set(rec.host_syncs))} inside the "
                                    "timed optimizer step")
                want = collections.Counter()
                for kind, axis, payload in train_expected_collectives(
                        mode, spec, mesh.size, AUDIT_SIZE, torch.bfloat16, gq,
                        batch=AUDIT_BATCH, zero=zero):
                    want[(kind, axis, payload)] += len(mesh.axis_groups(axis))
                got = collections.Counter(log)
                kinds = sorted({(k, a) for k, a, _ in got})
                want_kinds = sorted({(k, a) for k, a, _ in want})
                if kinds != want_kinds:
                    problems.append(f"TRAIN-001 {where}: collectives {kinds} are "
                                    f"not the model's {want_kinds}")
                elif got != want:
                    problems.append(f"TRAIN-002 {where}: payloads {sorted(got.items())} "
                                    f"are not the model's {sorted(want.items())}")
                downs[gq] = len(down)
                if gq is None:
                    # the update's own downcasts: the "update" prefix less
                    # the "grad_comm" one, exactly one a rank
                    counts = []
                    for phase in ("grad_comm", "update"):
                        with record_downcasts() as d:
                            setup.prefixes[phase](x, w)
                        counts.append(len(d))
                    if counts[1] - counts[0] != mesh.size:
                        problems.append(
                            f"TRAIN-004 {where}: the update made "
                            f"{counts[1] - counts[0]} downcasts, not one a rank "
                            f"({mesh.size})")
            quant, exact = downs[HIER_QUANT if spec else FLAT_QUANT], downs[None]
            if quant > exact:
                problems.append(
                    f"TRAIN-004 train:{mode}@{spec or 'flat'}/zero={int(zero)}: the "
                    f"quantized step makes {quant} float downcasts, the exact one "
                    f"{exact}: dequantized gradients left fp32 before the update")
        dp_ax, _ = train_axes(mesh, mode)
        rows = zero_shard_rows(AUDIT_SIZE, mesh.shape[dp_ax])
        covered = [i for start, stop in rows for i in range(start, stop)]
        if sorted(covered) != list(range(AUDIT_SIZE)):
            problems.append(f"TRAIN-003 train:{mode}@{spec or 'flat'}: the ZeRO "
                            f"rows {rows} do not tile [0, {AUDIT_SIZE}) disjointly")
    return problems
