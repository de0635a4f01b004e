"""Timing, validation and the record of the train-step workload.

Port of `tpu_matmul_bench/train/harness.py`. `bench_one` times the five
cumulative-prefix programs (`step.PHASES`) in turns, takes the per-phase
split by telescoping (so it sums to the full step's time), measures the update's
drift against an exact-wire shadow over several steps, validates one step
against the dense fp32 reference, and builds the record with the static
per-link wire prices of `analysis/comms_model.py
train_wire_bytes_summary`.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_matmul_bench_torch.parallel.collectives import link_format_spec
from tpu_matmul_bench_torch.parallel.mesh import Mesh, Sharded, gather
from tpu_matmul_bench_torch.parallel.modes import _mode_record
from tpu_matmul_bench_torch.train.step import (
    DEFAULT_BATCH,
    DEFAULT_LR,
    DEFAULT_STEPS,
    PHASES,
    TrainStepSetup,
    make_train_setup,
    train_step_programs,
    train_tolerance,
)
from tpu_matmul_bench_torch.utils.config import BenchConfig
from tpu_matmul_bench_torch.utils.metrics import calculate_tflops
from tpu_matmul_bench_torch.utils.reporting import BenchmarkRecord
from tpu_matmul_bench_torch.utils.timing import Timing, time_variants_n


@dataclasses.dataclass(frozen=True)
class TrainArgs:
    """The train-specific knobs on top of the shared BenchConfig."""

    mode: str = "dp"
    zero: bool = False
    grad_quant: str | None = None
    steps: int = DEFAULT_STEPS
    batch: int = DEFAULT_BATCH
    lr: float = DEFAULT_LR


def _rel_err(a: Sharded | torch.Tensor, b: Sharded | torch.Tensor) -> float:
    """Frobenius relative error ‖a − b‖ / ‖b‖ of the global arrays, in fp32."""
    af = (gather(a) if isinstance(a, Sharded) else a).float()
    bf = (gather(b) if isinstance(b, Sharded) else b).float()
    return float(torch.linalg.norm(af - bf) / torch.linalg.norm(bf).clamp_min(1e-30))


def wire_active(setup: TrainStepSetup) -> bool:
    """Whether the gradient sync quantizes: a wire format resolves on the
    data axis AND the axis is wide enough to move anything."""
    fmt = link_format_spec(setup.grad_quant, setup.dp_axis)
    return fmt not in (None, "none") and setup.dp > 1


def drift_series(setup: TrainStepSetup, exact: TrainStepSetup,
                 steps: int) -> list[float]:
    """The update's relative error after each step: the quantized-wire step
    and the exact-wire shadow iterate from the same w0 (both update in
    fp32, so the difference is what the wire did to the gradients), and
    ‖w_q − w_x‖/‖w_x‖ is recorded after each step."""
    x, w0 = setup.operands
    wq, wx = w0, w0
    out: list[float] = []
    for _ in range(steps):
        wq = setup.step(x, wq)
        wx = exact.step(x, wx)
        out.append(round(_rel_err(wq, wx), 10))
    return out


def validate_step(setup: TrainStepSetup, dtype) -> dict:
    """One full step against the dense fp32 reference, in the shape of the
    corner_validation verdict."""
    x, w0 = setup.operands
    err = _rel_err(setup.step(x, w0), setup.reference(x, w0))
    tol = train_tolerance(dtype, setup.grad_quant, setup.dp_axis, setup.dp)
    return {
        "validation": "ok" if err <= tol else "FAILED",
        "validation_max_rel_err": round(err, 8),
        "validation_tolerance": tol,
    }


def validate_train_record(rec) -> list[str]:
    """The train record's schema contract as checkable invariants; an empty
    list means valid. Shared by `train selftest` and the tests."""
    problems: list[str] = []
    t = rec.extras.get("train")
    if not isinstance(t, dict):
        return ["extras['train'] block missing"]
    for key in ("zero", "grad_quant", "steps", "lr", "dp", "tp",
                "global_batch", "local_batch", "phases", "phase_sum_s",
                "wall_s", "update_drift"):
        if key not in t:
            problems.append(f"extras['train'] lacks {key!r}")
    if problems:
        return problems
    if rec.benchmark != "train":
        problems.append(f"benchmark field is {rec.benchmark!r}, not 'train'")
    if t["dp"] * t["tp"] != rec.world:
        problems.append(f"dp {t['dp']} x tp {t['tp']} != world {rec.world}")
    if t["global_batch"] != t["local_batch"] * t["dp"]:
        problems.append(
            f"global_batch {t['global_batch']} != local_batch "
            f"{t['local_batch']} x dp {t['dp']}")
    phases = t["phases"]
    if not isinstance(phases, dict) or not phases:
        problems.append("phases block empty")
    else:
        for name, v in phases.items():
            if not name.endswith("_s"):
                problems.append(f"phase key {name!r} not *_s-suffixed")
            if not isinstance(v, (int, float)):
                problems.append(f"phase {name!r} value {v!r} not numeric")
        # the cumulative-prefix split sums to the wall time exactly (up to
        # the per-phase rounding)
        if abs(sum(v for v in phases.values() if isinstance(v, (int, float)))
               - t["wall_s"]) > 1e-6 * max(len(phases), 1):
            problems.append(
                f"phases sum {sum(phases.values()):.9f} != wall_s "
                f"{t['wall_s']:.9f} — the prefix split tore")
    if not isinstance(t["update_drift"], list):
        problems.append(f"update_drift {t['update_drift']!r} not a list")
    elif t["update_drift"]:
        if t.get("update_rel_err") != t["update_drift"][-1]:
            problems.append(
                f"update_rel_err {t.get('update_rel_err')!r} is not the "
                f"drift series' final point {t['update_drift'][-1]!r}")
    elif "update_rel_err" in t:
        problems.append("update_rel_err present without a drift series")
    if "wire" in t and not isinstance(t["wire"], dict):
        problems.append(f"wire summary {t['wire']!r} not a dict")
    if "mesh" in rec.extras and not isinstance(rec.extras["mesh"], str):
        problems.append(f"extras['mesh'] {rec.extras['mesh']!r} not a "
                        "mesh spec string")
    return problems


def resolve_train_impl(impl: str | None) -> str:
    """The matmul the train step runs: `torch`, which `auto` also resolves
    to. `cuda` is refused: the hand-written kernel (`ops/cuda_matmul.py`,
    the port of `pallas_matmul`) has no backward, as JAX's `pallas_matmul`
    has no VJP, so a backward kernel would be a feature the JAX package
    lacks."""
    impl = impl or "torch"
    if impl == "auto":
        impl = "torch"  # auto may route to the kernel, which has no backward
    if impl != "torch":
        raise ValueError(
            f"--matmul-impl {impl}: the train step differentiates the forward "
            "with torch.autograd, and the hand-written kernel has no backward "
            "(JAX's pallas_matmul has no VJP either); use --matmul-impl torch "
            "or auto")
    return impl


def bench_one(config: BenchConfig, mesh: Mesh, targs: TrainArgs,
              size: int) -> BenchmarkRecord:
    """Measure one (mode, mesh, size) train cell."""
    impl = resolve_train_impl(config.matmul_impl)
    setup = make_train_setup(
        mesh, targs.mode, size, config.dtype, batch=targs.batch,
        zero=targs.zero, grad_quant=targs.grad_quant, lr=targs.lr,
        impl=impl, seed=config.seed)

    # cumulative-prefix timing: prefix k runs phases 1..k, so the split
    # below telescopes to the full step's time exactly. The prefixes are
    # timed in turns, the median of three rounds each (JAX times them one
    # after another): on a card under its power limit the clock falls
    # while the prefixes run, and timed one after another the later
    # prefixes would pay for it, pushing the split's phases apart
    cum: dict[str, Timing] = dict(zip(PHASES, time_variants_n(
        [setup.prefixes[phase] for phase in PHASES], setup.operands,
        iterations=config.iterations, warmup=config.warmup)))
    wall = cum["allgather"].avg_s
    phases_s: dict[str, float] = {}
    prev = 0.0
    for phase in PHASES:
        t = cum[phase].avg_s
        phases_s[f"{phase}_s"] = round(t - prev, 9)
        prev = t

    drift: list[float] = []
    if wire_active(setup) and targs.steps > 0:
        # the exact-wire shadow shares the operands (same seed, same bits)
        exact_prefixes = train_step_programs(
            mesh, targs.mode, size, batch=setup.global_batch, zero=targs.zero,
            grad_quant=None, lr=targs.lr, impl=impl)
        exact = dataclasses.replace(setup, grad_quant=None, prefixes=exact_prefixes,
                                    step=exact_prefixes["allgather"])
        drift = drift_series(setup, exact, targs.steps)

    extras: dict = {"train": {
        "zero": int(setup.zero),
        "grad_quant": setup.grad_quant or "none",
        "steps": targs.steps,
        "lr": setup.lr,
        "dp": setup.dp, "tp": setup.tp,
        "global_batch": setup.global_batch,
        "local_batch": setup.local_batch,
        "phases": phases_s,
        "phase_sum_s": round(sum(phases_s.values()), 9),
        "wall_s": round(wall, 9),
        "update_drift": drift,
    }}
    if drift:
        extras["train"]["update_rel_err"] = drift[-1]
    if setup.mesh_spec is not None:
        extras["mesh"] = setup.mesh_spec
    try:
        from tpu_matmul_bench_torch.analysis.comms_model import train_wire_bytes_summary

        extras["train"]["wire"] = train_wire_bytes_summary(
            targs.mode, setup.mesh_spec, setup.world, size, config.dtype_name,
            setup.grad_quant, batch=setup.global_batch, zero=setup.zero)
    except ValueError:
        pass  # cells the analytic model doesn't cover stay label-only

    # the fwd+bwd prefix is the compute leg and the update is compute too;
    # the comm split charges the gradient sync and the ZeRO all_gather
    compute_s = cum["bwd"].avg_s + (cum["update"].avg_s - cum["grad_comm"].avg_s)
    comm_s = max(wall - compute_s, 0.0)
    # tflops_per_device counts the cards the ranks occupy, as every mode
    # record of the port does (`parallel/modes.py _mode_record`)
    rec = _mode_record(
        config, "train", targs.mode, size, mesh, cum["allgather"],
        calculate_tflops(size, wall, num_ops=2 * setup.global_batch), extras,
        avg_time_s=wall, compute_time_s=compute_s, comm_time_s=comm_s)
    if config.validate:
        rec.extras.update(validate_step(setup, config.dtype))
    return rec
