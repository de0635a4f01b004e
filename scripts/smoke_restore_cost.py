#!/usr/bin/env python3
"""What giving `chip_smoke.py` back each repeat count slice 22 cut would cost.

    python3 scripts/smoke_restore_cost.py SMOKE_STDOUT

SMOKE_STDOUT is the standard output of one whole `chip_smoke.py` run (its
JSON lines). For each cut, in the order they are given back (RESTORES), the
script adds up, over every run the count reaches, the calls that going from
the cut count to the restored one adds, times that run's own ms a call as
its phase line printed it. It prints one JSON line a restore, with its
seconds, the runs that make them up and the run's `seconds` line total
plus every restore up to this one (the total a tree that gave back those
would read, where the run was of the cut tree), then the `seconds` line.

Only the calls are costed: a run's set-up, validation and start-up do not
change with its repeat count. Step 4 (the wire runs across processes at
16384 instead of 8192) changes sizes, not counts: its cost is taken as
three more times each wire entry's seconds (its bytes grow fourfold, its
products eightfold), which is less than it would be.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

# (name, constant(s) of chip_smoke.py, the cut value, the restored value)
RESTORES = [
    ("scaling programs", "SCALING_ITERATIONS, SCALING_WARMUP", (5, 1), (10, 2)),
    ("collective-matmul modes", "CM_ITERATIONS, CM_WARMUP", (5, 1), (10, 2)),
    ("compare", "COMPARE_ITERATIONS", (2, 1), (3, 1)),
    ("wire timing across processes", "PROCESS_WIRE_SIZE", (8192,), (16384,)),
]
EFFICIENCY_MODES = ("independent", "batch_parallel", "data_parallel")


def program_calls(single: bool, timing: str, it: int, wu: int) -> int:
    """One timed program's calls: a single program's warmup and timed
    calls (or the fused eager call and chain), else those of the first of
    VARIANT_ROUNDS rounds and one warm and `it` timed a round after it."""
    if timing == "fused":
        return 1 + it
    return wu + it if single else wu + it + (cs.VARIANT_ROUNDS - 1) * (1 + it)


def scaling_family(lines: list[dict], old, new, base_ms: dict) -> tuple[float, dict]:
    """The runs SCALING_ITERATIONS and SCALING_WARMUP reach: the scaling,
    comm_quant, hybrid, summa and matmul_all_ranks runs, the curve's rows
    and `independent` across processes; each efficiency mode's
    single-device baseline product too (base_ms by impl)."""
    total, parts = 0.0, {}
    for o in lines:
        ph = o.get("phase", "")
        m = re.match(r"(scaling|hybrid|summa|matmul_all_ranks)\[([^\]]*)\]$", ph)
        if m and o.get("avg_ms") is not None:
            fields = m.group(2).split(",")
            if m.group(1) == "matmul_all_ranks":
                impl, timing = fields[0], fields[1]
                mode, d, single = "matmul", o.get("world", 4), True
            else:
                mode, impl, timing = fields[0], fields[1], fields[2]
                d = o.get("world") or cs.RING_WORLD
                single = mode == "independent" or (mode == "matrix_parallel" and d == 1)
            programs = 1 if single else 2
            extra = programs * (program_calls(single, timing, *new)
                                - program_calls(single, timing, *old)) * o["avg_ms"]
            if d > 1 and mode in EFFICIENCY_MODES:
                extra += (program_calls(True, timing, *new)
                          - program_calls(True, timing, *old)) * base_ms[impl]
            parts[ph] = extra / 1e3
            total += extra / 1e3
        elif ph == "curve":
            for n, row in (o.get("counts") or {}).items():
                single = int(n) == 1
                extra = (1 if single else 2) * (
                    program_calls(single, "dispatch", *new)
                    - program_calls(single, "dispatch", *old)) * row["avg_ms"]
                parts[f"curve[{n}]"] = extra / 1e3
                total += extra / 1e3
            extra = (program_calls(True, "dispatch", *new)
                     - program_calls(True, "dispatch", *old)) * base_ms["cuda"]
            parts["curve[baseline]"] = extra / 1e3
            total += extra / 1e3
        elif ph == "processes[independent]":
            extra = ((program_calls(True, "dispatch", *new) - program_calls(True, "dispatch", *old))
                     * (o["avg_ms"] + base_ms["cuda"]))
            parts[ph] = extra / 1e3
            total += extra / 1e3
    return total, parts


def cm_family(lines: list[dict], old, new) -> tuple[float, dict]:
    """The collective-matmul modes' runs (`overlap_modes`): a baseline and
    a ring program each, every call about the ring's ms."""
    total, parts = 0.0, {}
    for o in lines:
        m = re.match(r"overlap_modes\[(collective_matmul\w*),(\w+),(\w+)\]$", o.get("phase", ""))
        if m:
            timing = m.group(3)
            extra = 2 * (program_calls(False, timing, *new)
                         - program_calls(False, timing, *old)) * o["avg_ms"]
            parts[o["phase"]] = extra / 1e3
            total += extra / 1e3
    return total, parts


def compare_family(lines: list[dict], old, new) -> tuple[float, dict]:
    """Every row of the compare phase's runs: a one-rank or `independent`
    row times one program, a step mode its programs of STEPS_PER_CALL
    steps (its ms is a step's), every other row two programs."""
    total, parts = 0.0, {}
    for o in lines:
        if not o.get("phase", "").startswith("compare["):
            continue
        for row, r in (o.get("rows") or {}).items():
            if r.get("avg_ms") is None:
                continue
            single = r.get("world") == 1 or row == "independent"
            call_ms, programs = r["avg_ms"], 1 if single else 2
            if row in cs.STEP_MODES:
                call_ms *= cs.STEPS_PER_CALL
                programs = len(cs.overlap_programs(row, cs.RING_WORLD))
            extra = programs * (program_calls(single, "dispatch", *new)
                                - program_calls(single, "dispatch", *old)) * call_ms
            parts[f"{o['phase']}:{row}"] = extra / 1e3
            total += extra / 1e3
    return total, parts


def wire_family(lines: list[dict]) -> tuple[float, dict]:
    parts = {o["phase"]: 3 * o["seconds"] for o in lines
             if o.get("phase", "").startswith("processes[wire,")}
    return sum(parts.values()), parts


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("stdout", type=Path)
    args = p.parse_args(argv)
    lines = []
    for line in args.stdout.read_text().splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict):
            lines.append(obj)
    base_ms = {impl: next(o["avg_ms"] for o in lines
                          if o.get("phase") == f"main_path[{impl},dispatch]")
               for impl in ("cuda", "torch")}
    seconds = next((o for o in lines if o.get("phase") == "seconds"), {})
    running = seconds.get("total")
    for name, constants, cut, restored in RESTORES:
        if name == "scaling programs":
            cost, parts = scaling_family(lines, cut, restored, base_ms)
        elif name == "collective-matmul modes":
            cost, parts = cm_family(lines, cut, restored)
        elif name == "compare":
            cost, parts = compare_family(lines, cut, restored)
        else:
            cost, parts = wire_family(lines)
        running = None if running is None else running + cost
        print(json.dumps({"restore": name, "constants": constants, "from": cut,
                          "to": restored, "seconds": cost, "total_with_it": running,
                          "runs": parts}))
    print(json.dumps({"seconds_line_total": seconds.get("total"), "laps": seconds.get("laps")}))


if __name__ == "__main__":
    main()
