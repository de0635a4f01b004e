"""`scripts/smoke_restore_cost.py`: the seconds each cut repeat count of
`chip_smoke.py` would cost back, from the per-call ms a run prints."""

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import smoke_restore_cost as src  # noqa: E402

# the phase lines of a made-up run: the main path's products, one scaling
# run of each kind, a ring mode, two compare rows and a wire entry
LINES = [
    {"phase": "main_path[cuda,dispatch]", "avg_ms": 12.0},
    {"phase": "main_path[torch,dispatch]", "avg_ms": 11.0},
    {"phase": "scaling[batch_parallel,cuda,dispatch]", "world": 4, "avg_ms": 50.0},
    {"phase": "scaling[batch_parallel,torch,fused]", "world": 4, "avg_ms": 40.0},
    {"phase": "scaling[matrix_parallel,cuda,dispatch,d=1]", "world": 1, "avg_ms": 10.0},
    {"phase": "overlap_modes[collective_matmul,cuda,dispatch]", "avg_ms": 13.0},
    {"phase": "compare[table]", "rows": {
        "single": {"avg_ms": 30.0, "world": 1},
        "overlap": {"avg_ms": 50.0, "world": 4}}},
    {"phase": "processes[wire,none]", "seconds": 11.0},
    {"phase": "seconds", "total": 900.0, "laps": {"build": 30.0}},
]


def _run(tmp_path, capsys) -> list[dict]:
    out = tmp_path / "smoke.out"
    out.write_text("\n".join(json.dumps(line) for line in LINES) + "\nnot json\n")
    src.main([str(out)])
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_each_restore_costs_its_added_calls_at_each_runs_ms(tmp_path, capsys):
    rows = _run(tmp_path, capsys)
    scaling, cm_modes, compare, wire, total = rows
    # dispatch, 5 after 1 -> 10 after 2: a program's calls 1+5+2*6 = 18 ->
    # 2+10+2*11 = 34, two programs; the efficiency baseline 6 -> 12 calls
    batch = 2 * 16 * 50.0 + 6 * 12.0
    # fused: 1+5 -> 1+10 calls a program; the torch baseline
    fused = 2 * 5 * 40.0 + 5 * 11.0
    one_rank = 6 * 10.0  # one program, 6 -> 12 calls, no baseline
    assert scaling["seconds"] == pytest.approx((batch + fused + one_rank) / 1e3)
    assert cm_modes["seconds"] == pytest.approx(2 * 16 * 13.0 / 1e3)
    # compare, 2 after 1 -> 3 after 1: `single` 3 -> 4 calls; `overlap`
    # 1+2+2*3 = 9 -> 1+3+2*4 = 12 calls of 8 steps, three programs
    assert compare["seconds"] == pytest.approx((30.0 + 3 * 3 * 50.0 * 8) / 1e3)
    assert wire["seconds"] == pytest.approx(33.0)
    assert wire["total_with_it"] == pytest.approx(
        900.0 + sum(r["seconds"] for r in (scaling, cm_modes, compare, wire)))
    assert total["seconds_line_total"] == 900.0
