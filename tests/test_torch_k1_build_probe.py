"""`scripts/k1_build_probe.py`: the kernels of two builds of K1's library,
held together by readable name."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import k1_build_probe as probe  # noqa: E402

WGMMA = "wgmma_gemm<__nv_bfloat16, 128, 256, 64>"
WMMA = "wmma_gemm<__half, false, 64, 128, 32>"
USAGE = {WGMMA: {"registers": 168, "stack_bytes": 0, "spill_store_bytes": 0,
                 "spill_load_bytes": 0},
         WMMA: {"registers": 96, "stack_bytes": 8, "spill_store_bytes": 0,
                "spill_load_bytes": 0, "warnings": []}}


def _with(name: str, **changes) -> dict:
    return {k: dict(v, **changes) if k == name else dict(v) for k, v in USAGE.items()}


@pytest.mark.parametrize("other,differ", [
    (_with(WMMA), []),  # no warnings and an empty list are the same
    (_with(WGMMA, registers=232), [WGMMA]),
    (_with(WMMA, spill_load_bytes=4), [WMMA]),
    (_with(WGMMA, warnings=["wgmma_serialized"]), [WGMMA]),
    ({WGMMA: USAGE[WGMMA]}, [WMMA]),  # a kernel one build lacks
])
def test_builds_differ_only_where_a_kernel_does(other, differ):
    diff = probe.differences(USAGE, other)
    assert sorted(diff) == differ
    for name in differ:
        mine, theirs = diff[name]
        assert mine != theirs
