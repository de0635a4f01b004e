"""The kernels' own cost books: operations and bytes of a launch, beside the
hand model.

Port of `tpu_matmul_bench/obs/attribution.py:50-75`. The JAX package reads
XLA's books (`compiled.cost_analysis()`) and records them next to the hand
model 2·m·k·n, so a row shows whether the hand model describes the program
that ran. PyTorch has no compiler books, and cuBLAS keeps none that can be
read, so the port keeps the books of its own kernels instead: the counts
that a launch's geometry implies (`kernel_cost`). Every tensor-core route
and the SIMT route compute whole tiles (TMA, or the loads, fill past the
edge with zeros), so a ragged problem does more operations than the hand
model counts, and the block says so (`agrees` false), as XLA's books say so
of a padded program.

`bound_ms` is the least time the card could take for one product: its
operations at the datasheet peak, or its bytes (each operand read once, the
output written once) at the memory rate, whichever is larger.
"""

from __future__ import annotations

from typing import Any

from tpu_matmul_bench_torch.utils import metrics

# |books/hand − 1| above this marks the block as disagreeing (the JAX
# package's OBS-001 tolerance)
DEFAULT_TOLERANCE_PCT = 10.0


def _padded(x: int, block: int) -> int:
    return -(-x // block) * block


def kernel_cost(route: str, m: int, n: int, k: int, tile: tuple[int, int, int],
                splits: int = 1, dtype: Any = "bfloat16",
                out_dtype: Any = None) -> dict[str, Any]:
    """The counts of one C[m,n] = A[m,k]·B[k,n] launch on `route` at the
    resolved `tile` (bm, bn, bk), as `splits` K slabs of k / splits (the
    split-K GEMM and its reduction when `splits` > 1):

    - `flops`: the operations executed over whole tiles,
      2·⌈m/bm⌉bm·⌈n/bn⌉bn·S·⌈(k/S)/bk⌉bk;
    - `bytes_accessed`: the global loads and stores the tiles issue: each
      output tile loads bm rows of A and bn columns of B over the padded K,
      C is stored once, and a split writes S fp32 (int32 for int8) partials
      of m×n that the reduction reads back;
    - `min_bytes`: A and B read once and C written once.

    `out_dtype` defaults to the operand dtype's (`matmul_out_dtype`)."""
    bm, bn, bk = tile
    if min(bm, bn, bk, splits) < 1 or min(m, n, k) < 0 or k % splits:
        raise ValueError(f"no launch of {m}x{n}x{k} at tile {tile} in {splits} splits")
    item = metrics.bytes_per_element(dtype)
    out = metrics.matmul_out_dtype(dtype) if out_dtype is None else out_dtype
    out_item = metrics.bytes_per_element(out)
    mp, np_ = _padded(m, bm), _padded(n, bn)
    k_pad = splits * _padded(k // splits, bk)
    tiles = (mp // bm) * (np_ // bn)
    partials = 0
    if splits > 1:
        partials = 2 * splits * m * n * metrics.bytes_per_element(metrics.matmul_acc_dtype(out))
    return {"route": route, "tile": [bm, bn, bk], "splits": splits,
            "flops": 2.0 * mp * np_ * k_pad,
            "bytes_accessed": float(tiles * (bm + bn) * k_pad * item
                                    + m * n * out_item + partials),
            "min_bytes": float((m * k + k * n) * item + m * n * out_item)}


def attribution_block(route: str, m: int, n: int, k: int, tile: tuple[int, int, int],
                      splits: int = 1, dtype: Any = "bfloat16", out_dtype: Any = None, *,
                      tolerance_pct: float = DEFAULT_TOLERANCE_PCT) -> dict[str, Any]:
    """The record's `cost_analysis` block for one launch, with the JAX
    block's keys: the kernel's `flops` and `bytes_accessed`
    (`kernel_cost`), the hand model 2·m·k·n, their ratio, whether it is
    within `tolerance_pct`, and the arithmetic intensity."""
    cost = kernel_cost(route, m, n, k, tile, splits, dtype, out_dtype)
    flops, hand = cost["flops"], metrics.matmul_flops(m, n, k)
    ratio = flops / hand if hand else 0.0
    block: dict[str, Any] = {
        "flops": flops,
        "hand_model_flops": hand,
        "flops_ratio": round(ratio, 6),
        "agrees": abs(ratio - 1.0) * 100.0 <= tolerance_pct,
        "tolerance_pct": tolerance_pct,
        "bytes_accessed": cost["bytes_accessed"],
    }
    if cost["bytes_accessed"] > 0:
        block["arithmetic_intensity"] = round(flops / cost["bytes_accessed"], 3)
    return block


def bound(m: int, n: int, k: int, dtype: Any, device_kind: str,
          extra_bytes: float = 0.0) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time `device_kind` could
    take for C[m,n] = A[m,k]·B[k,n] of `dtype`, and which of the two legs
    sets it: 2mnk at the datasheet peak (`utils/metrics.py`), or the
    operands read once, the output written once and `extra_bytes` (a
    split's partials) at the memory rate."""
    peak = metrics.theoretical_peak_tflops(device_kind, dtype)
    bw = metrics.hbm_spec_gbps(device_kind)
    if not peak or not bw:
        raise ValueError(f"no peak or bandwidth row for {device_kind!r} at {dtype}")
    item = metrics.bytes_per_element(dtype)
    out_item = metrics.bytes_per_element(metrics.matmul_out_dtype(dtype))
    ops_s = metrics.matmul_flops(m, n, k) / (peak * 1e12)
    bytes_s = ((m * k + k * n) * item + m * n * out_item + extra_bytes) / (bw * 1e9)
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def bound_ms(m: int, n: int, k: int, dtype: Any, device_kind: str,
             extra_bytes: float = 0.0) -> float:
    """max(2mnk / peak, bytes / bandwidth) in ms (`bound`)."""
    return bound(m, n, k, dtype, device_kind, extra_bytes)[0]


def achieved_fraction_pct(flops: float, time_s: float, device_kind: str,
                          dtype: Any, *, tf32: bool = False) -> float | None:
    """The uniform achieved-fraction: the books' operations over measured
    time, as % of the device's datasheet peak (`tf32`: the TF32 row for a
    float32 product). None when the peak table doesn't know the
    device/dtype (e.g. CPU)."""
    peak = metrics.theoretical_peak_tflops(device_kind, dtype, tf32=tf32)
    if not peak or time_s <= 0:
        return None
    return round(100.0 * (flops / time_s / 1e12) / peak, 3)


def check_blocks(blocks: dict[str, dict[str, Any]], where: str) -> list:
    """OBS-001 findings for a ledger's cost_analysis blocks (keyed by
    entry label): each block whose books disagree with the hand model.
    Imported lazily by the selftest — attribution itself must not pull
    the analysis package in."""
    from tpu_matmul_bench_torch.analysis.findings import Finding

    findings = []
    for label, block in sorted((blocks or {}).items()):
        if not isinstance(block, dict) or block.get("agrees", True):
            continue
        findings.append(Finding(
            "OBS-001", f"{where}:{label}",
            f"compiler attributes {block.get('flops'):.0f} flops but the "
            f"hand model says {block.get('hand_model_flops'):.0f} "
            f"(ratio {block.get('flops_ratio')}, tolerance "
            f"{block.get('tolerance_pct')}%)",
            details=dict(block)))
    return findings
