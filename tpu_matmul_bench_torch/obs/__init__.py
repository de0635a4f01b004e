"""Observability: the kernels' own cost books (`obs/attribution.py`).

Port of the attribution part of `tpu_matmul_bench/obs/`.
"""
