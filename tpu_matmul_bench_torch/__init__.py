"""PyTorch/CUDA port of the matmul benchmark (`tpu_matmul_bench`), for the
NVIDIA H100. The JAX package stays beside it as the reference; this package
imports nothing of it.
"""
