"""The training-step workload (port of `tpu_matmul_bench/train/`).

One optimizer step (sharded forward and backward, the gradient sync on an
exact or quantized wire, a ZeRO-style sharded update) over the port's
meshes: `step.py` builds the programs, `harness.py` times and validates
them, `audit.py` checks the step's collectives and downcasts from a call
log, and `cli.py` wires ``python -m tpu_matmul_bench_torch train``.
"""
