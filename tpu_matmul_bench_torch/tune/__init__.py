"""The tuning database: the persistent cell store (`db`), cost-model tile
pruning (`prune`), measured-winner promotion (`promote`), the committed
store's regeneration (`regen`) and the head-to-head that seeds it
(`head_to_head`), wired as `python -m tpu_matmul_bench_torch tune
{show,prune,promote,selftest}` (tune/cli.py); flag-style invocations fall
through to the measurement sweep, `benchmarks/cuda_tune.py`.

Port of `tpu_matmul_bench/tune/`."""
