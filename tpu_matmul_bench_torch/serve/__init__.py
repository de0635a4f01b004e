"""Serving subsystem: matmul-as-a-service under latency SLOs.

Port of `tpu_matmul_bench/serve/` for one card. The other programs are
offline throughput benchmarks: one shape, timed in bulk. Serving is mixed
request shapes arriving concurrently, where what matters is the first
request of a shape against later ones, queueing delay, and tail latency
under load:

- `cache`   — executable cache: one CUDA graph of one product a key
  (M, K, N, dtype, impl, mesh shape), captured over the bucket's pooled
  operands, LRU-bounded, with hit/miss/eviction counters and each entry's
  cold-compile and warm-dispatch time;
- `queue`   — admission queue that buckets requests onto a padded shape
  grid (distinct request sizes share executables), micro-batches within
  a window, and sheds on overflow instead of blocking;
- `scheduler` — the multi-tenant continuous-batching admission path;
- `tenants`, `loadgen` — traffic classes and the seeded open-loop
  (Poisson) and closed-loop request generators, the JAX package's request
  streams;
- `trace`   — the per-request flight recorder and `serve explain`;
- `service` — the worker loop wiring cache + queue onto the port's ops,
  timing each request with the sync discipline of `utils/timing.py`, and
  writing schema-v2 ledgers;
- `cli`     — `python -m tpu_matmul_bench_torch serve
  {bench,ab,selftest,explain,trace selftest}`.
"""
