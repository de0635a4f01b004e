"""Campaign subsystem: declarative sweeps with resumable execution.

Port of `tpu_matmul_bench/campaign/`. A campaign is a declarative spec
(TOML/JSON — `spec.py`) expanded into a deterministic, fingerprinted job
plan; the executor (`executor.py`) runs each job as a child process of the
port's per-program CLIs (`python -m tpu_matmul_bench_torch <program>`)
with per-job timeout and backoff retries; a crash-safe journal
(`state.py`) makes a SIGKILLed campaign resumable at job granularity; the
store (`store.py`) merges the per-job schema-v2 ledgers into one result
set; and the gate (`gate.py`) turns a campaign-vs-baseline comparison into
one noise-aware pass/fail. Entry point: `python -m tpu_matmul_bench_torch
campaign {run,resume,status,gate}` (`cli.py`). The card-side specs live in
`specs/torch/`.
"""

from tpu_matmul_bench_torch.campaign.spec import (  # noqa: F401
    CampaignSpec,
    CampaignSpecError,
    Job,
    job_fingerprint,
    load_spec,
    spec_from_dict,
)
