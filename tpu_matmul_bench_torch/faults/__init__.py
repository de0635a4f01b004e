"""Deterministic fault injection, supervised execution, and
crash-consistency certification.

Port of `tpu_matmul_bench/faults/`. The port's durability story —
fsync-per-line journals and ledgers, SIGKILL-surviving span flush,
torn-line-tolerant JSONL stores — is attacked systematically:

- `plan.py` — seeded fault schedules (`kill9`, `hang`, `torn-write`,
  `transient-exc`, `disk-full`) injected at telemetry span boundaries
  via the `TPU_BENCH_FAULT_PLAN` env var (`utils/telemetry.py span`).
- `retry.py` — the unified retry-budget/backoff policy.
- `supervisor.py` — heartbeat-file watchdog for child processes with
  deadline escalation (SIGTERM, grace, SIGKILL); the single sanctioned
  subprocess spawn path (FAULT-001).
- `audit.py` — the crash-consistency certifier: each fault class runs
  fault-free and faulted-then-resumed, and the durable artifacts must
  converge to semantically identical final state; plus the FAULT-001/002
  static audits over the port's tree and its durable-writer registry.
- `workloads.py` / `cli.py` — resumable micro-workloads per subsystem
  and the `python -m tpu_matmul_bench_torch faults {run,audit,selftest}`
  entry points, driven by the committed chaos matrix `specs/chaos.toml`.
"""

from tpu_matmul_bench_torch.faults.plan import (  # noqa: F401
    FAULT_PLAN_ENV,
    FAULT_SCOPE_ENV,
    HEARTBEAT_ENV,
    FaultPlan,
    FaultPlanError,
    FaultSpec,
    parse_plan,
)
from tpu_matmul_bench_torch.faults.retry import RetryBudget, RetryPolicy  # noqa: F401
from tpu_matmul_bench_torch.faults.supervisor import (  # noqa: F401
    LaunchResult,
    supervised_run,
)
