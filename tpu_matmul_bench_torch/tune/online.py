"""Shadow-traffic online autotuner — the closed loop over the tune DB.

Port of `tpu_matmul_bench/tune/online.py`, over the port's two impls:
`torch` (the library product) and `cuda` (the hand-written kernel) are
each other's runner-up. The offline path measures on a bench and
promotes winners into `tune/db.py`; anything it did not measure rides on
the table or an analytic prior. This module closes the loop the way T3
(arXiv:2401.16677) and Triton-distributed (arXiv:2504.19442) argue for:
the *serving* process
itself routes a bounded fraction of real requests through the routing
question's runner-up implementation, measures warm service latency per
bucket, and feeds the verdict back into the DB as a ``measured-online``
cell — under exactly the promotion discipline the offline path uses.

Discipline, in order of precedence:

- **ε budget is a hard ceiling.** At any point in the stream,
  explored ≤ ε · seen. The check is an invariant on counters, not a coin
  flip — an adversarial arrival order cannot push shadow traffic past
  the budget.
- **SLO debt is sacred.** A request from a tenant whose backlog already
  implies a wait past its p99 budget (`scheduler.tenant_in_slo_debt`,
  the same predicate SLO shedding prices with) is never explored.
- **Open breakers stay quiet.** A bucket whose circuit breaker is open
  or half-open (`scheduler.breaker_open`) gets its recovery probe from
  the breaker machinery, not extra experimental traffic.
- **Analytic cells first.** Buckets whose incumbent rides on an analytic
  prior (or no cell at all) explore at the full ε; buckets with a
  measured incumbent are discounted — the loop spends its budget where
  the DB is weakest.
- **Promotion needs evidence.** Only warm samples count (a cold compile
  in the latency is not the kernel's fault); both arms need
  `min_samples`; the winner must clear the same 1%-of-runner-up tie gate
  as `tune/promote.py`; and the promoted cell cites the serve ledger the
  samples came from — TUNE-003 fails any online cell without a
  ``.jsonl`` reference.
"""

from __future__ import annotations

import dataclasses
import random
import statistics
from typing import Any

from tpu_matmul_bench_torch.tune.promote import TIE_GATE_PCT

PROVENANCE_ONLINE = "measured-online"

#: warm samples per arm before a comparison is allowed to promote
DEFAULT_MIN_SAMPLES = 8

#: ε multiplier for buckets whose incumbent is already measured — the
#: budget concentrates on analytic-provenance (and cell-less) buckets
MEASURED_DISCOUNT = 0.25

_ALTERNATE = {"torch": "cuda", "cuda": "torch"}


@dataclasses.dataclass
class _Arm:
    impl: str
    samples: list[float] = dataclasses.field(default_factory=list)

    @property
    def mean_s(self) -> float | None:
        return statistics.fmean(self.samples) if self.samples else None


@dataclasses.dataclass
class _BucketState:
    """Explorer state for one routing question (one padded bucket)."""

    m: int
    k: int
    n: int
    dtype: str
    weight: float            # ε multiplier (1.0 analytic/no-cell)
    provenance_kind: str     # incumbent's cell kind ("" = table fallback)
    incumbent: _Arm
    alternate: _Arm

    @property
    def label(self) -> str:
        return f"{self.m}x{self.k}x{self.n}/{self.dtype}"


class OnlineExplorer:
    """ε-budgeted two-arm bandit over the tune DB's runner-up impls.

    One instance per serve run. `bind(queue)` attaches the scheduler's
    guard hooks (duck-typed — a queue without them, e.g. the fixed FIFO,
    simply has no debt/breaker state to respect). `consider` decides
    per request; `observe` ingests the measured warm service time;
    `promote` writes winners into a DB under the offline tie gate.
    """

    def __init__(self, *, epsilon: float, device_kind: str,
                 db: Any = None, seed: int = 0,
                 min_samples: int = DEFAULT_MIN_SAMPLES,
                 configured_impl: str = "auto") -> None:
        if not 0.0 < epsilon <= 1.0:
            raise ValueError(f"epsilon must be in (0, 1], got {epsilon}")
        self.epsilon = float(epsilon)
        self.device_kind = device_kind
        self.min_samples = int(min_samples)
        # "auto" → the incumbent is whatever routing resolves; an
        # explicit --matmul-impl pins the incumbent arm instead
        self.configured_impl = configured_impl
        self._db = db
        self._rng = random.Random(seed)
        self._buckets: dict[tuple, _BucketState] = {}
        self.seen = 0
        self.explored = 0
        self.blocked = {"budget": 0, "slo_debt": 0, "breaker_open": 0}
        self._slo_debt = None
        self._breaker_open = None
        from tpu_matmul_bench_torch.obs.registry import get_registry

        reg = get_registry()
        self._m_decisions = {
            o: reg.counter("tune_explore_total", outcome=o)
            for o in ("explored", "routine", "budget", "slo_debt",
                      "breaker_open")}

    def bind(self, queue: Any) -> None:
        """Attach the scheduler guards (missing hooks → guard passes)."""
        self._slo_debt = getattr(queue, "tenant_in_slo_debt", None)
        self._breaker_open = getattr(queue, "breaker_open", None)

    # ---------------------------------------------------------- routing

    def _bucket_state(self, key: Any) -> _BucketState:
        bkey = (key.m, key.k, key.n, key.dtype)
        st = self._buckets.get(bkey)
        if st is not None:
            return st
        if self.configured_impl != "auto":
            incumbent, kind, weight = self.configured_impl, "flag", 1.0
        else:
            from tpu_matmul_bench_torch.ops.impl_select import resolve_route

            # the seam: routing speaks (m, n, k), keys speak (m, k, n)
            choice, cell = resolve_route(key.m, key.n, key.k,
                                         self.device_kind, key.dtype,
                                         db=self._db)
            incumbent = choice.impl
            kind = cell.provenance_kind if cell is not None else ""
            # measured incumbents are the DB at its strongest — discount
            # them; analytic priors and table fallbacks get the full
            # budget
            weight = MEASURED_DISCOUNT if kind.startswith("measured") \
                else 1.0
        st = _BucketState(
            m=key.m, k=key.k, n=key.n, dtype=key.dtype,
            weight=weight, provenance_kind=kind,
            incumbent=_Arm(incumbent),
            alternate=_Arm(_ALTERNATE.get(incumbent, "torch")))
        self._buckets[bkey] = st
        return st

    def consider(self, key: Any, tenant: str) -> str | None:
        """The runner-up impl to shadow-route this request through, or
        None (serve the incumbent). Every call counts toward `seen`;
        the hard-budget invariant explored ≤ ε·seen holds at every
        prefix of the stream regardless of arrival order."""
        self.seen += 1
        st = self._bucket_state(key)
        if self.explored + 1 > self.epsilon * self.seen:
            self.blocked["budget"] += 1
            self._m_decisions["budget"].inc()
            return None
        if self._slo_debt is not None and self._slo_debt(tenant):
            self.blocked["slo_debt"] += 1
            self._m_decisions["slo_debt"].inc()
            return None
        if self._breaker_open is not None \
                and self._breaker_open((key.m, key.k, key.n), key.dtype):
            self.blocked["breaker_open"] += 1
            self._m_decisions["breaker_open"].inc()
            return None
        # pacing draw: full ε on analytic/no-cell buckets, discounted on
        # measured ones — this spends the budget, the invariant above
        # caps it
        if self._rng.random() >= self.epsilon * st.weight:
            self._m_decisions["routine"].inc()
            return None
        self.explored += 1
        self._m_decisions["explored"].inc()
        return st.alternate.impl

    def observe(self, key: Any, service_s: float, *, cold: bool,
                explored: bool) -> None:
        """Ingest one measured warm service time for `key`'s bucket:
        `explored` samples feed the alternate arm, the rest the
        incumbent. Cold acquisitions are dropped — a compile (or
        artifact deserialize) in the latency is startup cost, not
        kernel speed."""
        if cold or service_s <= 0:
            return
        st = self._bucket_state(key)
        arm = st.alternate if explored else st.incumbent
        arm.samples.append(float(service_s))

    # -------------------------------------------------------- promotion

    def decisions(self) -> list[dict[str, Any]]:
        """Per-bucket verdicts (ledger/digest-facing): arm means, sample
        counts, and what promotion would do. Buckets the stream never
        touched are absent."""
        out = []
        for st in (self._buckets[k] for k in sorted(self._buckets)):
            inc, alt = st.incumbent, st.alternate
            row: dict[str, Any] = {
                "bucket": st.label,
                "incumbent": {"impl": inc.impl, "samples": len(inc.samples),
                              "mean_ms": _ms(inc.mean_s)},
                "alternate": {"impl": alt.impl, "samples": len(alt.samples),
                              "mean_ms": _ms(alt.mean_s)},
                "provenance": st.provenance_kind or "table",
                "weight": st.weight,
            }
            row["verdict"] = self._verdict(st)[0]
            out.append(row)
        return out

    def _verdict(self, st: _BucketState) -> tuple[str, float | None]:
        """("promote"|"tie"|"incumbent"|"insufficient", margin_pct)."""
        inc, alt = st.incumbent, st.alternate
        if len(inc.samples) < self.min_samples \
                or len(alt.samples) < self.min_samples:
            return "insufficient", None
        inc_s, alt_s = inc.mean_s, alt.mean_s
        if alt_s >= inc_s:
            return "incumbent", None
        # same runner-up-denominator margin as tune/promote: the
        # challenger must beat the incumbent by more than run noise
        margin_pct = (inc_s - alt_s) / alt_s * 100.0
        if margin_pct < TIE_GATE_PCT:
            return "tie", margin_pct
        return "promote", margin_pct

    def promote(self, db: Any, ledger_ref: str) -> dict[str, Any]:
        """Write every clear online winner into `db` as a
        ``measured-online`` cell citing `ledger_ref` (the serve ledger
        these samples came from — the TUNE-003 obligation). Returns
        {"promoted": [cells], "skipped": [reasons]}."""
        from tpu_matmul_bench_torch.tune.db import Cell, kind_token

        if ".jsonl" not in (ledger_ref or ""):
            raise ValueError(
                f"online promotion needs a serve ledger reference "
                f"(.jsonl), got {ledger_ref!r} — without one the cell "
                "would be born violating TUNE-003")
        promoted, skipped = [], []
        for st in (self._buckets[k] for k in sorted(self._buckets)):
            verdict, margin = self._verdict(st)
            inc, alt = st.incumbent, st.alternate
            if verdict == "insufficient":
                if alt.samples:  # untouched buckets stay silent
                    skipped.append(
                        f"{st.label}: {len(alt.samples)}/{self.min_samples} "
                        f"alternate samples — not enough evidence")
                continue
            if verdict == "incumbent":
                skipped.append(
                    f"{st.label}: incumbent {inc.impl} holds "
                    f"({_ms(inc.mean_s)} vs {_ms(alt.mean_s)} ms)")
                continue
            if verdict == "tie":
                skipped.append(
                    f"{st.label}: margin {margin:.2f}% is inside the "
                    f"{TIE_GATE_PCT}% confirm-noise gate — not promoted")
                continue
            blocks = None
            if alt.impl == "cuda":
                # the tile the explored executables ran: the default,
                # as the kernel resolves it for this problem
                from tpu_matmul_bench_torch.ops import cuda_matmul as cm

                blocks = cm.effective_blocks(st.m, st.n, st.k,
                                             *cm.DEFAULT_TILE, st.dtype)
            cell = Cell(
                m=st.m, k=st.k, n=st.n, dtype=st.dtype,
                device_kind=kind_token(self.device_kind),
                impl=alt.impl,
                provenance_kind=PROVENANCE_ONLINE,
                artifact=ledger_ref,
                detail=(f"online explorer shadow traffic: {alt.impl} mean "
                        f"{_ms(alt.mean_s)} ms vs incumbent {inc.impl} "
                        f"{_ms(inc.mean_s)} ms over "
                        f"{len(alt.samples)}/{len(inc.samples)} warm "
                        f"samples (margin {margin:.2f}%, "
                        f"eps={self.epsilon})"),
                blocks=blocks)
            promoted.append(db.put(cell))
        return {"promoted": promoted, "skipped": skipped}

    def summary(self) -> dict[str, Any]:
        """The ledger's ``extras["serve"]["explore"]`` block."""
        return {
            "epsilon": self.epsilon,
            "seen": self.seen,
            "explored": self.explored,
            "explored_pct": round(100.0 * self.explored / self.seen, 2)
            if self.seen else 0.0,
            "blocked": dict(self.blocked),
            "min_samples": self.min_samples,
            "decisions": self.decisions(),
        }


def _ms(seconds: float | None) -> float | None:
    return round(seconds * 1e3, 3) if seconds is not None else None


# ------------------------------------------------------------- selftest


class _AdversarialQueue:
    """Guard fixture for the selftest: one tenant permanently in SLO
    debt, one bucket's breaker permanently open."""

    def __init__(self, debtor: str, open_bucket: tuple) -> None:
        self.debtor = debtor
        self.open_bucket = open_bucket

    def tenant_in_slo_debt(self, tenant: str) -> bool:
        return tenant == self.debtor

    def breaker_open(self, bucket, dtype: str) -> bool:
        return tuple(bucket) == self.open_bucket


def run_selftest(*, epsilon: float = 0.1, requests: int = 4000,
                 seed: int = 0) -> int:
    """`tune online selftest`: drive the explorer with a seeded
    adversarial stream (a debt-ridden tenant, an open breaker, skewed
    arrival order) against an empty DB and check every discipline:
    budget invariant at each prefix, guard absolutes, tie gate, and
    that a promoted cell is a valid measured-online cell with a ledger
    reference. Device-free — arms are simulated, nothing compiles."""
    import os
    import tempfile

    from tpu_matmul_bench_torch.serve.cache import ExecKey
    from tpu_matmul_bench_torch.tune.db import TuningDB

    problems: list[str] = []
    rng = random.Random(seed)
    guard = _AdversarialQueue("debtor", (512, 512, 512))
    ex = OnlineExplorer(epsilon=epsilon, device_kind="cpu", seed=seed,
                        db=TuningDB(path=os.devnull))
    ex.bind(guard)
    # three buckets: a clean one (alternate genuinely 5% faster), the
    # breaker-open one, and a tie bucket (0.2% apart — must not promote)
    keys = {
        "clean": ExecKey(256, 256, 256, "float32", "auto"),
        "breaker": ExecKey(512, 512, 512, "float32", "auto"),
        "tie": ExecKey(1024, 1024, 1024, "float32", "auto"),
    }
    base_ms = {"clean": 2.0, "breaker": 4.0, "tie": 3.0}
    alt_factor = {"clean": 0.95, "breaker": 0.95, "tie": 0.998}
    tenants = ["interactive", "debtor", "bulk"]
    guard_violations = 0
    budget_violations = 0
    for i in range(requests):
        name = rng.choice(list(keys))
        key = keys[name]
        tenant = tenants[i % len(tenants)]
        alt = ex.consider(key, tenant)
        if alt is not None and (tenant == "debtor" or name == "breaker"):
            guard_violations += 1
        if ex.explored > ex.epsilon * ex.seen:  # prefix invariant
            budget_violations += 1
        base = base_ms[name] * (alt_factor[name] if alt is not None else 1.0)
        service_s = base * 1e-3 * rng.uniform(0.99, 1.01)
        ex.observe(key, service_s, cold=(i < 3), explored=alt is not None)
    if guard_violations:
        problems.append(f"{guard_violations} exploration(s) through a "
                        "guarded tenant/bucket — guards must be absolute")
    if budget_violations:
        problems.append(f"budget invariant violated at {budget_violations} "
                        f"stream prefix(es): explored > eps*seen")
    if ex.explored == 0:
        problems.append("explorer never explored — budget accounting is "
                        "stuck, no feedback can ever be gathered")
    if ex.blocked["slo_debt"] == 0 or ex.blocked["breaker_open"] == 0:
        problems.append("adversarial stream never hit a guard — the "
                        "selftest fixture is not exercising them")
    # promotion: clean bucket promotes, tie bucket must not
    with tempfile.TemporaryDirectory() as td:
        db = TuningDB(path=os.path.join(td, "online_db.jsonl"))
        result = ex.promote(db, ledger_ref="measurements/serve/run.jsonl")
        promoted = {c.key[0]: c for c in result["promoted"]}
        clean_key = keys["clean"]
        from tpu_matmul_bench_torch.tune.db import problem_fingerprint

        clean_fp = problem_fingerprint(clean_key.m, clean_key.k,
                                       clean_key.n, clean_key.dtype)
        tie_fp = problem_fingerprint(1024, 1024, 1024, "float32")
        if clean_fp not in promoted:
            problems.append("a 5%-faster alternate with full samples was "
                            "not promoted")
        else:
            cell = promoted[clean_fp]
            if cell.provenance_kind != PROVENANCE_ONLINE:
                problems.append(f"promoted cell carries "
                                f"{cell.provenance_kind!r}, expected "
                                f"{PROVENANCE_ONLINE!r}")
            if ".jsonl" not in cell.artifact:
                problems.append("promoted cell cites no ledger (.jsonl)")
        if tie_fp in promoted:
            problems.append("a 0.2% margin was promoted — the tie gate "
                            "must hold online exactly as offline")
        for prob in TuningDB.load(db.path).validate():
            if "does not exist" in prob:
                continue  # the selftest ledger path is synthetic
            problems.append(f"promoted DB fails validate(): {prob}")
    if problems:
        print(f"tune online selftest FAILED — {len(problems)} problem(s) "
              f"over {requests} seeded requests:")
        for prob in problems:
            print(f"  {prob}")
        return 1
    print(f"tune online selftest ok: {requests} seeded requests, "
          f"explored {ex.explored} ({ex.summary()['explored_pct']}% ≤ "
          f"eps={epsilon:g}), blocked "
          f"slo_debt={ex.blocked['slo_debt']} "
          f"breaker={ex.blocked['breaker_open']}, promotion + tie gate "
          f"verified")
    return 0
