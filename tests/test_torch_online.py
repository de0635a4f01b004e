"""The online explorer on the CPU (`tune/online.py`) against the JAX
package's: `tune online selftest`'s seeded adversarial stream gives the
same counters and promotes the same cell for seeds 0–2 (the JAX runner-up
`pallas` is the port's `cuda`); the port's explorer over the committed
H100 DB routes and promotes as its tier rules say."""

import os

import pytest

from tpu_matmul_bench.tune import online as jax_online
from tpu_matmul_bench_torch.__main__ import main as port_main
from tpu_matmul_bench_torch.serve.cache import ExecKey
from tpu_matmul_bench_torch.tune import db, online

H100 = "NVIDIA H100 80GB HBM3"


def _captured(monkeypatch, module) -> list:
    """Every explorer the module's selftest builds, and its promotions."""
    made = []

    class Recording(module.OnlineExplorer):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.promotions = []
            made.append(self)

        def promote(self, db, ledger_ref):
            result = super().promote(db, ledger_ref)
            self.promotions.append(result)
            return result

    monkeypatch.setattr(module, "OnlineExplorer", Recording)
    return made


def _cell(c) -> tuple:
    return (c.m, c.k, c.n, c.dtype, c.device_kind, c.provenance_kind, c.artifact, c.detail,
            c.fingerprint)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_selftest_counters_and_promotion_are_jaxs(seed, monkeypatch, capsys):
    port = _captured(monkeypatch, online)
    ref = _captured(monkeypatch, jax_online)
    assert online.run_selftest(seed=seed) == 0
    port_out = capsys.readouterr().out
    assert jax_online.run_selftest(seed=seed) == 0
    assert port_out == capsys.readouterr().out
    (ex,), (jx,) = port, ref
    assert (ex.seen, ex.explored, ex.blocked) == (jx.seen, jx.explored, jx.blocked)
    assert ex.seen == 4000 and ex.explored <= ex.epsilon * ex.seen
    # the decisions, with the port's impl names for JAX's
    names = {"xla": "torch", "pallas": "cuda"}
    rows = jx.decisions()
    for row in rows:
        for arm in ("incumbent", "alternate"):
            row[arm]["impl"] = names[row[arm]["impl"]]
    assert ex.decisions() == rows
    (got,), (want,) = ex.promotions, jx.promotions
    assert got["skipped"] == want["skipped"]
    assert [_cell(c) for c in got["promoted"]] == [
        _cell(c)[:7] + (c.detail.replace("pallas", "cuda").replace("xla", "torch"),
                        c.fingerprint) for c in want["promoted"]]
    assert [(c.impl, c.blocks) for c in got["promoted"]] == [("cuda", (64, 64, 16))]


def test_budget_holds_at_every_prefix_and_guards_are_absolute():
    class Guards:
        @staticmethod
        def tenant_in_slo_debt(tenant):
            return tenant == "late"

        @staticmethod
        def breaker_open(bucket, dtype):
            return tuple(bucket) == (256, 256, 256)

    ex = online.OnlineExplorer(epsilon=0.3, device_kind="cpu", seed=5,
                               db=db.TuningDB(path=os.devnull))
    ex.bind(Guards())
    keys = [ExecKey(128, 128, 128, "float32", "auto"), ExecKey(256, 256, 256, "float32", "auto")]
    for i in range(3000):
        key, tenant = keys[i % 2], ("late", "ok", "ok")[i % 3]
        alt = ex.consider(key, tenant)
        assert ex.explored <= 0.3 * ex.seen
        assert alt is None or (tenant != "late" and key is keys[0])
        assert alt in (None, "cuda")  # the CPU's incumbent is the library
    assert ex.blocked["slo_debt"] and ex.blocked["breaker_open"] and ex.explored
    with pytest.raises(ValueError, match="epsilon"):
        online.OnlineExplorer(epsilon=0.0, device_kind="cpu")


def test_on_the_h100_db_the_runner_up_and_its_cell(tmp_path):
    ex = online.OnlineExplorer(epsilon=1.0, device_kind=H100, seed=0, min_samples=2)
    bf16 = ExecKey(1024, 4096, 4096, "bfloat16", "auto")  # no cell: the table, torch
    int8 = ExecKey(4096, 4096, 4096, "int8", "auto")  # a measured cuda cell
    assert ex.consider(bf16, "t") == "cuda" and ex.consider(int8, "t") in (None, "torch")
    rows = {r["bucket"]: r for r in ex.decisions()}
    assert rows["1024x4096x4096/bfloat16"]["provenance"] == "table"
    assert rows["1024x4096x4096/bfloat16"]["weight"] == 1.0
    assert rows["4096x4096x4096/int8"]["incumbent"]["impl"] == "cuda"
    assert rows["4096x4096x4096/int8"]["weight"] == online.MEASURED_DISCOUNT
    for _ in range(3):
        ex.observe(bf16, 1.0e-3, cold=False, explored=False)
        ex.observe(bf16, 0.9e-3, cold=False, explored=True)
        ex.observe(bf16, 0.1e-3, cold=True, explored=True)  # a cold sample is dropped
    store = db.TuningDB(path=str(tmp_path / "db.jsonl"))
    with pytest.raises(ValueError, match="serve ledger reference"):
        ex.promote(store, ledger_ref="nowhere")
    (cell,) = ex.promote(store, ledger_ref="serve.jsonl")["promoted"]
    assert (cell.impl, cell.provenance_kind, cell.device_kind) == ("cuda", "measured-online",
                                                                   "h100")
    assert cell.blocks == (128, 256, 64)
    # the new cell is what `auto` routes this problem through, as the online tier
    from tpu_matmul_bench_torch.ops.impl_select import resolve_route

    choice, found = resolve_route(1024, 4096, 4096, H100, "bfloat16", db=store)
    assert (choice.impl, choice.source, found.blocks) == ("cuda", "online", (128, 256, 64))


def test_tune_online_selftest_flags():
    assert port_main(["tune", "online", "selftest", "--epsilon", "0.2", "--requests", "500",
                      "--seed", "3"]) == 0
