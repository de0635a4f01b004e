"""The perf observatory's history half on the CPU (`serve/trace.py
tail_attribution`, `obs/attribution.py` achieved fraction and OBS-001,
`obs/history.py`, `obs/detect.py`, `obs/report.py`, `campaign/gate.py
history_baseline`) against the JAX package's: the same span records give
the same tail shares, the same ledgers the same history points and the
same store bytes, the same store the same HIST findings and the same
report, the same campaign the same history baseline. Ledgers whose device
kind both packages map alike (`cpu`) compare whole; an H100 ledger compares
every field but `backend` and `series`, which the port's kind token sets
(`h100`)."""

import json
import random
import shutil
from pathlib import Path

import pytest

from tpu_matmul_bench.campaign import gate as jax_gate
from tpu_matmul_bench.obs import attribution as jax_attribution
from tpu_matmul_bench.obs import detect as jax_detect
from tpu_matmul_bench.obs import history as jax_hist
from tpu_matmul_bench.obs import report as jax_report
from tpu_matmul_bench.serve import trace as jax_trace
from tpu_matmul_bench_torch.campaign import executor, gate, spec
from tpu_matmul_bench_torch.obs import attribution, detect, history, report
from tpu_matmul_bench_torch.serve import trace

REPO = Path(__file__).resolve().parent.parent
CARD_LEDGERS = REPO / "measurements" / "torch" / "card_pr18"
H100 = "NVIDIA H100 80GB HBM3"


def _finding_rows(findings):
    return [(f.rule, f.severity, f.where, f.message, f.details) for f in findings]


# ------------------------------------------------------- tail attribution

def _span_records(seed: int, n: int) -> list[dict]:
    """Seeded serve_span terminal records: complete ones with the four
    span components (and an unknown span name), plus sheds and failures
    that the attribution must leave out."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        state = rng.choice(["complete"] * 6 + ["failed", "shed_overflow", "evicted"])
        spans = [{"name": name, "ms": round(rng.expovariate(1.0 / scale), 4)}
                 for name, scale in (("queue_wait", 0.4), ("batch_wait", 0.2),
                                     ("cache", 0.05), ("execute", 1.5), ("other", 0.1))
                 if rng.random() < 0.95]
        wall = round(sum(s["ms"] for s in spans) + rng.random() * 0.01, 4)
        out.append({"record_type": "serve_span", "trace_id": f"t{i}", "state": state,
                    "wall_ms": wall if rng.random() < 0.97 else None, "spans": spans})
    return out


@pytest.mark.parametrize("seed, n, quantile", [(0, 200, 0.95), (1, 1, 0.95), (2, 57, 0.95),
                                               (3, 400, 0.5), (4, 20, 0.99), (5, 0, 0.95)])
def test_tail_attribution_is_bitwise_jaxs(seed, n, quantile):
    records = _span_records(seed, n)
    port = trace.tail_attribution(records, quantile=quantile)
    assert port == jax_trace.tail_attribution(records, quantile=quantile)
    assert trace.TAIL_COMPONENTS == jax_trace.TAIL_COMPONENTS
    assert trace.TAIL_QUANTILE == jax_trace.TAIL_QUANTILE == 0.95
    if port is not None:
        assert set(port["shares"]) == set(trace.TAIL_COMPONENTS)
        assert port["tail_count"] >= 1


# ------------------------------------------------------------ attribution

_BLOCKS = {
    "128x128x128/float32/cuda": {"flops": 4194304.0, "hand_model_flops": 4194304.0,
                                 "flops_ratio": 1.0, "agrees": True, "tolerance_pct": 10.0},
    "128x128x128/bfloat16/cuda": {"flops": 8388608.0, "hand_model_flops": 4194304.0,
                                  "flops_ratio": 2.0, "agrees": False, "tolerance_pct": 10.0},
    "96x96x96/int8/cuda": {"flops": 2097152.0, "hand_model_flops": 1769472.0,
                           "flops_ratio": 1.185185, "agrees": False, "tolerance_pct": 10.0},
    "not_a_block": "x",
}


def test_check_blocks_is_jaxs():
    port = attribution.check_blocks(_BLOCKS, "obs-selftest")
    assert _finding_rows(port) == _finding_rows(jax_attribution.check_blocks(_BLOCKS,
                                                                            "obs-selftest"))
    assert [(f.rule, f.where) for f in port] == [
        ("OBS-001", "obs-selftest:128x128x128/bfloat16/cuda"),
        ("OBS-001", "obs-selftest:96x96x96/int8/cuda")]
    assert attribution.check_blocks({}, "x") == [] == attribution.check_blocks(None, "x")


@pytest.mark.parametrize("kind, dtype", [("cpu", "bfloat16"), ("TPU v5 lite", "bfloat16"),
                                         ("TPU v5 lite", "int8"), ("TPU v4", "float32")])
def test_achieved_fraction_is_jaxs(kind, dtype):
    flops, seconds = 2.0 * 8192 ** 3, 0.0125
    assert attribution.achieved_fraction_pct(flops, seconds, kind, dtype) == \
        jax_attribution.achieved_fraction_pct(flops, seconds, kind, dtype)
    assert attribution.achieved_fraction_pct(flops, 0.0, kind, dtype) is None


def test_achieved_fraction_on_the_h100_rows():
    # 2·16384³ in 12.332 ms (K1 dispatched on an NVIDIA H100 80GB HBM3 at 700 W)
    # is 713.27 TFLOP/s: 72.12% of the bf16 row (989), 144.10% of TF32's
    # (495); the JAX package's table has no H100 row
    flops = 2.0 * 16384 ** 3
    assert attribution.achieved_fraction_pct(flops, 12.332e-3, H100, "bfloat16") == 72.121
    assert attribution.achieved_fraction_pct(flops, 12.332e-3, H100, "float32",
                                             tf32=True) == 144.096
    assert attribution.achieved_fraction_pct(flops, 1.0, H100, "float32") == \
        round(100.0 * flops / 1e12 / 67.0, 3)
    assert jax_attribution.achieved_fraction_pct(flops, 12.332e-3, H100, "bfloat16") is None


# ------------------------------------------------------ history points

#: a dozen of the JAX package's committed ledgers, one of each record kind
#: the ingester reads (and two round files)
JAX_LEDGERS = [
    "measurements/r4/headline_fused_pallas.jsonl",             # bench
    "measurements/r4/headline_fused_pallas.HOISTED.jsonl",     # bench, hoisted
    "measurements/r2/tune16k_r2.jsonl",                        # tune sweep
    "measurements/r4/compare_r4_8k.jsonl",                     # every mode
    "measurements/comm_quant/jobs/distributed-int8b32_model_parallel.jsonl",
    "measurements/comm_quant/jobs/scaling-fp8_batch_parallel.jsonl",
    "measurements/hier/jobs/hybrid-d2i4-dcnfp8.jsonl",         # mesh, per-link wire
    "measurements/hier/jobs/stream-d8-ooc.jsonl",              # stream_k
    "measurements/serve_trace/run1.jsonl",                     # serve with spans
    "measurements/serve_tenants/jobs/continuous_mixed_qps600.jsonl",
    "measurements/serve_pod/jobs/pod_open_mixed_quant.jsonl",  # pod
    "measurements/train/jobs/hybrid-d2i4-zero1-dcnfp8.jsonl",  # train
    "BENCH_r04.json",
    "MULTICHIP_r02.json",
]


def _fault_audit_ledger(path: Path) -> None:
    """A fault certifier's verdict ledger (none is committed)."""
    lines = [{"record_type": "manifest", "schema_version": 2, "created_unix": 5.0,
              "device_kind": "cpu"}]
    for i, (cell, sub, status) in enumerate([("ledger_a", "ledger", "PASS"),
                                             ("tune_b", "tune", "FAIL"),
                                             ("ledger_a", "ledger", "PASS"),
                                             ("obs_c", "obs", "PASS")]):
        lines.append({"record_type": "fault_audit", "cell": cell, "subsystem": sub,
                      "status": status, "wall_s": 1.0 + i})
    path.write_text("".join(json.dumps(d) + "\n" for d in lines))


def _as_cpu(src: Path, dst: Path) -> None:
    """Copy a ledger with every device kind rewritten to `cpu` (torn and
    alien lines kept as they are)."""
    if src.suffix == ".json":
        shutil.copyfile(src, dst)
        return
    out = []
    for line in src.read_text().splitlines():
        try:
            d = json.loads(line)
        except ValueError:
            out.append(line)
            continue
        if isinstance(d, dict) and "device_kind" in d:
            d["device_kind"] = "cpu"
        out.append(json.dumps(d))
    dst.write_text("\n".join(out) + "\n")


@pytest.fixture(scope="module")
def cpu_ledgers(tmp_path_factory):
    root = tmp_path_factory.mktemp("ledgers")
    paths = []
    for rel in JAX_LEDGERS:
        dst = root / rel.replace("/", "__")
        _as_cpu(REPO / rel, dst)
        paths.append(dst)
    _fault_audit_ledger(root / "fault_audit.jsonl")
    paths.append(root / "fault_audit.jsonl")
    return root, paths


def test_ledger_set_covers_every_point_kind(cpu_ledgers):
    root, paths = cpu_ledgers
    kinds = {p["labels"]["kind"] for path in paths
             for p in history.points_from_source(path, root=str(root))}
    assert kinds == {"bench", "tune", "serve", "serve_tail", "train", "fault_audit", "round"}


@pytest.mark.parametrize("index", range(len(JAX_LEDGERS) + 1))
def test_points_from_cpu_ledgers_are_bitwise_jaxs(cpu_ledgers, index):
    root, paths = cpu_ledgers
    port = history.points_from_source(paths[index], root=str(root))
    ref = jax_hist.points_from_source(paths[index], root=str(root))
    assert port == ref
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert port, "every ledger of the set yields points"


def _without(point: dict, *keys: str) -> dict:
    out = {k: v for k, v in point.items() if k not in keys}
    out["labels"] = {k: v for k, v in point["labels"].items() if k != "backend"}
    return out


def _rows(points: list[dict], *keys: str) -> list[str]:
    """The points without `keys` and the backend label, in an order of
    their own: a ledger's points come in series order, which the backend
    token sets."""
    return sorted(json.dumps(_without(p, *keys), sort_keys=True) for p in points)


@pytest.mark.parametrize("rel", ["measurements/hier/jobs/hybrid-d2i4-dcnfp8.jsonl",
                                 "measurements/serve_pod/jobs/pod_open_mixed_quant.jsonl",
                                 "measurements/r4/compare_r4_8k.jsonl"])
def test_points_from_tpu_ledgers_differ_only_in_the_backend_token(rel):
    # the TPU's peak and link rows are reference rows of the port's tables
    port = history.points_from_source(REPO / rel)
    ref = jax_hist.points_from_source(REPO / rel)
    assert _rows(port, "backend", "series") == _rows(ref, "backend", "series")
    assert len(port) == len(ref) > 0
    if "compare" in rel:  # a TPU run: its single-device point predicts
        assert any(p.get("residual_pct") is not None for p in port)


def _card_ledger(name: str) -> Path:
    path = CARD_LEDGERS / name
    assert path.exists(), f"{path} is the port's committed round 1"
    return path


def test_points_from_an_h100_serve_ledger_differ_only_in_backend_and_series():
    path = _card_ledger("serve_cuda.ndjson")
    port, ref = history.points_from_source(path), jax_hist.points_from_source(path)
    assert _rows(port, "backend", "series") == _rows(ref, "backend", "series")
    assert len(port) == len(ref) == 5
    assert {p["backend"] for p in port} == {"h100"}
    assert {p["backend"] for p in ref} == {H100.lower()}
    assert {p["labels"]["kind"] for p in port} == {"serve", "serve_tail"}


def test_points_from_an_h100_matmul_ledger_add_the_cards_residual():
    # the JAX package's peak table has no H100 row, so only the port
    # predicts: compute at 989 bf16 TFLOP/s, no comm on one device
    path = _card_ledger("matmul_cuda.ndjson")
    (port,), (ref,) = history.points_from_source(path), jax_hist.points_from_source(path)
    keys = ("backend", "series", "predicted", "residual_pct")
    assert _without(port, *keys) == _without(ref, *keys)
    assert ref["predicted"] is None and ref["residual_pct"] is None
    tfd, avg = port["value"], port["measured"]["total_s"]
    assert port["predicted"] == {"compute_s": round(tfd * avg / 989.0, 9), "comm_s": 0.0}
    assert port["residual_pct"] == round(100.0 * (avg - tfd * avg / 989.0) / avg, 4)
    assert port["status"] == "ok" and port["labels"]["impl"] == "cuda"


def _h100_record(tflops: float, **extras) -> dict:
    return {"benchmark": "matmul", "mode": "single", "size": 16384, "dtype": "float32",
            "world": 1, "device_kind": H100, "tflops_per_device": tflops,
            "avg_time_s": 2.0 * 16384 ** 3 / (tflops * 1e12), "extras": extras}


def test_a_tf32_record_reads_against_the_tf32_row(tmp_path):
    ledger = tmp_path / "fp32.jsonl"
    ledger.write_text(json.dumps({"record_type": "manifest", "schema_version": 2,
                                  "device_kind": H100}) + "\n"
                      + json.dumps(_h100_record(300.0, float32_matmul_precision="high"))
                      + "\n")
    (point,) = history.points_from_source(ledger)
    assert point["status"] == "ok" and "detail" not in point
    assert point["predicted"]["compute_s"] == round(2.0 * 16384 ** 3 / 1e12 / 495.0, 9)
    # the same reading without the mark is above 1.1 × the fp32 row (67)
    ledger.write_text(json.dumps(_h100_record(300.0)) + "\n")
    (point,) = history.points_from_source(ledger)
    assert point["status"] == "unavailable"
    assert point["detail"] == {"implausible_above_peak_tflops": round(1.1 * 67.0, 2)}
    ledger.write_text(json.dumps(_h100_record(300.0, float32_matmul_precision="medium"))
                      + "\n")
    assert history.points_from_source(ledger)[0]["status"] == "ok"


@pytest.mark.parametrize("cards, predicted", [(None, True), (1, True), (2, False)])
def test_the_card_link_row_prices_ranks_on_one_card(tmp_path, cards, predicted):
    # world 4 batch_parallel at 16384²: the comms model's wire bytes over
    # the card's memory rate, each byte read and written once
    from tpu_matmul_bench_torch.analysis.comms_model import wire_bytes_summary

    rec = {"benchmark": "scaling", "mode": "batch_parallel", "size": 16384,
           "dtype": "bfloat16", "world": 4, "device_kind": H100,
           "tflops_per_device": 500.0, "avg_time_s": 0.05,
           "extras": {} if cards is None else {"cards": cards}}
    ledger = tmp_path / "mode.jsonl"
    ledger.write_text(json.dumps(rec) + "\n")
    (point,) = history.points_from_source(ledger)
    wire = wire_bytes_summary("batch_parallel", 4, 16384, "bfloat16", "none")["wire_bytes"]
    if predicted:
        assert point["predicted"]["comm_s"] == round(wire / (3087.0 / 2 * 1e9), 9)
        assert point["residual_pct"] is not None
    else:
        assert "comm_s" not in point["predicted"] and point["residual_pct"] is None


def test_default_sources_are_the_cards_ledgers_only():
    sources = [Path(p) for p in history.default_sources()]
    assert sources, "the committed card ledgers"
    for p in sources:
        # the card's ledgers but the head-to-head's multi-run ones, which
        # the JAX package's sweep of measurements/**/*.jsonl does not take
        assert p.relative_to(REPO / "measurements" / "torch" / "card_pr18")
        assert p.suffix == ".ndjson"
    assert {p.name for p in sources} == {"matmul_cuda.ndjson", "matmul_torch.ndjson",
                                         "obs_selftest.ndjson", "serve_cuda.ndjson",
                                         "tune_ksplit.ndjson"}
    assert not set(map(str, sources)) & set(jax_hist.default_sources())
    assert history.default_path() == str(REPO / "measurements" / "torch" / "history.jsonl")


# ------------------------------------------------------------------ store

def test_ingest_is_jaxs_byte_for_byte_and_idempotent(cpu_ledgers, tmp_path):
    root, paths = cpu_ledgers
    port_path, ref_path = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    port, ref = history.HistoryStore.load(str(port_path)), jax_hist.HistoryStore.load(
        str(ref_path))
    half = len(paths) // 2
    for seq, chunk in ((1, paths[:half]), (2, paths[half:])):
        got = history.ingest(chunk, port, seq=seq, root=str(root))
        assert got == jax_hist.ingest(chunk, ref, seq=seq, root=str(root))
        assert got[0] > 0
    data = port_path.read_bytes()
    assert data == ref_path.read_bytes()
    # re-ingest: nothing appended, the file unchanged, in a fresh load too
    assert history.ingest(paths, port, root=str(root)) == (0, len(port))
    again = history.HistoryStore.load(str(port_path))
    assert history.ingest(paths, again, root=str(root)) == (0, len(port))
    assert port_path.read_bytes() == data
    assert again.max_seq() == 2 and not again.validate(str(root))


def test_a_torn_tail_is_repaired_before_the_next_append(cpu_ledgers, tmp_path):
    root, paths = cpu_ledgers
    path = tmp_path / "store.jsonl"
    store = history.HistoryStore.load(str(path))
    history.ingest(paths[:3], store, seq=1, root=str(root))
    whole = path.read_bytes()
    path.write_bytes(whole + b'{"record_type": "history_point", "series": "ab')
    torn = history.HistoryStore.load(str(path))
    assert len(torn) == len(store) and torn.parse_errors == ["line %d: unparseable"
                                                             % (whole.count(b"\n") + 1)]
    added, _ = history.ingest(paths[3:5], torn, seq=2, root=str(root))
    assert added > 0
    healed = history.HistoryStore.load(str(path))
    assert not healed.parse_errors and len(healed) == len(store) + added
    assert path.read_bytes().startswith(whole) and path.read_bytes().endswith(b"\n")
    # the JAX reader reads the healed store alike
    assert jax_hist.HistoryStore.load(str(path)).points() == healed.points()


# --------------------------------------------------------- detect, report

def _point(mod, series_labels: dict, value, round_: int, *, residual=None, noise=None,
           status="ok", source="x.jsonl") -> dict:
    labels = dict(series_labels)
    point = mod._make_point(labels, value=value, unit="TFLOPS", status=status,
                            source=f"r{round_}/{source}", digest_=f"d{round_}{source}",
                            noise_pct=noise, backend=labels.get("backend", "cpu"),
                            attribution={"measured": None, "predicted": None,
                                         "residual_pct": residual})
    point["ingest_seq"] = round_
    return point


def _seeded_store(path: Path) -> None:
    """Six rounds of series that fire each of HIST-001..004 (and series
    that stay quiet), written with the JAX package's point maker."""
    rng = random.Random(7)
    base = {"kind": "bench", "metric": "tflops_per_device", "benchmark": "matmul",
            "dtype": "bfloat16", "world": 1, "backend": "cpu", "comm_quant": "none",
            "blocks": None, "timing": "fused", "impl": "cuda"}
    points = []
    for r in range(1, 7):
        jitter = 1.0 + rng.uniform(-0.005, 0.005)
        # HIST-001 and HIST-004: the last round falls 20%, its residual 15 pp
        points.append(_point(jax_hist, dict(base, mode="single", size=1024),
                             (80.0 if r == 6 else 100.0) * jitter, r,
                             residual=50.0 + (15.0 if r == 6 else rng.uniform(-1, 1))))
        # HIST-002: the last round improves 20%
        points.append(_point(jax_hist, dict(base, mode="single", size=2048),
                             (120.0 if r == 6 else 100.0) * jitter, r, noise=0.5))
        # quiet: within the noise band; a second point a round (best-of)
        for k in range(2):
            points.append(_point(jax_hist, dict(base, mode="batch_parallel", size=512),
                                 100.0 * jitter - k, r, source=f"y{k}.jsonl"))
        # HIST-003: measured in rounds 1-2, unavailable after
        points.append(_point(jax_hist, dict(base, mode="summa", size=4096),
                             90.0 if r <= 2 else None, r,
                             status="ok" if r <= 2 else "unavailable"))
        # a serve p99 (lower is better) and a tail share (symmetric)
        points.append(_point(jax_hist, {"kind": "serve", "metric": "p99_latency_ms",
                                        "mix": "128", "qps": 100.0, "backend": "cpu"},
                             (5.0 if r == 6 else 4.0) * jitter, r))
        points.append(_point(jax_hist, {"kind": "serve_tail", "metric": "tail_share_pct",
                                        "component": "execute", "mix": "128",
                                        "backend": "cpu"},
                             (40.0 if r == 6 else 60.0) * jitter, r))
        # exploratory tune candidates are never drift-gated
        points.append(_point(jax_hist, dict(base, kind="tune", mode="single", size=256),
                             10.0 if r == 6 else 100.0, r))
    path.write_text("".join(json.dumps(p, sort_keys=True) + "\n" for p in points))


@pytest.fixture(scope="module")
def seeded_store(tmp_path_factory):
    path = tmp_path_factory.mktemp("seeded") / "history.jsonl"
    _seeded_store(path)
    return path


@pytest.mark.parametrize("window, threshold, stale", [(8, 5.0, 3), (3, 5.0, 3),
                                                     (8, 25.0, 3), (8, 5.0, 6)])
def test_detect_findings_are_jaxs(seeded_store, window, threshold, stale):
    table = {"detect_window": window, "threshold_pct": threshold, "stale_rounds": stale}
    port = detect.detect_findings(history.HistoryStore.load(str(seeded_store)),
                                  detect.config_from_table(table))
    ref = jax_detect.detect_findings(jax_hist.HistoryStore.load(str(seeded_store)),
                                     jax_detect.config_from_table(table))
    assert _finding_rows(port) == _finding_rows(ref)
    if (window, threshold, stale) == (8, 5.0, 3):
        assert sorted({f.rule for f in port}) == ["HIST-001", "HIST-002", "HIST-003",
                                                  "HIST-004"]
        assert sum(f.rule == "HIST-001" for f in port) == 3  # single, p99, the tail share


def test_report_is_jaxs(seeded_store, cpu_ledgers, tmp_path):
    for path in (seeded_store, _ingested(cpu_ledgers, tmp_path)):
        port = report.render(history.HistoryStore.load(str(path)), detect.DetectConfig())
        ref = jax_report.render(jax_hist.HistoryStore.load(str(path)),
                                jax_detect.DetectConfig())
        assert port == ref
        assert port.startswith("# Perf trajectory") and "## Drift verdicts" in port
    assert report.sparkline([1.0, None, 3.0, 2.0]) == jax_report.sparkline(
        [1.0, None, 3.0, 2.0])


def _ingested(cpu_ledgers, tmp_path) -> Path:
    root, paths = cpu_ledgers
    path = tmp_path / "ingested.jsonl"
    store = history.HistoryStore.load(str(path))
    for seq, p in enumerate(paths, start=1):
        history.ingest([p], store, seq=seq, root=str(root))
    return path


@pytest.mark.parametrize("table, error", [
    ({"store": "s.jsonl", "detect_window": 4, "residual_threshold_pct": 2.5}, None),
    ({"detect_window": 0}, "positive integer"),
    ({"threshold_pct": -1.0}, "must be positive"),
    ({"bogus": 1}, "unknown [history] key"),
])
def test_detect_config_and_spec_lint_are_jaxs(table, error):
    if error is None:
        assert vars(detect.config_from_table(table)) == \
            vars(jax_detect.config_from_table(table))
    else:
        with pytest.raises(ValueError, match=error.replace("[", r"\[")):
            detect.config_from_table(table)
    assert _finding_rows(detect.lint_history_data({"history": table}, "spec")) == \
        _finding_rows(jax_detect.lint_history_data({"history": table}, "spec"))


def test_the_ports_spec_is_jaxs_but_its_store():
    port = detect.load_config(str(REPO / "specs" / "torch" / "history.toml"))
    ref = jax_detect.load_config(str(REPO / "specs" / "history.toml"))
    assert port.store == "measurements/torch/history.jsonl" == history.HISTORY_RELPATH
    assert {**vars(port), "store": None} == {**vars(ref), "store": None}
    assert detect.load_config(str(REPO / "specs" / "torch" / "history.toml"),
                              overrides={"detect_window": 2}).detect_window == 2


# ---------------------------------------------------------- the history gate

def _launch(created: float):
    """A fake job child that writes a ledger: a matmul record, or a serve
    record with its latency block."""
    def launch(cmd, *, log, timeout_s, env):
        ledger = cmd[cmd.index("--json-out") + 1]
        serve = "serve" in cmd
        rec = {"benchmark": "serve" if serve else "matmul", "mode": "single", "size": 64,
               "dtype": "float32", "world": 1, "device_kind": "cpu",
               "tflops_per_device": 2.0 + created, "avg_time_s": 0.01,
               "extras": {"samples": {"stddev_ms": 0.1, "p50_ms": 2.0}}}
        if serve:
            rec["extras"]["serve"] = {"p99_ms": 5.0 + created, "p50_ms": 1.0,
                                      "slo_attainment_pct": 99.0, "p99_noise_pct": 2.0}
        with open(ledger, "w") as fh:
            fh.write(json.dumps({"record_type": "manifest", "schema_version": 2,
                                 "created_unix": created, "device_kind": "cpu"}) + "\n")
            fh.write(json.dumps(rec) + "\n")
        return executor.LaunchResult(rc=0)
    return launch


def _campaign(path: Path, created: float) -> None:
    s = spec.spec_from_dict({
        "campaign": {"name": "g"},
        "job": [{"id": "mm", "program": "matmul", "flags": ["--sizes", "64"]},
                {"id": "mm2", "program": "matmul", "flags": ["--sizes", "128"]},
                {"id": "srv", "program": "serve", "flags": ["bench", "--qps", "10"]}]})
    executor.run_campaign(s, path, env={}, launch=_launch(created), sleep=lambda s: None)


def test_history_baseline_is_jaxs(tmp_path):
    _campaign(tmp_path / "old", 1.0)
    _campaign(tmp_path / "new", 2.0)
    store_path = tmp_path / "history.jsonl"
    store = history.HistoryStore.load(str(store_path))
    history.ingest(sorted((tmp_path / "old" / "jobs").glob("*.jsonl")), store, seq=1)
    history.ingest(sorted((tmp_path / "new" / "jobs").glob("*.jsonl")), store, seq=2)
    port = gate.history_baseline(tmp_path / "new", str(store_path))
    assert port == jax_gate.history_baseline(tmp_path / "new", str(store_path))
    # round 1 is the new campaign's baseline; the old one gates against no
    # earlier round but the new one's
    assert sorted(r["job_id"] for r in port.values()) == ["mm", "mm2", "srv"]
    assert {r["job_id"]: r.get("tflops_per_device", r.get("p99_latency_ms"))
            for r in port.values()} == {"mm": 3.0, "mm2": 3.0, "srv": 6.0}
    assert gate.history_baseline(tmp_path / "old", str(store_path)) == \
        jax_gate.history_baseline(tmp_path / "old", str(store_path))
    with pytest.raises(RuntimeError, match="empty or missing"):
        gate.history_baseline(tmp_path / "new", str(tmp_path / "none.jsonl"))
