"""The port's schedule audit (`tpu_matmul_bench_torch/analysis/schedule.py`)
against the JAX package's HLO schedule audit (`analysis/hlo_sched.py`).

JAX compiles each overlap-capable program and reads its optimized HLO; the
port runs it once and reads the recorded stream schedule. At worlds 4 and 8
both must find nothing, and each ring's hops and products a rank must be
JAX's counts from the optimized HLO. Seeded faults must fire their rules.
"""

import contextlib

import pytest
import torch

from tpu_matmul_bench_torch.analysis import schedule as sc
from tpu_matmul_bench_torch.parallel import mesh as pmesh
from tpu_matmul_bench_torch.utils.device import resolve_devices
from torch_port_util import single_torch_thread  # noqa: F401 — a fixture

pytestmark = pytest.mark.usefixtures("single_torch_thread")

WORLDS = sc.SCHED_WORLDS


@pytest.fixture(scope="module")
def cpu8():
    mp = pytest.MonkeyPatch()
    mp.setenv(pmesh.RANKS_PER_CARD_ENV, "8")
    yield resolve_devices("cpu", None)
    mp.undo()


@pytest.fixture(scope="module")
def runs(cpu8):
    return sc.run_inventory(cpu8)


def _jax_ring_counts():
    """JAX's (hops, products) of each ring program, from its optimized HLO
    (`ring_text` is cached: `audit_hlo_sched` compiled these already)."""
    from tpu_matmul_bench.analysis import hlo_sched
    from tpu_matmul_bench.analysis import hlo_tools as ht

    counts = {}
    for world in WORLDS:
        for kind in sc.RING_KINDS:
            comps = ht.parse_hlo(hlo_sched.ring_text(kind, world))
            op = {"ag_base": "all-gather", "rs_base": "reduce-scatter"}.get(
                kind, "collective-permute")
            (comp,) = ht.find_computations_with(comps, op)
            counts[(kind, world)] = (len(ht.instructions_of(comp, "collective-permute")),
                                     len(ht.instructions_of(comp, *ht.MATMUL_OPS)))
    return counts


def test_findings_and_ring_counts_equal_jax_s(cpu8, runs):
    # one test, so JAX compiles its 18 programs once in one worker
    from tpu_matmul_bench.analysis import hlo_sched

    jax_findings = hlo_sched.audit_hlo_sched(WORLDS)
    port = sc.audit_sched(cpu8, runs=runs)
    assert [f.rule for f in port] == [f.rule for f in jax_findings] == []
    assert set(runs) == {f"overlap:{v}@d{w}" for v in sc.SCAN_VARIANTS for w in WORLDS} | \
        {f"ring:{k}@d{w}" for k in sc.RING_KINDS for w in WORLDS}
    for (kind, world), want in _jax_ring_counts().items():
        counts = sc.ring_counts(runs[f"ring:{kind}@d{world}"].log.entries, world)
        assert counts == [want] * world, (kind, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", sc.SCAN_VARIANTS)
def test_scan_variant_steps_have_one_sum_and_a_product_a_rank(runs, variant, world):
    g = sc.graph(runs[f"overlap:{variant}@d{world}"].log.entries)
    steps = sorted({t for _k, _r, _s, t in g.launches})
    for i in steps:
        assert len(g.of("sum", step=i)) == 1  # one card: one sum a step
        assert sorted(g.launches[p][1] for p in g.of("product", step=i)) == list(range(world))


def test_schedule_is_deterministic(cpu8, runs):
    again = sc.run_inventory(cpu8, worlds=(4,))
    for key, run in again.items():
        assert sc.canonical(run.log.entries) == sc.canonical(runs[key].log.entries)


def seeded_hop_on_product(entries):
    """An all-gather ring's log whose first product is marked and whose
    first hop waits (data) on that mark."""
    out = list(entries)
    first = next(i for i, e in enumerate(out) if e[:2] == ("launch", "product"))
    eid = 1 + max((e[3] for e in out if e[0] == "mark"), default=-1)
    out.insert(first + 1, ("mark", out[first][2], out[first][3], eid, False))
    hop = next(i for i, e in enumerate(out) if e[:2] == ("launch", "hop"))
    out.insert(hop, ("wait", out[hop][2], out[hop][3], (eid,), False))
    return out


def seeded_stray_wait(entries):
    """A log with a wait on an event never marked."""
    first = next(i for i, e in enumerate(entries) if e[0] == "launch")
    _, _, rank, stream, _ = entries[first]
    return list(entries[:first]) + [("wait", rank, stream, (-1,), False)] + \
        list(entries[first:])


def test_seeded_serialized_overlap_fires_sched001(cpu8):
    assert {f.rule for f in sc.seeded_serialized_overlap(cpu8)} == {"SCHED-001"}


@pytest.mark.parametrize("kind", ["ag", "ag_bidir"])
def test_seeded_hop_on_a_product_fires_sched003(runs, kind):
    entries = seeded_hop_on_product(runs[f"ring:{kind}@d4"].log.entries)
    found = sc.check_ag_ring(entries, "seed", 4, bidir=kind == "ag_bidir")
    assert {f.rule for f in found} == {"SCHED-003"}


@pytest.mark.parametrize("key", ["overlap:overlap@d4", "ring:rs@d4", "ring:ag_base@d8"])
def test_seeded_stray_wait_fires_sched004(runs, key):
    found = sc.check_program(key, seeded_stray_wait(runs[key].log.entries))
    assert {f.rule for f in found} == {"SCHED-004"}


def test_seeded_product_waiting_on_a_hop_fires_sched003_on_rs(runs):
    entries = list(runs["ring:rs@d4"].log.entries)
    hop_mark = next(e for i, e in enumerate(entries) if e[0] == "mark"
                    and entries[i - 1][:2] == ("launch", "hop"))
    last = max(i for i, e in enumerate(entries) if e[:2] == ("launch", "product"))
    _, _, rank, stream, _ = entries[last]
    entries.insert(last, ("wait", rank, stream, (hop_mark[3],), False))
    assert {f.rule for f in sc.check_rs_ring(entries, "seed", 4)} == {"SCHED-003"}


def test_seeded_unserialized_no_overlap_fires_sched001(runs):
    # drop the sums' data waits: the baseline's sum no longer consumes the
    # step's products
    entries = [e for e in runs["overlap:no_overlap@d4"].log.entries
               if not (e[0] == "wait" and e[2] == 1 and not e[4])]
    found = sc.check_scan_variant(entries, "no_overlap", "seed")
    assert "SCHED-001" in {f.rule for f in found}


def test_seeded_unjoined_lane_fires_sched004(runs):
    # the exit barrier forgets rank 0's compute stream: its launches have no
    # done, so the caller may read Y before they finish
    entries = [e for e in runs["ring:ag@d4"].log.entries
               if not (e[0] == "mark" and e[4] and e[1:3] == (0, 0))]
    found = sc.check_ag_ring(entries, "seed", 4)
    assert [(f.rule, f.details.get("lanes")) for f in found] == [("SCHED-004", [(0, 0)])]


def test_unwaited_mark_is_no_finding(runs):
    # an event no wait reads orders nothing and costs one record: no done
    # is missing, so SCHED-004 stays quiet
    entries = list(runs["ring:ag@d4"].log.entries)
    first = next(i for i, e in enumerate(entries) if e[:2] == ("launch", "product"))
    entries.insert(first + 1, ("mark", entries[first][2], entries[first][3], 10**6, False))
    assert sc.check_ag_ring(entries, "seed", 4) == []


def test_seeded_product_on_its_own_sum_fires_sched002(runs):
    entries = list(runs["overlap:pipeline@d4"].log.entries)
    # the first product of the last step waits (data) on that step's sum
    g = sc.graph(entries)
    last = max(t for _k, _r, _s, t in g.launches)
    sum_launch = g.of("sum", step=last)[0]
    launch_idx = [i for i, e in enumerate(entries) if e[0] == "launch"]
    at = launch_idx[sum_launch]
    entries.insert(at + 1, ("mark", 0, 1, 10**6, False))
    prod = launch_idx[g.of("product", step=last)[0]] + 1
    entries.insert(prod, ("wait", 0, 0, (10**6,), False))
    found = sc.check_scan_variant(entries, "pipeline", "seed")
    assert "SCHED-002" in {f.rule for f in found}


def test_canonical_log_holds_no_event_ids(runs):
    canon = sc.canonical(runs["ring:ag_bidir@d8"].log.entries)
    assert set(canon) == {"launches", "edges"}
    assert {e[2] for e in canon["edges"]} == {"data", "reuse"}


class _Stream:
    """Stands in for a CUDA stream or event (there is no card here)."""

    def wait_event(self, event):
        pass

    def record(self, stream=None):
        pass


@pytest.mark.parametrize("key", ["overlap:no_overlap@d4", "overlap:overlap@d4",
                                 "overlap:pipeline@d4", "ring:ag@d4", "ring:ag_bidir@d4",
                                 "ring:rs@d4", "ring:rs_bidir@d4"])
def test_serial_reference_syncs_after_every_launch(cpu8, monkeypatch, key):
    """The race checks' reference (`_SerialSchedule`) synchronises the card
    after every launch, marked or not, before the next one is issued."""
    from tpu_matmul_bench_torch.parallel import overlap as ovl
    from tpu_matmul_bench_torch.analysis.recording import record_schedule

    fn, operands = sc.inventory_builds(cpu8, worlds=(4,))[key]()
    streams = [tuple(_Stream() for _ in range(fn.per_rank)) for _ in fn.mesh.ranks]
    monkeypatch.setattr(fn, "_schedule", lambda card: ovl._SerialSchedule(fn.mesh, streams))
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    with record_schedule() as log:
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: log.entries.append(("sync",)))
        fn(*operands)
    order = [e[0] for e in log.entries if e[0] in ("launch", "sync")]
    assert order.count("launch") > 0 and order[-1] == "sync"
    assert "launch" not in {b for a, b in zip(order, order[1:]) if a == "launch"}


@pytest.mark.parametrize("kind", ["ag", "ag_bidir", "rs", "rs_bidir"])
def test_ring_hops_are_recorded_primitives(runs, kind):
    # a hop is one primitive of the record, as on the card (where it is a
    # copy kernel, no torch operation), so the fingerprint does not depend
    # on the device
    rec = runs[f"ring:{kind}@d4"].record
    hops = 4 * (2 if kind.endswith("bidir") else 1) * 3
    assert rec.primitives.count("_hop") == hops
