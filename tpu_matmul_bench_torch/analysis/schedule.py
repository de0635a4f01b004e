"""Schedule audits: certify the overlap suite's scheduling contract on the
recorded stream schedule (SCHED-*).

Port of `tpu_matmul_bench/analysis/hlo_sched.py` (with the small part of
`hlo_tools.py` it needs: a dependency graph and its reachability). JAX
compiles each overlap-capable program and infers from the optimized HLO's
def-use edges whether XLA may overlap a collective with a product. The
port writes its schedule down: the rank-stream programs of
`parallel/overlap.py` put each launch on a stream and order streams with
event marks and waits (`ops/cuda_ring.py _Schedule`). So the contract is
read off one recorded call (`analysis/recording.record_schedule`), the
same log on the CPU as on the card, in which

- a launch follows the launches before it on its (rank, stream) lane;
- a wait makes the next launch on its lane follow the launch its event
  was marked after;
- a launch on the caller's own stream (`cuda_ring.CALLER`, where a
  serialized baseline issues its collective and its products) consumes
  the caller-stream launch issued before it, of any rank: one stream, in
  issue order, with no events. A wait that carries data (the next launch reads what
  the marked one wrote) is a **data edge**; a wait that guards a buffer's
  reuse (the next launch overwrites what the marked one read) is a
  **reuse edge**, which a jaxpr or HLO cannot have (their buffers are
  values).

"Depends on" below is reachability over data edges, JAX's def-use. Four
rules, JAX's IDs:

- SCHED-001 — forced serialization: a step's sum depends on that step's
  product. REQUIRED on `no_overlap` (that is what makes it a baseline)
  and, on the serialized ring baselines, the collective must sit on the
  products' path (gather before every product, the scatter after a
  product); an ERROR on `overlap` and `pipeline`.
- SCHED-002 — mutual independence: in `overlap`/`pipeline` every step
  has a product, and no product depends on its own step's sum.
- SCHED-003 — the ring contract, a rank at a time: (1 or 2)·(d−1) hops
  and d or 2d−1 products on an all-gather ring (d or 2d on a
  reduce-scatter ring); all-gather hops depend on no product and some
  product depends on no hop (the resident chunk's); on a reduce-scatter
  ring no product depends on a hop (the hops carry the accumulators,
  which the ring's adds consume).
- SCHED-004 — the torch form of JAX's async start/done pairing: every
  wait names an event marked earlier (a done with its start); every
  launch on a rank stream is joined by the exit barrier, a mark of
  `leave` after it on its lane (a start with its done: the caller's
  stream waits on those marks); and in `overlap`/`pipeline` a product is
  issued between a sum's mark and the first wait that consumes it (the
  sum has work to hide behind). A mark that no wait reads is not a
  finding: a launch on a stream needs no done of its own, and such an
  event orders nothing and costs one record.

The inventory is JAX's, at `SCHED_SIZE` and worlds 4 and 8, under
`--matmul-impl cuda` (K1 on the card, its plain version on the CPU): the
scan variants `no_overlap`, `overlap`, `pipeline` (`StepProgram`) and the
six collective-matmul rings `ag`, `ag_bidir`, `ag_base`, `rs`,
`rs_bidir`, `rs_base`. The ring kernels K2–K5 (`cuda_ring*` modes) are
left out, as JAX leaves out its Pallas rings: their schedule lives in
`ops/cuda_ring.py RingMatmul`, which records none.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import torch

from tpu_matmul_bench_torch.analysis.findings import Finding
from tpu_matmul_bench_torch.ops.cuda_ring import CALLER
from tpu_matmul_bench_torch.analysis.recording import (
    Recording,
    ScheduleLog,
    record,
    record_schedule,
)

# the dependency structure is size-invariant: the cheapest size that
# shards at both worlds
SCHED_SIZE = 64
# two worlds, so hop and product counts (which scale with d) are checked at
# two ring lengths
SCHED_WORLDS = (4, 8)

SCAN_VARIANTS = ("no_overlap", "overlap", "pipeline")
RING_KINDS = ("ag", "ag_bidir", "ag_base", "rs", "rs_bidir", "rs_base")


# ---------------------------------------------------------------- running

def _mesh(devices: Sequence[torch.device], world: int):
    from tpu_matmul_bench_torch.parallel.mesh import make_mesh

    return make_mesh(list(devices[:world]))


#: every primitive `run_program` ran, at build and call: what the kernels'
#: launch counters must have counted on the card (chip_smoke.py's check)
PRIMITIVES_RUN: collections.Counter = collections.Counter()


class Run(NamedTuple):
    """One program's recorded call."""

    record: Recording
    log: ScheduleLog
    operands: tuple


def run_program(build: Callable[[], tuple[Callable, tuple]]) -> Run:
    """Build `(fn, operands) = build()` and call `fn(*operands)` once,
    recorded (`record(opaque=True)`) and with its schedule logged. The
    build runs inside the block, so the products it binds are the
    recorder's primitives, and is then forgotten: the record is the
    call's."""
    with record(opaque=True) as rec, record_schedule() as log:
        fn, operands = build()
        PRIMITIVES_RUN.update(rec.primitives)
        rec.reset()
        log.entries.clear()
        fn(*operands)
    PRIMITIVES_RUN.update(rec.primitives)
    return Run(rec, log, tuple(operands))


def run_counted(fn: Callable[[], Any]) -> Any:
    """`fn()` with the primitives it runs counted in `PRIMITIVES_RUN` (a
    check that builds its own program, as a donation contract does)."""
    with record(opaque=True) as rec:
        out = fn()
    PRIMITIVES_RUN.update(rec.primitives)
    return out


def scan_build(variant: str, devices: Sequence[torch.device], world: int,
               size: int = SCHED_SIZE, program: type | None = None):
    """`build` for one scan variant's full program (`overlap_mode`), or
    for `program`, a `StepProgram` subclass, over the same operands."""
    from tpu_matmul_bench_torch.analysis.auditor import AUDIT_IMPL, _audit_config
    from tpu_matmul_bench_torch.parallel.overlap import overlap_mode

    def build():
        config = _audit_config("bfloat16", AUDIT_IMPL, devices[0])
        setup = overlap_mode(config, _mesh(devices, world), size, variant)
        fn = setup.full
        if program is not None:
            fn = program(fn.mesh, variant, fn.steps, AUDIT_IMPL)
        return fn, setup.operands
    return build


def ring_operands(devices: Sequence[torch.device], world: int, size: int, rs: bool):
    """JAX's ring operands: X row-sharded and W column-sharded for an
    all-gather ring, X column- and W row-sharded for a reduce-scatter one."""
    from tpu_matmul_bench_torch.analysis.auditor import AUDIT_IMPL, _audit_config
    from tpu_matmul_bench_torch.parallel.mesh import COLS, ROWS, sharded_normal

    cfg = _audit_config("bfloat16", AUDIT_IMPL, devices[0])
    mesh = _mesh(devices, world)
    x_spec, w_spec = (COLS, ROWS) if rs else (ROWS, COLS)
    (x,) = sharded_normal(cfg.seed, (size, size), cfg.dtype, mesh, x_spec, count=1)
    (w,) = sharded_normal(cfg.seed + 1, (size, size), cfg.dtype, mesh, w_spec, count=1)
    return mesh, x, w


def ring_program(mesh: Any, kind: str, impl: str):
    from tpu_matmul_bench_torch.parallel import overlap as ovl

    return {
        "ag": lambda: ovl.collective_matmul_program(mesh, overlap=True, impl=impl),
        "ag_bidir": lambda: ovl.collective_matmul_bidir_program(mesh, impl=impl),
        "ag_base": lambda: ovl.collective_matmul_program(mesh, overlap=False, impl=impl),
        "rs": lambda: ovl.collective_matmul_rs_program(mesh, overlap=True, impl=impl),
        "rs_bidir": lambda: ovl.collective_matmul_bidir_rs_program(mesh, impl=impl),
        "rs_base": lambda: ovl.collective_matmul_rs_program(mesh, overlap=False, impl=impl),
    }[kind]()


def ring_build(kind: str, devices: Sequence[torch.device], world: int,
               size: int = SCHED_SIZE):
    """`build` for one collective-matmul ring program on JAX's operands."""
    from tpu_matmul_bench_torch.analysis.auditor import AUDIT_IMPL

    def build():
        mesh, x, w = ring_operands(devices, world, size, kind.startswith("rs"))
        return ring_program(mesh, kind, AUDIT_IMPL), (x, w)
    return build


def inventory_builds(devices: Sequence[torch.device], worlds=SCHED_WORLDS,
                     size: int = SCHED_SIZE) -> dict[str, Callable]:
    """{"overlap:<variant>@d<w>" | "ring:<kind>@d<w>": build} for every
    program the audit runs (the fingerprints' keys for them)."""
    builds: dict[str, Callable] = {}
    for world in worlds:
        if world > len(devices):
            continue
        for variant in SCAN_VARIANTS:
            builds[f"overlap:{variant}@d{world}"] = scan_build(variant, devices, world, size)
        for kind in RING_KINDS:
            builds[f"ring:{kind}@d{world}"] = ring_build(kind, devices, world, size)
    return builds


# ---------------------------------------------------------------- the graph

@dataclasses.dataclass
class Graph:
    """One recorded call's launches and edges (see the module docstring)."""

    launches: list[tuple[str, int, int, int]]  # (kind, rank, stream, step)
    edges: list[tuple[int, int, bool]]  # (from, to, reuse), launch indices

    def of(self, kind: str, rank: int | None = None, step: int | None = None) -> list[int]:
        return [i for i, (k, r, _s, t) in enumerate(self.launches)
                if k == kind and (rank is None or r == rank)
                and (step is None or t == step)]

    def ancestors(self, i: int) -> set[int]:
        """The launches `i` depends on, over data edges."""
        preds = collections.defaultdict(list)
        for src, dst, reuse in self.edges:
            if not reuse:
                preds[dst].append(src)
        seen: set[int] = set()
        frontier = list(preds[i])
        while frontier:
            j = frontier.pop()
            if j not in seen:
                seen.add(j)
                frontier.extend(preds[j])
        return seen

    def depends(self, i: int, targets: Sequence[int]) -> bool:
        """Whether launch i depends on one of the `targets` launches."""
        return bool(self.ancestors(i) & set(targets))


def graph(entries: Sequence[tuple]) -> Graph:
    """The launches and edges of a schedule log's entries."""
    launches: list[tuple[str, int, int, int]] = []
    marked: dict[int, int | None] = {}  # event -> the launch it follows
    last: dict[tuple[int, int], int] = {}
    pending: dict[tuple[int, int], list[tuple[int, bool]]] = {}
    edges: set[tuple[int, int, bool]] = set()
    caller: int | None = None  # the last launch on the caller's stream
    for entry in entries:
        if entry[0] == "launch":
            _, kind, rank, stream, step = entry
            lane, idx = (rank, stream), len(launches)
            launches.append((kind, rank, stream, step))
            for eid, reuse in pending.pop(lane, []):
                if marked.get(eid) is not None:
                    edges.add((marked[eid], idx, reuse))
            if stream == CALLER:
                if caller is not None:
                    edges.add((caller, idx, False))
                caller = idx
            last[lane] = idx
        elif entry[0] == "mark":
            marked[entry[3]] = last.get((entry[1], entry[2]))
        elif entry[0] == "wait":
            pending.setdefault((entry[1], entry[2]), []).extend(
                (eid, entry[4]) for eid in entry[3])
    return Graph(launches, sorted(edges))


def canonical(entries: Sequence[tuple]) -> dict[str, list]:
    """The log's canonical form: each launch's (kind, rank, stream, step)
    in issue order and the edges between them by launch index, "data" or
    "reuse". No event ids, pointers or times: the same on every device."""
    g = graph(entries)
    return {"launches": [list(x) for x in g.launches],
            "edges": [[a, b, "reuse" if reuse else "data"] for a, b, reuse in g.edges]}


# ---------------------------------------------------------------- checkers
# Pure functions over a log's entries → findings, so seeded faults can feed
# mutated schedules straight in.

def check_events(entries: Sequence[tuple], where: str,
                 bracket: bool = False) -> list[Finding]:
    """SCHED-004: every wait names an event marked earlier; every launch on
    a rank stream is followed on its lane by a mark of the exit barrier;
    with `bracket`, a product is issued between each sum's mark and the
    first wait that consumes it."""
    findings: list[Finding] = []
    marked: set[int] = set()
    follows: dict[int, str | None] = {}  # event -> kind of the launch before it
    last_kind: dict[tuple[int, int], str] = {}
    leaving: set[int] = set()
    unjoined: set[tuple[int, int]] = set()  # lanes launched on since their leave mark
    for entry in entries:
        if entry[0] == "launch":
            last_kind[(entry[2], entry[3])] = entry[1]
            if entry[3] != CALLER:
                unjoined.add((entry[2], entry[3]))
        elif entry[0] == "mark":
            marked.add(entry[3])
            follows[entry[3]] = last_kind.get((entry[1], entry[2]))
            if entry[4]:
                leaving.add(entry[3])
                unjoined.discard((entry[1], entry[2]))
        elif entry[0] == "wait":
            stray = [e for e in entry[3] if e not in marked]
            if stray:
                findings.append(Finding(
                    "SCHED-004", where,
                    f"rank {entry[1]} stream {entry[2]} waits on event(s) never "
                    "marked before it — the wait orders nothing",
                    details={"rank": entry[1], "stream": entry[2], "events": stray}))
    if unjoined:
        findings.append(Finding(
            "SCHED-004", where,
            f"{len(unjoined)} rank stream(s) launched on and never joined by "
            "the exit barrier — the caller may read what is still being made",
            details={"lanes": sorted(unjoined)}))
    if bracket and not findings:
        sums = {e for e, kind in follows.items() if kind == "sum" and e not in leaving}
        open_: dict[int, bool] = {}  # sum event -> a product issued since its mark
        for entry in entries:
            if entry[0] == "mark" and entry[3] in sums:
                open_[entry[3]] = False
            elif entry[0] == "launch" and entry[1] == "product":
                open_ = dict.fromkeys(open_, True)
            elif entry[0] == "wait":
                for e in entry[3]:
                    if e in open_ and not open_.pop(e):
                        findings.append(Finding(
                            "SCHED-004", where,
                            "no product issued between a sum's mark and the "
                            "wait that consumes it — the sum hides nothing",
                            details={"event": e}))
    return findings


def check_scan_variant(entries: Sequence[tuple], variant: str, where: str) -> list[Finding]:
    """SCHED-001/-002/-004 for one {no_overlap, overlap, pipeline} call."""
    g = graph(entries)
    steps = sorted({t for k, _r, _s, t in g.launches if k == "sum"})
    if not steps or steps != list(range(len(steps))):
        return [Finding(
            "SCHED-002", where,
            f"expected a sum in every step, found sums at steps {steps} — the "
            "step structure the overlap claim rests on is gone",
            details={"steps": steps})]
    findings: list[Finding] = []
    serialized = [i for i in steps
                  if any(g.depends(s, g.of("product", step=i))
                         for s in g.of("sum", step=i))]
    if variant == "no_overlap":
        if serialized != steps:
            findings.append(Finding(
                "SCHED-001", where,
                "baseline no longer serialized: a step's sum does not consume "
                "the step's products, so the streams may overlap them and the "
                "no_overlap leg measures nothing",
                details={"variant": variant, "serialized_steps": serialized}))
        return findings + check_events(entries, where)
    if serialized:
        findings.append(Finding(
            "SCHED-001", where,
            "overlap path serialized: a step's sum consumes the same step's "
            "product — no stream can hide it",
            details={"variant": variant, "serialized_steps": serialized}))
    for i in steps:
        products = g.of("product", step=i)
        if not products:
            findings.append(Finding(
                "SCHED-002", where,
                f"step {i} has no product — nothing left to hide the sum behind",
                details={"variant": variant, "step": i}))
        elif any(g.depends(p, g.of("sum", step=i)) for p in products):
            findings.append(Finding(
                "SCHED-002", where,
                f"a product of step {i} depends on the step's sum — mutual "
                "independence (the overlap precondition) is broken",
                details={"variant": variant, "step": i}))
    return findings + check_events(entries, where, bracket=True)


def ring_counts(entries: Sequence[tuple], world: int) -> list[tuple[int, int]]:
    """(hops, products) of each rank."""
    g = graph(entries)
    return [(len(g.of("hop", r)), len(g.of("product", r))) for r in range(world)]


def _shape_findings(entries, where: str, world: int, exp_hops: int,
                    exp_products: int) -> list[Finding]:
    counts = ring_counts(entries, world)
    if all(c == (exp_hops, exp_products) for c in counts):
        return []
    return [Finding(
        "SCHED-003", where,
        f"ring shape mismatch: hops/products a rank {counts} (expected "
        f"{exp_hops} / {exp_products} at d={world})",
        details={"counts": counts, "expected_hops": exp_hops,
                 "expected_products": exp_products})]


def check_ag_ring(entries: Sequence[tuple], where: str, world: int,
                  bidir: bool = False) -> list[Finding]:
    """SCHED-003 for an all-gather ring: hops stream raw operand chunks
    (never products), and at least one product (the resident chunk's)
    depends on no hop."""
    g = graph(entries)
    findings = _shape_findings(entries, where, world, (2 if bidir else 1) * (world - 1),
                               2 * world - 1 if bidir else world)
    for h in g.of("hop"):
        if g.depends(h, g.of("product")):
            kind, rank, stream, step = g.launches[h]
            findings.append(Finding(
                "SCHED-003", where,
                "an all-gather ring hop depends on a product — the ring no "
                "longer streams raw chunks, so every hop waits on the products",
                details={"rank": rank, "stream": stream, "step": step}))
    products = g.of("product")
    if products and all(g.depends(p, g.of("hop")) for p in products):
        findings.append(Finding(
            "SCHED-003", where,
            "every product waits on a hop — the resident-chunk overlap (the "
            "step-0 product that needs no transfer) is gone",
            details={"products": len(products)}))
    return findings + check_events(entries, where)


def check_rs_ring(entries: Sequence[tuple], where: str, world: int,
                  bidir: bool = False) -> list[Finding]:
    """SCHED-003 for a reduce-scatter ring: the hops carry accumulators,
    but no product depends on a hop (each step's product reads the local
    shard, so the products never wait on the ring)."""
    g = graph(entries)
    findings = _shape_findings(entries, where, world, (2 if bidir else 1) * (world - 1),
                               2 * world if bidir else world)
    for p in g.of("product"):
        if g.depends(p, g.of("hop")):
            kind, rank, stream, step = g.launches[p]
            findings.append(Finding(
                "SCHED-003", where,
                "a product depends on a ring hop — the reduce-scatter overlap "
                "has been serialized (the products stall on the ring)",
                details={"rank": rank, "step": step}))
    return findings + check_events(entries, where)


def check_serialized_baseline(entries: Sequence[tuple], where: str,
                              collective: str) -> list[Finding]:
    """SCHED-001 (required direction) for the gather/scatter baselines:
    every product consumes the gathered operand ("gather"), or every
    scatter consumes a partial product ("scatter")."""
    g = graph(entries)
    colls = g.of(collective)
    if not colls:
        return [Finding(
            "SCHED-001", where,
            f"expected the baseline's {collective} in the schedule, found none",
            details={"collective": collective})]
    findings: list[Finding] = []
    if collective == "gather":
        products = g.of("product")
        if not products or not all(g.depends(p, g.of("gather")) for p in products):
            findings.append(Finding(
                "SCHED-001", where,
                "baseline product no longer consumes the gathered operand — "
                "the serialized gather-then-matmul baseline is broken",
                details={"collective": collective}))
    else:
        for c in colls:
            if not g.depends(c, g.of("product")):
                findings.append(Finding(
                    "SCHED-001", where,
                    "baseline scatter no longer consumes the partial product — "
                    "the serialized baseline is broken",
                    details={"collective": collective, "rank": g.launches[c][1]}))
    return findings + check_events(entries, where)


def check_ring(entries: Sequence[tuple], kind: str, where: str, world: int) -> list[Finding]:
    """The ring checker of `kind` (see `RING_KINDS`)."""
    if kind.endswith("_base"):
        return check_serialized_baseline(entries, where,
                                         "gather" if kind.startswith("ag") else "scatter")
    checker = check_rs_ring if kind.startswith("rs") else check_ag_ring
    return checker(entries, where, world, bidir=kind.endswith("_bidir"))


def check_program(key: str, entries: Sequence[tuple]) -> list[Finding]:
    """The findings of one inventory program ("overlap:<variant>@d<w>" or
    "ring:<kind>@d<w>") from its log."""
    family, _, rest = key.partition(":")
    name, _, world = rest.partition("@d")
    where = f"sched:{name}@d{world}"
    if family == "overlap":
        return check_scan_variant(entries, name, where)
    return check_ring(entries, name, where, int(world))


# ---------------------------------------------------------------- audit

def run_inventory(devices: Sequence[torch.device], worlds=SCHED_WORLDS,
                  size: int = SCHED_SIZE) -> dict[str, Run]:
    """Every inventory program run once: {key: its `Run`}."""
    return {key: run_program(build)
            for key, build in inventory_builds(devices, worlds, size).items()}


def audit_sched(devices: Sequence[torch.device], worlds=SCHED_WORLDS,
                size: int = SCHED_SIZE, runs: dict | None = None) -> list[Finding]:
    """Run and audit every overlap-capable program at every world: the
    scan variants, the all-gather and reduce-scatter rings (one and two
    directions) and the serialized baselines. `runs`: what
    `run_inventory` returned, to audit without running again."""
    findings: list[Finding] = []
    for world in worlds:
        if world > len(devices):
            findings.append(Finding(
                "SCHED-002", f"mesh:d{world}",
                f"cannot audit world={world}: only {len(devices)} ranks (set "
                "TMB_RANKS_PER_CARD to put more on one device)",
                severity="warn", details={"available": len(devices)}))
    runs = run_inventory(devices, worlds, size) if runs is None else runs
    for key, run in runs.items():
        findings += check_program(key, run.log.entries)
    return findings


# ---------------------------------------------------------------- seeded faults

def _serialized_overlap():
    """A `StepProgram` whose step issues its products first and then its
    sum, which waits on them: the `overlap` schedule serialized (a seeded
    SCHED-001)."""
    from tpu_matmul_bench_torch.parallel.overlap import StepProgram

    class SerializedOverlap(StepProgram):
        def _ring_steps(self, sched, a, b, ring0, slots, outs) -> None:
            d = len(self.mesh.ranks)
            k = ring0[0].shape[0]
            made: dict[int, list] = {}
            for i in range(self.steps):
                sched.step = i
                slot = i % k
                made[i] = []
                for r in range(d):
                    made[i].append(self._product(sched, r, a[r][slot], b[r][slot],
                                                 slots[r][i % (k + 1)]))
                src = [slots[r][i % (k + 1)] for r in range(d)]
                self._sum(sched, i, src, made[i], outs)

    return SerializedOverlap


def seeded_serialized_overlap(devices: Sequence[torch.device], world: int = 4,
                              size: int = SCHED_SIZE) -> list[Finding]:
    """The findings of `overlap` run with its sum waiting on its own
    step's products: SCHED-001 must fire."""
    run = run_program(scan_build("overlap", devices, world, size,
                                 program=_serialized_overlap()))
    return check_scan_variant(run.log.entries, "overlap", f"sched:overlap-serialized@d{world}")
