"""Concurrency certifier: the CONC-* rule family.

Port of `tpu_matmul_bench/analysis/concurrency.py`, over the port's own
threaded stack: the serve load producers (`serve/service.py`), the pod's
producers and group drains (`serve/pod.py`), the obs exporter's loop and
its HTTP server (`obs/export.py`), and the faults supervisor. Its
threading contracts (the FlightRecorder's "terminal() from any thread under
the lock, drain() worker-only" convention, the scheduler's single-condition
discipline, the pod's shared capture lock) are checked from the source, as
JAX's are: parse, never execute.

The pass builds, from the AST of every file in scope:

- **thread roots** — `threading.Thread(target=...)` call sites (the
  target's terminal name is the root's role), plus the implicit `main`
  role for everything reachable from non-thread code, plus
  `ROLE_HINTS` declarations for functions the name-based call graph
  cannot see into (duck-typed receivers like `pool.get(...)`);
- **a call graph** — callee terminal names resolved against every
  in-scope definition of that name; `self.m()` resolves within the
  class when it defines `m`; names in `_OPAQUE_NAMES` (dict.get, list
  mutators, ...) never resolve, because a name-level graph would
  connect them to everything;
- **per-function access/lock facts** — `self.<attr>` writes and reads
  (including subscript stores and list/dict mutator calls), module
  globals rebound via `global`, the stack of lock-ish context managers
  held at each site, blocking calls, and wall-clock/unseeded-randomness
  call sites.

Rules (all error severity; stable IDs in `analysis/findings.RULES`):

- **CONC-001** — a shared mutable attribute or module global written
  from ≥2 thread roots (main counts: it is a thread) with no common
  guarding lock across all of its write/read sites.
- **CONC-002** — a cycle in the lock-acquisition-order graph.
- **CONC-003** — a declared appender surface (`THREAD_ROLES`) called
  from a thread role outside its declaration, or — on the real tree —
  an appender-shaped method (`write_raw`/`drain`/`write_once`) shipped
  with no declaration at all.
- **CONC-004** — a blocking call issued while a lock is held. The torch
  form of JAX's list (`_BLOCKING_CALLS`): fsync, `time.sleep` and
  subprocess as in JAX; in place of its AOT compile/serialize/deserialize,
  what blocks a thread here: a CUDA-graph capture (`serve/cache.py
  capture`, and `torch.cuda.graph`, whose entry synchronises the card
  and empties the cache), `torch.cuda.synchronize`, `empty_cache` and
  `.synchronize()` on a stream or an event, the nvcc build entry (`ops/_build.py build`), and the
  kernel-library import and export (`_import_artifact`,
  `_export_artifact`).
- **CONC-005** — wall-clock (`time.time`, `datetime.now`) or unseeded
  randomness (module-level `random.*`) reachable from a fault-plan
  replay root.

Known limits of the static approximation are JAX's: the call graph is
name-based, so `_OPAQUE_NAMES` receivers need `ROLE_HINTS`; lock identity
is `Class.attr` textual; blocking detection is direct-call only (a lock
wrapper that serializes an fsyncing writer — `_LockedStream` — is an
accepted serialization point); and TOCTOU races across two
separately-guarded reads are below this pass's resolution.

Everything here is stdlib-only and imports no torch: the audit runs from
`lint` and `lint conc selftest` on machines without a card, in well under
a second.
"""

from __future__ import annotations

import ast
import dataclasses
import sys
import tempfile
from pathlib import Path
from typing import Any, Iterable

from tpu_matmul_bench_torch.analysis.findings import Finding

# --------------------------------------------------------------------------
# shipped declaration tables — the checked threading model of this tree

#: directories the real-tree pass certifies (the threaded stack); a
#: fixture tree injected via `root=` is scanned whole.
SCOPE_DIRS = ("serve", "obs", "faults")

#: Appender surfaces and the thread roles allowed to touch them.
#: Key: "<rel>::<Class>.<method>"; value: allowed role names, where a
#: role is a thread target's terminal name, "main" is always allowed
#: (setup/teardown run there), and "*" admits any role. Declaring a
#: surface makes cross-role touches a CONC-003 error; shipping an
#: appender-shaped method with NO declaration is also CONC-003 on the
#: real tree, so this table cannot silently rot.
THREAD_ROLES: dict[str, tuple[str, ...]] = {
    # terminal() buffers from any thread under the recorder lock; only
    # the worker drains to the JsonWriter (one fsyncing appender per
    # ledger) — serve/trace.py's FlightRecorder docstring
    "serve/trace.py::FlightRecorder.terminal": ("*",),
    "serve/trace.py::FlightRecorder.drain": ("_worker_drain",),
    # the pod ledger door: G group drains funnel through one lock
    # wrapper; nothing else may write the shared stream.
    "serve/pod.py::_LockedStream.write_raw": ("_worker_drain",),
    # the obs snapshot appender: the exporter loop owns the file;
    # `run_obs` (the faults chaos workload) drives it from main.
    "obs/export.py::SnapshotExporter.write_once": ("_loop",),
    # class-level declaration (no method suffix): a group's executable
    # cache is a phase-separated handoff, not concurrent state — main
    # warm-starts it before the group's drain thread exists, then exactly
    # one drain touches it until the join (pod.py gives drain g the cache
    # of group g alone). A class-level entry exempts the class from
    # CONC-001 and records the convention where the next refactor will
    # trip over it. The captures of every group's cache share one lock
    # (serve/pod.py _group_caches), held for a capture's eager warm call
    # and graph recording; its wait on the card runs after it
    # (serve/cache.py capture).
    "serve/cache.py::ExecutableCache": ("main", "_worker_drain"),
}

#: Reach declarations for functions the name-based call graph is blind
#: to — their callers invoke them through `_OPAQUE_NAMES` receivers
#: (`cache.get(...)`, `pool.get(...)`), so the BFS cannot discover the
#: thread roles that actually run them. Each entry seeds the role BFS
#: at that function. An entry here is a statement of the threading
#: model, exactly like a docstring's "one worker thread touches this" —
#: except CONC-001 now holds the code to it.
ROLE_HINTS: dict[str, tuple[str, ...]] = {
    # per-group operand views: shard memoization on the group drain
    # thread after a main-thread warm start. (The executable
    # cache itself is a class-level THREAD_ROLES handoff declaration —
    # see above — because its touches are phase-separated, not locked.)
    "serve/pod.py::_GroupOperandPool.get": ("main", "_worker_drain"),
}

#: Fault-plan replay roots: the resumable chaos workloads and the cell
#: driver. Everything statically reachable from these must be a pure
#: function of (plan, seed) — CONC-005 polices wall-clock/randomness.
REPLAY_ROOTS = ("run_cell", "run_audit", "run_ledger", "run_tune",
                "run_obs")

#: Wall-clock sites reachable from replay that are NOT determinism
#: hazards, with the reason (the FAULT-001 SPAWN_ALLOWLIST pattern:
#: an allowlist entry is a reviewed claim, and a stale entry is itself
#: a finding via the selftest's table checks).
REPLAY_CLOCK_ALLOWLIST: dict[str, str] = {
    "faults/supervisor.py":
        "heartbeat staleness compares wall clock against the heartbeat "
        "file's mtime — both sides are wall-clock, and replay checks "
        "the stall verdict, never the stamp",
    "obs/export.py":
        "snapshot ts_unix / flush-age stamps are observability "
        "metadata; the chaos certifier's convergence compare excludes "
        "manifests and timestamps",
    "obs/context.py":
        "uuid4 mints the process run id — identity in manifests, not "
        "replayed state; TPU_BENCH_RUN_ID pins it when a spawner needs "
        "the child to BE a specific run, and convergence compares "
        "exclude manifests",
}

# --------------------------------------------------------------------------
# pattern tables

#: a context-manager expression whose terminal name matches this is a
#: lock acquisition (Lock, RLock, Condition, module-level *_LOCK, ...)
_LOCK_NAME_PARTS = ("lock", "cond", "mutex", "rlock", "semaphore")

#: method names the call graph never resolves: they are stdlib-common
#: (dict.get, list.append, re.match, ...) and a name-level graph would
#: connect every `.get(...)` to every in-scope `def get`.
_OPAQUE_NAMES = frozenset({
    "get", "put", "items", "keys", "values", "append", "appendleft",
    "add", "update", "pop", "popleft", "setdefault", "close", "read",
    "write", "copy", "sort", "join", "start", "run", "set", "clear",
    "count", "index", "open", "search", "match", "group", "groups",
    "split", "rsplit", "strip", "encode", "decode", "acquire",
    "release", "wait", "notify", "notify_all", "touch", "exists",
    "mkdir", "stat", "poll", "kill", "send", "recv", "extend",
    "remove", "discard", "insert", "flush", "seek", "tell", "format",
    "replace", "lower", "upper", "startswith", "endswith", "fileno",
    "is_set", "is_alive", "move_to_end", "total_seconds", "as_posix",
    "resolve", "glob", "rglob", "relative_to", "print",
})

#: mutator method names on `self.<attr>` that count as writes to the
#: attribute's contents (the FlightRecorder `_pending.append` shape)
_MUTATOR_NAMES = frozenset({
    "append", "appendleft", "extend", "add", "insert", "pop", "popleft",
    "update", "setdefault", "clear", "remove", "discard", "sort",
    "move_to_end",
})

#: methods written only here are construction, not shared-state writes
_INIT_METHODS = frozenset({"__init__", "__post_init__", "__new__"})

#: appender-shaped method names that MUST carry a THREAD_ROLES entry
#: on the real tree (the CONC-003 coverage leg)
_APPENDER_NAMES = frozenset({"write_raw", "drain", "write_once"})

#: (receiver, name) shapes that block the calling thread; receiver ""
#: matches any (the first match names the call)
_BLOCKING_CALLS: tuple[tuple[str, str, str], ...] = (
    ("os", "fsync", "fsync"),
    ("time", "sleep", "time.sleep"),
    ("subprocess", "", "subprocess"),
    # the torch form of JAX's AOT compile/serialize/deserialize
    ("", "capture", "CUDA-graph capture"),
    # its entry synchronises the card and empties the cache before it
    # records; `CUDAGraph.capture_begin`/`capture_end` wait for nothing
    ("torch.cuda", "graph", "torch.cuda.graph"),
    ("torch.cuda", "empty_cache", "torch.cuda.empty_cache"),
    ("torch.cuda", "synchronize", "torch.cuda.synchronize"),
    ("", "synchronize", "stream/event synchronize"),
    ("_build", "build", "nvcc build"),
    ("", "_import_artifact", "kernel-library import"),
    ("", "_export_artifact", "kernel-library export"),
)

#: (receiver, name) shapes that read the wall clock or unseeded
#: randomness — the CONC-005 determinism hazards. `random.Random(seed)`
#: instances are deliberately absent: their draws replay.
_CLOCK_CALLS: tuple[tuple[str, str, str], ...] = (
    ("time", "time", "time.time"),
    ("datetime", "now", "datetime.now"),
    ("datetime.datetime", "now", "datetime.now"),
    ("random", "random", "random.random"),
    ("random", "randint", "random.randint"),
    ("random", "randrange", "random.randrange"),
    ("random", "choice", "random.choice"),
    ("random", "shuffle", "random.shuffle"),
    ("random", "uniform", "random.uniform"),
    ("random", "gauss", "random.gauss"),
    ("uuid", "uuid4", "uuid.uuid4"),
)

_MAIN_ROLE = "main"


def _is_lock_name(term: str) -> bool:
    low = term.lower()
    return any(part in low for part in _LOCK_NAME_PARTS)


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted source of a Name/Attribute chain ('' if the
    expression is not a plain chain)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    if isinstance(node, ast.Call):
        inner = _dotted(node.func)
        return f"{inner}()" if inner else ""
    return ""


# --------------------------------------------------------------------------
# per-function facts


@dataclasses.dataclass
class _Access:
    """One read/write of shared state, with the locks held at the site."""

    key: tuple[str, ...]  # ("attr", rel, Class, name) | ("global", rel, name)
    kind: str  # "write" | "read"
    lineno: int
    locks: frozenset[str]  # terminal lock names held


@dataclasses.dataclass
class _Call:
    name: str  # callee terminal name
    recv: str  # dotted receiver ("" for a bare call)
    lineno: int
    locks: frozenset[str]  # class-qualified lock nodes held


@dataclasses.dataclass
class _Func:
    qual: str  # "rel::Class.meth" | "rel::func"
    rel: str
    cls: str | None
    name: str
    lineno: int
    accesses: list[_Access] = dataclasses.field(default_factory=list)
    calls: list[_Call] = dataclasses.field(default_factory=list)
    acquires: set[str] = dataclasses.field(default_factory=set)
    blocking: list[tuple[str, int, frozenset]] = dataclasses.field(
        default_factory=list)
    clocks: list[tuple[str, int]] = dataclasses.field(default_factory=list)
    thread_targets: list[str] = dataclasses.field(default_factory=list)
    globals_declared: set[str] = dataclasses.field(default_factory=set)


class _FuncVisitor(ast.NodeVisitor):
    """Walks ONE function body tracking the held-lock stack; nested
    function defs are indexed separately by the module scan and skipped
    here (their bodies run on whatever thread calls them, which the
    call graph models), but lambda bodies are inlined."""

    def __init__(self, func: _Func) -> None:
        self.f = func
        self._lock_stack: list[str] = []  # class-qualified nodes

    # -- lock bookkeeping ---------------------------------------------------

    def _lock_node(self, expr: ast.AST) -> str | None:
        if isinstance(expr, ast.BoolOp):
            # `with self._lock or contextlib.nullcontext():` — an optional
            # lock is held whenever it is given
            for value in expr.values:
                lock = self._lock_node(value)
                if lock is not None:
                    return lock
            return None
        dotted = _dotted(expr)
        if not dotted:
            return None
        term = dotted.split(".")[-1].replace("()", "")
        if not _is_lock_name(term):
            return None
        if dotted.startswith("self.") and self.f.cls:
            return f"{self.f.cls}.{term}"
        return f"{self.f.rel}:{dotted}"

    def _held(self) -> frozenset[str]:
        return frozenset(self._lock_stack)

    def _held_terms(self) -> frozenset[str]:
        return frozenset(n.rsplit(".", 1)[-1].rsplit(":", 1)[-1]
                         for n in self._lock_stack)

    def visit_With(self, node: ast.With) -> None:
        self._with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._with(node)

    def _with(self, node: Any) -> None:
        acquired: list[str] = []
        for item in node.items:
            lock = self._lock_node(item.context_expr)
            if lock is not None:
                # a lock acquired while others are held orders after
                # every one of them
                self.f.acquires.add(lock)
                acquired.append(lock)
                self._lock_stack.append(lock)
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self._lock_stack.pop()

    # -- shared-state accesses ---------------------------------------------

    def _attr_key(self, node: ast.AST) -> tuple[str, ...] | None:
        """('attr', rel, Class, name) for a `self.<name>` chain head."""
        while isinstance(node, ast.Subscript):
            node = node.value
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self" and self.f.cls):
            return ("attr", self.f.rel, self.f.cls, node.attr)
        return None

    def _record(self, key: tuple[str, ...] | None, kind: str,
                lineno: int) -> None:
        if key is not None:
            self.f.accesses.append(
                _Access(key, kind, lineno, self._held_terms()))

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._target(tgt, node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._target(node.target, node.lineno)
        # an augmented assign also reads
        self._record(self._attr_key(node.target), "read", node.lineno)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._target(node.target, node.lineno)
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            self._target(tgt, node.lineno)

    def _target(self, tgt: ast.AST, lineno: int) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._target(el, lineno)
            return
        self._record(self._attr_key(tgt), "write", lineno)
        if (isinstance(tgt, ast.Name)
                and tgt.id in self.f.globals_declared):
            self.f.accesses.append(_Access(
                ("global", self.f.rel, tgt.id), "write", lineno,
                self._held_terms()))

    def visit_Global(self, node: ast.Global) -> None:
        self.f.globals_declared.update(node.names)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.ctx, ast.Load):
            self._record(self._attr_key(node), "read", node.lineno)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if (isinstance(node.ctx, ast.Load)
                and node.id in self.f.globals_declared):
            self.f.accesses.append(_Access(
                ("global", self.f.rel, node.id), "read", node.lineno,
                self._held_terms()))

    # -- calls --------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        recv, _, name = dotted.rpartition(".")
        if not name:
            name = dotted
        if name:
            self.f.calls.append(
                _Call(name, recv, node.lineno, self._held()))
            # self.<attr>.append(...) mutates the attribute's contents
            if (name in _MUTATOR_NAMES
                    and isinstance(node.func, ast.Attribute)):
                self._record(self._attr_key(node.func.value), "write",
                             node.lineno)
            for brecv, bname, desc in _BLOCKING_CALLS:
                if ((bname == "" or bname == name)
                        and (brecv == "" or recv == brecv
                             or recv.startswith(brecv + "."))
                        and (bname or recv.split(".")[0] == brecv)):
                    if self._lock_stack:
                        self.f.blocking.append(
                            (desc, node.lineno, self._held()))
                    break
            for crecv, cname, desc in _CLOCK_CALLS:
                if name == cname and (recv == crecv
                                      or recv.endswith("." + crecv)):
                    self.f.clocks.append((desc, node.lineno))
                    break
            if name == "Thread" and recv in ("threading", ""):
                for kw in node.keywords:
                    if kw.arg == "target":
                        tgt = _dotted(kw.value)
                        if tgt:
                            self.f.thread_targets.append(
                                tgt.split(".")[-1])
        if isinstance(node.func, ast.Attribute):
            self.visit(node.func.value)  # receiver reads (self.x.m())
        for arg in node.args:
            self.visit(arg)
        for kw in node.keywords:
            self.visit(kw.value)

    # nested defs are indexed as their own _Func by the module scan
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self.visit(node.body)


# --------------------------------------------------------------------------
# tree model


@dataclasses.dataclass
class _Tree:
    funcs: dict[str, _Func]  # qual -> facts
    by_name: dict[str, list[str]]  # terminal name -> [qual, ...]
    thread_targets: list[tuple[str, str, int]]  # (target, rel, lineno)
    appender_defs: list[str]  # quals of appender-shaped methods


def _scope_files(root: Path, real_tree: bool) -> list[Path]:
    if not real_tree:
        return sorted(root.rglob("*.py"))
    files: list[Path] = []
    for d in SCOPE_DIRS:
        files.extend((root / d).rglob("*.py"))
    return sorted(files)


def _index_tree(root: Path, real_tree: bool) -> _Tree:
    funcs: dict[str, _Func] = {}
    by_name: dict[str, list[str]] = {}
    threads: list[tuple[str, str, int]] = []
    appenders: list[str] = []

    def walk_body(body: Iterable[ast.stmt], rel: str,
                  cls: str | None) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = (f"{rel}::{cls}.{node.name}" if cls
                        else f"{rel}::{node.name}")
                f = _Func(qual, rel, cls, node.name, node.lineno)
                # collect `global` declarations first: the visitor needs
                # them before it sees the assignments
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Global):
                        f.globals_declared.update(sub.names)
                v = _FuncVisitor(f)
                for stmt in node.body:
                    v.visit(stmt)
                funcs[qual] = f
                by_name.setdefault(node.name, []).append(qual)
                for tgt in f.thread_targets:
                    threads.append((tgt, rel, node.lineno))
                if cls and node.name in _APPENDER_NAMES:
                    appenders.append(qual)
                walk_body(node.body, rel, cls)  # nested defs
            elif isinstance(node, ast.ClassDef):
                walk_body(node.body, rel, node.name)

    for path in _scope_files(root, real_tree):
        rel = path.relative_to(root).as_posix()
        try:
            tree = ast.parse(path.read_text(errors="replace"))
        except (OSError, SyntaxError):
            continue
        walk_body(tree.body, rel, None)

    for qual in sorted(by_name, key=lambda n: n):
        by_name[qual].sort()
    return _Tree(funcs, by_name, sorted(threads), sorted(appenders))


def _resolve(tree: _Tree, caller: _Func, call: _Call) -> list[str]:
    """Callee quals for one call site (the name-based approximation)."""
    if call.name in _OPAQUE_NAMES:
        return []
    if call.recv == "self" and caller.cls:
        own = f"{caller.rel}::{caller.cls}.{call.name}"
        if own in tree.funcs:
            return [own]
    cands = tree.by_name.get(call.name, [])
    if call.recv in ("", None):
        # a bare call prefers same-module definitions
        same = [q for q in cands if tree.funcs[q].rel == caller.rel
                and tree.funcs[q].cls is None]
        if same:
            return same
    return list(cands)


def _reach(tree: _Tree, seeds: Iterable[str]) -> set[str]:
    seen: set[str] = set()
    frontier = [q for q in seeds if q in tree.funcs]
    while frontier:
        qual = frontier.pop()
        if qual in seen:
            continue
        seen.add(qual)
        f = tree.funcs[qual]
        for call in f.calls:
            for callee in _resolve(tree, f, call):
                if callee not in seen:
                    frontier.append(callee)
    return seen


def _role_map(tree: _Tree,
              role_hints: dict[str, tuple[str, ...]]) -> dict[str, set[str]]:
    """qual -> set of thread roles whose dynamic extent can reach it."""
    seeds_by_role: dict[str, set[str]] = {}
    for target, _rel, _ln in tree.thread_targets:
        seeds_by_role.setdefault(target, set()).update(
            tree.by_name.get(target, []))
    for qual, roles in role_hints.items():
        for role in roles:
            if role != _MAIN_ROLE:
                seeds_by_role.setdefault(role, set()).add(qual)

    roles: dict[str, set[str]] = {q: set() for q in tree.funcs}
    thread_reach: set[str] = set()
    for role in sorted(seeds_by_role):
        reach = _reach(tree, sorted(seeds_by_role[role]))
        thread_reach.update(reach)
        for q in reach:
            roles[q].add(role)
    # main: everything reachable from functions no thread root reaches
    # (the main thread is the only thing left that can call them)
    main_seeds = sorted(q for q in tree.funcs if q not in thread_reach)
    for q in _reach(tree, main_seeds):
        roles[q].add(_MAIN_ROLE)
    for qual, hinted in role_hints.items():
        if _MAIN_ROLE in hinted and qual in roles:
            roles[qual].add(_MAIN_ROLE)
    return roles


# --------------------------------------------------------------------------
# the rules


def _lock_terms(nodes: Iterable[str]) -> frozenset[str]:
    return frozenset(n.rsplit(".", 1)[-1].rsplit(":", 1)[-1]
                     for n in nodes)


def _inherited_locks(tree: _Tree) -> dict[str, frozenset[str]]:
    """Lock tokens guaranteed held at EVERY static call site of each
    function — the `_collect_locked` convention, checked: a helper only
    ever invoked under the caller's lock inherits that guard at its
    access sites. Meet over call sites, iterated so a locked helper's
    own helpers inherit too; a function with no static callers (an
    entry point) inherits nothing."""
    callers: dict[str, list[tuple[str, frozenset[str]]]] = {}
    for qual in sorted(tree.funcs):
        f = tree.funcs[qual]
        for call in f.calls:
            for callee in _resolve(tree, f, call):
                callers.setdefault(callee, []).append(
                    (qual, _lock_terms(call.locks)))
    inherited: dict[str, frozenset[str]] = {
        q: frozenset() for q in tree.funcs}
    for _ in range(8):  # bounded: chains this deep don't exist here
        changed = False
        for qual in sorted(callers):
            sets = [held | inherited[caller]
                    for caller, held in callers[qual]]
            meet = frozenset.intersection(*sets)
            if meet != inherited[qual]:
                inherited[qual] = meet
                changed = True
        if not changed:
            break
    return inherited


def _conc001(tree: _Tree, roles: dict[str, set[str]],
             thread_roles: dict[str, tuple[str, ...]],
             inherited: dict[str, frozenset[str]]) -> list[Finding]:
    declared_single = set()
    for key in thread_roles:
        rel_cls = key.split("::", 1)
        if len(rel_cls) == 2:
            rel, tail = rel_cls
            declared_single.add((rel, tail.split(".")[0]))

    by_key: dict[tuple[str, ...], list[tuple[_Access, _Func]]] = {}
    for qual in sorted(tree.funcs):
        f = tree.funcs[qual]
        for acc in f.accesses:
            by_key.setdefault(acc.key, []).append((acc, f))

    findings: list[Finding] = []
    for key in sorted(by_key):
        sites = by_key[key]
        writes = [(a, f) for a, f in sites
                  if a.kind == "write" and f.name not in _INIT_METHODS]
        if not writes:
            continue
        if key[0] == "attr" and (key[1], key[2]) in declared_single:
            continue  # declared sole-toucher class; CONC-003 owns it
        write_roles: set[str] = set()
        for _a, f in writes:
            write_roles.update(roles.get(f.qual, {_MAIN_ROLE})
                               or {_MAIN_ROLE})
        if len(write_roles) < 2:
            continue
        # every write AND read outside construction must share a guard
        # (held at the site, or inherited from all callers — the
        # `_collect_locked` convention)
        checked = [(a, f) for a, f in sites
                   if f.name not in _INIT_METHODS]
        common = frozenset.intersection(
            *[a.locks | inherited[f.qual] for a, f in checked]) \
            if checked else frozenset()
        if common:
            continue
        a0, f0 = min(writes, key=lambda s: (s[1].rel, s[0].lineno))
        if key[0] == "attr":
            what = f"{key[2]}.{key[3]}"
        else:
            what = f"module global {key[2]!r}"
        bare = sorted({f"{f.rel}:{a.lineno}" for a, f in checked
                       if not (a.locks | inherited[f.qual])})
        findings.append(Finding(
            "CONC-001", f"{f0.rel}:{a0.lineno}",
            f"shared mutable state {what} is written from thread roles "
            f"{{{', '.join(sorted(write_roles))}}} with no common "
            f"guarding lock — unguarded site(s): {', '.join(bare[:4])}",
            details={"state": what, "roles": sorted(write_roles),
                     "unguarded_sites": bare}))
    return findings


def _lock_graph(tree: _Tree) -> dict[str, set[tuple[str, str]]]:
    """lock -> {(lock acquired while held, witness site)}. Edges come
    from lexically nested `with` blocks and from calls made while a
    lock is held into functions that (transitively) acquire."""
    # transitive acquisition sets, fixpoint over the call graph
    acq: dict[str, set[str]] = {
        q: set(tree.funcs[q].acquires) for q in tree.funcs}
    changed = True
    guard = 0
    while changed and guard < 50:
        changed = False
        guard += 1
        for qual in sorted(tree.funcs):
            f = tree.funcs[qual]
            for call in f.calls:
                for callee in _resolve(tree, f, call):
                    extra = acq[callee] - acq[qual]
                    if extra:
                        acq[qual].update(extra)
                        changed = True

    edges: dict[str, set[tuple[str, str]]] = {}
    for qual in sorted(tree.funcs):
        f = tree.funcs[qual]
        for call in f.calls:
            if not call.locks:
                continue
            inner: set[str] = set()
            for callee in _resolve(tree, f, call):
                inner.update(acq[callee])
            for held in sorted(call.locks):
                for got in sorted(inner - {held}):
                    edges.setdefault(held, set()).add(
                        (got, f"{f.rel}:{call.lineno}"))
    return edges


def _conc002(tree: _Tree, root: Path, real_tree: bool) -> list[Finding]:
    edges = _lock_graph(tree)
    # add direct with-nesting edges (re-walk: _Func drops its AST)
    for path in _scope_files(root, real_tree):
        rel = path.relative_to(root).as_posix()
        try:
            mod = ast.parse(path.read_text(errors="replace"))
        except (OSError, SyntaxError):
            continue
        _collect_nested_with(mod, rel, edges)

    graph = {src: sorted({dst for dst, _w in dsts})
             for src, dsts in edges.items()}
    witness = {}
    for src, dsts in edges.items():
        for dst, site in sorted(dsts):
            witness.setdefault((src, dst), site)

    findings: list[Finding] = []
    seen_cycles: set[tuple[str, ...]] = set()
    for start in sorted(graph):
        cycle = _find_cycle(graph, start)
        if not cycle:
            continue
        canon = _canon_cycle(cycle)
        if canon in seen_cycles:
            continue
        seen_cycles.add(canon)
        hops = " -> ".join(canon + (canon[0],))
        sites = sorted({witness.get((a, b), "?")
                        for a, b in zip(canon, canon[1:] + (canon[0],))})
        findings.append(Finding(
            "CONC-002", sites[0] if sites else canon[0],
            f"lock-order cycle {hops}: two threads taking these locks "
            "in opposite orders deadlock",
            details={"cycle": list(canon), "witness_sites": sites}))
    return findings


def _collect_nested_with(mod: ast.Module, rel: str,
                         edges: dict[str, set[tuple[str, str]]]) -> None:
    def walk(body: Iterable[ast.stmt], cls: str | None,
             stack: list[str]) -> None:
        for node in body:
            if isinstance(node, ast.ClassDef):
                walk(node.body, node.name, [])
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                walk(node.body, cls, [])
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                shim = _Func(f"{rel}::<with>", rel, cls, "<with>",
                             node.lineno)
                helper = _FuncVisitor(shim)
                got: list[str] = []
                for item in node.items:
                    lock = helper._lock_node(item.context_expr)
                    if lock is not None:
                        for outer in stack:
                            if outer != lock:
                                edges.setdefault(outer, set()).add(
                                    (lock, f"{rel}:{node.lineno}"))
                        stack.append(lock)
                        got.append(lock)
                walk(node.body, cls, stack)
                for _ in got:
                    stack.pop()
            else:
                for field in ("body", "orelse", "finalbody", "handlers"):
                    sub = getattr(node, field, None)
                    if sub:
                        inner = [getattr(h, "body", h) for h in sub] \
                            if field == "handlers" else [sub]
                        for blk in inner:
                            walk(blk, cls, stack)

    walk(mod.body, None, [])


def _find_cycle(graph: dict[str, list[str]],
                start: str) -> tuple[str, ...] | None:
    path: list[str] = []
    on_path: set[str] = set()
    done: set[str] = set()

    def dfs(node: str) -> tuple[str, ...] | None:
        if node in on_path:
            i = path.index(node)
            return tuple(path[i:])
        if node in done:
            return None
        path.append(node)
        on_path.add(node)
        for nxt in graph.get(node, []):
            got = dfs(nxt)
            if got:
                return got
        path.pop()
        on_path.discard(node)
        done.add(node)
        return None

    return dfs(start)


def _canon_cycle(cycle: tuple[str, ...]) -> tuple[str, ...]:
    i = cycle.index(min(cycle))
    return cycle[i:] + cycle[:i]


def _conc003(tree: _Tree, roles: dict[str, set[str]],
             thread_roles: dict[str, tuple[str, ...]],
             real_tree: bool) -> list[Finding]:
    findings: list[Finding] = []
    declared_methods: dict[tuple[str | None, str], str] = {}
    for key, allowed in sorted(thread_roles.items()):
        rel, _, tail = key.partition("::")
        if "." not in tail:
            # class-level handoff declaration (CONC-001 exemption);
            # there is no single method surface to police call sites on
            continue
        cls, _, meth = tail.rpartition(".")
        declared_methods[(cls or None, meth)] = key

    for qual in sorted(tree.funcs):
        f = tree.funcs[qual]
        for call in f.calls:
            # match declared surfaces by method name (+ class when the
            # receiver is self)
            for (cls, meth), key in declared_methods.items():
                if call.name != meth:
                    continue
                allowed = thread_roles[key]
                if "*" in allowed:
                    continue
                srel, _, stail = key.partition("::")
                # the surface's own class may call itself
                if f.rel == srel and f.cls and stail.startswith(
                        f.cls + "."):
                    continue
                caller_roles = roles.get(qual, set()) or {_MAIN_ROLE}
                bad = sorted(caller_roles
                             - set(allowed) - {_MAIN_ROLE})
                if bad:
                    findings.append(Finding(
                        "CONC-003", f"{f.rel}:{call.lineno}",
                        f"appender surface {key} touched from thread "
                        f"role(s) {{{', '.join(bad)}}} — its declared "
                        f"sole toucher is "
                        f"{{{', '.join(allowed)}}} (THREAD_ROLES)",
                        details={"surface": key,
                                 "caller_roles": sorted(caller_roles),
                                 "allowed": list(allowed)}))
                break
    if real_tree:
        declared_quals = {k.replace("::", "::") for k in thread_roles}
        for qual in tree.appender_defs:
            rel, _, tail = qual.partition("::")
            if f"{rel}::{tail}" not in declared_quals:
                findings.append(Finding(
                    "CONC-003", rel,
                    f"appender-shaped method {qual} has no THREAD_ROLES "
                    "declaration — every write_raw/drain/write_once "
                    "surface must declare its sole toucher",
                    details={"surface": qual}))
    return findings


def _conc004(tree: _Tree) -> list[Finding]:
    findings: list[Finding] = []
    for qual in sorted(tree.funcs):
        f = tree.funcs[qual]
        for desc, lineno, locks in f.blocking:
            findings.append(Finding(
                "CONC-004", f"{f.rel}:{lineno}",
                f"blocking call ({desc}) while holding "
                f"{{{', '.join(sorted(locks))}}} — every thread "
                "contending the lock stalls behind the syscall on the "
                "serve hot path",
                details={"blocking": desc,
                         "locks": sorted(locks)}))
    return findings


def _conc005(tree: _Tree, replay_roots: tuple[str, ...],
             clock_allowlist: dict[str, str]) -> list[Finding]:
    seeds: list[str] = []
    for name in replay_roots:
        seeds.extend(tree.by_name.get(name, []))
    reach = _reach(tree, sorted(seeds))
    findings: list[Finding] = []
    for qual in sorted(reach):
        f = tree.funcs[qual]
        if f.rel in clock_allowlist:
            continue
        for desc, lineno in f.clocks:
            findings.append(Finding(
                "CONC-005", f"{f.rel}:{lineno}",
                f"{desc} reachable from fault-plan replay root(s) — "
                "the chaos certifier's converged-state verdict assumes "
                "replay is a pure function of (plan, seed); use "
                "time.monotonic for intervals or a seeded "
                "random.Random",
                details={"call": desc, "function": qual}))
    return findings


# --------------------------------------------------------------------------
# entry points


def _package_root() -> Path:
    return Path(__file__).resolve().parents[1]


def conc_findings(
    root: str | Path | None = None, *,
    thread_roles: dict[str, tuple[str, ...]] | None = None,
    role_hints: dict[str, tuple[str, ...]] | None = None,
    replay_roots: tuple[str, ...] | None = None,
    clock_allowlist: dict[str, str] | None = None,
) -> list[Finding]:
    """CONC-001..005 over the tree (package serve/obs/faults by
    default; tests inject seeded fixture trees plus their own
    declaration tables). Deterministic: findings sort by (rule, where,
    message), so two runs on one tree are byte-identical."""
    real_tree = root is None
    base = Path(root) if root is not None else _package_root()
    t_roles = THREAD_ROLES if thread_roles is None else thread_roles
    hints = ROLE_HINTS if role_hints is None else role_hints
    r_roots = REPLAY_ROOTS if replay_roots is None else replay_roots
    allow = (REPLAY_CLOCK_ALLOWLIST if clock_allowlist is None
             else clock_allowlist)

    tree = _index_tree(base, real_tree)
    roles = _role_map(tree, hints)
    inherited = _inherited_locks(tree)
    findings: list[Finding] = []
    findings.extend(_conc001(tree, roles, t_roles, inherited))
    findings.extend(_conc002(tree, base, real_tree))
    findings.extend(_conc003(tree, roles, t_roles, real_tree))
    findings.extend(_conc004(tree))
    findings.extend(_conc005(tree, tuple(r_roots), allow))
    return sorted(findings, key=lambda f: (f.rule, f.where, f.message))


# --------------------------------------------------------------------------
# selftest (`lint conc selftest`)

_SELFTEST_FIXTURES: tuple[tuple[str, str, str], ...] = (
    # (rule expected, filename, source) — each fixture is the minimal
    # tree that must trip exactly its rule; the selftest also asserts
    # the repaired twin stays clean where one exists.
    ("CONC-001", "racy.py", """\
import threading

class Box:
    def __init__(self):
        self.n = 0
    def bump(self):
        self.n += 1
    def zero(self):
        self.n = 0

def t1(box):
    box.bump()

def t2(box):
    box.zero()

def main(box):
    threading.Thread(target=t1, args=(box,)).start()
    threading.Thread(target=t2, args=(box,)).start()
"""),
    ("CONC-002", "deadlock.py", """\
import threading

A_LOCK = threading.Lock()
B_LOCK = threading.Lock()

def fwd():
    with A_LOCK:
        with B_LOCK:
            pass

def rev():
    with B_LOCK:
        with A_LOCK:
            pass

def main():
    threading.Thread(target=fwd).start()
    threading.Thread(target=rev).start()
"""),
    ("CONC-004", "slowpath.py", """\
import threading
import time

class Hot:
    def __init__(self):
        self._lock = threading.Lock()
    def step(self):
        with self._lock:
            time.sleep(0.5)

def loop(h):
    h.step()

def main(h):
    threading.Thread(target=loop, args=(h,)).start()
"""),
    ("CONC-005", "replay.py", """\
import random
import time

def run_cell(plan):
    stamp = time.time()
    jitter = random.random()
    return stamp + jitter
"""),
)

_CONC003_FIXTURE = """\
import threading

class Ledger:
    def write_raw(self, rec):
        pass

def producer(led):
    led.write_raw({})

def main(led):
    threading.Thread(target=producer, args=(led,)).start()
"""


def run_conc_selftest() -> list[Any]:
    """`lint conc selftest`: (1) the real serve/obs/faults tree must
    certify clean, (2) each seeded CONC-001..005 fixture must trip
    exactly its rule, (3) two consecutive real-tree passes must render
    byte-identical findings, and (4) the shipped declaration tables
    must not have rotted (every THREAD_ROLES / ROLE_HINTS /
    REPLAY_CLOCK_ALLOWLIST entry names a surface that still exists).
    Exits nonzero on any violation."""
    # utils.reporting imports torch; this selftest runs without it, so
    # it prints its header block directly
    bar = "=" * 60
    print("\n".join([
        bar, "Concurrency lint selftest", bar, "Configuration:",
        f"  - Scope: {', '.join(SCOPE_DIRS)}",
        "  - Rules: CONC-001..005",
        f"  - Declared surfaces: {len(THREAD_ROLES)}", bar,
    ]))
    problems: list[str] = []

    tree_findings = conc_findings()
    problems.extend(
        f"real tree: {f.rule} at {f.where}: {f.message}"
        for f in tree_findings)

    second = conc_findings()
    if [f.to_record() for f in second] != \
            [f.to_record() for f in tree_findings]:
        problems.append("nondeterministic findings: two consecutive "
                        "passes over one tree differ")

    with tempfile.TemporaryDirectory(prefix="conc-seeded-") as td:
        for rule, fname, src in _SELFTEST_FIXTURES:
            fdir = Path(td) / rule.lower()
            fdir.mkdir()
            (fdir / fname).write_text(src)
            got = conc_findings(fdir, thread_roles={}, role_hints={},
                                clock_allowlist={})
            rules = sorted({f.rule for f in got})
            if rule not in rules:
                problems.append(
                    f"seeded {rule} fixture did not fire (got {rules})")
        fdir = Path(td) / "conc-003"
        fdir.mkdir()
        (fdir / "appender.py").write_text(_CONC003_FIXTURE)
        got = conc_findings(
            fdir,
            thread_roles={"appender.py::Ledger.write_raw": ("drainer",)},
            role_hints={}, clock_allowlist={})
        if "CONC-003" not in {f.rule for f in got}:
            problems.append("seeded CONC-003 fixture did not fire")

    # table hygiene: an entry naming a vanished surface claims a
    # contract nobody ships
    pkg_tree = _index_tree(_package_root(), real_tree=True)
    for key in sorted(THREAD_ROLES) + sorted(ROLE_HINTS):
        rel, _, tail = key.partition("::")
        if "." not in tail:
            # class-level declaration: live iff any method of that
            # class exists in the scoped tree
            prefix = f"{rel}::{tail}."
            if not any(q.startswith(prefix) for q in pkg_tree.funcs):
                problems.append(f"stale declaration: {key} names a "
                                "class that no longer exists")
            continue
        if f"{rel}::{tail}" not in pkg_tree.funcs:
            problems.append(f"stale declaration: {key} names a surface "
                            "that no longer exists")
    scoped_rels = {f.rel for f in pkg_tree.funcs.values()}
    for rel in sorted(REPLAY_CLOCK_ALLOWLIST):
        if rel not in scoped_rels:
            problems.append(f"stale REPLAY_CLOCK_ALLOWLIST entry: {rel}")

    if problems:
        for p in problems:
            print(f"conc selftest FAILED: {p}", file=sys.stderr)
        raise SystemExit(1)
    print(f"conc selftest ok: real tree clean over {len(SCOPE_DIRS)} "
           f"scope dirs, {len(_SELFTEST_FIXTURES) + 1} seeded rules "
           "fire, findings deterministic, declaration tables live")
    return [f.to_record() for f in tree_findings]
