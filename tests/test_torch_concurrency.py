"""The port's concurrency certifier (`tpu_matmul_bench_torch/analysis/
concurrency.py`) against the JAX package's, and its torch form.

Each of JAX's seeded fixtures goes through both certifiers with the same
tables and must give the same findings; the port's own tree must certify
clean; the torch form's blocking calls must fire CONC-004 under a lock;
and the executable cache's graph capture must wait for the card after it
releases the pod's shared lock.
"""

import contextlib
import threading
from pathlib import Path

import pytest
import torch

from tpu_matmul_bench.analysis import concurrency as jax_conc
from tpu_matmul_bench_torch.analysis import concurrency as conc
from tpu_matmul_bench_torch.serve import cache

_EMPTY = dict(thread_roles={}, role_hints={}, clock_allowlist={})


def _records(found):
    """Findings as records; `rule_doc` is the rule's one-line text, which the
    port rewords where its torch form replaces an XLA thing (CONC-004's
    blocking calls)."""
    return [{k: v for k, v in f.to_record().items() if k != "rule_doc"} for f in found]


def _tree(tmp_path: Path, name: str, source: str) -> Path:
    root = tmp_path / "tree"
    root.mkdir(parents=True)
    (root / name).write_text(source)
    return root


@pytest.mark.parametrize("rule,name,source", jax_conc._SELFTEST_FIXTURES,
                         ids=[f[0] for f in jax_conc._SELFTEST_FIXTURES])
def test_seeded_fixtures_match_jax(tmp_path, rule, name, source):
    root = _tree(tmp_path, name, source)
    port = conc.conc_findings(root, **_EMPTY)
    ref = jax_conc.conc_findings(root, **_EMPTY)
    assert _records(port) == _records(ref)
    assert rule in {f.rule for f in port}


def test_conc003_fixture_matches_jax(tmp_path):
    root = _tree(tmp_path, "appender.py", jax_conc._CONC003_FIXTURE)
    tables = dict(thread_roles={"appender.py::Ledger.write_raw": ("drainer",)},
                  role_hints={}, clock_allowlist={})
    port = conc.conc_findings(root, **tables)
    assert _records(port) == _records(jax_conc.conc_findings(root, **tables))
    assert {f.rule for f in port} == {"CONC-003"}


def test_conc_rule_severities_are_jax_s():
    from tpu_matmul_bench.analysis import findings as jax_findings
    from tpu_matmul_bench_torch.analysis import findings

    for i in range(1, 6):
        rule = f"CONC-{i:03d}"
        assert findings.RULES[rule][0] == jax_findings.RULES[rule][0] == "error"
        # the one-line text is JAX's but where the torch form replaces an
        # XLA thing: CONC-004's blocking calls
        if rule != "CONC-004":
            assert findings.RULES[rule][1] == jax_findings.RULES[rule][1]


def test_port_tree_is_clean_and_deterministic():
    first = conc.conc_findings()
    assert first == []
    assert [f.to_record() for f in conc.conc_findings()] == [f.to_record() for f in first]


def test_selftest_passes_with_live_tables(capsys):
    assert conc.run_conc_selftest() == []
    assert "conc selftest ok" in capsys.readouterr().out


def test_declared_thread_roots_are_the_port_s():
    tree = conc._index_tree(conc._package_root(), real_tree=True)
    targets = {(t, rel) for t, rel, _ in tree.thread_targets}
    assert {("_open_loop_producer", "serve/service.py"),
            ("_closed_loop_producer", "serve/service.py"),
            ("_open_loop_producer", "serve/pod.py"), ("_closed_loop_producer", "serve/pod.py"),
            ("_worker_drain", "serve/pod.py"), ("_loop", "obs/export.py"),
            ("serve_forever", "obs/export.py")} <= targets
    assert conc.REPLAY_ROOTS == jax_conc.REPLAY_ROOTS
    assert set(conc.THREAD_ROLES) == set(jax_conc.THREAD_ROLES)


_LOCKED = """\
import threading
import torch
from tpu_matmul_bench_torch.ops import _build

class Hot:
    def __init__(self):
        self._lock = threading.Lock()
    def step(self, stream, event):
        with self._lock:
            {call}

def loop(h):
    h.step(None, None)

def main(h):
    threading.Thread(target=loop, args=(h,)).start()
"""


@pytest.mark.parametrize("call,desc", [
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("stream.synchronize()", "stream/event synchronize"),
    ("event.synchronize()", "stream/event synchronize"),
    ("capture(None, None, None)", "CUDA-graph capture"),
    ("torch.cuda.graph(None)", "torch.cuda.graph"),
    ("torch.cuda.empty_cache()", "torch.cuda.empty_cache"),
    ("_build.build('matmul')", "nvcc build"),
    ("self._import_artifact(None)", "kernel-library import"),
    ("self._export_artifact(None)", "kernel-library export"),
])
def test_torch_form_blocking_call_under_a_lock_fires_conc004(tmp_path, call, desc):
    root = _tree(tmp_path, "hot.py", _LOCKED.format(call=call))
    found = conc.conc_findings(root, **_EMPTY)
    assert [(f.rule, f.details["blocking"]) for f in found] == [("CONC-004", desc)]
    # the repaired twin: the same call after the lock is released
    fixed = _LOCKED.format(call="pass\n        " + call)
    assert conc.conc_findings(_tree(tmp_path / "fixed", "hot.py", fixed), **_EMPTY) == []


def test_optional_lock_is_seen_through_or(tmp_path):
    src = _LOCKED.format(call="pass").replace(
        "with self._lock:\n            pass",
        "with self._lock or contextlib.nullcontext():\n            torch.cuda.synchronize()")
    found = conc.conc_findings(_tree(tmp_path, "hot.py", src), **_EMPTY)
    assert [f.rule for f in found] == ["CONC-004"]


def test_graph_entry_under_an_optional_lock_fires_conc004(tmp_path):
    # the shape of a capture that records through `torch.cuda.graph` under
    # the pod's lock: its entry synchronises the card while the lock is held
    src = _LOCKED.format(call="pass").replace(
        "with self._lock:\n            pass",
        "with self._lock or contextlib.nullcontext():\n"
        "            with torch.cuda.graph(event):\n"
        "                pass")
    found = conc.conc_findings(_tree(tmp_path, "hot.py", src), **_EMPTY)
    assert [(f.rule, f.details["blocking"]) for f in found] == [
        ("CONC-004", "torch.cuda.graph")]


class _Fake:
    """Stands in for a CUDA stream or event; `log` records each call with
    whether the capture lock was held."""

    def __init__(self, log, lock, name):
        self.log, self.lock, self.name = log, lock, name

    def __getattr__(self, attr):
        def call(*a, **kw):
            self.log.append((f"{self.name}.{attr}", self.lock.locked()))
        return call


class _FakeGraph:
    """Stands in for `torch.cuda.CUDAGraph`: logs its capture's begin (with
    its mode) and end."""

    def __init__(self, log, lock):
        self.log, self.lock = log, lock

    def capture_begin(self, pool=None, capture_error_mode="global", **kw):
        self.log.append((f"capture_begin[{capture_error_mode}]", self.lock.locked()))

    def capture_end(self):
        self.log.append(("capture_end", self.lock.locked()))


def test_capture_waits_for_the_card_outside_the_lock(monkeypatch):
    """Nothing waits for the card while the lock is held. There is no card
    here, so streams, events and the graph object are stand-ins; the
    card-wide waits (`torch.cuda.synchronize`, `empty_cache`) are spies,
    and `torch.cuda.graph` is left as it is: a capture that recorded
    through it would run its real entry, which synchronises the card."""
    lock, log, made = threading.Lock(), [], []

    def stream(*a):
        made.append(_Fake(log, lock, f"stream{len(made)}"))
        return made[-1]

    @contextlib.contextmanager
    def on(s):
        log.append((f"on[{s.name}]", lock.locked()))
        yield

    monkeypatch.setattr(torch.cuda.graph, "default_capture_stream", None)
    monkeypatch.setattr(cache, "_CAPTURE_STREAMS", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Fake(log, lock, "current"))
    monkeypatch.setattr(torch.cuda, "Stream", stream)
    monkeypatch.setattr(torch.cuda, "stream", on)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: _FakeGraph(log, lock))
    monkeypatch.setattr(torch.cuda, "Event", lambda: _Fake(log, lock, "event"))
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _n=name: log.append((_n, lock.locked())))
    # the pinned host cache `torch.cuda.graph` empties (absent from a CPU build)
    monkeypatch.setattr(torch._C, "_host_emptyCache", lambda: None, raising=False)
    a = torch.ones(4, 4)

    def fn(x, y, out=None):
        log.append(("fn", lock.locked()))
        return out

    exe = cache.capture(fn, a, a, lock=lock)
    assert isinstance(exe, cache.GraphExecutable)
    # everything that puts work on a stream runs under the lock (the eager
    # warm call on a side stream, the recording in thread-local mode on the
    # card's capture stream, the event's mark); the host wait for the card
    # after it, and no card-wide wait at all
    assert log == [("stream0.wait_stream", True), ("on[stream0]", True), ("fn", True),
                   ("current.wait_stream", True), ("on[stream1]", True),
                   ("capture_begin[thread_local]", True), ("fn", True),
                   ("capture_end", True), ("event.record", True),
                   ("event.synchronize", False)]
    # without a lock: global mode, the same capture stream, the same wait
    log.clear()
    cache.capture(fn, a, a)
    assert [e for e in log if e[0].startswith(("on[", "capture_begin"))] == [
        ("on[stream2]", False), ("on[stream1]", False), ("capture_begin[global]", False)]
    assert log[-1] == ("event.synchronize", False)
    assert not [e for e in log if e[0] in ("synchronize", "empty_cache")]
