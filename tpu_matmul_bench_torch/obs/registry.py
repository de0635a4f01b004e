"""Thread-safe metrics registry: labeled counters, gauges, histograms.

A copy of `tpu_matmul_bench/obs/registry.py` (stdlib only): the port
imports nothing of the JAX package.

The bus replaces the ad-hoc ints that grew inside `serve/cache.py` and
`serve/queue.py` with named, labeled instruments that any subsystem can
create and a single process-global `snapshot()` can read. Design points:

- **Per-instance instruments.** `registry.counter(name, **labels)`
  returns a *fresh* instrument every call; `snapshot()` aggregates all
  instruments sharing a (name, labels) series. A component therefore
  reads its *own* instrument for its ledger stats (two serve windows in
  one process keep byte-identical per-window ``extras["serve"]``
  blocks) while the snapshot shows process-wide totals.
- **Bounded histograms.** Observations land in a sliding-window
  reservoir (`deque(maxlen=window)`); quantiles are computed over the
  window at snapshot time, so a long-lived service pays O(window)
  memory and zero per-observation sorting.
- **Locking discipline.** One lock per instrument guards its hot path
  (an `inc` is one guarded integer add); the registry lock is taken
  only at instrument creation and snapshot — never inside timed
  regions.

stdlib-only: the registry imports nothing of torch, so any entry point
can record into it without a backend.
"""

from __future__ import annotations

import collections
import itertools
import threading
from typing import Any

DEFAULT_HISTOGRAM_WINDOW = 2048

QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))

# Exemplar reservoir bound per histogram: the K largest observations
# retain their trace ids, so a tail quantile in any snapshot can name
# the requests that produced it (flight-recorder forensics; lint
# TRACE-003 certifies this bound exists and stays small).
EXEMPLAR_LIMIT = 8

# global write sequence: lets snapshot() resolve "last set wins" across
# gauge instruments that share a series without comparing wall clocks
_SEQ = itertools.count(1)


def series_key(name: str, labels: dict[str, Any]) -> str:
    """Canonical series identity, Prometheus-style:
    ``name{k="v",...}`` with labels sorted — also the exposition text's
    left-hand side, so snapshots and /metrics agree on naming."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class _Instrument:
    """Shared identity + lock. Subclasses own their value semantics."""

    kind = ""

    def __init__(self, name: str, labels: dict[str, Any]) -> None:
        self.name = name
        self.labels = dict(labels)
        self.key = series_key(name, self.labels)
        self._lock = threading.Lock()


class Counter(_Instrument):
    """Monotonic accumulator (int or float adds)."""

    kind = "counter"

    def __init__(self, name: str, labels: dict[str, Any]) -> None:
        super().__init__(name, labels)
        self._value: float = 0

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Instrument):
    """Point-in-time value; the series' most recent `set` wins."""

    kind = "gauge"

    def __init__(self, name: str, labels: dict[str, Any]) -> None:
        super().__init__(name, labels)
        self._value: float = 0
        self._seq = 0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value
            self._seq = next(_SEQ)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _state(self) -> tuple[int, float]:
        """(seq, value) under the instrument lock — snapshot() resolves
        last-set-wins across instruments from these pairs without
        reaching into a foreign instrument's fields."""
        with self._lock:
            return self._seq, self._value


class Histogram(_Instrument):
    """Sliding-window quantile histogram over a bounded reservoir."""

    kind = "histogram"

    def __init__(self, name: str, labels: dict[str, Any], *,
                 window: int = DEFAULT_HISTOGRAM_WINDOW) -> None:
        if window < 1:
            raise ValueError(f"histogram window must be >= 1, got {window}")
        super().__init__(name, labels)
        self._window: collections.deque[float] = collections.deque(
            maxlen=window)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        # tail exemplars: (value, trace_id), largest values first,
        # bounded at EXEMPLAR_LIMIT — the bridge from a p99 summary
        # back to the individual requests that live in the tail
        self._exemplars: list[tuple[float, str]] = []

    def observe(self, value: float, trace_id: str | None = None) -> None:
        with self._lock:
            self._window.append(float(value))
            self._count += 1
            self._sum += float(value)
            if value > self._max:
                self._max = float(value)
            if trace_id:
                self._exemplars.append((float(value), str(trace_id)))
                self._exemplars.sort(key=lambda e: -e[0])
                del self._exemplars[EXEMPLAR_LIMIT:]

    def _state(self) -> tuple[
            list[float], int, float, float, list[tuple[float, str]]]:
        with self._lock:
            return (list(self._window), self._count, self._sum, self._max,
                    list(self._exemplars))


def _quantile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolated quantile over a sorted window (numpy's
    default method, but stdlib — obs must not require numpy)."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def _histogram_summary(
    windows: list[float], count: int, total: float, peak: float,
    tail_exemplars: list[tuple[float, str]] | None = None,
) -> dict[str, Any]:
    out: dict[str, Any] = {"count": count, "sum": round(total, 6)}
    if windows:
        ordered = sorted(windows)
        for label, q in QUANTILES:
            out[label] = round(_quantile(ordered, q), 6)
        out["max"] = round(peak, 6)
    if tail_exemplars:
        out["exemplars"] = [
            {"value": round(v, 6), "trace_id": t}
            for v, t in tail_exemplars]
    return out


class MetricsRegistry:
    """The bus: creates instruments, aggregates them at snapshot time."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: list[_Instrument] = []

    def _register(self, inst: _Instrument) -> _Instrument:
        with self._lock:
            self._instruments.append(inst)
        return inst

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._register(Counter(name, labels))  # type: ignore[return-value]

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._register(Gauge(name, labels))  # type: ignore[return-value]

    def histogram(self, name: str, *,
                  window: int = DEFAULT_HISTOGRAM_WINDOW,
                  **labels: Any) -> Histogram:
        return self._register(
            Histogram(name, labels, window=window))  # type: ignore[return-value]

    def snapshot(self) -> dict[str, Any]:
        """Aggregate every instrument by series: counters sum, the
        freshest gauge write wins, histogram reservoirs merge. Keys are
        sorted so snapshots diff cleanly line-to-line."""
        with self._lock:
            instruments = list(self._instruments)
        counters: dict[str, float] = {}
        gauges: dict[str, tuple[int, float]] = {}
        hists: dict[str, list[tuple]] = {}
        for inst in instruments:
            if isinstance(inst, Counter):
                counters[inst.key] = counters.get(inst.key, 0) + inst.value
            elif isinstance(inst, Gauge):
                seq, val = inst._state()
                if inst.key not in gauges or seq >= gauges[inst.key][0]:
                    gauges[inst.key] = (seq, val)
            elif isinstance(inst, Histogram):
                hists.setdefault(inst.key, []).append(inst._state())
        merged_hists: dict[str, dict[str, Any]] = {}
        for key, states in hists.items():
            window: list[float] = []
            count, total, peak = 0, 0.0, 0.0
            merged_ex: list[tuple[float, str]] = []
            for w, c, s, mx, exs in states:
                window.extend(w)
                count += c
                total += s
                peak = max(peak, mx)
                merged_ex.extend(exs)
            merged_ex.sort(key=lambda e: -e[0])
            merged_hists[key] = _histogram_summary(
                window, count, total, peak, merged_ex[:EXEMPLAR_LIMIT])
        return {
            "counters": {k: counters[k] for k in sorted(counters)},
            "gauges": {k: gauges[k][1] for k in sorted(gauges)},
            "histograms": {k: merged_hists[k] for k in sorted(merged_hists)},
        }


_REGISTRY = MetricsRegistry()
_REGISTRY_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global bus every subsystem records into by default.

    Read under the same lock `reset_registry` swaps under: an exporter
    thread grabbing the bus mid-reset must see either the old registry
    or the new one, never a torn reference."""
    with _REGISTRY_LOCK:
        return _REGISTRY


def reset_registry() -> MetricsRegistry:
    """Swap in a fresh registry (tests / `obs selftest` isolation) and
    return it. Components holding instruments from the old registry keep
    working — they just stop appearing in new snapshots."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = MetricsRegistry()
        return _REGISTRY
