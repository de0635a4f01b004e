"""Recorders over one run of a program: what it called, not what it traced.

The port's counterpart of `tpu_matmul_bench/analysis/jaxpr_tools.py`. JAX
audits a program by tracing it (`jax.make_jaxpr`) and walking the jaxpr.
PyTorch runs eagerly and has no trace to walk, so the port runs each
program once, at the audit size, while these context managers record what
it does:

- **collectives** (`record`, `record_collectives`): the doors of
  `parallel/collectives.py` (`psum_over`, `pmean_over`,
  `psum_scatter_over`, `all_gather_over`, `all_to_all_over`, `ppermute`)
  are wrapped while the block runs, and each call is logged as (kind,
  axis, per-rank payload bytes, dtype), one entry for each group of the
  axis it runs over. A door is looked up in the module at call time by
  every program of the port (`psum_impl(None)` and the wire formats
  alike); a program that bound a door before the block began would call
  the unwrapped one, and its collective would be missing from the log:
  the audits then report it as a mismatch against the comms model.
- **float discipline** (`record`, `record_downcasts`): a `TorchFunctionMode`
  logs every operation whose float result is narrower than its widest
  float input (a downcast), every conversion that widens the result of a
  narrowing conversion (a round trip), and every cast to or from a wire
  dtype. Under `record(opaque=True)` a collective door and a kernel's
  plain version run as one primitive each, as a `psum` or a `dot_general`
  is one equation of a jaxpr: their own casts are not logged, so a
  program's log does not depend on the device or the impl under it.
- **host round trips** (PURE-001, TRAIN-005): an operation that hands a
  value to the host (`item`, `tolist`, `numpy`, `bool`/`float`/`int` of a
  tensor, a copy of a card tensor to the CPU) or a `torch.cuda.synchronize`.
  On the card, `sync_debug_error` runs a call under
  `torch.cuda.set_sync_debug_mode("error")`, the runtime's own authority.
- **live bytes** (`record_live_bytes`, MEM-001/002): a `TorchDispatchMode`
  adds each new storage's bytes when an operation creates it and takes
  them off when the storage is freed (`weakref.finalize` on the storage,
  whose Python object lives as long as the storage does), keeping the
  peak a device. Ranks that share a device sum there.
- **storage identity** (DONATE-001): `storage_state` and `written_in_place`
  say whether a tensor was written in place (the same storage, its version
  counter moved) rather than replaced.
- **the stream schedule** (`record_schedule`, SCHED-001..004 and the
  fingerprints' schedule): the launches, event marks and waits and the
  entry and exit barriers of the rank-stream programs
  (`parallel/overlap.py`), in issue order (`ScheduleLog`). JAX infers from
  optimized HLO whether XLA may overlap a collective with a product; the
  port writes its schedule down, so the contract is read off the record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import weakref
from typing import Any, Callable, Iterator, Sequence

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

#: the collective doors of `parallel/collectives.py`: factory name -> kind
#: (each is called as `door(mesh, **kw)(shards)`); `ppermute(mesh,
#: shards, perm)` is called directly
DOORS = {"psum_over": "all_reduce", "pmean_over": "all_reduce",
         "psum_scatter_over": "reduce_scatter", "all_gather_over": "all_gather",
         "all_to_all_over": "all_to_all"}

#: the kernels' plain versions (`ops/cuda_matmul.py`), each one primitive
#: under `record(opaque=True)`
PLAIN_PRODUCTS = ("matmul_plain", "matmul_acc_plain", "matmul_ksplit_plain")

#: what runs a kernel or the library on the card and a plain version on
#: the CPU, each one primitive under `record(opaque=True)` for a program
#: built inside the block, so its record does not depend on the device:
#: (module, function) — K1 and K1b's wrappers, the library product, a hop
PRODUCT_ENTRIES = (("tpu_matmul_bench_torch.ops.cuda_matmul", "cuda_matmul"),
                   ("tpu_matmul_bench_torch.ops.cuda_matmul", "cuda_matmul_ksplit"),
                   ("tpu_matmul_bench_torch.ops.matmul", "_library"),
                   ("tpu_matmul_bench_torch.ops.cuda_ring", "_hop"))

# dtypes that only ever appear on a quantized wire
_WIRE_DTYPES = {torch.int8, torch.float8_e4m3fn}

# conversions: the operations whose only job is to change a dtype
_CONVERSIONS = {"to", "float", "double", "half", "bfloat16", "type"}

# operations that hand a value to the host
HOST_READS = {"item", "tolist", "numpy", "__bool__", "__float__", "__int__",
              "__index__"}


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class CollectiveUse:
    """One recorded collective over one group of an axis: its kind, the
    axis (the 1-D mesh's 'x', or a factorized mesh's link class), each
    rank's payload bytes and the payload's dtype."""

    kind: str
    axis: str
    payload_bytes: int
    dtype: str

    def entry(self) -> tuple[str, str, int]:
        return (self.kind, self.axis, self.payload_bytes)


@dataclasses.dataclass
class Recording:
    """What one recorded block did (see the module docstring)."""

    collectives: list[CollectiveUse] = dataclasses.field(default_factory=list)
    log: list[tuple[str, str, int]] = dataclasses.field(default_factory=list)
    downcasts: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    roundtrips: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    wire_casts: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    host_syncs: list[str] = dataclasses.field(default_factory=list)
    # the names of the operations that made tensors, in order
    ops: list[str] = dataclasses.field(default_factory=list)
    # the primitives (doors, products, hops) called outside any other, in
    # order, under `record(opaque=True)`
    primitives: list[str] = dataclasses.field(default_factory=list)
    opaque: int = 0  # depth of primitives running now

    def reset(self) -> None:
        """Forget what was recorded so far (a program built inside the
        block, whose build is not part of its record)."""
        for f in dataclasses.fields(self):
            if f.name != "opaque":
                getattr(self, f.name).clear()

    def add_collective(self, kind: str, mesh: Any, shards: Any) -> None:
        with torch._C.DisableTorchFunction():  # the recorder's own reads
            first = shards[0]
            use = CollectiveUse(kind, mesh.axis, first.numel() * first.element_size(),
                                dtype_name(first.dtype))
        self.collectives.append(use)
        self.log.append(use.entry())


class _FunctionRecorder(TorchFunctionMode):
    """The float-discipline and host round-trip half of `record`."""

    def __init__(self, rec: Recording) -> None:
        super().__init__()
        self.rec = rec
        # id -> (weakref, source dtype) of each narrowing conversion's result
        self._narrowed: dict[int, tuple[weakref.ref, torch.dtype]] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.rec.opaque:
            return out
        name = getattr(func, "__name__", "")
        rec = self.rec
        if isinstance(out, torch.Tensor) or (
                isinstance(out, (list, tuple)) and any(isinstance(o, torch.Tensor)
                                                       for o in out)):
            rec.ops.append(name)  # an operation; metadata reads make no value
        tensors = [a for a in list(args) + list((kwargs or {}).values())
                   if isinstance(a, torch.Tensor)]
        if name in HOST_READS or (name in ("cpu", "to") and isinstance(out, torch.Tensor)
                                  and out.device.type == "cpu"
                                  and any(t.device.type == "cuda" for t in tensors)):
            rec.host_syncs.append(name)
        if not isinstance(out, torch.Tensor) or not tensors:
            return out
        if {out.dtype} & _WIRE_DTYPES or any(t.dtype in _WIRE_DTYPES for t in tensors):
            if name in _CONVERSIONS:
                rec.wire_casts.append((dtype_name(tensors[0].dtype), dtype_name(out.dtype)))
            return out
        floats = [t for t in tensors if t.is_floating_point()]
        if not (out.is_floating_point() and floats):
            return out
        widest = max(floats, key=lambda t: t.element_size()).dtype
        if out.element_size() < widest.itemsize:
            rec.downcasts.append((dtype_name(widest), dtype_name(out.dtype)))
            if name in _CONVERSIONS:
                self._narrowed[id(out)] = (weakref.ref(out), widest)
        elif name in _CONVERSIONS and out.element_size() > floats[0].element_size():
            src = self._narrowed.get(id(floats[0]))
            if src is not None and src[0]() is floats[0]:
                rec.roundtrips.append((dtype_name(floats[0].dtype), dtype_name(src[1])))
        return out


def _door(rec: Recording, kind: str, make: Callable, opaque: bool) -> Callable:
    def wrapped(mesh, **kw):
        inner = make(mesh, **kw)

        def fn(shards):
            rec.add_collective(kind, mesh, shards)
            with _primitive(rec, opaque, kind):
                return inner(shards)
        return fn
    return wrapped


@contextlib.contextmanager
def _primitive(rec: Recording, opaque: bool, name: str) -> Iterator[None]:
    if opaque and not rec.opaque:
        rec.primitives.append(name)
    rec.opaque += opaque
    try:
        yield
    finally:
        rec.opaque -= opaque


@contextlib.contextmanager
def record(*, collectives: bool = True, dtypes: bool = True,
           opaque: bool = False) -> Iterator[Recording]:
    """Record the block (see the module docstring): its collectives, its
    float downcasts, round trips and wire casts, and its host round trips.
    `opaque`: collectives, the kernels' plain versions and the
    `PRODUCT_ENTRIES` are primitives, whose own casts and operations are
    not logged; each is logged once in `primitives`."""
    from tpu_matmul_bench_torch.ops import cuda_matmul
    from tpu_matmul_bench_torch.parallel import collectives as coll

    rec = Recording()
    saved: list[tuple[Any, str, Any]] = []

    def patch(module: Any, name: str, fn: Any) -> None:
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    if collectives:
        for name, kind in DOORS.items():
            patch(coll, name, _door(rec, kind, getattr(coll, name), opaque))
        real_ppermute = coll.ppermute

        def ppermute(mesh, shards, perm):
            rec.add_collective("ppermute", mesh, shards)
            with _primitive(rec, opaque, "ppermute"):
                return real_ppermute(mesh, shards, perm)
        patch(coll, "ppermute", ppermute)
    if opaque:
        entries = [(cuda_matmul, name) for name in PLAIN_PRODUCTS]
        entries += [(importlib.import_module(m), name) for m, name in PRODUCT_ENTRIES]
        for module, name in entries:
            def product(*a, _real=getattr(module, name), _name=name, **kw):
                with _primitive(rec, True, _name):
                    return _real(*a, **kw)
            patch(module, name, product)
    real_sync = torch.cuda.synchronize

    def synchronize(*a, **kw):
        rec.host_syncs.append("torch.cuda.synchronize")
        return real_sync(*a, **kw)
    patch(torch.cuda, "synchronize", synchronize)
    mode = _FunctionRecorder(rec) if dtypes else contextlib.nullcontext()
    try:
        with mode:
            yield rec
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)


@contextlib.contextmanager
def record_collectives() -> Iterator[list[tuple[str, str, int]]]:
    """While the block runs, log each collective as (kind, axis, per-rank
    payload bytes): the exact all_reduce, reduce_scatter, all_gather and
    all_to_all, and each wire hop (ppermute) and wire gather, whose doors
    the wire formats call too."""
    with record(dtypes=False) as rec:
        yield rec.log


@contextlib.contextmanager
def record_downcasts() -> Iterator[list[tuple[str, str]]]:
    """While the block runs, log (source, result) float dtypes of every
    operation whose result is narrower than its widest float input, wire
    dtypes aside."""
    with record(collectives=False) as rec:
        yield rec.downcasts


def sync_debug_error(fn: Callable[[], Any]) -> str | None:
    """Run `fn` under `torch.cuda.set_sync_debug_mode("error")`: the
    runtime's message when an operation synchronized the card with the
    host, else None. Any other error propagates."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        return str(e)
    finally:
        torch.cuda.set_sync_debug_mode(before)
    torch.cuda.synchronize()
    return None


class LiveBytes(TorchDispatchMode):
    """The live-bytes walk: each storage an operation creates counts its
    bytes on its device from then until it is freed; `peak` keeps the most
    a device held at once. Storages that existed before the block (the
    operands) are not counted, as the allocator's peak over a baseline
    does not count them."""

    def __init__(self) -> None:
        super().__init__()
        self.live: dict[str, int] = {}
        self.peak: dict[str, int] = {}
        self._seen: set[int] = set()
        self._before: set[int] = set()

    def _freed(self, key: int, device: str, nbytes: int) -> None:
        self._seen.discard(key)
        self.live[device] -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ins = [a for a in list(args) + list((kwargs or {}).values())
               if isinstance(a, torch.Tensor)]
        for t in ins:  # a storage an input brought in existed before
            key = id(t.untyped_storage())
            if key not in self._seen:
                self._before.add(key)
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (list, tuple)) else (out,):
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key = id(storage)
            if key in self._seen or key in self._before:
                continue
            self._seen.add(key)
            device, nbytes = str(t.device), storage.nbytes()
            self.live[device] = self.live.get(device, 0) + nbytes
            self.peak[device] = max(self.peak.get(device, 0), self.live[device])
            weakref.finalize(storage, self._freed, key, device, nbytes)
        return out

    def peak_bytes(self) -> int:
        """The most any one device held at once."""
        return max(self.peak.values(), default=0)


@contextlib.contextmanager
def record_live_bytes() -> Iterator[LiveBytes]:
    """While the block runs, walk its live bytes (see `LiveBytes`)."""
    walk = LiveBytes()
    with walk:
        yield walk


def storage_state(t: torch.Tensor) -> tuple[int, int]:
    """(storage address, version counter) of a tensor."""
    return t.untyped_storage().data_ptr(), t._version


def written_in_place(before: tuple[int, int], t: torch.Tensor) -> bool:
    """Whether `t` was written in its own storage since `before`
    (`storage_state`): the same address, and a version counter that moved."""
    ptr, version = storage_state(t)
    return ptr == before[0] and version > before[1]


# ---------------------------------------------------------------------------
# the stream schedule (SCHED-*, and the schedule part of a fingerprint)
# ---------------------------------------------------------------------------

class ScheduleEvent:
    """A marked event where no CUDA event exists (on the CPU): its number
    in the log."""

    def __init__(self, eid: int) -> None:
        self.eid = eid


class ScheduleLog:
    """What the rank-stream programs issued, in issue order, while
    `record_schedule` was active (`ops/cuda_ring.py _Schedule`, which logs
    a launch where its `on` puts work on a stream):

    - ("enter",) and ("leave",): the call's entry and exit barriers;
    - ("launch", kind, rank, stream, step): a launch on rank `rank`'s
      stream `stream` (`cuda_ring.CALLER` for the caller's own, whose
      launches follow one another in issue order) at step `step`, of
      kind "product" (the program's `matmul_2d`, K1 under `cuda`), "sum"
      (the psum door), "hop" (`cuda_ring._hop`), "add" (the
      reduce-scatter ring's accumulation), "gather" or "scatter" (a
      serialized baseline's collective) or "copy";
    - ("mark", rank, stream, eid, leaving): an event marked on that stream,
      numbered in mark order; `leaving` for the marks of the exit barrier;
    - ("wait", rank, stream, eids, reuse): that stream waits on the events
      (-1 for one this log never marked); `reuse` when the wait guards a
      buffer's reuse (a write after a read), not data the next launch
      consumes.

    The log is the same on the CPU, where the schedule has no streams and
    every launch runs at once, as on the card: event numbers replace the
    card's events, and nothing in it depends on a pointer or a time."""

    def __init__(self) -> None:
        self.entries: list[tuple] = []
        self._eids: dict[int, int] = {}
        self._held: list[Any] = []  # the marked events, kept alive for their ids
        self._leaving = False

    def launch(self, kind: str, rank: int, stream: int, step: int) -> None:
        self.entries.append(("launch", kind, rank, stream, step))

    def mark(self, rank: int, stream: int, event: Any) -> Any:
        eid = len(self._held)
        if event is None:
            event = ScheduleEvent(eid)
        self._eids[id(event)] = eid
        self._held.append(event)
        self.entries.append(("mark", rank, stream, eid, self._leaving))
        return event

    def wait(self, rank: int, stream: int, events: Sequence[Any], reuse: bool) -> None:
        # a marked event is held, so no other live object shares its id
        eids = tuple(self._eids.get(id(e), -1) for e in events)
        self.entries.append(("wait", rank, stream, eids, reuse))

    def barrier(self, name: str) -> None:
        self._leaving = name == "leave"
        self.entries.append((name,))


@contextlib.contextmanager
def record_schedule() -> Iterator[ScheduleLog]:
    """While the block runs, every rank-stream program logs its schedule
    (see `ScheduleLog`): the log is handed to the schedules made meanwhile
    (`cuda_ring._Schedule.recorder`)."""
    from tpu_matmul_bench_torch.ops.cuda_ring import _Schedule

    log = ScheduleLog()
    saved, _Schedule.recorder = _Schedule.recorder, log
    try:
        yield log
    finally:
        _Schedule.recorder = saved
