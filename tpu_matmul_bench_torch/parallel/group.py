"""Ranks as processes: the `torch.distributed` group the port's world spans.

The JAX package runs a parallel program as a multi-controller cluster
(`jax.distributed.initialize`); the reference runs one process a GPU under
`torch.distributed.run`. Here a process holds its local ranks of one
global world (`parallel/mesh.py`): a rank of another process is a
placeholder on the meta device, with the shape and dtype its shard has
there and no data. Every process runs the same program in the same
order, computes its own ranks only, and moves the bytes of remote shards
through this group wherever a collective needs them.

The group is gloo: NCCL keeps one communicator rank a card, and two
processes that share one card (the one-card machine's case) need two.
Tensors cross as `uint8` views of their bytes, staged through host
memory, so every dtype crosses (gloo refuses int16 and float8 by type)
and nothing on the wire is summed or rounded: a collective gathers the
remote shards' bytes and then runs the one-process world's rank-order
code, so its results are that world's bits. A wire format's collectives
move its quantized payloads and fp32 scales the same way, never a
dequantized value. Gloo's own reductions are
used only on control values (a verdict, a clock reading).

`CROSSINGS` counts the exchanges of data this process made through the
group; the fused timing protocol reads it to refuse a program that would
put a crossing inside a CUDA graph. `CROSSING_BYTES_OUT` and
`CROSSING_BYTES_IN` count the bytes it sent to and received from other
processes (an all_gather's padded payload once for each peer), and
`CROSSING_BYTES_IN_BY_DTYPE` the received shards' bytes by their dtype,
which tells a wire format's payload and scales from exact values.
"""

from __future__ import annotations

import contextlib
import socket
import time
from typing import Any, Sequence

import torch

# exchanges of shard data through the group by this process, and the wall
# seconds they took (host copies and the transport, loopback on one host)
CROSSINGS = 0
CROSSING_S = 0.0
CROSSING_MIN_S = float("inf")  # the quickest, where no peer kept it waiting
CROSSING_BYTES_OUT = 0
CROSSING_BYTES_IN = 0
CROSSING_BYTES_IN_BY_DTYPE: dict[str, int] = {}
# each process's card identity, in process order, exchanged at init
_PROCESS_CARDS: list[str] = []
_STARTUP_S: list[float] = []
# subgroups by their sorted process tuple (the whole world uses WORLD)
_GROUPS: dict[tuple[int, ...], Any] = {}


def _dist():
    return torch.distributed


def active() -> bool:
    """True inside a process group of more than one process."""
    dist = _dist()
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def process_index() -> int:
    return _dist().get_rank() if active() else 0


def process_count() -> int:
    return _dist().get_world_size() if active() else 1


def card_id(device: torch.device) -> str:
    """The physical identity of a device across processes: the host, and
    the card's UUID (its index where the UUID cannot be read), or the
    host's CPU. `cuda:0` of two processes on one machine is one card."""
    host = socket.gethostname()
    if device.type != "cuda":
        return f"{host}/cpu"
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return f"{host}/cuda/{uuid if uuid is not None else device.index}"


def process_cards() -> list[str]:
    """Each process's card identity (`card_id`), in process order."""
    return list(_PROCESS_CARDS)


def share_cards(local: str, startup_s: float | None = None) -> list[str]:
    """Every process's card identity, and its seconds from launch to the
    rendezvous where a launcher timed them, exchanged once after the
    rendezvous."""
    out: list[Any] = [None] * process_count()
    _dist().all_gather_object(out, (local, startup_s))
    _PROCESS_CARDS[:] = [card for card, _ in out]
    times = [t for _, t in out]
    _STARTUP_S[:] = times if None not in times else []
    return process_cards()


def startup_seconds() -> tuple[float, ...] | None:
    """Each process's seconds from launch to the rendezvous, or None."""
    return tuple(_STARTUP_S) if active() and _STARTUP_S else None


def ensure_group(processes: Sequence[int]) -> None:
    """Create the subgroup of `processes` where it is neither one process
    nor the whole world. Every process of the world must call this for
    the same sets in the same order (`torch.distributed.new_group`);
    `parallel/mesh.make_mesh` does, for every axis group of a mesh."""
    key = tuple(sorted(set(processes)))
    if len(key) < 2 or len(key) == process_count() or key in _GROUPS:
        return
    _GROUPS[key] = _dist().new_group(list(key), backend="gloo")


def _group(processes: Sequence[int]):
    key = tuple(sorted(set(processes)))
    if len(key) == process_count():
        return None  # the default group
    if key not in _GROUPS:
        raise RuntimeError(f"no process group over processes {key}: a mesh "
                           "that spans them must be made with make_mesh")
    return _GROUPS[key]


@contextlib.contextmanager
def _crossing():
    """Count one exchange of data and its seconds."""
    global CROSSINGS, CROSSING_S, CROSSING_MIN_S
    t0 = time.perf_counter()
    yield
    took = time.perf_counter() - t0
    CROSSING_S += took
    CROSSING_MIN_S = min(CROSSING_MIN_S, took)
    CROSSINGS += 1


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes as a flat uint8 tensor in host memory."""
    flat = t.detach().contiguous().reshape(-1)
    return flat.view(torch.uint8).cpu()


def _from_bytes(raw: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A host tensor of `like`'s shape and dtype holding `raw`."""
    return raw.clone().view(like.dtype).reshape(like.shape)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _count_bytes(out: int, received: Sequence[torch.Tensor] = (),
                 padding: int = 0) -> None:
    """Add `out` bytes sent, and the `received` tensors' bytes (plus
    `padding` bytes that carried no shard) to the bytes received."""
    global CROSSING_BYTES_OUT, CROSSING_BYTES_IN
    CROSSING_BYTES_OUT += out
    CROSSING_BYTES_IN += padding
    for t in received:
        n = nbytes(t)
        CROSSING_BYTES_IN += n
        key = str(t.dtype).removeprefix("torch.")
        CROSSING_BYTES_IN_BY_DTYPE[key] = CROSSING_BYTES_IN_BY_DTYPE.get(key, 0) + n


def all_gather_shards(owners: Sequence[int], shards: Sequence[torch.Tensor],
                      processes: Sequence[int] | None = None) -> list[torch.Tensor]:
    """Every shard of `shards` (one a rank, `owners[i]` the process that
    holds rank i) real on this process: local ones as they are, remote
    placeholders replaced by host tensors with the owner's bytes. One
    all_gather of uint8 payloads over the owners' processes; each payload
    is its process's shards in rank order, padded to the longest, whose
    length every process knows from the placeholders. `processes` (default:
    the owners) are the processes that take part."""
    procs = sorted(set(owners) | set(processes or ()))
    me = process_index()
    sizes = {p: sum(nbytes(s) for o, s in zip(owners, shards) if o == p)
             for p in procs}
    longest = max(max(sizes.values()), 1)
    payload = torch.zeros(longest, dtype=torch.uint8)
    at = 0
    for o, s in zip(owners, shards):
        if o == me:
            n = nbytes(s)
            payload[at:at + n] = _bytes(s)
            at += n
    got = [torch.empty(longest, dtype=torch.uint8) for _ in procs]
    with _crossing():
        _dist().all_gather(got, payload, group=_group(procs))
    by_proc = dict(zip(procs, got))
    offset = dict.fromkeys(procs, 0)
    out = []
    for o, s in zip(owners, shards):
        n = nbytes(s)
        if o == me:
            out.append(s)
        else:
            out.append(_from_bytes(by_proc[o][offset[o]:offset[o] + n], s))
        offset[o] += n
    peers = [p for p in procs if p != me]
    _count_bytes(longest * len(peers),
                 [s for o, s in zip(owners, shards) if o != me],
                 sum(longest - sizes[p] for p in peers))
    return out


def exchange_pairs(moves: Sequence[tuple[int, int, torch.Tensor]]) -> dict[int, torch.Tensor]:
    """Point-to-point moves between processes: each (src process, dst
    process, tensor) sends the tensor's bytes where this process is src
    and receives a host tensor of its shape and dtype where it is dst
    (the tensor is then a placeholder). All are posted at once, tagged by
    their position, and waited for; returns what arrived, by position."""
    dist = _dist()
    me = process_index()
    mine = [(tag, src, dst, t) for tag, (src, dst, t) in enumerate(moves)
            if (src == me) != (dst == me)]
    if not mine:
        return {}
    works, arrived, keep = [], {}, []
    with _crossing():
        for tag, src, dst, t in mine:
            if src == me:
                buf = _bytes(t)
                keep.append(buf)
                works.append(dist.isend(buf, dst=dst, tag=tag))
            else:
                buf = torch.empty(nbytes(t), dtype=torch.uint8)
                arrived[tag] = (buf, t)
                works.append(dist.irecv(buf, src=src, tag=tag))
        for w in works:
            w.wait()
    _count_bytes(sum(nbytes(t) for _, src, _, t in mine if src == me),
                 [like for _, like in arrived.values()])
    return {tag: _from_bytes(buf, like) for tag, (buf, like) in arrived.items()}


def send_tensor(t: torch.Tensor, dst: int) -> None:
    """Blocking send of a tensor's bytes to process `dst`."""
    with _crossing():
        _dist().send(_bytes(t), dst=dst)
    _count_bytes(nbytes(t))


def recv_tensor(like: torch.Tensor, src: int) -> torch.Tensor:
    """Blocking receive from process `src` of a tensor shaped as `like`,
    into host memory."""
    buf = torch.empty(nbytes(like), dtype=torch.uint8)
    with _crossing():
        _dist().recv(buf, src=src)
    _count_bytes(0, [like])
    return _from_bytes(buf, like)


def share_objects(obj: Any) -> list[Any]:
    """Every process's `obj` (small control values), in process order."""
    out: list[Any] = [None] * process_count()
    _dist().all_gather_object(out, obj)
    return out


def agree(value: float) -> float:
    """Process 0's reading of a clock-derived value, on every process
    (≙ JAX `utils/timing.py _agree`): a decision taken from it (how many
    calls a timed window makes) is then the same everywhere, and every
    process dispatches the same collectives."""
    if not active():
        return value
    t = torch.tensor([value], dtype=torch.float64)
    _dist().broadcast(t, src=0)
    return float(t.item())


def all_true(flag: bool) -> bool:
    """The AND of a verdict across processes (≙ JAX
    `parallel/collectives.py:650-660`)."""
    if not active():
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    _dist().all_reduce(t, op=_dist().ReduceOp.MIN)
    return bool(t.item())


def barrier() -> None:
    """Every process waits for the others (no-op in one process)."""
    if active():
        _dist().barrier()


def crossing_counts() -> dict:
    """This process's crossings: their number, seconds (all, and the
    quickest) and bytes sent and received (`counts.write_counts` writes
    them beside the kernels' launches)."""
    return {"crossings": CROSSINGS, "crossing_s": CROSSING_S,
            "crossing_min_s": CROSSING_MIN_S if CROSSINGS else None,
            "crossing_bytes_out": CROSSING_BYTES_OUT,
            "crossing_bytes_in": CROSSING_BYTES_IN,
            "crossing_bytes_in_by_dtype": dict(CROSSING_BYTES_IN_BY_DTYPE)}
