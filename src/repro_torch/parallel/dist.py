"""Ranks, their mesh and the transport between them (the torch form of the
mesh half of ``repro/parallel/jaxcompat.py`` and of the JAX launcher's
``_ensure_host_devices``).

A run of ``dp`` data-parallel replicas of ``S`` pipeline stages (or of a
context ring or a tensor-MP group of ``S`` ranks) is ``dp * S`` ``torch.distributed`` ranks,
rank = d * S + s in the JAX mesh's ``("data", "model")`` order.  ``RankMesh`` holds the axis sizes, this rank's
coordinates and the process group of each axis this rank lies on; every
rank creates every group, in one fixed order.

``RankMesh.ring`` gives a rank's neighbours on an axis (the context ring's
and the tensor-MP rings'), ``message_tag`` the tag of each of the context
ring's messages, ``tp_message_tag`` that of each tensor-MP ring message and
``rnn_message_tag`` that of each per-step message of a tensor-MP recurrence,
each in a range of its own.

The transport is chosen by a stated rule before ``init_process_group`` and
never changed after (``choose_transport``):

- ``nccl`` when every rank has a card of its own;
- ``gloo`` on the CPU;
- ``gloo`` when ranks share a card.  NCCL refuses two ranks on one device,
  and gloo carries CPU tensors only, so the helpers below copy CUDA tensors
  through host buffers: the ranks compute on the card and their messages
  cross host memory.  This is the torch form of JAX's forced host devices,
  and step times of such ranks are not multi-card step times.

``spawn_ranks(fn, world, device)`` starts the ranks as fresh processes
(``spawn``), meets them through a file in a new temporary directory (no TCP
port: concurrent test workers would collide, and the card's machine has no
network), calls ``fn(mesh, *args)`` in each and returns each rank's result.
An exception in any rank fails the whole run with that rank's traceback; a
rank that exits without one (``os._exit``, as an injected ``kill`` fault
does) fails it with ``RankExitError`` carrying the exit code.  The groups
carry a ``timeout`` so that no rank waits forever on a dead peer.

``gather_tree`` brings every rank's tree of an axis group to the group's
first rank, and ``barrier`` waits for every rank: what a checkpoint of a
run on ranks needs (``train.steps.checkpoint_saver``).
``all_gather_objects`` gives every rank of a group each rank's small host
record (the serving router's, once a tick).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
import traceback
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 900.0


class RankExitError(RuntimeError):
    """A rank's process ended with ``exit_code`` and no Python error."""

    def __init__(self, rank: int, exit_code: int, world: int):
        super().__init__(f"rank {rank} of {world} exited with code {exit_code}")
        self.rank, self.exit_code = rank, exit_code


@dataclasses.dataclass(frozen=True)
class Transport:
    """The backend of a run and how its ranks sit on the cards."""
    backend: str      # "nccl" | "gloo"
    cards: int        # cards the ranks compute on (0 on the CPU)
    placement: str    # "own" (a card a rank) | "shared" | "cpu"

    def device(self, rank: int) -> torch.device:
        if self.placement == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", rank % self.cards)

    def describe(self, world: int) -> str:
        return (f"[dist] backend={self.backend} ranks={world} cards={self.cards} "
                f"({self.placement})")


def choose_transport(device_type: str, world: int, cards: int) -> Transport:
    """The transport rule: nccl when each of ``world`` ranks has one of the
    ``cards`` to itself, gloo on the CPU, and gloo with host-staged messages
    when ranks share cards.  Raises when CUDA is asked for and no card is
    visible (never falls back to the CPU)."""
    if device_type == "cpu":
        return Transport("gloo", 0, "cpu")
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    if cards < 1:
        raise RuntimeError("ranks on cuda requested but no CUDA card is visible")
    if cards >= world:
        return Transport("nccl", world, "own")
    return Transport("gloo", cards, "shared")


@dataclasses.dataclass
class RankMesh:
    """This rank's place in the ``{"data": dp, "model": S}`` mesh."""
    shape: Dict[str, int]
    rank: int
    transport: Transport
    device: torch.device
    groups: Dict[str, Optional[dist.ProcessGroup]] = dataclasses.field(repr=False)

    @property
    def world(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape["model"]

    def rank_of(self, data: int, model: int) -> int:
        return data * self.shape["model"] + model % self.shape["model"]

    def size(self, axis: str) -> int:
        return len(self.members(axis))

    def ring(self, axis: str) -> Tuple[int, int, int, int]:
        """(j, m, next, prev): this rank's place j on the ring of the m ranks
        of its ``axis`` group, and the ranks of places j + 1 and j - 1."""
        ranks = self.members(axis)
        m, j = len(ranks), ranks.index(self.rank)
        return j, m, ranks[(j + 1) % m], ranks[(j - 1) % m]

    def members(self, axis: str) -> List[int]:
        """The ranks of this rank's group on ``axis`` ("data", "model", "ends":
        the first and last stage of this replica, or None for all ranks)."""
        dp, s = self.shape["data"], self.shape["model"]
        d, m = self.data_index, self.model_index
        if axis is None:
            return list(range(self.world))
        if axis == "model":
            return [d * s + j for j in range(s)]
        if axis == "data":
            return [i * s + m for i in range(dp)]
        if axis == "ends":
            return sorted({d * s, d * s + s - 1})
        raise KeyError(axis)


def _group_specs(dp: int, stages: int) -> List[Tuple[str, List[int]]]:
    """Every group of the mesh, in the one order all ranks create them."""
    specs = [("model", [d * stages + j for j in range(stages)]) for d in range(dp)]
    specs += [("data", [i * stages + m for i in range(dp)]) for m in range(stages)]
    specs += [("ends", [d * stages, d * stages + stages - 1]) for d in range(dp)]
    return [(a, r) for a, r in specs if len(r) > 1 and len(set(r)) == len(r)]


def init_mesh(rank: int, dp: int, stages: int, transport: Transport, init_method: str,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> RankMesh:
    """``init_process_group`` on ``transport`` and every axis group."""
    device = transport.device(rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(transport.backend, init_method=init_method, rank=rank,
                            world_size=dp * stages, timeout=timeout)
    groups: Dict[str, Optional[dist.ProcessGroup]] = {a: None for a in ("data", "model",
                                                                          "ends")}
    for axis, ranks in _group_specs(dp, stages):
        g = dist.new_group(ranks, timeout=timeout)
        if rank in ranks and groups[axis] is None:
            groups[axis] = g
    mesh = RankMesh({"data": dp, "model": stages}, rank, transport, device, groups)
    # one collective over all ranks first: NCCL leaves a batch_isend_irecv
    # undefined when it is a group's first call and not every rank is in it
    all_reduce(mesh, torch.zeros(1, device=device))
    return mesh


# ---------------------------------------------------------------------------
# collectives and messages (host-staged where the transport says so)
# ---------------------------------------------------------------------------

def _wire(mesh: RankMesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` on the device the backend carries: the CPU for gloo, the rank's
    card for nccl.  Returns ``t`` itself where it already lies there."""
    want = mesh.device if mesh.transport.backend == "nccl" else torch.device("cpu")
    return t if t.device == want else t.to(want)


def _group(mesh: RankMesh, axis: Optional[str]):
    return None if axis is None else mesh.groups[axis]


def all_reduce(mesh: RankMesh, t: torch.Tensor, axis: Optional[str] = None,
               op: str = "sum") -> torch.Tensor:
    """Sum ``t`` in place over the ranks of ``axis`` (all ranks for None), or
    take the elementwise max with ``op="max"``."""
    if mesh.size(axis) == 1:
        return t
    w = _wire(mesh, t)
    dist.all_reduce(w, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                    group=_group(mesh, axis))
    if w is not t:
        t.copy_(w)
    return t


def broadcast(mesh: RankMesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``t`` of the first rank of this rank's ``axis`` group, written in
    place on every rank of the group."""
    ranks = mesh.members(axis)
    if len(ranks) == 1:
        return t
    w = _wire(mesh, t)
    dist.broadcast(w, src=ranks[0], group=_group(mesh, axis))
    if w is not t:
        t.copy_(w)
    return t


def reduce_scatter(mesh: RankMesh, out: torch.Tensor, inp: torch.Tensor, axis: str):
    """``out`` = this rank's 1/n part of the sum of ``inp`` over ``axis``."""
    if mesh.size(axis) == 1:
        return out.copy_(inp)
    wo, wi = _wire(mesh, out), _wire(mesh, inp)
    with warnings.catch_warnings():   # the torch 2.11 names, deprecated later
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(wo, wi, group=_group(mesh, axis))
    if wo is not out:
        out.copy_(wo)
    return out


def all_gather(mesh: RankMesh, out: torch.Tensor, inp: torch.Tensor, axis: str):
    """``out`` = the ``inp`` of every rank of ``axis``, concatenated."""
    if mesh.size(axis) == 1:
        return out.copy_(inp)
    wo, wi = _wire(mesh, out), _wire(mesh, inp)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(wo, wi, group=_group(mesh, axis))
    if wo is not out:
        out.copy_(wo)
    return out


def all_gather_objects(mesh: RankMesh, obj, axis: Optional[str] = None) -> List:
    """The picklable ``obj`` of every rank of ``axis`` (all ranks for None), in
    group order, on every rank of the group: each pickled to uint8, the
    lengths gathered, each padded to the longest, then gathered."""
    ranks = mesh.members(axis)
    if len(ranks) == 1:
        return [obj]
    data = pickle.dumps(obj)
    lens = torch.empty(len(ranks), dtype=torch.int64)
    all_gather(mesh, lens, torch.tensor([len(data)], dtype=torch.int64), axis)
    width = int(lens.max())
    mine = torch.zeros(width, dtype=torch.uint8)
    mine[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    out = torch.empty(len(ranks) * width, dtype=torch.uint8)
    all_gather(mesh, out, mine, axis)
    rows = out.view(len(ranks), width).numpy()
    return [pickle.loads(rows[i, :int(n)].tobytes()) for i, n in enumerate(lens.tolist())]


def exchange(mesh: RankMesh, sends: Sequence[Tuple[torch.Tensor, int, int]],
             recvs: Sequence[Tuple[torch.Size, torch.dtype, int, int]], *,
             to_device: bool = True) -> List[torch.Tensor]:
    """One ``batch_isend_irecv`` of point-to-point messages: ``sends`` are
    (tensor, peer rank, tag), ``recvs`` (shape, dtype, peer rank, tag).
    Every op is posted before any is waited on, so two ranks that list each
    other's messages in the same order cannot deadlock.  Returns the
    received tensors on this rank's device (``to_device``) or where the
    transport carried them."""
    if not sends and not recvs:
        return []
    ops, bufs = [], []
    for t, peer, tag in sends:
        ops.append(dist.P2POp(dist.isend, _wire(mesh, t.contiguous()), peer, tag=tag))
    wire_dev = mesh.device if mesh.transport.backend == "nccl" else torch.device("cpu")
    for shape, dtype, peer, tag in recvs:
        buf = torch.empty(shape, dtype=dtype, device=wire_dev)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [b.to(mesh.device) for b in bufs] if to_device else bufs


def barrier(mesh: RankMesh) -> None:
    """Return once every rank has called it."""
    all_reduce(mesh, torch.zeros(1, device=mesh.device))


def gather_tree(mesh: RankMesh, tree, axis: str):
    """Every rank of this rank's ``axis`` group sends its ``tree`` (nested
    dicts, lists and tuples of tensors; the ranks' trees may differ) to the
    group's first rank, which returns them in group order; the others
    return None.  Only the ranks of one group call it together.  The
    received leaves lie where the transport carries them: on the CPU for
    gloo, on the rank's card for nccl."""
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    ranks = mesh.members(axis)
    if len(ranks) == 1:
        return [tree]
    root = ranks[0]
    leaves = tree_leaves(tree)
    meta = (tree_map(lambda _: None, tree), [(tuple(t.shape), t.dtype) for t in leaves])
    metas = [None] * len(ranks) if mesh.rank == root else None
    dist.gather_object(meta, metas, dst=root, group=_group(mesh, axis))
    if mesh.rank != root:
        exchange(mesh, [(t, root, GATHER_TAG_BASE + i) for i, t in enumerate(leaves)], [])
        return None
    recvs = [(torch.Size(shape), dtype, peer, GATHER_TAG_BASE + i)
             for peer, (_, specs) in zip(ranks[1:], metas[1:])
             for i, (shape, dtype) in enumerate(specs)]
    got = iter(exchange(mesh, [], recvs, to_device=False))
    return [tree] + [tree_unflatten(skeleton, [next(got) for _ in specs])
                     for skeleton, specs in metas[1:]]


MESSAGE_PARTS, MESSAGE_HOPS = 4, 64
# the tensor-MP rings' tags start here, above every context-ring tag
TP_TAG_BASE = 1 << 22
# the tensor-MP recurrences' per-step messages, above every ring's
RNN_TAG_BASE = 3 << 28
# gather_tree's messages: one tag a leaf, above every ring's
GATHER_TAG_BASE = 1 << 30
TP_OPS, TP_PHASES, TP_CHUNKS = 8, 3, 16
# the tensor-MP ops of a layer: the qkv gather ring, the wo reduce ring, the
# MLP's gather and reduce rings, and ``collectives.ring_all_gather``
TP_OP_GATHER = 4
RNN_KINDS, RNN_STEPS = 3, 1 << 16


def message_tag(layer: int, hop: int, backward: bool, part: int = 0) -> int:
    """The tag of one ring message: distinct for every (layer, hop,
    direction, part), so a backward that autograd runs in its own order can
    never pair one layer's message with another's."""
    if not (0 <= hop < MESSAGE_HOPS and 0 <= part < MESSAGE_PARTS
            and 0 <= layer < TP_TAG_BASE // (2 * MESSAGE_HOPS * MESSAGE_PARTS)):
        raise ValueError(f"no message tag for layer {layer}, hop {hop}, part {part}")
    return ((layer * 2 + int(backward)) * MESSAGE_HOPS + hop) * MESSAGE_PARTS + part


def tp_message_tag(layer: int, op: int, phase: int, hop: int, chunk: int) -> int:
    """The tag of one message of a tensor-MP ring (``parallel.collectives``):
    distinct for every (layer, op, phase, hop, chunk) and from every
    ``message_tag``.  ``op`` numbers the rings of a layer, ``phase`` is 0 for
    the forward ring and 1 or 2 for the backward's two rings."""
    span = TP_OPS * TP_PHASES * MESSAGE_HOPS * TP_CHUNKS
    if not (0 <= layer < (RNN_TAG_BASE - TP_TAG_BASE) // span and 0 <= op < TP_OPS
            and 0 <= phase < TP_PHASES and 0 <= hop < MESSAGE_HOPS
            and 0 <= chunk < TP_CHUNKS):
        raise ValueError(f"no tensor-MP message tag for layer {layer}, op {op}, phase "
                         f"{phase}, hop {hop}, chunk {chunk}")
    return TP_TAG_BASE + ((((layer * TP_OPS + op) * TP_PHASES + phase) * MESSAGE_HOPS + hop)
                          * TP_CHUNKS + chunk)


def rnn_message_tag(layer: int, step: int, kind: int) -> int:
    """The tag of one per-step message of a tensor-MP recurrence
    (``models.lstm``): distinct for every (layer, step, kind) and from every
    ring's tag.  ``kind`` 0 is the forward's h at ``step``, 1 the backward's
    dh, 2 the backward's input gradient (once a layer, step 0)."""
    if not (0 <= layer < (GATHER_TAG_BASE - RNN_TAG_BASE) // (RNN_KINDS * RNN_STEPS)
            and 0 <= step < RNN_STEPS and 0 <= kind < RNN_KINDS):
        raise ValueError(f"no recurrence message tag for layer {layer}, step {step}, "
                         f"kind {kind}")
    return RNN_TAG_BASE + (layer * RNN_KINDS + kind) * RNN_STEPS + step


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------

def _rank_entry(rank: int, dp: int, stages: int, transport: Transport, rundir: str,
                fn: Callable, args: tuple, timeout_s: float, threads: int) -> None:
    if transport.placement == "cpu":
        torch.set_num_threads(threads)
    mesh = init_mesh(rank, dp, stages, transport, f"file://{rundir}/rendezvous", timeout_s)
    if rank == 0:
        print(transport.describe(mesh.world), flush=True)
    try:
        result = fn(mesh, *args)
        torch.save(result, Path(rundir) / f"result_{rank}.pt")
    except BaseException:
        # when this rank's failure brings its peers down, the run reports the
        # rank that failed first, not a peer's broken connection
        (Path(rundir) / f"error_{rank}.txt").write_text(
            f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, device="cpu", args: tuple = (), *,
                stages: int = 1, timeout_s: float = DEFAULT_TIMEOUT_S,
                threads: Optional[int] = None) -> List:
    """Run ``fn(mesh, *args)`` on ``world`` = dp * ``stages`` fresh ranks and
    return their results in rank order.  ``fn`` and ``args`` are pickled (a
    module-level function); each result is saved by its rank and loaded
    here.  A rank that raises fails the call with a RuntimeError carrying
    the traceback of the rank that failed first, a rank that exits without
    an error with ``RankExitError`` (its exit code), and the others are
    stopped.  Rank 0 prints the transport (``Transport.describe``).
    ``threads`` caps each CPU rank's intra-op threads (default: the host's
    cores shared out, at least one)."""
    if world % stages:
        raise ValueError(f"{world} ranks do not form replicas of {stages} stages")
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    transport = choose_transport(dev.type, world, cards)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as rundir:
        try:
            torch.multiprocessing.start_processes(
                _rank_entry, args=(world // stages, stages, transport, rundir, fn,
                                   tuple(args), timeout_s, threads),
                nprocs=world, join=True, start_method="spawn")
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            failed = []
            for path in Path(rundir).glob("error_*.txt"):
                at, text = path.read_text().split("\n", 1)
                failed.append((float(at), int(path.stem.split("_")[1]), text))
            if not failed:
                if isinstance(e, torch.multiprocessing.ProcessExitedException):
                    raise RankExitError(e.error_index, e.exit_code, world) from e
                raise
            _, rank, text = min(failed)
            raise RuntimeError(f"rank {rank} of {world} failed first:\n{text}") from e
        return [torch.load(Path(rundir) / f"result_{r}.pt", weights_only=False)
                for r in range(world)]

