"""The replica group: one process per NoLoCo replica, or per part of one,
over ``torch.distributed``.

The port of ``repro/launch/mesh.py``.  Where the JAX package lays its
replicas on the ``data`` axis of a device mesh (and each replica's shards
on its ``model`` axis) and moves the outer payload with ``ppermute``
inside ``shard_map``, the port runs one process (a rank) per replica, or
per shard of one, each on its own device, and moves the payload with
``torch.distributed``.

:func:`init_replica_group` joins the process group and returns a
:class:`ReplicaGroup`: the rank, the world, the rank's device and the
backend, and the only calls the runtime makes across ranks, each counted
in ``calls``.  The backend is the caller's choice and nothing switches it:

  * ``nccl`` moves CUDA tensors between cards, one rank per card: more
    ranks than cards raises, naming ``--backend gloo``;
  * ``gloo`` moves host tensors.  On CUDA every payload is staged through
    pinned host buffers (the slow link of the paper's setting), so ranks
    can share one card.

With a model axis (``tp`` ranks) and, under the ``fsdp_hybrid`` plan, a
data axis (``fsdp`` ranks) inside each replica, the world is ``replicas ×
fsdp × tp`` ranks, laid out as the reference's ``(pod, data, model)`` mesh
orders its devices: rank ``r`` holds model index ``r % tp`` and data index
``(r // tp) % fsdp`` of replica ``r // (fsdp · tp)``.  Each rank then has
up to three subgroups: the ranks of its replica with its data index (its
model axis, a :class:`ModelAxis`: the model-axis collectives of
:class:`~repro_torch.parallel.sharding.ShardCtx`), the ranks of its
replica with its model index (its data axis, another :class:`ModelAxis`:
ZeRO-3's gathers and the data-axis sums) and the ranks of the other
replicas at its (data, model) place (the replica axis: the exchange,
DiLoCo's all-reduce, the checkpoint's gathers).  Every rank creates every
subgroup, in one fixed order, as ``torch.distributed.new_group`` requires.
The replica-axis calls of :class:`ReplicaGroup` take replica indices:
``exchange(dst, src)`` moves a rank's shards to the rank of replica
``dst`` that holds the same data and model indices.

Besides the blocking exchange, a stream's φ′ pre-send is posted without a
wait (:meth:`ReplicaGroup.exchange_start`, a :class:`PendingExchange`
whose ``wait()`` gives the received tensors), so that it is in flight
during the inner steps that follow; each stream's pre-send has tags and
pinned buffers of its own.  A rejoin's warm start is a one-way
:meth:`~ReplicaGroup.send` / :meth:`~ReplicaGroup.recv`.

:func:`spawn` starts ``world`` ranks with ``torch.multiprocessing`` (start
method ``spawn``) and a ``file://`` rendezvous in a temporary directory,
so no network port is needed, runs ``fn(group, *args)`` on each and
returns their results in rank order.  On CUDA the parent builds every
kernel first, so the ranks load the libraries instead of each running
``nvcc``.  Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` set) a process
joins with :func:`init_replica_group` and ``init_method="env://"``
instead.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["BACKENDS", "ReplicaGroup", "ModelAxis", "PendingExchange", "PhaseClock",
           "init_replica_group",
           "check_backend", "spawn", "from_env"]

BACKENDS = ("gloo", "nccl")


class PhaseClock:
    """Wall time by phase of one call, each phase ended by :meth:`mark`
    after the device has finished its work (a synchronize on CUDA): the
    outer step's encode / D2H / wire / H2D / decode / update split.  Set
    as :attr:`ReplicaGroup.clock` by a caller that times a step; without
    one the runtime's path never synchronizes."""

    def __init__(self, device: torch.device):
        self.device = device
        self.ms: dict[str, float] = collections.defaultdict(float)
        self._last = None

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def start(self) -> None:
        self._last = self._now()

    def mark(self, phase: str) -> None:
        now = self._now()
        self.ms[phase] += (now - self._last) * 1e3
        self._last = now


# message tags: each channel of a rank pair owns a range, its buffers counted up from the base
_TAG_STRIDE = 1 << 12


def _tag_base(channel) -> int:
    """The first tag of ``channel``: the blocking exchange 0, the one-way
    send 1, stream k's pre-send k + 2, each times the stride."""
    if channel == "exchange":
        return 0
    if channel == "oneway":
        return _TAG_STRIDE
    return (channel[1] + 2) * _TAG_STRIDE


class PendingExchange:
    """A posted send/receive (:meth:`ReplicaGroup.exchange_start`).
    :meth:`wait` completes it once and returns the received tensors on the
    rank's device (staged: copied back from the pinned buffers, the H2D,
    only after the wire is done); later calls return the same tensors.
    The sent tensors are held until then."""

    def __init__(self, group: "ReplicaGroup", works, send: list[torch.Tensor],
                 recv: list[torch.Tensor], prefix: str):
        self.group, self._works, self._prefix = group, works or [], prefix
        self._send, self._recv = send, recv
        self._out: list[torch.Tensor] | None = None

    def wait(self) -> list[torch.Tensor]:
        if self._out is None:
            for work in self._works:
                work.wait()
            self._works = self._send = []
            self.group.mark(self._prefix + "wire")
            out = self._recv
            if self.group.staged and out:
                out = [h.to(self.group.device, copy=True) for h in out]
                self.group.mark(self._prefix + "h2d")
            self._out, self._recv = out, None
        return self._out


class ModelAxis:
    """An axis inside one replica (the model axis, or the data axis under
    ``fsdp_hybrid``): its collectives over the ``torch.distributed``
    subgroup of its ranks, each counted apart from the replica
    axis's calls in :attr:`calls` / :attr:`sent_bytes` (by kind:
    ``all_reduce``, ``all_max``, ``all_gather``, ``reduce_scatter``,
    ``all_to_all``; the bytes this rank hands to the call).  Staged (gloo
    with CUDA tensors) every call goes through pinned host buffers, as the
    replica exchange does.  Each call returns a new tensor on the rank's
    device."""

    def __init__(self, pg, ranks: list[int], index: int, device: torch.device, backend: str):
        self.pg, self.ranks, self.index = pg, list(ranks), index
        self.size = len(ranks)
        self.device, self.backend = device, backend
        self.calls: collections.Counter = collections.Counter()
        self.sent_bytes: collections.Counter = collections.Counter()

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _count(self, kind: str, x: torch.Tensor) -> None:
        self.calls[kind] += 1
        self.sent_bytes[kind] += x.numel() * x.element_size()

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return x
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        return buf

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device, copy=True) if self.staged else x

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (``op="sum"``) or max (``"max"``) of ``x`` over the axis."""
        self._count("all_reduce" if op == "sum" else "all_max", x)
        buf = self._host(x.contiguous()) if self.staged else x.contiguous().clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=self.pg)
        return self._back(buf)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order (the
        reference's tiled ``all_gather``)."""
        self._count("all_gather", x)
        lead = self._host(x.movedim(dim, 0).contiguous())
        out = torch.empty((self.size * lead.shape[0],) + lead.shape[1:], dtype=lead.dtype,
                          device=lead.device, pin_memory=self.staged)
        dist.all_gather_into_tensor(out, lead, group=self.pg)
        return self._back(out).movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` of the sum over the axis (the
        reference's tiled ``psum_scatter``)."""
        self._count("reduce_scatter", x)
        lead = self._host(x.movedim(dim, 0).contiguous())
        out = torch.empty((lead.shape[0] // self.size,) + lead.shape[1:], dtype=lead.dtype,
                          device=lead.device, pin_memory=self.staged)
        dist.reduce_scatter_tensor(out, lead, group=self.pg)
        return self._back(out).movedim(0, dim)

    def all_to_all(self, x: torch.Tensor, split: int, concat: int) -> torch.Tensor:
        """The reference's tiled ``all_to_all``: ``x`` cut into ``size``
        blocks along ``split``, block j sent to rank j, the blocks received
        concatenated along ``concat`` in rank order."""
        self._count("all_to_all", x)
        lead = self._host(x.movedim(split, 0).contiguous())
        out = torch.empty(lead.shape, dtype=lead.dtype, device=lead.device,
                          pin_memory=self.staged)
        dist.all_to_all_single(out, lead, group=self.pg)
        blocks = self._back(out).chunk(self.size, 0)
        return torch.cat([b.movedim(0, split) for b in blocks], dim=concat)


@dataclasses.dataclass
class ReplicaGroup:
    """One rank's view of the replica group and its cross-rank calls.

    ``rank`` / ``world`` are global; with a model axis (``tp`` > 1) or a
    data axis (``fsdp`` > 1) the rank holds model index
    :attr:`model_index` and data index :attr:`data_index` of replica
    :attr:`replica` of :attr:`replicas`, ``model`` and ``data`` are its
    :class:`ModelAxis` objects (None for an axis of one rank) and
    ``replica_pg`` the subgroup of the ranks at its (data, model) place in
    every replica, over which the replica-axis calls below run (without
    either axis: the world).

    ``calls`` counts each replica-axis call by kind (``p2p``: one batched send/receive,
    ``presend``: one posted without a wait, ``send`` / ``recv``: one way,
    ``all_reduce``, ``gather``, ``broadcast``, ``barrier``) and ``sent_bytes``
    the bytes this rank handed to sends (by the same kinds) and ``all_reduce``.
    ``clock``, when a caller sets one, splits the exchanges that follow
    into their phases (:meth:`mark`)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    calls: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    sent_bytes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    clock: PhaseClock | None = None
    tp: int = 1
    model: ModelAxis | None = None
    replica_pg: Any = None
    fsdp: int = 1
    data: ModelAxis | None = None
    _pinned: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def replica(self) -> int:
        """The replica this rank holds (a part of, with a model or data axis)."""
        return self.rank // (self.fsdp * self.tp)

    @property
    def replicas(self) -> int:
        return self.world // (self.fsdp * self.tp)

    @property
    def model_index(self) -> int:
        """This rank's position on its replica's model axis."""
        return self.rank % self.tp

    @property
    def data_index(self) -> int:
        """This rank's position on its replica's data axis."""
        return (self.rank // self.tp) % self.fsdp

    def rank_of(self, replica: int) -> int:
        """The global rank of ``replica`` at this rank's (data, model) place."""
        return (replica * self.fsdp + self.data_index) * self.tp + self.model_index

    @property
    def staged(self) -> bool:
        """Whether payloads cross through host buffers (gloo with CUDA)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def mark(self, phase: str) -> None:
        """End ``phase`` on :attr:`clock`, if one is set."""
        if self.clock is not None:
            self.clock.mark(phase)

    def _host(self, key, like: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer shaped like ``like``, kept per ``key``."""
        buf = self._pinned.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _post(self, send: Sequence[torch.Tensor], dst: int | None, like: Sequence[torch.Tensor],
              src: int | None, channel, kind: str, prefix: str = "") -> "PendingExchange":
        """Post one ``batch_isend_irecv``: ``send`` to ``dst`` and tensors
        shaped like ``like`` from ``src`` (either side may be empty).  Each
        message's tag is its channel's base plus its buffer index, and a
        staged channel keeps pinned buffers of its own, so that a posted
        exchange of one channel never shares a tag or a buffer with another
        in flight.  Staged: the sends are copied to pinned host memory
        (D2H, complete before the call returns) before they are posted."""
        self.calls[kind] += 1
        self.sent_bytes[kind] += sum(t.numel() * t.element_size() for t in send)
        base = _tag_base(channel)
        if self.staged:
            host = []
            for i, t in enumerate(send):
                buf = self._host((channel, "send", i), t)
                buf.copy_(t)
                host.append(buf)
            send = host
            recv = [self._host((channel, "recv", i), t) for i, t in enumerate(like)]
            self.mark(prefix + "d2h")
        else:
            send = list(send)
            recv = [torch.empty_like(t) for t in like]
        dst = None if dst is None else self.rank_of(dst)
        src = None if src is None else self.rank_of(src)
        ops = [dist.P2POp(dist.isend, t, dst, tag=base + i) for i, t in enumerate(send)]
        ops += [dist.P2POp(dist.irecv, t, src, tag=base + i) for i, t in enumerate(recv)]
        return PendingExchange(self, dist.batch_isend_irecv(ops), send, recv, prefix)

    def exchange(self, tensors: Sequence[torch.Tensor], dst: int, src: int) -> list[torch.Tensor]:
        """Send ``tensors`` to replica ``dst`` and receive the same shapes from
        replica ``src`` (the ranks of those replicas that hold this rank's
        model index), all in one ``batch_isend_irecv``.  Staged: each
        tensor is copied into a pinned host buffer first (D2H) and each
        received one back to the device (H2D).  No tensors: no call."""
        if not tensors:
            return []
        return self._post(tensors, dst, tensors, src, "exchange", "p2p").wait()

    def exchange_start(self, tensors: Sequence[torch.Tensor], dst: int, src: int, *,
                       stream: int = 0) -> "PendingExchange":
        """:meth:`exchange` without the wait: posts the send/receive of
        stream ``stream``'s pre-send (counted as ``presend``) and returns
        at once; ``wait()`` on the result gives the received tensors.  The
        caller keeps ``tensors`` unchanged until then.  Every rank must post
        its pre-sends in the same order, which the shared schedule gives."""
        if not tensors:
            return PendingExchange(self, [], [], [], "pre_")
        pending = self._post(tensors, dst, tensors, src, ("presend", stream), "presend", "pre_")
        self.mark("pre_post")
        return pending

    def send(self, tensors: Sequence[torch.Tensor], dst: int) -> None:
        """One-way: ``tensors`` to rank ``dst`` in one ``batch_isend_irecv``
        (counted as ``send``), which :meth:`recv` on ``dst`` meets."""
        if tensors:
            self._post(tensors, dst, [], None, "oneway", "send").wait()

    def recv(self, like: Sequence[torch.Tensor], src: int) -> list[torch.Tensor]:
        """One-way: tensors shaped like ``like`` from rank ``src`` (counted
        as ``recv``), on this rank's device."""
        if not like:
            return []
        return self._post([], None, like, src, "oneway", "recv").wait()

    def all_reduce_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum of ``tensor`` over the replica axis (a new tensor on
        this rank's device; staged through a pinned host buffer)."""
        self.calls["all_reduce"] += 1
        self.sent_bytes["all_reduce"] += tensor.numel() * tensor.element_size()
        if self.staged:
            host = self._host(("reduce", 0), tensor)
            host.copy_(tensor)
            self.mark("d2h")
            dist.all_reduce(host, group=self.replica_pg)
            self.mark("wire")
            out = host.to(self.device, copy=True)
            self.mark("h2d")
            return out
        out = tensor.clone()
        dist.all_reduce(out, group=self.replica_pg)
        self.mark("wire")
        return out

    def gather_rows(self, tensor: torch.Tensor) -> torch.Tensor | None:
        """Replica 0's ranks: every replica's ``tensor`` (from the ranks
        with this rank's model index) stacked along a new leading axis in
        replica order, on the CPU; the other ranks: None."""
        self.calls["gather"] += 1
        t = tensor.detach().contiguous()
        t = t.cpu() if self.backend == "gloo" else t.to(self.device)
        root = self.replica == 0
        parts = [torch.empty_like(t) for _ in range(self.replicas)] if root else None
        dist.gather(t, parts, dst=self.rank_of(0), group=self.replica_pg)
        return torch.stack([p.cpu() for p in parts]) if root else None

    def gather_object(self, obj: Any) -> list | None:
        """Replica 0's ranks: every replica's ``obj`` in replica order; the
        others: None."""
        self.calls["gather"] += 1
        root = self.replica == 0
        out = [None] * self.replicas if root else None
        dist.gather_object(obj, out, dst=self.rank_of(0), group=self.replica_pg)
        return out

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank."""
        self.calls["broadcast"] += 1
        box = [obj]
        dist.broadcast_object_list(box, src=0,
                                   device=self.device if self.backend == "nccl" else None)
        return box[0]

    def barrier(self) -> None:
        self.calls["barrier"] += 1
        dist.barrier()


def check_backend(backend: str, world: int, device: str | torch.device) -> torch.device:
    """The device type the ranks run on, after checking that ``backend``
    serves ``world`` ranks there: ``nccl`` needs CUDA and one card per
    rank; ``gloo`` runs anywhere."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {list(BACKENDS)}")
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("--backend nccl moves CUDA tensors: use --device cuda, or "
                             "--backend gloo on the CPU")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"--backend nccl puts one rank on each card, and {world} ranks need {world} "
                f"cards where {cards} are visible; run with --backend gloo, which stages "
                "the payload through host memory so that ranks can share a card")
    return dev


def init_replica_group(world: int, backend: str, device: str | torch.device, *,
                       rank: int | None = None, init_method: str = "env://",
                       tp: int = 1, fsdp: int = 1) -> ReplicaGroup:
    """Join the process group as ``rank`` (default: ``$RANK``) of ``world``
    over ``backend`` and return the :class:`ReplicaGroup`.  The rank's
    device is ``cuda:{rank % device_count}`` for ``device="cuda"``, or the
    CPU when the caller asks for it.  A barrier, which every rank joins,
    is the group's first call: torch leaves a first ``batch_isend_irecv``
    that some rank sits out (a rank paired with itself in an odd world)
    undefined over NCCL.  With ``tp`` > 1 or ``fsdp`` > 1 every rank then
    creates, in this order, a model-axis subgroup per (replica, data index)
    (``tp`` > 1), a data-axis subgroup per (replica, model index) (``fsdp``
    > 1) and a replica-axis subgroup per (data index, model index), and
    keeps its own."""
    dev = check_backend(backend, world, device)
    if rank is None:
        rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    dist.barrier(**({"device_ids": [dev.index]} if backend == "nccl" else {}))
    if tp == 1 and fsdp == 1:
        return ReplicaGroup(rank=rank, world=world, device=dev, backend=backend)
    if world % (tp * fsdp):
        raise ValueError(f"a world of {world} ranks does not split into replicas of "
                         f"{fsdp} data × {tp} model ranks")
    replicas = world // (tp * fsdp)
    at = lambda rep, d, m: (rep * fsdp + d) * tp + m   # the rank at (replica, data, model)

    def own(groups):
        """Create every subgroup of ``groups`` (rank lists), in order; return
        (process group, ranks) of the one that holds this rank."""
        mine = None
        for ranks in groups:
            pg = dist.new_group(ranks)
            if rank in ranks:
                mine = (pg, ranks)
        return mine

    model = data = None
    if tp > 1:
        pg, ranks = own([[at(rep, d, m) for m in range(tp)]
                         for rep in range(replicas) for d in range(fsdp)])
        model = ModelAxis(pg, ranks, rank % tp, dev, backend)
    if fsdp > 1:
        pg, ranks = own([[at(rep, d, m) for d in range(fsdp)]
                         for rep in range(replicas) for m in range(tp)])
        data = ModelAxis(pg, ranks, (rank // tp) % fsdp, dev, backend)
    replica_pg, _ = own([[at(rep, d, m) for rep in range(replicas)]
                         for d in range(fsdp) for m in range(tp)])
    return ReplicaGroup(rank=rank, world=world, device=dev, backend=backend, tp=tp,
                        model=model, replica_pg=replica_pg, fsdp=fsdp, data=data)


def from_env() -> tuple[int, int] | None:
    """(rank, world) when started by ``torchrun``, else None."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return None


def _entry(rank: int, fn: Callable, world: int, backend: str, device: str, init_method: str,
           out_dir: str, threads: int | None, tp: int = 1, fsdp: int = 1) -> None:
    if threads:
        torch.set_num_threads(threads)
    with open(os.path.join(out_dir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    group = init_replica_group(world, backend, device, rank=rank, init_method=init_method,
                               tp=tp, fsdp=fsdp)
    try:
        result = fn(group, *args)
        with open(os.path.join(out_dir, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *, backend: str = "gloo",
          device: str = "cuda", threads: int | None = None, tp: int = 1,
          fsdp: int = 1) -> list:
    """Run ``fn(group, *args)`` on ``world`` spawned ranks; returns their
    results (picklable) in rank order.  ``fn`` must be a module-level
    function.  ``threads`` sets each rank's intra-op thread count (default:
    the host's cores shared out between the ranks); ``tp`` the ranks of
    each replica's model axis, ``fsdp`` those of its data axis
    (``fsdp_hybrid``)."""
    import torch.multiprocessing as mp

    dev = check_backend(backend, world, device)
    threads = threads or max(1, torch.get_num_threads() // world)
    if dev.type == "cuda":
        from repro_torch.kernels import build

        build.build_all()
    with tempfile.TemporaryDirectory(prefix="replicas-") as tmp:
        # the arguments go through a file: a spawned child reads what its
        # parent pipes to it only after importing the main module, so large
        # piped arguments would start the ranks one after another
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(tuple(args), f)
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(_entry, args=(fn, world, backend, dev.type, init_method, tmp, threads,
                                         tp, fsdp),
                           nprocs=world, join=True, start_method="spawn")
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"result-{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
