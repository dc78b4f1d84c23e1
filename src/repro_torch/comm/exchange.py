"""Communicators for the outer step: the stacked simulation's and the
replica group's.

The port of ``repro/comm/exchange.py``.  In :class:`StackedGather`
replicas sit on a leading axis of every leaf;
a replica's partner values come from an index gather with the partner table
of :mod:`repro_torch.core.pairing`, and the DiLoCo mean is a mean over that
axis (masked to the active replicas when a mask is given).  A lossy codec
is applied to the gathered values as an encode→decode round trip
(:func:`wire_roundtrip`), each replica's payload packed and coded on its
own, so the simulation sees the values a compressed wire would deliver.
:func:`exchange_gossip` expresses the paper's §3.2 overlap: when the
partner's φ was pre-sent (:func:`presend`) during the previous inner phase
(φ does not change during inner steps), only Δ crosses the wire at the
sync.

Over the replica group (:mod:`repro_torch.launch.mesh`, one rank per
replica), :class:`ShardedPermute` packs this rank's tree, encodes each
buffer, moves every buffer to and from the round's partner in one batched
send/receive, then decodes and unpacks: the pairwise exchange, with no
collective.  :meth:`ShardedPermute.exchange_start` splits that call: it
posts the transfer and returns a :class:`PendingTree` whose ``wait()``
decodes the tree, which is how :func:`presend` puts a stream's φ′ in
flight during the next inner steps.  :class:`AllReduce` is DiLoCo's group
mean (an ``all_reduce`` of each packed buffer in its own dtype, divided by
the world), or with a participation ``weight`` the elastic mean
sum(w·Δ)/sum(w) over the round's participants.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.comm import payload as payload_lib
from repro_torch.comm.compress import CommConfig, get_codec
from repro_torch.tree import tree_map

PyTree = Any

__all__ = ["Communicator", "StackedGather", "ShardedPermute", "PendingTree", "AllReduce",
           "wire_roundtrip", "exchange_gossip", "presend"]


def wire_roundtrip(tree: PyTree, cfg: CommConfig, *, lead: int = 0) -> PyTree:
    """pack → encode → decode → unpack: the values the partner would
    receive.  The first ``lead`` axes of every leaf are batch axes (the
    replica axis), each index coded on its own as the JAX package's
    ``vmap`` over replicas does; one kernel launch per buffer serves them
    all.  Identity for ``codec="none"``."""
    codec = get_codec(cfg)
    buffers, spec = payload_lib.pack(tree, fuse=cfg.fuse, lead=lead)
    out = [codec.decode(codec.encode(buf), bs.dtype, bs.size)
           for buf, bs in zip(buffers, spec.buffers)]
    return payload_lib.unpack(out, spec)


class Communicator:
    """Pairwise gossip exchange and group mean over the replica dimension:
    :class:`StackedGather` in the stacked simulation, :class:`ShardedPermute`
    and :class:`AllReduce` over the replica group (with a model axis, over
    the ranks that hold this rank's model index: each moves its shards)."""

    cfg: CommConfig
    #: the plain wire may go leaf by leaf (a gather costs no message); a
    #: communicator that sends messages takes the whole tree at once
    per_leaf: bool = False

    def exchange(self, tree: PyTree) -> PyTree:
        """Return the PARTNER's copy of ``tree`` (this replica's view)."""
        raise NotImplementedError

    def allreduce_mean(self, tree: PyTree) -> PyTree:
        """Group mean of ``tree`` over all replicas (DiLoCo baseline)."""
        raise NotImplementedError


class StackedGather(Communicator):
    """Replicas stacked on axis 0 of every leaf; partner via index gather.

    ``active`` (optional (world,) bool mask) restricts :meth:`allreduce_mean`
    to the active replicas: a dropped replica contributes nothing to the
    mean, and every replica still receives it."""

    per_leaf = True

    def __init__(self, partner: torch.Tensor | None, cfg: CommConfig | None = None, *,
                 active: torch.Tensor | None = None):
        self.partner = partner
        self.active = active
        self.cfg = cfg or CommConfig()
        self.cfg.validate()

    def exchange(self, tree: PyTree) -> PyTree:
        if self.partner is None:
            raise ValueError("StackedGather.exchange needs a partner table")
        gathered = tree_map(lambda x: x.index_select(0, self.partner.to(x.device)), tree)
        if self.cfg.codec == "none":
            return gathered
        return wire_roundtrip(gathered, self.cfg, lead=1)

    def allreduce_mean(self, tree: PyTree) -> PyTree:
        if self.active is None:
            # fp32 accumulation, result in the leaf's dtype (jnp.mean's rule)
            return tree_map(
                lambda x: x.float().mean(0, keepdim=True).to(x.dtype).expand_as(x), tree
            )
        w = self.active.float()
        w = w / torch.clamp_min(w.sum(), 1.0)

        def _masked(x):
            wx = w.to(x.device, x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
            return (x * wx).float().sum(0, keepdim=True).to(x.dtype).expand_as(x)

        return tree_map(_masked, tree)


class ShardedPermute(Communicator):
    """One rank's replica: its partner's copy comes over the group.

    ``pairs`` is the round's (source, destination) list over replicas (an
    involution for the gossip schedules); this rank sends to its
    destination and receives from the rank whose destination it is, every
    packed buffer in one batched send/receive.  A rank paired with itself
    moves nothing: it decodes its own wire, as the reference's
    ``ppermute`` over a self-pair gives it.  The group's clock, when one is
    set, splits the call into encode (pack and code), D2H, wire, H2D and
    decode (decode and unpack), and puts the time before it under update."""

    def __init__(self, group, pairs, cfg: CommConfig | None = None):
        self.group = group
        self.pairs = [(int(s), int(d)) for s, d in pairs]
        dst = dict(self.pairs)
        src = {d: s for s, d in self.pairs}
        if len(dst) != group.replicas or len(src) != group.replicas:
            raise ValueError(f"pairs {self.pairs} are no permutation of {group.replicas} "
                             "replicas")
        self.dst, self.src = dst[group.replica], src[group.replica]
        self.cfg = cfg or CommConfig()
        self.cfg.validate()

    @property
    def paired(self) -> bool:
        """Whether this rank's payload crosses to another rank."""
        return self.dst != self.group.replica or self.src != self.group.replica

    def _encode(self, tree: PyTree, prefix: str = ""):
        buffers, spec = payload_lib.pack(tree, fuse=self.cfg.fuse)
        wires = [get_codec(self.cfg).encode(buf) for buf in buffers]
        del buffers
        self.group.mark(prefix + "encode")
        return wires, spec

    def _decode(self, wires, spec, prefix: str = "") -> PyTree:
        codec = get_codec(self.cfg)
        out = [codec.decode(w, bs.dtype, bs.size) for w, bs in zip(wires, spec.buffers)]
        tree = payload_lib.unpack(out, spec)
        self.group.mark(prefix + "decode")
        return tree

    def exchange(self, tree: PyTree) -> PyTree:
        self.group.mark("update")   # the outer step's own math before the exchange (Δ)
        wires, spec = self._encode(tree)
        if self.paired:
            wires = self.group.exchange(wires, self.dst, self.src)
        return self._decode(wires, spec)

    def exchange_start(self, tree: PyTree, *, stream: int = 0) -> "PendingTree":
        """Post :meth:`exchange`'s transfer (stream ``stream``'s channel)
        and return at once; ``wait()`` on the result gives the partner's
        tree.  A rank paired with itself posts nothing."""
        wires, spec = self._encode(tree, "pre_")
        pending = (self.group.exchange_start(wires, self.dst, self.src, stream=stream)
                   if self.paired else wires)
        return PendingTree(self, pending, spec)


class PendingTree:
    """A tree in flight from :meth:`ShardedPermute.exchange_start`:
    :meth:`wait` completes the transfer once (the phases ``pre_wire``,
    ``pre_h2d``, ``pre_decode``) and returns the decoded tree."""

    def __init__(self, comm: ShardedPermute, pending, spec):
        self._comm, self._pending, self._spec = comm, pending, spec
        self._tree = None

    def wait(self) -> PyTree:
        if self._tree is None:
            wires = self._pending if isinstance(self._pending, list) else self._pending.wait()
            self._tree = self._comm._decode(wires, self._spec, "pre_")
            self._pending = None
        return self._tree


class AllReduce(Communicator):
    """DiLoCo's group mean over the replica group: each packed buffer is
    summed over the ranks in its own dtype by one ``all_reduce`` and divided
    by the world, as the reference's ``lax.pmean``, so the wire carries the
    buffers' bytes and no more.

    ``weight`` (this rank's participation, 0 or 1) with ``participants``
    (the sum of the ranks' weights, which every rank knows from the shared
    membership) gives the elastic mean sum(w·x) / max(sum(w), 1) over the
    round's participants, the reference's ``psum(w·x) / psum(w)``: a rank
    of weight 0 adds zeros but still makes the call, so no rank waits on
    one that skipped it."""

    def __init__(self, group, cfg: CommConfig | None = None, *, weight: float | None = None,
                 participants: int | None = None):
        if (weight is None) != (participants is None):
            raise ValueError("the elastic mean needs both weight and participants")
        self.group = group
        self.cfg = cfg or CommConfig()
        self.weight = weight
        self.participants = participants

    def allreduce_mean(self, tree: PyTree) -> PyTree:
        self.group.mark("update")
        buffers, spec = payload_lib.pack(tree, fuse=self.cfg.fuse)
        if self.weight is None:
            denom = self.group.replicas
        else:
            buffers = [buf * float(self.weight) for buf in buffers]
            denom = max(float(self.participants), 1.0)
        self.group.mark("encode")
        out = [self.group.all_reduce_sum(buf) / denom for buf in buffers]
        tree = payload_lib.unpack(out, spec)
        self.group.mark("decode")
        return tree


def exchange_gossip(comm: Communicator, delta: PyTree, phi: PyTree, *,
                    phi_prefetched: PyTree | None = None) -> tuple[PyTree, PyTree]:
    """Blocking part of the gossip exchange: the partner's (Δ, φ).  With
    ``phi_prefetched`` (the §3.2 overlap) the partner's φ arrived during the
    previous inner phase, so only Δ is exchanged here; otherwise Δ and φ
    travel together as one payload."""
    if phi_prefetched is not None:
        return comm.exchange(delta), phi_prefetched
    return comm.exchange((delta, phi))


def presend(comm_next: Communicator, phi_next: PyTree, *, stream: int = 0):
    """The φ′ transfer along the NEXT pairing, a payload of its own; on a
    wire it overlaps the next m inner steps.  A communicator that sends
    messages posts it and returns a :class:`PendingTree` (its ``wait()``
    gives the partner's φ′); the stacked simulation returns the tree."""
    if isinstance(comm_next, ShardedPermute):
        return comm_next.exchange_start(phi_next, stream=stream)
    return comm_next.exchange(phi_next)
