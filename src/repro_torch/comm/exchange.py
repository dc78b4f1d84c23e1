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
collective.  :class:`AllReduce` is DiLoCo's group mean (an ``all_reduce``
of each packed buffer in its own dtype, divided by the world).  The elastic
weighted mean and the φ′ pre-send over the group come with ROADMAP Queue 1
item 9b.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.comm import payload as payload_lib
from repro_torch.comm.compress import CommConfig, get_codec
from repro_torch.tree import tree_map

PyTree = Any

__all__ = ["Communicator", "StackedGather", "ShardedPermute", "AllReduce", "wire_roundtrip",
           "exchange_gossip", "presend"]


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
    and :class:`AllReduce` over the replica group.  The elastic weighted
    mean and the pre-send over the group come with ROADMAP Queue 1 item 9b,
    a model axis within a replica with item 9c."""

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

    ``pairs`` is the round's (source, destination) list over ranks (an
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
        if len(dst) != group.world or len(src) != group.world:
            raise ValueError(f"pairs {self.pairs} are no permutation of {group.world} ranks")
        self.dst, self.src = dst[group.rank], src[group.rank]
        self.cfg = cfg or CommConfig()
        self.cfg.validate()

    def exchange(self, tree: PyTree) -> PyTree:
        codec = get_codec(self.cfg)
        self.group.mark("update")   # the outer step's own math before the exchange (Δ)
        buffers, spec = payload_lib.pack(tree, fuse=self.cfg.fuse)
        wires = [codec.encode(buf) for buf in buffers]
        del buffers
        self.group.mark("encode")
        if self.dst != self.group.rank or self.src != self.group.rank:
            wires = self.group.exchange(wires, self.dst, self.src)
        out = [codec.decode(w, bs.dtype, bs.size) for w, bs in zip(wires, spec.buffers)]
        tree = payload_lib.unpack(out, spec)
        self.group.mark("decode")
        return tree


class AllReduce(Communicator):
    """DiLoCo's group mean over the replica group: each packed buffer is
    summed over the ranks in its own dtype by one ``all_reduce`` and divided
    by the world, as the reference's ``lax.pmean``, so the wire carries the
    buffers' bytes and no more."""

    def __init__(self, group, cfg: CommConfig | None = None):
        self.group = group
        self.cfg = cfg or CommConfig()

    def allreduce_mean(self, tree: PyTree) -> PyTree:
        self.group.mark("update")
        buffers, spec = payload_lib.pack(tree, fuse=self.cfg.fuse)
        self.group.mark("encode")
        out = [self.group.all_reduce_sum(buf) / self.group.world for buf in buffers]
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


def presend(comm_next: Communicator, phi_next: PyTree) -> PyTree:
    """The φ′ transfer along the NEXT pairing, a payload of its own; on a
    wire it overlaps the next m inner steps."""
    return comm_next.exchange(phi_next)
