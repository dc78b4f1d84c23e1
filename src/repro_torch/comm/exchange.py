"""Communicators for the outer step of the stacked simulation.

The port of :class:`StackedGather` and :func:`exchange_gossip` from
``repro/comm/exchange.py``.  Replicas sit on a leading axis of every leaf;
a replica's partner values come from an index gather with the partner table
of :mod:`repro_torch.core.pairing`, and the DiLoCo mean is a mean over that
axis (masked to the active replicas when a mask is given).  The codec is
the identity (``none``), the only one ported so far; the multi-GPU
communicators come with the multi-GPU runtime.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.comm.compress import CommConfig, get_codec
from repro_torch.tree import tree_map

PyTree = Any

__all__ = ["Communicator", "StackedGather", "exchange_gossip"]


class Communicator:
    """Pairwise gossip exchange and group mean over the replica dimension."""

    cfg: CommConfig

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

    def __init__(self, partner: torch.Tensor | None, cfg: CommConfig | None = None, *,
                 active: torch.Tensor | None = None):
        self.partner = partner
        self.active = active
        self.cfg = cfg or CommConfig()
        self.cfg.validate()
        get_codec(self.cfg)  # raises for codecs not ported yet

    def exchange(self, tree: PyTree) -> PyTree:
        if self.partner is None:
            raise ValueError("StackedGather.exchange needs a partner table")
        return tree_map(lambda x: x.index_select(0, self.partner.to(x.device)), tree)

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


def exchange_gossip(comm: Communicator, delta: PyTree, phi: PyTree) -> tuple[PyTree, PyTree]:
    """Blocking part of the gossip exchange: the partner's (Δ, φ), which
    travel together as one payload (the §3.2 φ-prefetch comes with
    streaming, ROADMAP Queue 1 item 10)."""
    return comm.exchange((delta, phi))
