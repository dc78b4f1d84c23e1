"""ElasticContext: the owner of elasticity state (the port of
``repro/core/elastic.py``).

The stacked :class:`~repro_torch.train.adapters.GossipProgram` holds one.
It carries four things:

  * ``membership``   — the epoch-stamped :class:`~repro_torch.core.pairing.
    Membership` over replica slots (who is in the cluster);
  * ``partition``    — the transient network-partition view (pairings never
    cross a component);
  * ``round_absent`` — stragglers missing the next outer round only
    (participation, not membership; consumed by :meth:`plan_round`);
  * ``last_partner`` — the partner table the last outer round used.

:meth:`plan_round` decides a round's participants: it consumes the
straggler view, turns a round in which every member is absent into a frozen
no-exchange round (the outer counter still advances, so the schedule stays
aligned) and returns a :class:`RoundPlan` with the active mask and the
partner table of the caller's ``partner_fn``.  All of it is host-side numpy.
:meth:`state_dict` / :meth:`load_state_dict` give the checkpoint view in the
JAX package's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.pairing import Membership

__all__ = ["ELASTIC_METHODS", "ElasticContext", "RoundPlan", "stream_assignment"]

# the outer methods an elastic run takes: a dropped or waiting replica sits
# its rounds out, which a per-step gradient all-reduce (fsdp) cannot
ELASTIC_METHODS = ("noloco", "diloco")


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """One outer round's participation, as decided by ``plan_round``."""

    participants: Membership          # membership minus this round's stragglers
    partner: np.ndarray | None        # (world,) table used, None for all-reduce
    active: np.ndarray | None         # (world,) bool mask, None when full
    all_absent: bool = False          # every live replica timed out this round


class ElasticContext:
    """Membership epoch, partition view, straggler set and the last table."""

    def __init__(self, membership: Membership | None = None, *, world: int | None = None):
        if membership is None:
            if world is None:
                raise ValueError("ElasticContext needs a membership or a world size")
            membership = Membership.full(world)
        self.membership = membership
        self.partition: tuple[tuple[int, ...], ...] | None = None
        self.round_absent: frozenset[int] = frozenset()
        self.last_partner: np.ndarray | None = None
        # per-tick step gate of the asynchronous clock (SimCluster sets it
        # before every inner step; None: every member steps).  Not
        # checkpointed: the clock recomputes it on the first tick after resume.
        self.tick_active: np.ndarray | None = None

    @property
    def world(self) -> int:
        return self.membership.world

    @property
    def epoch(self) -> int:
        return self.membership.epoch

    @property
    def is_full(self) -> bool:
        return self.membership.is_full

    def active_array(self) -> np.ndarray | None:
        """(world,) bool mask of the replicas that step this tick (members
        whose clock granted a step), or None when every replica does: the
        healthy and rate-1 worlds keep the unmasked path."""
        mask = np.asarray(self.membership.mask, dtype=bool)
        if self.tick_active is not None:
            mask = mask & np.asarray(self.tick_active, dtype=bool)
        if mask.all():
            return None
        return mask.copy()

    def active_ids(self) -> tuple[int, ...]:
        return self.membership.active_ids

    def set_membership(self, membership: Membership) -> None:
        if membership.world != self.world:
            raise ValueError(f"membership world {membership.world} != world {self.world}")
        self.membership = membership

    def set_partition(self, groups: Sequence[Sequence[int]] | None) -> None:
        """Restrict pairings to partition components (None heals)."""
        self.partition = (
            None if groups is None else tuple(tuple(int(r) for r in g) for g in groups)
        )

    def plan_round(self, partner_fn: Callable[[Membership], np.ndarray] | None = None) -> RoundPlan:
        """Decide one outer round's participants; consumes ``round_absent``.
        ``partner_fn(participants)`` gives the round's partner table (None
        for all-reduce methods); it is recorded as ``last_partner``."""
        absent, self.round_absent = self.round_absent, frozenset()
        active_now = set(self.membership.active_ids)
        absent = absent & active_now
        if absent == active_now:
            # every live replica timed out: nobody exchanges, but the round
            # happens, so the outer counter advances
            self.last_partner = np.arange(self.world, dtype=np.int64)
            return RoundPlan(participants=self.membership, partner=self.last_partner,
                             active=np.zeros((self.world,), dtype=bool), all_absent=True)
        participants = self.membership.without(absent)
        partner = None if partner_fn is None else partner_fn(participants)
        self.last_partner = partner
        active = None if participants.is_full else participants.active_array()
        return RoundPlan(participants=participants, partner=partner, active=active)

    def state_dict(self) -> dict:
        """``{"mask", "epoch", "partition"}``: the partition as one group id
        per replica, −1 for none."""
        part = np.full((self.world,), -1, dtype=np.int64)
        if self.partition is not None:
            for gid, group in enumerate(self.partition):
                for r in group:
                    part[r] = gid
        return {
            "mask": np.asarray(self.membership.mask, dtype=bool),
            "epoch": np.int64(self.membership.epoch),
            "partition": part,
        }

    def load_state_dict(self, tree: dict) -> None:
        self.membership = Membership(
            world=self.world,
            mask=tuple(bool(b) for b in np.asarray(tree["mask"])),
            epoch=int(tree["epoch"]),
        )
        part = np.asarray(tree["partition"])
        if (part >= 0).any():
            self.partition = tuple(
                tuple(int(i) for i in np.nonzero(part == g)[0])
                for g in sorted(set(int(p) for p in part if p >= 0))
            )
        else:
            self.partition = None


def stream_assignment(membership: Membership, t: int) -> np.ndarray:
    """Elastic data reassignment: which loader stream each replica consumes
    at inner step ``t``, a pure function of ``(membership, t)``.

    Each dropped replica's stream is adopted by a survivor (round-robin over
    the actives by dropped rank); a survivor reads ``pool[t % len(pool)]``
    of its own stream followed by its adopted ones.  Identity at full
    membership; inactive replicas map to their own stream (their row is
    never consumed)."""
    world = membership.world
    table = np.arange(world, dtype=np.int64)
    if membership.is_full:
        return table
    actives = sorted(membership.active_ids)
    dropped = [r for r in range(world) if r not in set(actives)]
    pools: dict[int, list[int]] = {a: [a] for a in actives}
    for rank, d in enumerate(dropped):
        pools[actives[rank % len(actives)]].append(d)
    for a, pool in pools.items():
        table[a] = pool[t % len(pool)]
    return table
