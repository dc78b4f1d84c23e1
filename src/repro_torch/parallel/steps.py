"""Step builders of the replica group: the inner train step, eval, and the
outer step (gossip or all-reduce), each run by every rank on its own
replica.

The port of ``repro/parallel/steps.py`` for the replica axis.  A rank
holds one replica as a replica-stacked tree with a leading axis of 1, so
the port's stacked model, AdamW and kernels run on it unchanged.  As in
the reference, the train step descends the mean of the replicas' losses
(the reference differentiates ``sum(losses) / replicas`` outside its
``shard_map``), so each rank's gradient is its own loss's divided by the
world; the step makes no cross-rank call unless ``data_sync`` asks for the
DDP/FSDP baseline, which all-reduces the gradients every step.

The outer step moves the packed (Δ, φ) payload to the round's partner and
back in one batched send/receive (NoLoCo) or all-reduces Δ (DiLoCo).  The
reference compiles one ``ppermute`` program per pairing, so its
:class:`OuterProgramPool` cycles a bounded pool of matchings; a send and a
receive need no compiled permutation, but the port deals the same pool
slots and hypercube dimensions, so a run's partners are the reference's.
With nothing to compile, a pool entry is the round's pairs and outer-step
function, and ``misses`` counts the first use of a slot.  The pool's
elastic views and streamed entries come with ROADMAP Queue 1 item 9b;
``build_decode_step`` / ``build_prefill_step`` with item 9c.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.comm import CommConfig
from repro_torch.comm import exchange as exchange_lib
from repro_torch.core import outer as outer_lib
from repro_torch.core import pairing as pairing_lib
from repro_torch.core.outer import OuterConfig, OuterState
from repro_torch.core.pairing import Membership
from repro_torch.models import model as model_api
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, AdamWState, adamw_init, adamw_update
from repro_torch.parallel.plans import Plan
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = ["TrainStepBundle", "build_train_step", "init_opt_state", "build_outer_step",
           "OuterProgramPool", "ELASTIC_ITEM"]

ELASTIC_ITEM = "ROADMAP Queue 1 item 9b (elastic, async and streamed rounds on the replica group)"


@dataclasses.dataclass
class TrainStepBundle:
    step_fn: Callable   # (theta, opt, batch) -> (theta, opt, metrics)
    eval_fn: Callable   # (theta, batch) -> (1,) losses, grad-free


def build_train_step(cfg: ModelConfig, plan: Plan, group, inner: AdamWConfig, *,
                     data_sync: bool = False) -> TrainStepBundle:
    """The rank's inner step on its replica: forward, backward of its loss
    over ``plan.replicas``, AdamW (the moments donated: updated in place).
    ``data_sync`` means the gradients over the group before the update.
    ``batch`` leaves are (1, B, S) on the rank's device."""
    world = plan.replicas

    def step(theta, opt, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(), theta)
        losses = model_api.stacked_loss(params, cfg, batch)
        grads = torch.autograd.grad(losses.sum() / world, tree_leaves(params))
        grads = tree_unflatten(params, list(grads))
        if data_sync and world > 1:
            grads = exchange_lib.AllReduce(group).allreduce_mean(grads)
        with torch.no_grad():
            theta, opt, gnorm = adamw_update(grads, opt, theta, inner)
        return theta, opt, {"loss": losses.detach(), "grad_norm": gnorm}

    @torch.no_grad()
    def eval_fn(theta, batch):
        return model_api.stacked_loss(theta, cfg, batch)

    return TrainStepBundle(step_fn=step, eval_fn=eval_fn)


def init_opt_state(theta: PyTree) -> AdamWState:
    """AdamW state of the rank's replica-stacked parameters."""
    return adamw_init(theta)


def build_outer_step(plan: Plan, outer_cfg: OuterConfig, pairs, *, group,
                     comm_cfg: CommConfig | None = None) -> Callable:
    """One outer step of the rank's replica: ``(theta, phi, delta, step) ->
    (theta', phi', delta', step + 1)``.  NoLoCo exchanges with the partner
    of ``pairs``, the (source, destination) list over ranks; DiLoCo
    all-reduces; ``none`` moves nothing."""
    def fn(theta, phi, delta, step):
        state = OuterState(phi=phi, delta=delta, step=step)
        new_state, new_theta = outer_lib.outer_step_sharded(
            state, theta, outer_cfg, group=group, pairs=pairs, comm_cfg=comm_cfg)
        return new_theta, new_state.phi, new_state.delta, new_state.step

    return fn


class OuterProgramPool:
    """The outer step of each round, keyed by (membership view, pairing
    slot), as the reference's pool keys its compiled programs.

    ``schedule="random"``: round k uses the matching of slot
    ``k % pairing_pool`` (the reference's cycling pool); ``"hypercube"``:
    partner = rank XOR 2^j with j = :func:`~repro_torch.core.pairing.
    hypercube_dim`.  ``program`` returns the round's outer step; a slot's
    first use counts as a miss.  Every round here runs on the full
    membership: partial views (elastic rounds, :meth:`view_key`) wait for
    ROADMAP Queue 1 item 9b."""

    def __init__(self, plan: Plan, outer_cfg: OuterConfig, *, group,
                 comm_cfg: CommConfig | None = None, schedule: str = "random",
                 pairing_pool: int = 16, seed: int = 0):
        if schedule not in ("random", "hypercube"):
            raise ValueError(f"unknown pairing schedule: {schedule!r}")
        self.plan = plan
        self.outer_cfg = outer_cfg
        self.group = group
        self.comm_cfg = comm_cfg or CommConfig()
        self.schedule = schedule
        self.pairing_pool = pairing_pool
        self.seed = seed
        self._programs: dict[Any, Callable] = {}
        self.hits = 0
        self.misses = 0

    @property
    def max_programs_per_view(self) -> int:
        """Entries per membership view: ``pairing_pool`` for the random
        schedule, log2(world) for the hypercube (the reference's bound,
        whose overlap and stream factors are 1 on this path)."""
        if self.schedule == "hypercube":
            return max(int(np.log2(self.plan.replicas)), 1)
        return self.pairing_pool

    def pool_slot(self, outer_index: int) -> int:
        """The pairing slot of outer round ``outer_index``."""
        if self.schedule == "hypercube":
            return pairing_lib.hypercube_dim(outer_index, self.plan.replicas, seed=self.seed)
        return outer_index % max(self.pairing_pool, 1)

    def pairs_for(self, outer_index: int) -> tuple[int, list[tuple[int, int]]]:
        """(pool slot, (source, destination) pairs) of one outer round of
        the full membership: a pure function of (seed, slot), so every rank
        derives the same pairs with no message."""
        world = self.plan.replicas
        slot = self.pool_slot(outer_index)
        if self.schedule == "hypercube":
            return slot, pairing_lib.hypercube_ppermute_pairs(outer_index, world, seed=self.seed)
        return slot, pairing_lib.ppermute_pairs(slot, world, seed=self.seed)

    @staticmethod
    def view_key(membership: Membership | None, groups: Any | None = None) -> Any:
        """Hashable participant-view part of the key (None: the full
        membership, shared by epochs with equal masks)."""
        if membership is None or (membership.is_full and groups is None):
            return None
        gk = None if groups is None else tuple(tuple(int(r) for r in g) for g in groups)
        return (tuple(membership.mask), gk)

    def program(self, outer_index: int) -> Callable:
        """The outer step of round ``outer_index``."""
        slot, pairs = self.pairs_for(outer_index)
        key = (None, slot)
        if key in self._programs:
            self.hits += 1
        else:
            self.misses += 1
            self._programs[key] = build_outer_step(self.plan, self.outer_cfg, pairs,
                                                   group=self.group, comm_cfg=self.comm_cfg)
        return self._programs[key]

    def stats(self) -> dict:
        return {"pool_size": len(self._programs), "hits": self.hits, "misses": self.misses,
                "schedule": self.schedule, "max_programs_per_view": self.max_programs_per_view}
