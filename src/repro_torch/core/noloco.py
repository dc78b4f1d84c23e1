"""The stacked trainer: m inner AdamW steps on every replica, then the
gossip (NoLoCo) / all-reduce (DiLoCo) / none outer step.

The port of ``repro/core/noloco.py``.  Every leaf of the state carries a
leading replica axis of size ``world``.  Where the JAX package vmaps the
one-replica loss and update over that axis, the port runs all replicas in
one batched forward (the stacked loss returns the (R,) per-replica losses),
backpropagates their sum, so each replica's slice of the gradient is its
own, and updates every replica with one call of the stacked AdamW.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.comm import CommConfig
from repro_torch.core import outer as outer_lib
from repro_torch.optim import AdamWConfig, AdamWState, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any
StackedLossFn = Callable[[PyTree, dict], torch.Tensor]
#               loss_fn(stacked params, stacked batch) -> (R,) per-replica losses

__all__ = ["TrainerConfig", "TrainState", "GossipTrainer"]


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    outer: outer_lib.OuterConfig = dataclasses.field(default_factory=outer_lib.OuterConfig)
    inner: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    comm: CommConfig = dataclasses.field(default_factory=CommConfig)
    # FSDP/DDP baseline: mean the gradients across replicas EVERY inner step.
    sync_grads: bool = False


@dataclasses.dataclass
class TrainState:
    theta: PyTree                 # fast weights, leading replica axis
    opt: AdamWState               # per-replica AdamW moments (leading axis)
    outer: outer_lib.OuterState   # slow weights φ and momentum δ
    inner_step: int = 0           # global inner step counter


class GossipTrainer:
    """Functional trainer: every method returns a new state."""

    def __init__(self, cfg: TrainerConfig, loss_fn: StackedLossFn):
        cfg.outer.validate()
        self.cfg = cfg
        self.loss_fn = loss_fn

    def init(self, stacked_params: PyTree) -> TrainState:
        return TrainState(
            theta=stacked_params,
            opt=adamw_init(stacked_params),
            outer=outer_lib.init_outer_state(stacked_params),
            inner_step=0,
        )

    def inner_step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        """One local AdamW step on every replica; ``batch`` leaves have a
        leading replica axis.  Returns (state, {"loss": (R,), "grad_norm":
        (R,)})."""
        theta = tree_map(lambda p: p.detach().requires_grad_(), state.theta)
        leaves = tree_leaves(theta)
        losses = self.loss_fn(theta, batch)
        grads = torch.autograd.grad(losses.sum(), leaves)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), theta)
        if self.cfg.sync_grads:
            grads = tree_map(
                lambda g: g.float().mean(0, keepdim=True).to(g.dtype).expand_as(g), grads
            )
        with torch.no_grad():
            theta, opt, gnorm = adamw_update(grads, state.opt, state.theta, self.cfg.inner)
        new_state = TrainState(theta=theta, opt=opt, outer=state.outer,
                               inner_step=state.inner_step + 1)
        return new_state, {"loss": losses.detach(), "grad_norm": gnorm}

    def outer_step(self, state: TrainState, partner=None, active=None) -> TrainState:
        """Gossip / all-reduce sync of the slow weights; the fast weights
        restart from the new slow weights.  ``partner`` None derives the
        pairing from the outer step counter."""
        new_outer, new_theta = outer_lib.outer_step_stacked(
            state.outer, state.theta, self.cfg.outer, partner=partner, active=active,
            comm_cfg=self.cfg.comm,
        )
        return TrainState(theta=new_theta, opt=state.opt, outer=new_outer,
                          inner_step=state.inner_step)

    @torch.no_grad()
    def eval_loss(self, theta: PyTree, batch: dict) -> torch.Tensor:
        """Grad-free per-replica losses (R,)."""
        return self.loss_fn(theta, batch)

    def should_sync(self, state: TrainState) -> bool:
        m = self.cfg.outer.inner_steps
        return state.inner_step > 0 and state.inner_step % m == 0
