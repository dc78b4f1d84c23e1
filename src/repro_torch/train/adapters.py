"""The stacked-simulation runtime as a :class:`TrainProgram` (the port of
``repro/train/adapters.py::GossipProgram``).

Replicas sit on a leading axis of every state leaf, on one device: the
card, or the CPU when asked.  Every replica starts from the same weights,
the port's initialisation from ``seed`` drawn on the CPU generator and then
moved to the device, so a card run and a CPU run of the same config start
from the same point.  Membership is always full: the elastic context,
streaming, the φ-prefetch overlap and asynchronous rounds come with ROADMAP
Queue 1 item 10 and raise until then.  The checkpoint view of the state is
the JAX ``GossipProgram.state_pytree`` layout (:func:`repro_torch.models.
convert.train_state_to_numpy`), so a JAX checkpoint resumes here and this
program's restore in JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.comm import bytes_model
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import pairing as pairing_lib
from repro_torch.core.noloco import GossipTrainer, TrainerConfig, TrainState
from repro_torch.device import resolve_device
from repro_torch.models import convert
from repro_torch.models import model as model_api
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map

PyTree = Any

__all__ = ["GossipProgram"]


class GossipProgram:
    """Stacked-simulation runtime over :class:`GossipTrainer`.

    ``partners`` records the partner table of every NoLoCo outer step, in
    order."""

    membership_epoch = 0  # full membership, never changes

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, *, replicas: int, seed: int = 0,
                 device: torch.device | str = "cuda"):
        tcfg.comm.validate()
        if tcfg.comm.streams > 1 or tcfg.comm.overlap:
            raise NotImplementedError(
                "streaming outer steps and the φ-prefetch overlap are not ported yet "
                "(ROADMAP Queue 1 item 10)"
            )
        self.cfg = cfg
        self.tcfg = tcfg
        self.replicas = replicas
        self.seed = seed
        self.device = resolve_device(device)
        self.membership = pairing_lib.Membership.full(replicas)
        self.partners: list[np.ndarray] = []
        self.trainer = GossipTrainer(
            tcfg, lambda params, batch: model_api.stacked_loss(params, cfg, batch)
        )

    def initial_params(self) -> PyTree:
        """One replica's starting weights, on the CPU."""
        return model_api.init_params(torch.Generator().manual_seed(self.seed), self.cfg)

    def _batch(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    # -- TrainProgram -------------------------------------------------------

    def init_state(self, example_batch: dict) -> TrainState:
        r = self.replicas
        stacked = tree_map(
            lambda p: p.to(self.device).unsqueeze(0).repeat((r,) + (1,) * p.dim()),
            self.initial_params(),
        )
        return self.trainer.init(stacked)

    def inner_step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        return self.trainer.inner_step(state, self._batch(batch))

    def maybe_outer_step(self, state: TrainState) -> tuple[TrainState, bool]:
        if not self.trainer.should_sync(state):
            return state, False
        partner = None
        if self.tcfg.outer.method == "noloco":
            partner = pairing_lib.elastic_partner_table(
                state.outer.step, self.membership, seed=self.tcfg.outer.seed
            )
            self.partners.append(partner)
        return self.trainer.outer_step(state, partner=partner), True

    def eval_step(self, state: TrainState, batch: dict) -> float:
        return float(self.trainer.eval_loss(state.theta, self._batch(batch)).mean())

    def weight_std(self, state: TrainState) -> float:
        if self.replicas < 2:
            return 0.0
        return float(metrics_lib.replica_weight_std(state.theta))

    def state_pytree(self, state: TrainState) -> dict:
        return convert.train_state_to_numpy(state)

    def load_state_pytree(self, state: TrainState, tree: dict) -> TrainState:
        """The state of a checkpoint in the JAX layout.  Only full
        membership is ported: a saved membership with a dropped replica or
        a partition, or in-flight streaming state, raises."""
        mem = tree.get("membership")
        if mem is not None:
            mask = np.asarray(mem["mask"], dtype=bool)
            if mask.shape != (self.replicas,):
                raise ValueError(f"checkpoint holds {mask.shape[0]} replicas, this run {self.replicas}")
            if not mask.all() or (np.asarray(mem["partition"]) >= 0).any():
                raise NotImplementedError(
                    "the checkpoint's membership has dropped replicas or a partition; elastic "
                    "membership is not ported yet (ROADMAP Queue 1 item 10)"
                )
        if "stream" in tree:
            raise NotImplementedError(
                "the checkpoint holds streaming outer-step state; streaming is not ported "
                "yet (ROADMAP Queue 1 item 10)"
            )
        return convert.train_state_from_jax_numpy(tree, self.cfg, device=self.device)

    def comm_cost(self):
        method = self.tcfg.outer.method
        if method == "none":  # also the fsdp baseline, whose outer step is "none"
            return None
        return bytes_model.outer_step_cost(
            bytes_model.abstract_params(self.cfg), self.tcfg.comm, method=method,
            world=self.replicas,
        )
