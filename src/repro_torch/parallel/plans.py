"""Parallelism plans: which rank holds which replica.

The port of ``repro/parallel/plans.py`` for the replica axis.  Under the
JAX package's ``gossip_dp`` plan every ``data`` coordinate of the mesh is
one NoLoCo replica with its own weights, and weight matrices shard over
``model`` within a replica.  The port runs the plan at model-axis size 1:
one rank per replica, the replica's whole state on the rank's device, so
the inner step makes no cross-rank call.  Tensor parallelism over
``model`` and the ``fsdp_hybrid`` plan (ZeRO-3 within a replica, gossip
between pods) come with ROADMAP Queue 1 item 9c, the model axis.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

__all__ = ["Plan", "make_plan", "MODEL_AXIS_ITEM"]

MODEL_AXIS_ITEM = "ROADMAP Queue 1 item 9c (the model axis)"


@dataclasses.dataclass(frozen=True)
class Plan:
    """``replicas`` NoLoCo replicas, one per rank, each whole on its rank:
    no model axis yet, so ``tp`` and ``fsdp`` are 1."""

    name: str = "gossip_dp"
    replicas: int = 1
    tp: ClassVar[int] = 1
    fsdp: ClassVar[int] = 1

    @property
    def world(self) -> int:
        """Ranks the plan needs: one per replica."""
        return self.replicas

    def replica_of(self, rank: int) -> int:
        """The replica rank ``rank`` holds: its own."""
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a world of {self.world}")
        return rank


def make_plan(plan_name: str, data: int, model: int = 1) -> Plan:
    """The plan over ``data`` replica ranks and a model axis of ``model``
    ranks a replica.  Only ``gossip_dp`` at ``model == 1`` runs here."""
    if plan_name == "fsdp_hybrid":
        raise NotImplementedError(f"the fsdp_hybrid plan comes with {MODEL_AXIS_ITEM}")
    if plan_name != "gossip_dp":
        raise ValueError(f"unknown plan {plan_name!r}")
    if data < 1:
        raise ValueError(f"need at least one replica, got data={data}")
    if model != 1:
        raise NotImplementedError(
            f"tensor parallelism over a model axis of {model} comes with {MODEL_AXIS_ITEM}; "
            "run with --model 1")
    return Plan(name=plan_name, replicas=data)
