"""Parallelism plans: which rank holds which part of which replica.

The port of ``repro/parallel/plans.py``.  Under the ``gossip_dp`` plan
every ``data`` coordinate is one NoLoCo replica with its own weights, and
the weight matrices of a replica are split over its ``model`` ranks
(tensor and expert parallelism).  The port runs one rank per (replica,
model index), rank-major over the model axis as the reference's
``(data, model)`` mesh lays its devices: rank ``r`` holds model index
``r % tp`` of replica ``r // tp``.

The reference maps each parameter's logical axes to a ``PartitionSpec``
(``spec_for`` / ``param_pspecs``); the port's counterpart cuts the rank's
shard out of a whole tree (:func:`shard_tree`) and puts the shards back
together (:func:`gather_tree`), with the reference's per-dimension rule:
a ``"tp"`` or ``"expert"`` dimension is split over the model axis when its
size divides by ``tp`` and kept whole otherwise, the rule that ``ShardCtx``'s sizing helpers
apply, so shards and collectives agree.  ``"fsdp"`` dimensions stay whole:
the ``fsdp_hybrid`` plan (ZeRO-3 within a replica, gossip between pods) is
ROADMAP Queue 1 item 9d.  The logical axes of the port's parameter trees
come from :func:`repro_torch.models.logical.logical_axes`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Sequence

import torch

from repro_torch.parallel.sharding import ShardCtx
from repro_torch.tree import tree_map

PyTree = Any

__all__ = ["Plan", "make_plan", "ZERO3_ITEM", "shard_dim", "shard_tree", "gather_tree",
           "sharded_mask", "adjust_attn_specs_for_decode"]

ZERO3_ITEM = ("ROADMAP Queue 1 item 9d (fsdp_hybrid, and elastic, asynchronous and "
              "streamed rounds with a model axis)")
_MODEL_LOGICAL = ("tp", "expert")


@dataclasses.dataclass(frozen=True)
class Plan:
    """``replicas`` NoLoCo replicas, each split over ``tp`` model ranks."""

    name: str = "gossip_dp"
    replicas: int = 1
    tp: int = 1
    model_axis: str = "model"
    fsdp: ClassVar[int] = 1
    kv_shard_seq: bool = False  # decode: shard the KV cache's sequence on the model axis

    @property
    def world(self) -> int:
        """Ranks the plan needs: ``replicas × tp``."""
        return self.replicas * self.tp

    def _check(self, rank: int) -> None:
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a world of {self.world}")

    def replica_of(self, rank: int) -> int:
        """The replica rank ``rank`` holds (a part of)."""
        self._check(rank)
        return rank // self.tp

    def model_index_of(self, rank: int) -> int:
        """Rank ``rank``'s position on its replica's model axis."""
        self._check(rank)
        return rank % self.tp

    def ctx(self, axis=None) -> ShardCtx:
        """The model code's context on the rank whose model axis is
        ``axis`` (a :class:`~repro_torch.launch.mesh.ModelAxis`; None
        without one, for a plan of ``tp`` 1)."""
        if self.tp > 1 and axis is None:
            raise ValueError(f"a plan of tp {self.tp} needs the rank's model axis")
        if axis is not None and axis.size != self.tp:
            raise ValueError(f"model axis of {axis.size} ranks, plan tp {self.tp}")
        if self.tp == 1:
            return ShardCtx.local()
        return ShardCtx(axis=axis, index=axis.index, tp=self.tp, kv_shard_seq=self.kv_shard_seq)


def make_plan(plan_name: str, data: int, model: int = 1, *, shape_kind: str = "train",
              has_global_attention: bool = True) -> Plan:
    """The plan over ``data`` replicas of ``model`` ranks each.  As in the
    reference, the KV cache's sequence is sharded over the model axis for
    a ``decode`` shape when the model has global attention and tp > 1."""
    if plan_name == "fsdp_hybrid":
        raise NotImplementedError(f"the fsdp_hybrid plan comes with {ZERO3_ITEM}")
    if plan_name != "gossip_dp":
        raise ValueError(f"unknown plan {plan_name!r}")
    if data < 1 or model < 1:
        raise ValueError(f"need at least one replica and one model rank, got data={data}, "
                         f"model={model}")
    kv_shard_seq = shape_kind == "decode" and has_global_attention and model > 1
    return Plan(name=plan_name, replicas=data, tp=model, kv_shard_seq=kv_shard_seq)


# ---------------------------------------------------------------------------
# Logical axes -> the rank's shard
# ---------------------------------------------------------------------------


def shard_dim(axes: Sequence, shape: Sequence[int], plan: Plan) -> int | None:
    """The dimension of a leaf of GLOBAL ``shape`` and logical ``axes``
    that the model axis splits, or None (the leaf is whole on every rank):
    the reference's ``spec_for`` rule for ``"tp"`` / ``"expert"``."""
    if plan.tp == 1:
        return None
    for i, (name, size) in enumerate(zip(axes, shape)):
        if name in _MODEL_LOGICAL and size % plan.tp == 0:
            return i
    return None


def adjust_attn_specs_for_decode(plan: Plan, logical: PyTree) -> PyTree:
    """Under ``kv_shard_seq`` the attention heads are whole on every rank
    (``ShardCtx.heads_tp`` is 1): the logical tree with the model-axis
    names dropped inside every ``attn`` / ``cross_attn`` subtree."""
    if not plan.kv_shard_seq:
        return logical

    def walk(node, inside):
        if isinstance(node, dict):
            return {k: walk(v, inside or k in ("attn", "cross_attn")) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, inside) for v in node]
        if node is None or not inside:
            return node
        return type(node)(tuple(None if n in _MODEL_LOGICAL else n for n in node.names))

    return walk(logical, False)


def sharded_mask(logical: PyTree, shapes: PyTree, plan: Plan) -> PyTree:
    """Per leaf: is it split over the model axis?  ``shapes`` holds each
    leaf's GLOBAL shape (tensors, or anything with ``.shape``)."""
    return tree_map(lambda s, ax: shard_dim(ax.names, tuple(s.shape), plan) is not None,
                    shapes, logical)


def shard_tree(full: PyTree, logical: PyTree, plan: Plan, model_index: int) -> PyTree:
    """Rank ``model_index``'s shard of the whole tree ``full``: each split
    leaf sliced to its contiguous block (a copy), every other leaf as it
    is."""
    def one(x, ax):
        dim = shard_dim(ax.names, tuple(x.shape), plan)
        if dim is None:
            return x
        n = x.shape[dim] // plan.tp
        return x.narrow(dim, model_index * n, n).contiguous()

    return tree_map(one, full, logical)


def gather_tree(shards: Sequence[PyTree], logical: PyTree, plan: Plan,
                shapes: PyTree) -> PyTree:
    """The whole tree from the ``tp`` ranks' shards (model-index order),
    the inverse of :func:`shard_tree`; ``shapes`` gives the global shapes
    that decide which leaves were split."""
    def one(s, ax, *parts):
        dim = shard_dim(ax.names, tuple(s.shape), plan)
        return parts[0] if dim is None else torch.cat(list(parts), dim=dim)

    return tree_map(one, shapes, logical, *shards)
