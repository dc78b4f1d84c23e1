"""Parallelism plans: which rank holds which part of which replica.

The port of ``repro/parallel/plans.py``.  Two plans:

  gossip_dp    every (pod, data) coordinate is one NoLoCo replica with its
               own weights, and the weight matrices of a replica are split
               over its ``model`` ranks (tensor and expert parallelism);
  fsdp_hybrid  the replicas are the pods; inside a pod the weights are
               split ZeRO-3 style over the ``data`` ranks (``fsdp`` of
               them) as well as over ``model``, and each rank gossips its
               shards with its counterpart in the partner pod.

The port runs one rank per (replica, data index, model index), laid out as
the reference's ``(pod, data, model)`` mesh orders its devices: rank ``r``
holds model index ``r % tp`` and data index ``(r // tp) % fsdp`` of
replica ``r // (fsdp · tp)``.

The reference maps each parameter's logical axes to a ``PartitionSpec``
(``spec_for`` / ``param_pspecs``); the port's counterpart cuts the rank's
shard out of a whole tree (:func:`shard_tree`) and puts the shards back
together (:func:`gather_tree`), with the reference's per-dimension rule: a
``"tp"`` or ``"expert"`` dimension is split over the model axis when its
size divides by ``tp``, an ``"fsdp"`` dimension over the data axis when its
size divides by ``fsdp`` (``fsdp_hybrid`` only), and every other dimension
is whole.  ``ShardCtx``'s sizing helpers and ``gather_param`` apply the
same rule, so shards and collectives agree.  A leaf can be split on one
dimension over ``model`` and on another over ``data``.  The logical axes
of the port's parameter trees come from
:func:`repro_torch.models.logical.logical_axes`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.parallel.sharding import ShardCtx
from repro_torch.tree import tree_map

PyTree = Any

__all__ = ["Plan", "make_plan", "ITEM_9E", "shard_dim", "fsdp_dim", "shard_tree",
           "gather_tree", "sharded_mask", "adjust_attn_specs_for_decode"]

ITEM_9E = ("ROADMAP Queue 1 item 9e (elastic, asynchronous and streamed rounds with a "
           "model axis or under fsdp_hybrid)")
PLANS = ("gossip_dp", "fsdp_hybrid")
_MODEL_LOGICAL = ("tp", "expert")


@dataclasses.dataclass(frozen=True)
class Plan:
    """``replicas`` NoLoCo replicas, each split over ``fsdp`` data ranks
    (``fsdp_hybrid``; 1 under ``gossip_dp``) times ``tp`` model ranks."""

    name: str = "gossip_dp"
    replicas: int = 1
    tp: int = 1
    fsdp: int = 1
    model_axis: str = "model"
    kv_shard_seq: bool = False  # decode: shard the KV cache's sequence on the model axis

    @property
    def world(self) -> int:
        """Ranks the plan needs: ``replicas × fsdp × tp``."""
        return self.replicas * self.fsdp * self.tp

    def _check(self, rank: int) -> None:
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a world of {self.world}")

    def replica_of(self, rank: int) -> int:
        """The replica rank ``rank`` holds (a part of)."""
        self._check(rank)
        return rank // (self.fsdp * self.tp)

    def data_index_of(self, rank: int) -> int:
        """Rank ``rank``'s position on its replica's data axis."""
        self._check(rank)
        return (rank // self.tp) % self.fsdp

    def model_index_of(self, rank: int) -> int:
        """Rank ``rank``'s position on its replica's model axis."""
        self._check(rank)
        return rank % self.tp

    def ctx(self, axis=None, data=None) -> ShardCtx:
        """The model code's context on the rank whose model axis is
        ``axis`` and whose data axis is ``data`` (each a
        :class:`~repro_torch.launch.mesh.ModelAxis`; None where the plan
        has no such axis)."""
        for kind, size, ax in (("model", self.tp, axis), ("data", self.fsdp, data)):
            if size > 1 and ax is None:
                raise ValueError(f"a plan of {size} {kind} ranks needs the rank's {kind} axis")
            if ax is not None and ax.size != size:
                raise ValueError(f"{kind} axis of {ax.size} ranks, the plan's of {size}")
        if self.tp == 1 and self.fsdp == 1:
            return ShardCtx.local()
        return ShardCtx(axis=axis if self.tp > 1 else None,
                        index=axis.index if self.tp > 1 else 0, tp=self.tp,
                        data_axis=data if self.fsdp > 1 else None, fsdp=self.fsdp,
                        kv_shard_seq=self.kv_shard_seq)


def make_plan(plan_name: str, data: int, model: int = 1, *, pod: int = 1,
              shape_kind: str = "train", has_global_attention: bool = True) -> Plan:
    """The plan over a ``(pod, data, model)`` layout, as the reference's
    ``make_plan`` reads its mesh: under ``gossip_dp`` every (pod, data)
    coordinate is a replica (``pod × data`` of them), under ``fsdp_hybrid``
    every pod is one, its weights split over its ``data`` ranks.  As in the
    reference, the KV cache's sequence is sharded over the model axis for a
    ``decode`` shape when the model has global attention and tp > 1."""
    if plan_name not in PLANS:
        raise ValueError(f"unknown plan {plan_name!r}; options: {list(PLANS)}")
    if min(pod, data, model) < 1:
        raise ValueError(f"need at least one rank on each axis, got pod={pod}, data={data}, "
                         f"model={model}")
    kv_shard_seq = shape_kind == "decode" and has_global_attention and model > 1
    if plan_name == "fsdp_hybrid":
        return Plan(name=plan_name, replicas=pod, tp=model, fsdp=data, kv_shard_seq=kv_shard_seq)
    return Plan(name=plan_name, replicas=pod * data, tp=model, kv_shard_seq=kv_shard_seq)


# ---------------------------------------------------------------------------
# Logical axes -> the rank's shard
# ---------------------------------------------------------------------------


def shard_dim(axes: Sequence, shape: Sequence[int], plan: Plan) -> int | None:
    """The dimension of a leaf of GLOBAL ``shape`` and logical ``axes``
    that the model axis splits, or None (the leaf is whole over the model
    axis): the reference's ``spec_for`` rule for ``"tp"`` / ``"expert"``."""
    if plan.tp == 1:
        return None
    for i, (name, size) in enumerate(zip(axes, shape)):
        if name in _MODEL_LOGICAL and size % plan.tp == 0:
            return i
    return None


def fsdp_dim(axes: Sequence, shape: Sequence[int], plan: Plan) -> int | None:
    """The dimension that the data axis splits (ZeRO-3, ``fsdp_hybrid``),
    or None: the reference's ``spec_for`` rule for ``"fsdp"``."""
    if plan.fsdp == 1:
        return None
    for i, (name, size) in enumerate(zip(axes, shape)):
        if name == "fsdp" and size % plan.fsdp == 0:
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


def sharded_mask(logical: PyTree, shapes: PyTree, plan: Plan, axis: str = "model") -> PyTree:
    """Per leaf: is it split over the model axis (``axis="model"``) or
    over the data axis (``"data"``)?  ``shapes`` holds each leaf's GLOBAL
    shape (tensors, or anything with ``.shape``)."""
    rule = {"model": shard_dim, "data": fsdp_dim}[axis]
    return tree_map(lambda s, ax: rule(ax.names, tuple(s.shape), plan) is not None,
                    shapes, logical)


def shard_tree(full: PyTree, logical: PyTree, plan: Plan, model_index: int,
               data_index: int = 0) -> PyTree:
    """The shard of the whole tree ``full`` at (``data_index``,
    ``model_index``): each split leaf sliced to its contiguous block on
    each axis that splits it (a copy), every other leaf as it is."""
    def one(x, ax):
        shape = tuple(x.shape)
        dim, ddim = shard_dim(ax.names, shape, plan), fsdp_dim(ax.names, shape, plan)
        if dim is None and ddim is None:
            return x
        if dim is not None:
            n = x.shape[dim] // plan.tp
            x = x.narrow(dim, model_index * n, n)
        if ddim is not None:
            n = x.shape[ddim] // plan.fsdp
            x = x.narrow(ddim, data_index * n, n)
        return x.contiguous()

    return tree_map(one, full, logical)


def gather_tree(shards: Sequence[PyTree], logical: PyTree, plan: Plan,
                shapes: PyTree) -> PyTree:
    """The whole tree from the ``fsdp × tp`` shards of a replica in rank
    order (shard ``d · tp + m`` at data index d, model index m), the
    inverse of :func:`shard_tree`; ``shapes`` gives the global shapes that
    decide which leaves were split."""
    def one(s, ax, *parts):
        shape = tuple(s.shape)
        dim, ddim = shard_dim(ax.names, shape, plan), fsdp_dim(ax.names, shape, plan)
        rows = [parts[d * plan.tp:(d + 1) * plan.tp] for d in range(plan.fsdp)]
        rows = [r[0] if dim is None else torch.cat(list(r), dim=dim) for r in rows]
        return rows[0] if ddim is None else torch.cat(rows, dim=ddim)

    return tree_map(one, shapes, logical, *shards)
