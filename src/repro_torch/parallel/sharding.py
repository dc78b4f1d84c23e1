"""ShardCtx: the model and data axes inside a replica, seen from the model code.

The port of ``repro/parallel/sharding.py``.  ``ShardCtx.local()`` is the
identity: every collective returns its input and every weight is whole, so
the model code runs unchanged on one device.  A context made by
:meth:`repro_torch.parallel.plans.Plan.ctx` holds the rank's model axis
(:class:`repro_torch.launch.mesh.ModelAxis`: the ``torch.distributed``
subgroup of the ranks of its replica that share its data index), its index
on that axis and its size ``tp`` and, under the ``fsdp_hybrid`` plan, its
data axis (the subgroup of the ranks of its replica that share its model
index) and that axis's size ``fsdp``.  The weights it meets are the
rank's shards (``plans.shard_tree``) and the collectives run over the
subgroups.  The sizing helpers (``heads_tp``, ``ff_tp``, ``vocab_tp``,
``experts_tp``) and ``gather_param`` apply the same per-dimension rule as
``plans.shard_tree``: a dimension that does not divide by the axis size is
kept whole, so the collectives and the shards agree.

ZeRO-3.  Under ``fsdp_hybrid`` every weight is stored split over the data
axis on its ``"fsdp"`` dimension (the model width d) and all-gathered just
before use (:meth:`ShardCtx.gather_param`); the gather's backward is the
reduce-scatter of the gathered weight's gradient, so each data rank ends
with its block of the sum over the data ranks, ZeRO's gradient sharding.
The port gathers only what the plan split (a width that does not divide by
``fsdp`` stays whole); the reference gathers every ``"fsdp"`` weight, whatever
``spec_for`` decided.

Gradients.  Every collective on a differentiated path is a
``torch.autograd.Function`` whose backward is the transpose of its forward,
as JAX transposes the reference's ``lax`` collectives under ``shard_map``
with ``check_vma=False``: ``psum`` → ``psum``, ``all_gather`` →
``psum_scatter``, ``psum_scatter`` → ``all_gather``, a tiled ``all_to_all``
→ the inverse ``all_to_all``.  The reference differentiates outside its
``shard_map``, where the cotangent of the loss (an output replicated over
the model and data axes) reaches each rank divided by ``tp × fsdp`` and the
cotangent of every input replicated over an axis is summed over it.  The
port does the same around its own backward (``parallel/steps.py``): each
rank seeds the backward with 1/(tp · fsdp) of its loss's cotangent, and
after the backward sums the gradients of the leaves it holds whole over
the model axis, and of those it holds whole over the data axis, over that
axis (:func:`psum_replicated`).  With that, every leaf's gradient on every
rank is the unsharded gradient of the slice the rank holds: the sum over
the ranks of their partial activation gradients is the true one at each
collective and at each whole leaf, by linearity.  This is the reference's
own transposition, which is exact (the JAX package's sharded gradients
equal its unsharded ones to fp32 rounding), rather than Megatron's pair of
an identity forward with an all-reduce backward at every place where a
replicated activation enters a column-parallel product, which would need
that operator at each such place (the K/V slices of grouped heads, the
MoE block's sequence split, the router) to give the same numbers.

``pmax_model`` runs only on a stop-gradient maximum
(``layers.cross_entropy_parts``, the decode's softmax combine) and has no
backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["ShardCtx", "psum_replicated"]


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, axis):
        fctx.axis = axis
        return axis.all_reduce(x, "sum")

    @staticmethod
    def backward(fctx, g):
        return fctx.axis.all_reduce(g.contiguous(), "sum"), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, axis, dim):
        fctx.axis, fctx.dim = axis, dim
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(fctx, g):
        return fctx.axis.reduce_scatter(g, fctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, axis, dim):
        fctx.axis, fctx.dim = axis, dim
        return axis.reduce_scatter(x, dim)

    @staticmethod
    def backward(fctx, g):
        return fctx.axis.all_gather(g, fctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, axis, split, concat):
        fctx.axis, fctx.split, fctx.concat = axis, split, concat
        return axis.all_to_all(x, split, concat)

    @staticmethod
    def backward(fctx, g):
        return fctx.axis.all_to_all(g, fctx.concat, fctx.split), None, None, None


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Model-axis size and flags visible to model code, and the axis.

    ``axis``         — the rank's :class:`~repro_torch.launch.mesh.ModelAxis`
                       (None: no model axis, tp = 1).
    ``index``        — the rank's position on the axis (0 without one).
    ``tp``           — the axis size.
    ``kv_shard_seq`` — decode: dense KV caches are sharded over the axis on
                       the sequence dimension; attention heads are then
                       whole on every rank and the partial softmax of each
                       rank's slice is combined by ``pmax``/``psum``.
    ``replicate_experts`` — keep every expert on every rank (no all-to-all).
    ``data_axis``    — the rank's data axis under ``fsdp_hybrid`` (ZeRO-3
                       within the replica; None otherwise).
    ``fsdp``         — the data axis's size."""

    axis: Any = None
    index: int = 0
    tp: int = 1
    kv_shard_seq: bool = False
    replicate_experts: bool = False
    data_axis: Any = None
    fsdp: int = 1

    @staticmethod
    def local() -> "ShardCtx":
        return ShardCtx()

    @property
    def model_axis(self):
        """The axis, or None for the local context (the reference's name)."""
        return self.axis if self.tp > 1 else None

    # -- model-axis collectives ---------------------------------------------

    def psum_model(self, x: torch.Tensor) -> torch.Tensor:
        if self.model_axis is None:
            return x
        return _Psum.apply(x.contiguous(), self.axis)

    def pmax_model(self, x: torch.Tensor) -> torch.Tensor:
        """Max over the axis of a value that carries no gradient."""
        if self.model_axis is None:
            return x
        if x.requires_grad:
            raise ValueError("pmax_model takes a stop-gradient value")
        return self.axis.all_reduce(x.contiguous(), "max")

    def all_gather_model(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        if self.model_axis is None:
            return x
        return _AllGather.apply(x, self.axis, axis % x.dim())

    def reduce_scatter_model(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        if self.model_axis is None:
            return x
        return _ReduceScatter.apply(x, self.axis, axis % x.dim())

    def all_to_all_model(self, x: torch.Tensor, split_axis: int, concat_axis: int
                         ) -> torch.Tensor:
        if self.model_axis is None:
            return x
        return _AllToAll.apply(x, self.axis, split_axis % x.dim(), concat_axis % x.dim())

    def model_index(self) -> int:
        return self.index if self.model_axis is not None else 0

    # -- data-axis (ZeRO-3) helpers ------------------------------------------

    def gather_param(self, w: torch.Tensor, axis: int, size: int) -> torch.Tensor:
        """ZeRO-3: the whole weight from the rank's block of ``w`` on
        dimension ``axis``, whose global length is ``size``: a tiled
        all-gather over the data axis where the plan split that dimension
        (``size`` divides by ``fsdp``), ``w`` itself otherwise.  Its
        backward is the reduce-scatter over the data axis.  Count ``axis``
        from the end (-1, -2, ...) so that a replica-stacked weight and an
        unstacked one name the same dimension."""
        if self.data_axis is None or size % self.fsdp:
            return w
        return _AllGather.apply(w, self.data_axis, axis % w.dim())

    # -- sequence-parallel activation movement --------------------------------

    def scatter_seq_sum(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """A row-parallel product's partial sums → the whole sum (``psum``)."""
        return self.psum_model(x)

    # -- sizing helpers -------------------------------------------------------

    def heads_tp(self, num_heads: int) -> int:
        """Ranks the attention heads split over: tp where the heads divide
        by it, 1 (attention whole on every rank) otherwise, and always 1
        under ``kv_shard_seq`` (the axis shards the KV cache's sequence)."""
        if self.model_axis is None or self.kv_shard_seq:
            return 1
        return self.tp if num_heads % self.tp == 0 else 1

    def ff_tp(self, d_ff: int) -> int:
        if self.model_axis is None:
            return 1
        return self.tp if d_ff % self.tp == 0 else 1

    def vocab_tp(self, vocab: int) -> int:
        if self.model_axis is None:
            return 1
        return self.tp if vocab % self.tp == 0 else 1

    def experts_tp(self, num_experts: int) -> int:
        if self.model_axis is None or self.replicate_experts:
            return 1
        return self.tp if num_experts % self.tp == 0 else 1


def psum_replicated(grads: list[torch.Tensor], sharded: list[bool], axis) -> list[torch.Tensor]:
    """``grads`` with every leaf the rank holds whole over ``axis``
    (``sharded`` False) summed over that axis (the model or the data
    axis), in one all-reduce of a packed buffer per dtype: the reference's
    transpose of an input replicated over the axis."""
    out = list(grads)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, (g, s) in enumerate(zip(grads, sharded)):
        if not s:
            by_dtype.setdefault(g.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        summed = axis.all_reduce(flat, "sum")
        offset = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = summed[offset:offset + n].view(grads[i].shape)
            offset += n
    return out
