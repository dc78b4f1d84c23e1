"""Step builders of the replica group: the inner train step, eval, the
outer step (gossip or all-reduce) and the serving steps, each run by every
rank on its own replica, or its part of one.

The port of ``repro/parallel/steps.py``.  A rank
holds one replica as a replica-stacked tree with a leading axis of 1, so
the port's stacked model, AdamW and kernels run on it unchanged.  As in
the reference, the train step descends the mean of the replicas' losses
(the reference differentiates ``sum(losses) / replicas`` outside its
``shard_map``), so each rank's gradient is its own loss's divided by the
world; the step makes no cross-rank call unless ``data_sync`` asks for the
DDP/FSDP baseline, which all-reduces the gradients every step.

With a model axis (``plan.tp`` > 1) the rank holds its shard of its
replica (``plans.shard_tree``) and runs ``loss_fn`` under the plan's
:class:`~repro_torch.parallel.sharding.ShardCtx`.  As in the reference,
which differentiates outside its ``shard_map``, the backward starts from
1/tp of the loss's cotangent on each rank, every collective's backward is
its transpose, and the gradients of the leaves the rank holds whole are
summed over the model axis after the backward
(``sharding.psum_replicated``): every leaf's gradient is then the unsharded
gradient of the rank's slice.  AdamW clips by the replica's whole norm:
the squares of the split leaves summed over the model axis, each whole
leaf counted once.  The model axis's calls in one inner step of a model
with L attention + MLP layers are, from the code: forward 2L + 4 (each
layer's attention and MLP output ``psum``; the embedding's ``psum``; the
cross entropy's ``pmax`` and two ``psum``), backward 2L + 3 (the
transposes of the ``psum`` calls: the ``pmax`` carries no gradient), one
all-reduce of the whole leaves' gradients per dtype, and one of the
norm's squares: 4L + 8 + dtypes, plus L more
under ``cfg.remat``: the backward recomputes each layer's forward up to
the last tensor the backward saves, which takes the attention output's
``psum`` (the norm after it saves its input) and stops before the MLP's.

Under the ``fsdp_hybrid`` plan (``plan.fsdp`` > 1) a replica is a pod and
its ranks also split its weights over a data axis (ZeRO-3).  As the
reference's ``batch_pspecs`` lays the batch, each data rank takes its
contiguous B/fsdp rows of its replica's batch (the whole batch where B
does not divide by fsdp); the model code gathers each weight over the data
axis just before use (``ShardCtx.gather_param``, whose backward is the
reduce-scatter); the loss is the mean over the data ranks of theirs
(``pmean``), so the backward's seed carries 1/(tp · fsdp); after it the
gradients of the leaves held whole over the model axis are summed over
that axis and those of the leaves held whole over the data axis over the
data axis (a leaf can be split on one and whole on the other: ``w_k`` is
split on data and whole on model, ``lam`` the other way round), and the
clipping norm is the replica's: each split leaf's squares summed over the
axes that split it, each whole leaf counted once.  The data axis's calls
in one inner step are, from the code: one all-gather per use of a split
leaf in the forward (each layer's uses again under ``cfg.remat``, whose
backward recomputes the layer), one reduce-scatter per use in the
backward, one all-reduce per dtype of the leaves held whole over the
axis, one of the norm's squares and one of the loss (its ``pmean``).

The outer step moves the packed (Δ, φ) payload to the round's partner and
back in one batched send/receive (NoLoCo) or all-reduces Δ (DiLoCo).  The
reference compiles one ``ppermute`` program per pairing, so its
:class:`OuterProgramPool` cycles a bounded pool of matchings; a send and a
receive need no compiled permutation, but the port deals the same pool
slots and hypercube dimensions, so a run's partners are the reference's.
With nothing to compile, a pool entry is the round's pairs and outer-step
function, keyed as the reference keys its programs: by membership view
and slot, and for a streamed sync or an asynchronous tick by the variant
too, so ``misses`` counts the first use of a key and ``stats()`` is the
reference's for the same run.  With a model axis each rank exchanges its
shards, and its copy of the whole leaves, with the rank of the partner
replica that holds its model index; DiLoCo all-reduces over the ranks with
its model index.

``build_prefill_step`` / ``build_decode_step`` serve one replica's rows on
its model ranks: under the decode plan (``kv_shard_seq``) the attention
heads are whole on every rank (``plans.adjust_attn_specs_for_decode``), the
dense cache of each global layer is split by sequence, and the logits are
the rank's vocabulary slice, which :func:`gather_logits` puts together.
"""

from __future__ import annotations

import dataclasses
import time
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
from repro_torch.models.logical import logical_axes
from repro_torch.optim import AdamWConfig, AdamWState, adamw_init, adamw_update
from repro_torch.optim.adamw import _square_sum
from repro_torch.parallel import plans as plans_lib
from repro_torch.parallel.plans import Plan
from repro_torch.parallel.sharding import ShardCtx, psum_replicated
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = ["TrainStepBundle", "build_train_step", "init_opt_state", "build_outer_step",
           "OuterProgramPool", "leaf_mask", "build_prefill_step",
           "build_decode_step", "gather_logits", "shard_params"]


@dataclasses.dataclass
class TrainStepBundle:
    step_fn: Callable   # (theta, opt, batch) -> (theta, opt, metrics)
    eval_fn: Callable   # (theta, batch) -> (1,) losses, grad-free


def leaf_mask(cfg: ModelConfig, plan: Plan, axis: str = "model") -> list[bool]:
    """Per parameter leaf (flatten order): is it split over the model axis
    (``axis="model"``), or over the data axis (``"data"``)?"""
    from repro_torch.comm import bytes_model

    return tree_leaves(plans_lib.sharded_mask(logical_axes(cfg), bytes_model.abstract_params(cfg),
                                              plan, axis))


def shard_params(full: PyTree, cfg: ModelConfig, plan: Plan, model_index: int, *,
                 stacked: bool = True, data_index: int = 0) -> PyTree:
    """The shard at (``data_index``, ``model_index``) of a whole parameter
    tree (replica-stacked with ``stacked``), under the plan's attention
    specs (whole heads under ``kv_shard_seq``)."""
    from repro_torch.models.logical import stacked as stack_axes

    logical = plans_lib.adjust_attn_specs_for_decode(plan, logical_axes(cfg))
    return plans_lib.shard_tree(full, stack_axes(logical) if stacked else logical, plan,
                                model_index, data_index)


def gather_shards(tree: PyTree, cfg: ModelConfig, plan: Plan, axis, data=None) -> PyTree:
    """The whole replica-stacked tree from the rank's shard of it: each
    leaf split over the data axis all-gathered over ``data`` first, then
    each leaf split over the model axis over the model ``axis``; every
    other leaf as it is (the rank's own copy)."""
    from repro_torch.comm import bytes_model
    from repro_torch.comm.payload import LeafShape
    from repro_torch.models.logical import stacked

    shapes = tree_map(lambda x: LeafShape((1,) + tuple(x.shape), x.dtype),
                      bytes_model.abstract_params(cfg))

    def one(x, s, ax):
        x = x.detach()
        ddim = plans_lib.fsdp_dim(ax.names, s.shape, plan)
        if ddim is not None:
            x = data.all_gather(x, ddim)
        dim = plans_lib.shard_dim(ax.names, s.shape, plan)
        return x if dim is None else axis.all_gather(x, dim)

    return tree_map(one, tree, shapes, stacked(logical_axes(cfg)))


def _replica_norm(grads: list[torch.Tensor], split_model: list[bool], split_data: list[bool],
                  ctx: ShardCtx) -> torch.Tensor:
    """(R,) norm of each replica's whole gradient from the rank's leaves:
    each split leaf's squares summed over the axes that split it (model,
    data or both), each whole leaf counted once."""
    squares: dict[tuple[bool, bool], list] = {}
    for g, m, d in zip(grads, split_model, split_data):
        squares.setdefault((m, d), []).append(_square_sum(g))
    zero = torch.zeros(grads[0].shape[0], dtype=torch.float32, device=grads[0].device)
    part = {key: torch.stack(v, dim=1).sum(dim=1) for key, v in squares.items()}
    model_part, both = part.get((True, False), zero), part.get((True, True), zero)
    if ctx.model_axis is not None and ctx.data_axis is not None:
        model_part, both = ctx.psum_model(torch.stack([model_part, both])).unbind(0)
    elif ctx.model_axis is not None:
        model_part = ctx.psum_model(model_part)
    total = part.get((False, False), zero) + model_part
    if ctx.data_axis is not None:
        total = total + ctx.data_axis.all_reduce(part.get((False, True), zero) + both, "sum")
    return total.sqrt()


def data_rows(batch: dict, plan: Plan, data_index: int) -> dict:
    """The rows of a replica's (1, B, ...) batch that data index
    ``data_index`` trains on: its contiguous B/fsdp rows, as the
    reference's ``batch_pspecs`` splits the batch over the data axis; the
    whole batch where B does not divide by fsdp (every data rank then
    computes the same loss)."""
    if plan.fsdp == 1:
        return batch

    def rows(x):
        b = x.shape[1]
        if b % plan.fsdp:
            return x
        n = b // plan.fsdp
        return x.narrow(1, data_index * n, n)

    return {k: rows(v) for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, plan: Plan, group, inner: AdamWConfig, *,
                     data_sync: bool = False) -> TrainStepBundle:
    """The rank's inner step on its replica: forward, backward of its loss
    over ``plan.replicas``, AdamW (the moments donated: updated in place).
    ``data_sync`` means the gradients over the replica axis before the
    update.  ``batch`` leaves are (1, B, S) on the rank's device, the
    replica's batch; with a model or a data axis ``theta`` is the rank's
    shard, every model rank trains on the rows of its data index
    (:func:`data_rows`) and the loss reported is the replica's (the mean
    over its data ranks)."""
    world, tp, fsdp = plan.replicas, plan.tp, plan.fsdp
    ctx = plan.ctx(group.model if tp > 1 else None, group.data if fsdp > 1 else None)
    split_model, split_data = leaf_mask(cfg, plan), leaf_mask(cfg, plan, "data")
    data_index = group.data_index if fsdp > 1 else 0

    def pmean_data(x: torch.Tensor) -> torch.Tensor:
        return x if fsdp == 1 else group.data.all_reduce(x, "sum") / fsdp

    def step(theta, opt, batch):
        batch = data_rows(batch, plan, data_index)
        params = tree_map(lambda p: p.detach().requires_grad_(), theta)
        losses = model_api.stacked_loss(params, cfg, batch, ctx)
        grads = list(torch.autograd.grad(losses.sum() / (world * tp * fsdp),
                                         tree_leaves(params)))
        norm = None
        if tp > 1:
            grads = psum_replicated(grads, split_model, group.model)
        if fsdp > 1:
            grads = psum_replicated(grads, split_data, group.data)
        grads = tree_unflatten(params, grads)
        if data_sync and world > 1:
            grads = exchange_lib.AllReduce(group).allreduce_mean(grads)
        if (tp > 1 or fsdp > 1) and inner.clip_norm is not None:
            norm = _replica_norm(tree_leaves(grads), split_model, split_data, ctx)
        with torch.no_grad():
            theta, opt, gnorm = adamw_update(grads, opt, theta, inner, norm=norm)
        return theta, opt, {"loss": pmean_data(losses.detach()), "grad_norm": gnorm}

    @torch.no_grad()
    def eval_fn(theta, batch):
        batch = data_rows(batch, plan, data_index)
        return pmean_data(model_api.stacked_loss(theta, cfg, batch, ctx))

    return TrainStepBundle(step_fn=step, eval_fn=eval_fn)


def init_opt_state(theta: PyTree) -> AdamWState:
    """AdamW state of the rank's replica-stacked parameters."""
    return adamw_init(theta)


def build_outer_step(plan: Plan, outer_cfg: OuterConfig, pairs, *, group,
                     comm_cfg: CommConfig | None = None, active=None, staleness=None,
                     stream: int | None = None, partition=None, consume_prefetch: bool = False,
                     pairs_presend=None) -> Callable:
    """One outer step of the rank's replica.  NoLoCo exchanges with the
    partner of ``pairs``, the (source, destination) list over ranks;
    DiLoCo all-reduces; ``none`` moves nothing.

    ``active`` (host (world,) bool mask or None) is the round's update
    set: a rank outside it runs no update and keeps (θ, φ, δ), and elastic
    DiLoCo means over the set.  ``staleness`` (host (world,) τ of an
    asynchronous tick) discounts each rank's Δ on the wire.

    Without ``stream``: ``(theta, phi, delta, step) -> (theta', phi',
    delta', step + 1)``.  With ``stream`` (one stream of ``partition``,
    :func:`~repro_torch.core.outer.outer_step_sharded_stream`):
    ``(theta, phi, delta, step, phi_pre) -> (theta', phi', delta', step + 1,
    pending)``; ``consume_prefetch`` reads the partner's φ from ``phi_pre``,
    ``pairs_presend`` posts the φ′ pre-send along that pairing and
    ``pending`` is its :class:`~repro_torch.comm.exchange.PendingTree`."""
    rank = group.replica if group is not None else 0
    flag = None if active is None else bool(np.asarray(active, dtype=bool)[rank])
    participants = None if active is None else int(np.asarray(active, dtype=bool).sum())
    tau = None if staleness is None else float(np.asarray(staleness, dtype=np.float32)[rank])
    if stream is not None:
        if outer_cfg.method != "noloco":
            raise ValueError("streamed outer programs are NoLoCo-only")
        if staleness is not None:
            raise ValueError("staleness (async rounds) does not compose with streaming")

        def stream_fn(theta, phi, delta, step, phi_pre=None):
            new_state, new_theta, pending = outer_lib.outer_step_sharded_stream(
                OuterState(phi=phi, delta=delta, step=step), theta, outer_cfg, group=group,
                stream=stream, partition=partition, pairs=pairs, phi_pre=phi_pre,
                consume_prefetch=consume_prefetch, pairs_next=pairs_presend,
                comm_cfg=comm_cfg, active_flag=flag)
            return new_theta, new_state.phi, new_state.delta, new_state.step, pending

        return stream_fn
    if consume_prefetch or pairs_presend is not None:
        raise ValueError("consume_prefetch/pairs_presend require a streamed program")

    def fn(theta, phi, delta, step):
        state = OuterState(phi=phi, delta=delta, step=step)
        new_state, new_theta = outer_lib.outer_step_sharded(
            state, theta, outer_cfg, group=group, pairs=pairs, comm_cfg=comm_cfg,
            active_flag=flag, participants=participants, staleness=tau)
        return new_theta, new_state.phi, new_state.delta, new_state.step

    return fn


class OuterProgramPool:
    """The outer step of each round, keyed by (membership view, pairing
    slot), as the reference's pool keys its compiled programs.

    ``schedule="random"``: round k uses the matching of slot
    ``k % pairing_pool`` (the reference's cycling pool); ``"hypercube"``:
    partner = rank XOR 2^j with j = :func:`~repro_torch.core.pairing.
    hypercube_dim`.  A partial membership view (dropped replicas,
    stragglers sitting the round out, a partition) draws its pairs over
    the view's members with every other rank paired with itself, and keys
    entries of its own (:meth:`view_key`); two epochs with equal masks
    share them.  A streamed pool (``partition``) keys each entry by
    (stream, consume-or-block, pre-send slot and view), an asynchronous
    tick by (update set, staleness).  ``program`` returns the entry and
    ``info`` (``compiled`` marks a first use, a miss); ``events`` holds one
    record per miss, the reference's fields (``build_s``: the time to
    build the step function)."""

    def __init__(self, plan: Plan, outer_cfg: OuterConfig, *, group,
                 comm_cfg: CommConfig | None = None, schedule: str = "random",
                 pairing_pool: int = 16, seed: int = 0, partition=None):
        if schedule not in ("random", "hypercube"):
            raise ValueError(f"unknown pairing schedule: {schedule!r}")
        self.plan = plan
        self.outer_cfg = outer_cfg
        self.group = group
        self.comm_cfg = comm_cfg or CommConfig()
        self.schedule = schedule
        self.pairing_pool = pairing_pool
        self.seed = seed
        self.partition = partition
        self._programs: dict[Any, Callable] = {}
        self.hits = 0
        self.misses = 0
        self.events: list[dict] = []

    @property
    def max_programs_per_view(self) -> int:
        """Entries per membership view, the reference's bound: the
        random schedule's ``pairing_pool`` or the hypercube's log2(world)
        dimensions (their square under the overlap, whose key pairs the
        sync's slot with the pre-send's), times the streams and, under the
        overlap, the consume-or-block variants."""
        world = self.plan.replicas
        noloco = self.outer_cfg.method == "noloco"
        overlap = self.comm_cfg.overlap and noloco
        streams = self.comm_cfg.streams if noloco else 1
        if self.schedule == "hypercube":
            dims = max(int(np.log2(world)), 1)
            base = dims * dims if overlap else dims
        else:
            base = self.pairing_pool
        return base * streams * (2 if overlap else 1)

    def pool_slot(self, outer_index: int) -> int:
        """The pairing slot of outer round ``outer_index``."""
        if self.schedule == "hypercube":
            return pairing_lib.hypercube_dim(outer_index, self.plan.replicas, seed=self.seed)
        return outer_index % max(self.pairing_pool, 1)

    def pairs_for(self, outer_index: int, membership: Membership | None = None,
                  groups: Any | None = None) -> tuple[int, list[tuple[int, int]]]:
        """(pool slot, (source, destination) pairs) of one outer round: a
        pure function of (seed, slot, membership view), so every rank
        derives the same pairs with no message."""
        world = self.plan.replicas
        slot = self.pool_slot(outer_index)
        full = membership is None or (membership.is_full and groups is None)
        if self.schedule == "hypercube":
            if full:
                return slot, pairing_lib.hypercube_ppermute_pairs(outer_index, world,
                                                                  seed=self.seed)
            return slot, pairing_lib.elastic_hypercube_ppermute_pairs(
                outer_index, membership, seed=self.seed, groups=groups)
        if full:
            return slot, pairing_lib.ppermute_pairs(slot, world, seed=self.seed)
        return slot, pairing_lib.elastic_ppermute_pairs(slot, membership, seed=self.seed,
                                                        groups=groups)

    @staticmethod
    def view_key(membership: Membership | None, groups: Any | None = None) -> Any:
        """Hashable participant-view part of the key (None: the full
        membership, shared by epochs with equal masks)."""
        if membership is None or (membership.is_full and groups is None):
            return None
        gk = None if groups is None else tuple(tuple(int(r) for r in g) for g in groups)
        return (tuple(membership.mask), gk)

    def program(self, outer_index: int, membership: Membership | None = None,
                groups: Any | None = None, *, stream: int | None = None, consume: bool = False,
                presend_index: int | None = None, presend_membership: Membership | None = None,
                update_mask=None, staleness=None) -> tuple[Callable, dict]:
        """The outer step of round ``outer_index`` under the given view and
        its ``info`` (``key``, ``slot``, ``view``, ``compiled``,
        ``build_s``, ``pool_size``).

        ``stream`` selects one stream's sync (``outer_index`` is then the
        global stream-sync index); ``consume`` reads the prefetched φ;
        ``presend_index`` adds the φ′ pre-send along that future index's
        pairing, drawn over ``presend_membership`` (the whole current
        membership, stragglers included).  ``update_mask`` (the due set of
        an asynchronous tick: the others are passive sources) and
        ``staleness`` (τ per replica, for the ``momentum`` rule) key an
        asynchronous entry; the all-due τ = 0 tick takes the ``(view,
        slot)`` entry."""
        slot, pairs = self.pairs_for(outer_index, membership, groups)
        view = self.view_key(membership, groups)
        key: Any = (view, slot)
        pairs_presend = presend_key = None
        if stream is None and (consume or presend_index is not None):
            raise ValueError("consume/presend are stream-program options; pass stream=")
        if presend_index is not None:
            slot_p, pairs_presend = self.pairs_for(presend_index, presend_membership, groups)
            presend_key = (slot_p, self.view_key(presend_membership, groups))
        if stream is not None:
            if self.partition is None:
                raise ValueError("streamed programs need the pool constructed with a "
                                 "StreamPartition (partition=...)")
            key = (view, slot, "stream", stream, bool(consume), presend_key)
        # the update set is the view's members; an active replica outside
        # every partition component stays one (paired with itself)
        active = None if view is None else np.asarray(membership.mask, dtype=bool)
        stale_vec = None
        if update_mask is not None or staleness is not None:
            if stream is not None:
                raise ValueError("async update_mask/staleness do not compose with streamed "
                                 "programs (SimCluster forbids the pairing at init)")
            um_key = st_key = None
            if update_mask is not None:
                due = np.asarray(update_mask, dtype=bool)
                active = due if active is None else (active & due)
                um_key = tuple(bool(x) for x in due)
            if staleness is not None:
                stale_vec = np.asarray(staleness, dtype=np.float32)
                st_key = tuple(float(x) for x in stale_vec)
            key = (view, slot, "async", um_key, st_key)
        fn, info = self._lookup(key, lambda: build_outer_step(
            self.plan, self.outer_cfg, pairs, group=self.group, comm_cfg=self.comm_cfg,
            active=active, staleness=stale_vec, stream=stream, partition=self.partition,
            consume_prefetch=consume, pairs_presend=pairs_presend), {
                "slot": str(slot), "view": "full" if view is None else "elastic",
                "epoch": None if membership is None else membership.epoch,
                "stream": stream, "async": update_mask is not None or staleness is not None})
        return fn, dict(info, slot=slot, view=view)

    def all_absent(self) -> tuple[Callable, dict]:
        """The round in which every live replica timed out: identity pairs,
        nobody updates, every counter advances.  One entry, keyed
        ``"all-absent"``, counted and telemetered like any other."""
        world = self.plan.replicas
        fn, info = self._lookup("all-absent", lambda: build_outer_step(
            self.plan, self.outer_cfg, [(i, i) for i in range(world)], group=self.group,
            comm_cfg=self.comm_cfg, active=np.zeros((world,), dtype=bool)),
            {"slot": "all-absent", "view": "all-absent", "epoch": None})
        return fn, dict(info, slot="all-absent", view="all-absent")

    def _lookup(self, key: Any, build: Callable[[], Callable], event: dict
                ) -> tuple[Callable, dict]:
        """The entry under ``key``, built by ``build`` on its first use (a
        miss, recorded with ``event``'s fields), else a hit."""
        compiled = key not in self._programs
        build_s = 0.0
        if compiled:
            self.misses += 1
            t0 = time.time()
            self._programs[key] = build()
            build_s = time.time() - t0
            self.events.append(dict(event, build_s=round(build_s, 4),
                                    pool_size=len(self._programs)))
        else:
            self.hits += 1
        return self._programs[key], {"key": key, "compiled": compiled, "build_s": build_s,
                                     "pool_size": len(self._programs)}

    def drain_events(self) -> list[dict]:
        events, self.events = self.events, []
        return events

    def stats(self) -> dict:
        return {"pool_size": len(self._programs), "hits": self.hits, "misses": self.misses,
                "schedule": self.schedule, "max_programs_per_view": self.max_programs_per_view}


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


def _serve_ctx(plan: Plan, group) -> ShardCtx:
    if plan.fsdp > 1:
        raise NotImplementedError(f"serving steps under the {plan.name} plan come with "
                                  f"{plans_lib.ITEM_9E}")
    return plan.ctx(group.model if plan.tp > 1 else None)


def build_prefill_step(cfg: ModelConfig, plan: Plan, group) -> Callable:
    """``(theta, caches, batch) -> (last hidden (B, 1, d), caches)``: the
    reference's prefill step on this rank's part of its replica.  ``theta``
    is the rank's unstacked shard under the plan's attention specs
    (``shard_params(..., stacked=False)``), ``caches`` its part of the
    dense cache (``model.init_cache_tree(..., ctx=)``), ``batch`` the
    replica's rows.  Under ``kv_shard_seq`` each rank writes the prompt
    positions of its own slice of every global layer's cache."""
    ctx = _serve_ctx(plan, group)

    @torch.no_grad()
    def fn(theta, caches, batch):
        return model_api.prefill(theta, cfg, batch, caches, ctx)

    return fn


def build_decode_step(cfg: ModelConfig, plan: Plan, group) -> Callable:
    """``(theta, caches, tokens (B, 1), index) -> (logits (B, 1, V/tp),
    caches)``: one decode step on this rank's part of its replica, the
    vocab-sharded logits of the reference's ``out_specs``
    (:func:`gather_logits` puts them together).  Under ``kv_shard_seq`` the
    rank owning slot ``index`` writes the token, and the ranks' partial
    softmax is combined over the model axis."""
    ctx = _serve_ctx(plan, group)

    @torch.no_grad()
    def fn(theta, caches, tokens, index):
        return model_api.decode_step(theta, cfg, tokens, index, caches, ctx)

    return fn


def gather_logits(logits: torch.Tensor, cfg: ModelConfig, plan: Plan, group) -> torch.Tensor:
    """The whole vocabulary's logits from each rank's slice (an all-gather
    over the model axis where the vocabulary is split)."""
    ctx = _serve_ctx(plan, group)
    if ctx.vocab_tp(cfg.vocab_size) == 1:
        return logits
    return group.model.all_gather(logits, logits.dim() - 1)
