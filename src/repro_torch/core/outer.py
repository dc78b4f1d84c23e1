"""Outer optimizers: NoLoCo (gossip, modified Nesterov), DiLoCo (all-reduce
Nesterov) and none (the slow weights track the fast ones).

The port of ``repro/core/outer.py`` for the stacked simulation: replicas on
a leading axis of every leaf, partner values from an index gather
(:class:`~repro_torch.comm.exchange.StackedGather`), the NoLoCo update
through the fused kernel op (:func:`repro_torch.kernels.ops.
noloco_update_pytree`).  Equations (paper §3.2), with the appendix-
consistent +β sign the JAX package documents::

    Δ_{t,i}   = θ_{t+1,i} − φ_{t,i}                                  (1)
    δ_{t,i}   = α δ_{t−1,i} + β·mean_j Δ_{t,j} − γ (φ_{t,i} − mean_j φ_{t,j})  (2)
    φ_{t+1,i} = φ_{t,i} + δ_{t,i}                                    (3)

The arithmetic keeps the JAX package's dtypes and order: Δ and the group
means in the parameters' dtype (``mean = 0.5·(a + b)`` rounded there), the
momentum update in fp32 cast back.  Asynchronous rounds discount a stale
Δ on the wire (:func:`stale_discount`).  Streaming outer steps sync one
parameter-group stream at a time on staggered round offsets
(:class:`StreamSchedule`, :func:`outer_step_stacked_stream`), with the
§3.2 φ-prefetch: a stream's φ′ is pre-sent along its next pairing, so its
next sync blocks on Δ alone.  Over the replica group (one rank per
replica, :mod:`repro_torch.launch.mesh`) :func:`outer_step_sharded` runs
the same step on the rank's row, the partner's (Δ, φ) from one batched
send/receive, and :func:`outer_step_sharded_stream` one stream's sync,
whose φ′ pre-send is posted without a wait and stays in flight during the
next inner steps.  A rank that sits a round out decides so on the host and
skips the update: its (θ, φ, δ) stay the same tensors, which is bitwise
what the reference's select gives.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.comm import CommConfig
from repro_torch.comm import exchange as exchange_lib
from repro_torch.core import pairing
from repro_torch.kernels import ops as kernel_ops
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = [
    "OuterConfig", "OuterState", "gamma_band", "default_gamma", "init_outer_state",
    "outer_gradient", "stale_discount", "noloco_momentum_update", "diloco_momentum_update",
    "outer_step", "outer_step_stacked", "StreamSchedule", "outer_step_stacked_stream",
    "outer_step_sharded", "outer_step_sharded_stream",
]


def gamma_band(alpha: float, n: int = 2) -> tuple[float, float]:
    """Stability band for γ from Eq. 74: sqrt(n/(2(n−1)))·α < γ <
    sqrt(n/(2(n−1))·(2+α²))."""
    if n < 2:
        raise ValueError("group size must be >= 2 for the γ term to exist")
    scale = math.sqrt(n / (2.0 * (n - 1)))
    return scale * alpha, scale * math.sqrt(2.0 + alpha * alpha)


def default_gamma(alpha: float, n: int = 2) -> float:
    """Midpoint of the Eq. 74 stability band."""
    lo, hi = gamma_band(alpha, n)
    return 0.5 * (lo + hi)


@dataclasses.dataclass(frozen=True)
class OuterConfig:
    """Hyper-parameters of the outer optimizer (paper §4 defaults)."""

    method: str = "noloco"  # "noloco" | "diloco" | "none"
    alpha: float = 0.5      # Nesterov momentum (NoLoCo: 0.5; DiLoCo: 0.3)
    beta: float = 0.7       # outer learning rate
    gamma: float | None = None  # local-averaging strength; None -> Eq. 74 midpoint
    group_size: int = 2     # n; the paper uses 2
    inner_steps: int = 50   # m
    seed: int = 0           # pairing seed
    stale: str = "naive"    # async stale-Δ rule: "naive" | "momentum"

    def resolved_gamma(self) -> float:
        if self.method != "noloco":
            return 0.0
        if self.gamma is not None:
            return float(self.gamma)
        return default_gamma(self.alpha, self.group_size)

    def validate(self) -> None:
        if self.method not in ("noloco", "diloco", "none"):
            raise ValueError(f"unknown outer method: {self.method}")
        if not 0.0 <= self.alpha < 1.0:
            raise ValueError("alpha must be in [0, 1)")
        if self.method == "noloco":
            lo, hi = gamma_band(self.alpha, self.group_size)
            g = self.resolved_gamma()
            if not (lo < g < hi):
                raise ValueError(
                    f"gamma={g:.4f} outside stability band ({lo:.4f}, {hi:.4f}) "
                    "from Eq. 74 — the slow-weight variance would diverge"
                )
        if self.beta <= self.alpha:
            raise ValueError("outer learning rate beta must exceed alpha (App. A.2)")
        if self.stale not in ("naive", "momentum"):
            raise ValueError(f"unknown stale-Δ rule: {self.stale!r}")


@dataclasses.dataclass
class OuterState:
    """Slow weights φ and outer momentum δ (leading replica axis), and the
    outer step counter (host int: it keys the pairing)."""

    phi: PyTree
    delta: PyTree
    step: int = 0


def init_outer_state(params: PyTree) -> OuterState:
    return OuterState(
        phi=tree_map(lambda p: p.detach().clone(), params),
        delta=tree_map(torch.zeros_like, params),
        step=0,
    )


@dataclasses.dataclass(frozen=True)
class StreamSchedule:
    """When each payload stream syncs (Streaming DiLoCo round offsets).

    Stream ``k`` of ``S`` has the round offset ``o_k = ⌊k·m/S⌋`` and syncs at
    inner steps ``t = r·m + o_k`` for rounds ``r ≥ 1``; the offsets are
    distinct (``S ≤ m``), so at most one stream syncs at an inner step.
    Stream 0 keeps offset 0: with ``S = 1`` this is the one sync point
    ``t % m == 0``.  The global sync index of stream ``k``'s round-``r``
    sync is ``(r−1)·S + k``, the gossip pairing key (``OuterState.step``
    advances once per stream sync); stream ``k``'s next sync after index
    ``i`` is ``i + S``, the key its φ′ pre-send travels on."""

    inner_steps: int
    stream_count: int = 1

    def __post_init__(self):
        if self.stream_count < 1:
            raise ValueError(f"stream_count must be >= 1, got {self.stream_count}")
        if self.stream_count > self.inner_steps:
            raise ValueError(
                f"stream_count ({self.stream_count}) must not exceed "
                f"inner_steps ({self.inner_steps}): round offsets ⌊k·m/S⌋ "
                "must be distinct for the staggered schedule to exist"
            )

    @property
    def offsets(self) -> tuple[int, ...]:
        m, s = self.inner_steps, self.stream_count
        return tuple((k * m) // s for k in range(s))

    def due(self, inner_step: int) -> int | None:
        """The stream syncing at ``inner_step`` (None if none is due)."""
        m = self.inner_steps
        off = inner_step % m
        for k, o in enumerate(self.offsets):
            if off == o and inner_step - o >= m:
                return k
        return None

    def sync_index(self, stream: int, inner_step: int) -> int:
        """Global sync index (the pairing key) of ``stream``'s sync at
        ``inner_step``; the stream must be due there."""
        o = self.offsets[stream]
        r = (inner_step - o) // self.inner_steps
        if inner_step != r * self.inner_steps + o or r < 1:
            raise ValueError(f"stream {stream} is not due at inner step {inner_step}")
        return (r - 1) * self.stream_count + stream


def outer_gradient(theta: PyTree, phi: PyTree) -> PyTree:
    """Eq. 1: Δ = θ − φ (computed in θ's dtype, stored in φ's)."""
    return tree_map(lambda t, p: (t - p.to(t.dtype)).to(p.dtype), theta, phi)


def _wire_discount(staleness):
    """The stale rule's map of a Δ leaf onto its wire copy: each replica's
    rows times 1/(1+τ), in fp32 cast back."""
    scale = 1.0 / (1.0 + torch.as_tensor(staleness, dtype=torch.float32))

    def discount(d: torch.Tensor) -> torch.Tensor:
        s = scale.to(d.device)
        if s.dim() == 1:
            s = s.reshape((-1,) + (1,) * (d.dim() - 1))
        return (d.float() * s).to(d.dtype)

    return discount


def stale_discount(delta: PyTree, staleness) -> PyTree:
    """Scale each replica's Δ by 1/(1+τ), in fp32 cast back (the
    ``stale="momentum"`` rule): a Δ that arrives τ merged ticks late is
    anchored at a φ (1+τ) round intervals old.  Applied to the wire copy
    only; a replica's own Δ enters its own mean undiscounted.
    ``staleness`` is a (world,) vector or a scalar; τ = 0 scales by
    exactly 1.0."""
    return tree_map(_wire_discount(staleness), delta)


def noloco_momentum_update(phi, delta_mom, mean_delta, mean_phi, *, alpha: float,
                           beta: float, gamma: float) -> tuple[PyTree, PyTree]:
    """Eqs. 2–3 given the group means, through the fused kernel op.
    Returns (φ′, δ′)."""
    return kernel_ops.noloco_update_pytree(
        phi, delta_mom, mean_delta, mean_phi, alpha=alpha, beta=beta, gamma=gamma
    )


def diloco_momentum_update(phi, delta_mom, mean_delta, *, alpha: float, beta: float):
    """DiLoCo outer Nesterov: δ′ = αδ + β·mean(Δ); φ′ = φ + δ′, fp32 inside."""
    new_delta = tree_map(lambda d, md: alpha * d.float() + beta * md.float(), delta_mom, mean_delta)
    new_phi = tree_map(lambda p, nd: (p.float() + nd).to(p.dtype), phi, new_delta)
    return new_phi, tree_map(lambda nd, d: nd.to(d.dtype), new_delta, delta_mom)


def outer_step(state: OuterState, theta: PyTree, cfg: OuterConfig,
               comm: exchange_lib.Communicator | None, *,
               staleness: torch.Tensor | None = None) -> tuple[OuterState, PyTree]:
    """One outer step against a communicator.  Returns (new_state,
    new_theta): the fast weights restart from the new slow weights.

    ``staleness`` (asynchronous rounds): each replica's τ.  Under
    ``cfg.stale == "momentum"`` the partner receives the Δ discounted by
    :func:`stale_discount`, while each replica's own Δ enters its own mean
    undiscounted; under ``"naive"`` it is ignored."""
    cfg.validate()
    discount = None
    if staleness is not None and cfg.method == "noloco" and cfg.stale == "momentum":
        discount = _wire_discount(staleness)
    if cfg.method == "none":
        return OuterState(phi=theta, delta=state.delta, step=state.step + 1), theta
    if cfg.method == "noloco" and comm.cfg.codec == "none" and comm.per_leaf:
        phi_next, delta_next = _noloco_leafwise(state, theta, cfg, comm, discount)
        return OuterState(phi=phi_next, delta=delta_next, step=state.step + 1), phi_next
    delta = outer_gradient(theta, state.phi)
    if cfg.method == "diloco":
        mean_delta = comm.allreduce_mean(delta)
        phi_next, delta_next = diloco_momentum_update(
            state.phi, state.delta, mean_delta, alpha=cfg.alpha, beta=cfg.beta
        )
    else:  # noloco
        delta_wire = delta if discount is None else tree_map(discount, delta)
        delta_p, phi_p = exchange_lib.exchange_gossip(comm, delta_wire, state.phi)
        del delta_wire
        mean_delta = tree_map(lambda a, b: 0.5 * (a + b), delta, delta_p)
        mean_phi = tree_map(lambda a, b: 0.5 * (a + b), state.phi, phi_p)
        phi_next, delta_next = noloco_momentum_update(
            state.phi, state.delta, mean_delta, mean_phi,
            alpha=cfg.alpha, beta=cfg.beta, gamma=cfg.resolved_gamma(),
        )
    return OuterState(phi=phi_next, delta=delta_next, step=state.step + 1), phi_next


def _noloco_leafwise(state: OuterState, theta: PyTree, cfg: OuterConfig,
                     comm: exchange_lib.Communicator, discount=None,
                     phi_prefetched: PyTree | None = None) -> tuple[PyTree, PyTree]:
    """The NoLoCo step over a plain wire one leaf at a time: Δ, the
    partner's (Δ, φ), the means and the update of a leaf are formed and
    dropped before the next, so the step's temporaries are one leaf's,
    not the tree's (recurrentgemma-9b's stacked trees are 6.8 GB each in
    bf16).  Each value is the whole-tree path's, operation for operation;
    a packed wire (a codec) keeps that path.  ``discount`` (the stale
    rule's) maps a Δ leaf onto the copy that goes on the wire;
    ``phi_prefetched`` (a tree like ``theta``) holds the partner's φ that
    arrived before the sync, and then only Δ is exchanged."""
    out = []

    def one(t, phi, dmom, pre=None):
        delta = outer_gradient(t, phi)
        wire = delta if discount is None else discount(delta)
        delta_p, phi_p = exchange_lib.exchange_gossip(comm, wire, phi, phi_prefetched=pre)
        del wire
        mean_delta = 0.5 * (delta + delta_p)
        del delta, delta_p
        mean_phi = 0.5 * (phi + phi_p)
        del phi_p
        out.append(noloco_momentum_update(phi, dmom, mean_delta, mean_phi, alpha=cfg.alpha,
                                          beta=cfg.beta, gamma=cfg.resolved_gamma()))
        return len(out) - 1

    trees = (theta, state.phi, state.delta) + (() if phi_prefetched is None else (phi_prefetched,))
    index = tree_map(one, *trees)
    return tree_map(lambda i: out[i][0], index), tree_map(lambda i: out[i][1], index)


@torch.no_grad()
def outer_step_sharded(state: OuterState, theta: PyTree, cfg: OuterConfig, *, group,
                       pairs=None, comm_cfg: CommConfig | None = None,
                       active_flag: bool | None = None, participants: int | None = None,
                       staleness: float | None = None) -> tuple[OuterState, PyTree]:
    """One outer step on one rank of the replica group: ``theta``, φ and δ
    are this rank's replica (a leading axis of 1).  NoLoCo: a
    :class:`~repro_torch.comm.exchange.ShardedPermute` over ``pairs``
    moves the packed (Δ, φ) payload to the partner and back, the only
    cross-rank call, and no collective.  DiLoCo: an
    :class:`~repro_torch.comm.exchange.AllReduce`.  The arithmetic is
    :func:`outer_step`'s, so each rank's row equals the stacked step's
    row.  Returns (new_state, new_theta).

    ``active_flag`` (does this rank's replica update this round?) is
    DiLoCo's participation weight, over ``participants`` ranks; a rank
    whose flag is False runs no update and keeps (θ, φ, δ) as the same
    tensors, only its counter advancing, but still makes the round's call:
    DiLoCo's all-reduce with weight 0, or, paired with another rank (a
    passive source of an asynchronous tick), the exchange of its (Δ, φ).
    ``staleness`` (this rank's τ) discounts its Δ on the wire under
    ``stale="momentum"`` (:func:`stale_discount`)."""
    cfg.validate()
    comm = None
    if cfg.method == "noloco":
        if pairs is None:
            raise ValueError("the sharded NoLoCo step needs the round's pairs")
        comm = exchange_lib.ShardedPermute(group, pairs, comm_cfg)
    elif cfg.method == "diloco":
        weight = None if active_flag is None else float(bool(active_flag))
        comm = exchange_lib.AllReduce(group, comm_cfg, weight=weight,
                                      participants=None if weight is None else participants)
    stale = None if staleness is None else torch.tensor(float(staleness))
    if active_flag is None or active_flag:
        return outer_step(state, theta, cfg, comm, staleness=stale)
    if cfg.method == "noloco" and comm.paired:
        delta = outer_gradient(theta, state.phi)
        if stale is not None and cfg.stale == "momentum":
            delta = stale_discount(delta, stale)
        comm.exchange((delta, state.phi))
    elif cfg.method == "diloco" and participants:
        comm.allreduce_mean(outer_gradient(theta, state.phi))
    return OuterState(phi=state.phi, delta=state.delta, step=state.step + 1), theta


@torch.no_grad()
def outer_step_sharded_stream(state: OuterState, theta: PyTree, cfg: OuterConfig, *, group,
                              stream: int, partition, pairs, phi_pre: PyTree | None = None,
                              consume_prefetch: bool = False, pairs_next=None,
                              comm_cfg: CommConfig | None = None,
                              active_flag: bool | None = None):
    """One stream's outer sync on one rank of the replica group (NoLoCo
    only): :func:`outer_step_stacked_stream`'s sync over a
    :class:`~repro_torch.comm.exchange.ShardedPermute` along ``pairs``.

    ``pairs_next`` posts the φ′ pre-send of the stream's leaves along the
    next pairing, after the freeze, so a rank that sat the sync out
    pre-sends its true φ; the transfer is not waited here.
    ``active_flag`` False: the rank runs no update and keeps its leaves; it
    is a non-participant, which ``pairs`` pairs with itself, so it moves
    nothing.  Returns (new_state, new_theta, pending): ``pending`` is None
    without ``pairs_next``, else a
    :class:`~repro_torch.comm.exchange.PendingTree` whose ``wait()`` gives
    the partner's φ′ of the stream's leaves, in order."""
    presend = None
    if pairs_next is not None:
        def presend(phi_next_k, idxs):
            group.mark("update")   # the sync's own update, before the pre-send's encode
            comm_next = exchange_lib.ShardedPermute(group, pairs_next, comm_cfg)
            return exchange_lib.presend(comm_next, list(phi_next_k), stream=stream)
    return _stream_sync(state, theta, cfg, exchange_lib.ShardedPermute(group, pairs, comm_cfg),
                        stream=stream, partition=partition, phi_pre=phi_pre,
                        consume_prefetch=consume_prefetch,
                        update=active_flag is None or bool(active_flag), presend=presend)


def _stream_sync(state: OuterState, theta: PyTree, cfg: OuterConfig,
                 comm: exchange_lib.Communicator, *, stream: int, partition,
                 phi_pre: PyTree | None, consume_prefetch: bool, update: bool = True,
                 freeze=None, presend=None):
    """The streamed sync both layouts share: pick the stream's leaves,
    exchange (Δ_k, φ_k) or Δ_k alone against the prefetched φ, run the
    update (``update`` False: none, the leaves kept), ``freeze(new, old)``
    the rows that sit the sync out, call ``presend(φ′_k, leaf indices)``
    and write the stream's leaves back; every other leaf passes through as
    the same tensor.  Returns (new_state, new_theta, what ``presend``
    returned or None)."""
    cfg.validate()
    if cfg.method != "noloco":
        raise ValueError("streamed outer sync is NoLoCo-only (gossip pairing)")
    theta_leaves = tree_leaves(theta)
    phi_leaves = tree_leaves(state.phi)
    mom_leaves = tree_leaves(state.delta)
    idxs = partition.leaf_indices(stream)
    theta_k = [theta_leaves[i] for i in idxs]
    phi_k = [phi_leaves[i] for i in idxs]
    mom_k = [mom_leaves[i] for i in idxs]
    prefetched = None
    if consume_prefetch:
        if phi_pre is None:
            raise ValueError("consume_prefetch=True requires phi_pre")
        pre_leaves = tree_leaves(phi_pre)
        prefetched = [pre_leaves[i] for i in idxs]
    phi_next_k, mom_next_k, theta_next_k = phi_k, mom_k, theta_k
    if update and comm.cfg.codec == "none" and comm.per_leaf:
        phi_next_k, mom_next_k = _noloco_leafwise(
            OuterState(phi=phi_k, delta=mom_k), theta_k, cfg, comm, phi_prefetched=prefetched)
        theta_next_k = phi_next_k
    elif update:
        delta_k = outer_gradient(theta_k, phi_k)
        delta_p, phi_p = exchange_lib.exchange_gossip(comm, delta_k, phi_k,
                                                      phi_prefetched=prefetched)
        mean_delta = tree_map(lambda a, b: 0.5 * (a + b), delta_k, delta_p)
        del delta_k, delta_p
        mean_phi = tree_map(lambda a, b: 0.5 * (a + b), phi_k, phi_p)
        del phi_p
        phi_next_k, mom_next_k = noloco_momentum_update(
            phi_k, mom_k, mean_delta, mean_phi,
            alpha=cfg.alpha, beta=cfg.beta, gamma=cfg.resolved_gamma(),
        )
        theta_next_k = phi_next_k
    if freeze is not None:
        phi_next_k = tree_map(freeze, phi_next_k, phi_k)
        mom_next_k = tree_map(freeze, mom_next_k, mom_k)
        theta_next_k = tree_map(freeze, theta_next_k, theta_k)
    sent = None if presend is None else presend(phi_next_k, idxs)
    new_phi, new_mom, new_theta = list(phi_leaves), list(mom_leaves), list(theta_leaves)
    for i, p, d, t in zip(idxs, phi_next_k, mom_next_k, theta_next_k):
        new_phi[i], new_mom[i], new_theta[i] = p, d, t
    new_state = OuterState(phi=tree_unflatten(state.phi, new_phi),
                           delta=tree_unflatten(state.delta, new_mom), step=state.step + 1)
    return new_state, tree_unflatten(theta, new_theta), sent


def _select(active, device):
    """``where(active row, new, old)`` over leaves with a leading replica axis."""
    act = torch.as_tensor(active, dtype=torch.bool, device=device)
    return lambda new, old: torch.where(act.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


@torch.no_grad()
def outer_step_stacked(state: OuterState, theta: PyTree, cfg: OuterConfig, *,
                       partner=None, active=None, comm_cfg: CommConfig | None = None,
                       staleness=None) -> tuple[OuterState, PyTree]:
    """One outer step with replicas stacked on axis 0 of every leaf.

    ``partner``: (world,) partner table; None derives it from the state's
    outer step (:func:`repro_torch.core.pairing.partner_table`).
    ``active``: (world,) bool mask of this round's participants; the others
    keep (φ, δ, θ) as they were.  A participant paired with itself runs the
    self-group update (its own Δ and φ are the group means).
    ``staleness``: (world,) τ of an asynchronous merged tick (see
    :func:`outer_step`).  Returns (new_state, new_theta)."""
    cfg.validate()
    world = tree_leaves(theta)[0].shape[0]
    device = tree_leaves(theta)[0].device
    comm = None
    if cfg.method == "noloco":
        if partner is None:
            partner = pairing.partner_table(state.step, world, seed=cfg.seed)
        comm = exchange_lib.StackedGather(torch.as_tensor(partner, device=device), comm_cfg)
    elif cfg.method == "diloco":
        act = None if active is None else torch.as_tensor(active, dtype=torch.bool, device=device)
        comm = exchange_lib.StackedGather(None, comm_cfg, active=act)
    new_state, new_theta = outer_step(state, theta, cfg, comm, staleness=staleness)
    if active is not None:
        _sel = _select(active, device)
        new_theta = tree_map(_sel, new_theta, theta)
        new_state = OuterState(
            phi=tree_map(_sel, new_state.phi, state.phi),
            delta=tree_map(_sel, new_state.delta, state.delta),
            step=new_state.step,
        )
    return new_state, new_theta


@torch.no_grad()
def outer_step_stacked_stream(state: OuterState, theta: PyTree, cfg: OuterConfig, *,
                              stream: int, partition, partner, active=None,
                              phi_pre: PyTree | None = None, consume_prefetch: bool = False,
                              partner_next=None, comm_cfg: CommConfig | None = None,
                              ) -> tuple[OuterState, PyTree, PyTree | None]:
    """One stream's outer sync with replicas stacked on axis 0 (NoLoCo only).

    Exchanges and updates only the leaves ``partition`` (a
    :class:`~repro_torch.comm.payload.StreamPartition` over the stacked
    parameter tree) assigns to ``stream``; every other leaf of (φ, δ, θ)
    passes through as the same tensor.  The per-leaf math is
    :func:`outer_step`'s restricted to the stream's leaves.  On the plain
    wire the stream goes leaf by leaf; a codec packs the stream's (Δ_k, φ_k)
    as one payload, or Δ_k alone when the prefetch is consumed, and the
    pre-send φ′_k as a payload of its own, each fused by dtype.

    ``consume_prefetch``: the partner's φ of this stream was pre-sent at the
    stream's previous sync; it is read from ``phi_pre`` (a full tree like
    φ; only the stream's leaves are read) and only Δ_k is exchanged.
    ``partner_next``: pre-send φ′_k along that table for the stream's next
    sync; the returned third element is ``phi_pre`` (or, before the first
    pre-send, φ) with the stream's leaves replaced by the partner's φ′_k,
    else None.  ``active`` freezes the other replicas over this stream's
    leaves.  ``step`` advances by one, also for an empty stream."""
    device = tree_leaves(theta)[0].device
    presend = None
    if partner_next is not None:
        def presend(phi_next_k, idxs):
            comm_next = exchange_lib.StackedGather(torch.as_tensor(partner_next, device=device),
                                                   comm_cfg)
            pre_k = exchange_lib.presend(comm_next, phi_next_k)
            pre_leaves = list(tree_leaves(phi_pre if phi_pre is not None else state.phi))
            for i, leaf in zip(idxs, pre_k):
                pre_leaves[i] = leaf
            return tree_unflatten(state.phi, pre_leaves)
    comm = exchange_lib.StackedGather(torch.as_tensor(partner, device=device), comm_cfg)
    return _stream_sync(state, theta, cfg, comm, stream=stream, partition=partition,
                        phi_pre=phi_pre, consume_prefetch=consume_prefetch,
                        freeze=None if active is None else _select(active, device),
                        presend=presend)
