"""Mixture-of-Experts block: top-k routing, capacity-bounded dispatch into
per-expert buffers, the experts as batched products, and the weighted
combine.

The port of ``repro/models/moe.py``.  Routing is
fp32 (the router is an fp32 leaf at every model dtype); each token takes the
k most probable experts, the lower expert index first on equal
probabilities as ``jax.lax.top_k`` does, with the k probabilities
renormalised.  Each expert holds ``cap = max(1, ceil(T·k/E·capacity
factor))`` assignments; an assignment's rank in its expert is its place in
a stable sort of the flat (token, k) expert ids less its expert's segment
start, as in the reference.  Assignments at rank >= cap are dropped.  Every step has a fixed order on each device: the dispatch writes
each kept assignment to a slot of its own, and the combine sums a token's k
contributions as one reduction over k (``index_add_`` would accumulate in
no fixed order on the card).

The training forward takes replica-stacked parameters (every leaf with a
leading replica axis R) and x (R, B, S, d).  Routing, capacity and the
auxiliary loss are then per replica with T = B·S, as the reference
``vmap``s its loss over replicas: R never folds into the token axis, which
would change the capacity, the ranks and so the dropped assignments.

Under a model axis (``ctx``) the block sees the rank's part of the
sequence (``transformer._split_seq``), routes it with the whole router and
counts its capacity over those tokens alone, as the reference does: at
tp > 1 the block is not the unsharded block, whose capacity covers the
whole sequence.  The experts are split over the ranks where their number
divides by tp (``ctx.experts_tp``): the dispatch buffer goes (E, C, d) →
(ep, E_l, C, d) → ``all_to_all`` → (E_l, ep·C, d), each rank runs its E_l
experts on every rank's tokens, and the inverse ``all_to_all`` brings the
outputs back before the combine.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import torch_dtype, truncated_normal
from repro_torch.parallel.sharding import ShardCtx

__all__ = ["init_moe", "apply_moe"]


def init_moe(gen: torch.Generator, cfg) -> dict:
    d, e = cfg.d_model, cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    std_in, std_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        # fp32 at every model dtype, for routing stability (as the reference)
        "router": truncated_normal(gen, (d, e), std_in, torch.float32),
        "w_in": truncated_normal(gen, (e, d, f), std_in, dt),
        "w_out": truncated_normal(gen, (e, f, d), std_out, dt),
    }
    if cfg.mlp_variant in ("swiglu", "geglu"):
        p["w_gate"] = truncated_normal(gen, (e, d, f), std_in, dt)
    return p


def _act(cfg, gate_h: torch.Tensor | None, h: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_variant == "swiglu":
        return F.silu(gate_h) * h
    if cfg.mlp_variant == "geglu":
        return F.gelu(gate_h, approximate="tanh") * h
    return F.gelu(h, approximate="tanh")


def route(router: torch.Tensor, xt: torch.Tensor, k: int):
    """Routing of tokens ``xt`` (R, T, d) by ``router`` (R, d, E), in fp32:
    (probs (R, T, E), top-k probabilities renormalised (R, T, k), top-k
    expert ids (R, T, k)).  A stable descending sort puts the lower expert
    index first among equal probabilities."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_e


def capacity(t: int, k: int, e: int, factor: float) -> int:
    """Assignments each expert holds: Python floats, as the reference."""
    return max(1, int(math.ceil(t * k / e * factor)))


def apply_moe(p: dict, cfg, x: torch.Tensor,
              ctx: ShardCtx = ShardCtx.local()) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) with unstacked ``p``, or (R, B, S, d) with ``p`` stacked
    over R.  Returns (y shaped as x in x's dtype, auxiliary load-balance
    loss: a scalar, or (R,) for stacked input)."""
    stacked = p["router"].dim() == 3
    if not stacked:
        y, aux = apply_moe({k: v[None] for k, v in p.items()}, cfg, x[None], ctx)
        return y[0], aux[0]
    r, b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_token
    t = b * s
    xt = x.reshape(r, t, d)

    probs, top_p, top_e = route(p["router"], xt, k)
    flat_e = top_e.reshape(r, t * k)
    counts = torch.zeros((r, e), dtype=torch.int64, device=x.device).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    # Switch-style load balance: E · Σ_e mean prob_e · share of assignments_e
    aux = e * (probs.mean(dim=1) * (counts.float() / (t * k))).sum(dim=-1) * cfg.router_aux_coef

    # rank of each assignment within its expert: its place in a stable sort
    # of the flat (token, k) expert ids less its expert's segment start
    cap = capacity(t, k, e, cfg.moe_capacity_factor)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    seg_start = counts.cumsum(dim=-1) - counts
    rank_sorted = (torch.arange(t * k, device=x.device)
                   - seg_start.gather(1, flat_e.gather(1, order)))
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    keep = rank < cap
    # slot of each kept assignment in the (E·cap) buffer; dropped ones all
    # go to one extra slot, written with zeros and cut off
    slot = torch.where(keep, flat_e * cap + rank, torch.full_like(rank, e * cap))

    vals = xt[:, :, None, :].expand(r, t, k, d).reshape(r, t * k, d)
    vals = torch.where(keep[..., None], vals, torch.zeros((), dtype=x.dtype, device=x.device))
    buf = torch.zeros((r, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.scatter(1, slot[..., None].expand(r, t * k, d), vals)
    buf = buf[:, : e * cap].reshape(r, e, cap, d)

    ep = ctx.experts_tp(e)
    if ep > 1:   # (R, E, C, d) -> (R, ep, E_l, C, d) -> a2a -> (R, E_l, ep·C, d)
        buf = ctx.all_to_all_model(buf.reshape(r, ep, e // ep, cap, d), 1, 3)
        buf = buf.reshape(r, e // ep, ep * cap, d)
    # ZeRO-3: the experts' weights gathered over the data axis on d
    w_in = ctx.gather_param(p["w_in"], -2, d)                         # (R, E_l, d, f)
    w_out = ctx.gather_param(p["w_out"], -1, d)                       # (R, E_l, f, d)
    h = torch.matmul(buf, w_in)                                       # (R, E_l, ·, f)
    gate = torch.matmul(buf, ctx.gather_param(p["w_gate"], -2, d)) if "w_gate" in p else None
    out_buf = torch.matmul(_act(cfg, gate, h), w_out)                 # (R, E_l, ·, d)
    if ep > 1:   # the inverse: (R, E_l, ep, C, d) -> a2a -> (R, E, C, d)
        out_buf = ctx.all_to_all_model(out_buf.reshape(r, e // ep, ep, cap, d), 2, 1)
        out_buf = out_buf.reshape(r, e, cap, d)

    out_buf = torch.cat([out_buf.reshape(r, e * cap, d),
                         torch.zeros((r, 1, d), dtype=out_buf.dtype, device=x.device)], dim=1)
    gathered = out_buf.gather(1, slot[..., None].expand(r, t * k, d))  # dropped: zeros
    w = top_p.reshape(r, t, k, 1)
    y = (gathered.reshape(r, t, k, d).float() * w).sum(dim=2)
    return y.reshape(r, b, s, d).to(x.dtype), aux
