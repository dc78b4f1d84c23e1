"""Transformer assembly: layer plan, blocks and the stack of layers.

The port of ``repro/models/transformer.py``: attention blocks (``global``,
``local`` and the encoder's bidirectional ``encoder``) and the recurrent
mixers (``rglru``, ``ssd``, under the JAX key ``"mixer"``), each with a
dense MLP unless ``d_ff`` is 0 (MoE blocks: ``"moe"`` in its place), and
with ``cross=True`` a cross-attention block over the encoder output after
the mixer (``ln_cross``, ``cross_attn``: encoder-decoder decoders).  The
parameter tree keeps the JAX package's layout, ``{"scan": [stacked per
period position], "rem": [...]}`` with a leading layer axis on every
scanned leaf; where JAX scanned over that axis, the port loops over it in
Python.  The training forward (no caches) takes replica-stacked
parameters, so its scanned leaves are (R, L, ...) and the layer axis is 1;
with ``cfg.remat`` each period of layers runs under
``torch.utils.checkpoint``, the counterpart of JAX's ``jax.checkpoint`` of
the scan body: its activations are recomputed in the backward pass.  MoE
blocks return their auxiliary load-balance loss, which the stack sums over
layers: per replica, (R,), in the training forward.  Caches (dense or
paged) thread through the stack as ``(mixer cache, cross cache)`` pairs,
the cross cache None where the model has no cross-attention.

``ctx`` (a :class:`~repro_torch.parallel.sharding.ShardCtx`, default the
local one) threads the model axis through every block.  Before an MoE
block each rank takes its contiguous part of the sequence (the reference's
``_split_seq``: the dispatch buffers stay small and each rank routes its
own tokens with its own capacity), and the block's output is gathered back
over the axis (``all_gather_model``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.parallel.sharding import ShardCtx
from repro_torch.tree import tree_map

_LOCAL = ShardCtx.local()

PyTree = Any

_ATTENTION = ("global", "local", "encoder")
_MIXERS = {"rglru": (rglru_lib.init_rglru, rglru_lib.apply_rglru),
           "ssd": (ssd_lib.init_ssd, ssd_lib.apply_ssd)}


def check_kind(kind: str) -> None:
    if kind not in _ATTENTION and kind not in _MIXERS:
        raise ValueError(f"unknown layer kind {kind!r}")


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg, kind: str, *, cross: bool = False) -> dict:
    check_kind(kind)
    p: dict = {"ln1": init_norm(cfg, cfg.d_model, gen.device)}
    if kind in _MIXERS:
        p["mixer"] = _MIXERS[kind][0](gen, cfg)
    else:
        p["attn"] = attn_lib.init_attention(gen, cfg)
    if cross:
        p["ln_cross"] = init_norm(cfg, cfg.d_model, gen.device)
        p["cross_attn"] = attn_lib.init_attention(gen, cfg)
    if cfg.arch_type == "moe":
        p["ln2"] = init_norm(cfg, cfg.d_model, gen.device)
        p["moe"] = moe_lib.init_moe(gen, cfg)
    elif cfg.d_ff > 0:
        p["ln2"] = init_norm(cfg, cfg.d_model, gen.device)
        p["mlp"] = init_mlp(gen, cfg)
    return p


def _split_seq(x: torch.Tensor, ctx: ShardCtx) -> tuple[torch.Tensor, bool]:
    """The rank's contiguous part of a replicated (..., S, d) sequence, and
    whether it was split (S divides by tp and S >= tp)."""
    s = x.shape[-2]
    if ctx.model_axis is None or s % ctx.tp or s < ctx.tp:
        return x, False
    loc = s // ctx.tp
    return x.narrow(-2, ctx.model_index() * loc, loc), True


def apply_block(
    p: dict,
    cfg,
    x: torch.Tensor,
    kind: str,
    *,
    positions: torch.Tensor | None = None,
    cache: Any = None,
    cross_cache: attn_lib.AttnCache | None = None,
    enc_out: torch.Tensor | None = None,
    decode: bool = False,
    paged: attn_lib.PagedView | None = None,
    chunk_lengths: torch.Tensor | None = None,
    chunk_exact: bool = False,
    ctx: ShardCtx = _LOCAL,
) -> tuple[torch.Tensor, tuple[Any, Any], torch.Tensor | None]:
    """Pre-norm block.  Returns (x, (cache, cross_cache), aux): aux is an
    MoE block's load-balance loss, None for the others.  With no cache and
    x (R, B, S, d) this is the training forward on p's leaves stacked over
    replicas (``enc_out`` (R, B, S_enc, d)); a recurrent mixer then runs its
    scan once over the R·B rows, an MoE block routes each replica's B·S
    tokens on their own.  The cross block builds its cache from
    ``enc_out`` when both are given (prefill) and reads it when ``enc_out``
    is None (decode).  ``chunk_exact`` (the speculative verify) runs a paged
    chunk as per-token decode steps; a recurrent mixer then returns a new
    cache holding its per-token trajectory and leaves ``cache`` unwritten."""
    check_kind(kind)
    h = apply_norm(p["ln1"], x)
    if kind in _MIXERS:
        y, cache = _MIXERS[kind][1](p["mixer"], cfg, h, cache=cache, chunk_lengths=chunk_lengths,
                                    chunk_exact=chunk_exact, ctx=ctx)
    elif kind == "encoder":   # bidirectional self-attention (whisper encoder)
        y, cache = attn_lib.apply_attention(p["attn"], cfg, h, mode="full", positions=positions,
                                            ctx=ctx)
    else:
        y, cache = attn_lib.apply_attention(
            p["attn"], cfg, h, mode="local" if kind == "local" else "causal",
            positions=positions, cache=cache, paged=paged, decode=decode,
            chunk_lengths=chunk_lengths, chunk_exact=chunk_exact, ctx=ctx,
        )
    x = x + y
    if "cross_attn" in p:
        h = apply_norm(p["ln_cross"], x)
        if enc_out is not None and cross_cache is not None:
            cross_cache = attn_lib.build_cross_cache(p["cross_attn"], cfg, enc_out, cross_cache,
                                                     ctx)
        y, cross_cache = attn_lib.apply_attention(
            p["cross_attn"], cfg, h, mode="full", positions=positions,
            kv_source=enc_out, cache=cross_cache, ctx=ctx,
        )
        x = x + y
    aux = None
    if "moe" in p:
        h, split = _split_seq(apply_norm(p["ln2"], x), ctx)
        y, aux = moe_lib.apply_moe(p["moe"], cfg, h, ctx)
        x = x + (ctx.all_gather_model(y, axis=-2) if split else y)
    elif "mlp" in p:
        x = x + apply_mlp(p["mlp"], cfg, apply_norm(p["ln2"], x), ctx)
    return x, (cache, cross_cache), aux


# ---------------------------------------------------------------------------
# Stacked layers
# ---------------------------------------------------------------------------


def stack_trees(trees: list[PyTree]) -> PyTree:
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if first is None:
        return None
    if isinstance(first, tuple):          # a layer's (mixer, cross) cache pair
        return tuple(stack_trees([t[i] for t in trees]) for i in range(len(first)))
    if dataclasses.is_dataclass(first):   # a layer's cache
        return type(first)(**{f.name: torch.stack([getattr(t, f.name) for t in trees])
                              for f in dataclasses.fields(first)})
    return torch.stack(trees)


def _unstack(tree: PyTree, n: int, axis: int = 0) -> list[PyTree]:
    """Per-layer views of a tree stacked over layers on ``axis`` (``unbind``
    once per leaf)."""
    if isinstance(tree, dict):
        cols = {k: _unstack(v, n, axis) for k, v in tree.items()}
        return [{k: cols[k][i] for k in tree} for i in range(n)]
    if tree is None:
        return [None] * n
    if isinstance(tree, tuple):           # a (mixer, cross) cache pair
        cols = [_unstack(t, n, axis) for t in tree]
        return [tuple(c[i] for c in cols) for i in range(n)]
    if dataclasses.is_dataclass(tree):    # views: in-place writes reach the stack
        cols = {f.name: getattr(tree, f.name).unbind(axis) for f in dataclasses.fields(tree)}
        return [type(tree)(**{k: v[i] for k, v in cols.items()}) for i in range(n)]
    return list(tree.unbind(axis))


def layer_plan(cfg) -> tuple[tuple[str, ...], int, int]:
    """(period pattern, n_full periods, n remainder layers)."""
    period = cfg.attn_pattern
    n = len(period)
    return period, cfg.num_layers // n, cfg.num_layers % n


def init_stack(gen: torch.Generator, cfg, *, cross: bool = False) -> dict:
    """Random layers drawn in the reference's order; each layer of a full
    period is copied into its slot of the stacked tree as soon as it is
    drawn, so the init never holds a period position's layers twice."""
    period, n_full, rem = layer_plan(cfg)
    params: dict = {"scan": [], "rem": []}
    for kind in period:
        stacked = None
        for i in range(n_full):
            layer = init_block(gen, cfg, kind, cross=cross)
            if stacked is None:
                stacked = tree_map(lambda t: t.new_empty((n_full,) + t.shape), layer)
            tree_map(lambda dst, src, i=i: dst[i].copy_(src), stacked, layer)
            del layer
        params["scan"].append(stacked)
    for j in range(rem):
        params["rem"].append(init_block(gen, cfg, period[j], cross=cross))
    return params


def apply_stack(
    params: dict,
    cfg,
    x: torch.Tensor,
    *,
    positions: torch.Tensor | None = None,
    caches: dict | None = None,
    enc_out: torch.Tensor | None = None,
    decode: bool = False,
    paged: attn_lib.PagedView | None = None,
    chunk_lengths: torch.Tensor | None = None,
    chunk_exact: bool = False,
    ctx: ShardCtx = _LOCAL,
) -> tuple[torch.Tensor, dict | None, torch.Tensor | None]:
    """Run all layers in the JAX package's order: every full period, then
    the remainder.  With ``caches`` None this is the training forward over
    replica-stacked parameters; otherwise ``caches`` mirrors the params
    structure with ``(mixer cache, cross cache)`` pairs, the caches are
    written in place and the same tree is returned.  With ``chunk_exact``
    (the speculative verify) the recurrent caches are left as they were
    and the tree returned is a new one: the page pools as given (written),
    every recurrent entry its per-token trajectory, stacked over layers as
    the params are.  The third result is the MoE blocks' auxiliary loss
    summed over layers, (R,) in training (None without MoE blocks)."""
    period, n_full, rem = layer_plan(cfg)
    training = caches is None
    layer_axis = 1 if training else 0
    kw = dict(positions=positions, enc_out=enc_out, decode=decode, paged=paged,
              chunk_lengths=chunk_lengths, chunk_exact=chunk_exact, ctx=ctx)
    # chunk_exact: the trajectories of the recurrent layers, per period
    # position (a list over the stacked layers) and per remainder layer
    traj: dict = {"scan": [[] for _ in period], "rem": [None] * rem}

    def add(total, aux):
        return aux if total is None else (total if aux is None else total + aux)

    def run(p, x, kind, entry, slot):
        c, cc = entry if entry is not None else (None, None)
        x, new, aux = apply_block(p, cfg, x, kind, cache=c, cross_cache=cc, **kw)
        if chunk_exact and kind in _MIXERS:
            part, i = slot
            if part == "scan":
                traj["scan"][i].append(new)
            else:
                traj["rem"][i] = new
        return x, aux

    aux_total = None
    if n_full:
        layer_params = [
            _unstack(params["scan"][pos], n_full, layer_axis) for pos in range(len(period))
        ]
        layer_caches = [
            [None] * n_full if training else _unstack(caches["scan"][pos], n_full)
            for pos in range(len(period))
        ]
        for i in range(n_full):
            def period_body(x, i=i):
                period_aux = None
                for pos, kind in enumerate(period):
                    x, aux = run(layer_params[pos][i], x, kind, layer_caches[pos][i],
                                 ("scan", pos))
                    period_aux = add(period_aux, aux)
                return x, period_aux

            if training and cfg.remat:
                x, aux = checkpoint(period_body, x, use_reentrant=False)
            else:
                x, aux = period_body(x)
            aux_total = add(aux_total, aux)
    for j in range(rem):
        x, aux = run(params["rem"][j], x, period[j % len(period)],
                     None if training else caches["rem"][j], ("rem", j))
        aux_total = add(aux_total, aux)
    if chunk_exact:
        caches = {
            "scan": [stack_trees(t) if t else e for t, e in zip(traj["scan"], caches["scan"])],
            "rem": [t if t is not None else e for t, e in zip(traj["rem"], caches["rem"])],
        }
    return x, caches, aux_total
