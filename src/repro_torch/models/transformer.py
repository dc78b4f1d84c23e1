"""Transformer assembly: layer plan, blocks and the stack of layers.

The port of ``repro/models/transformer.py`` for attention blocks
(``global``/``local``) with a dense MLP.  The parameter tree keeps the JAX
package's layout, ``{"scan": [stacked per period position], "rem": [...]}``
with a leading layer axis on every scanned leaf; where JAX scanned over that
axis, the port loops over it in Python.  The training forward (no caches)
takes replica-stacked parameters, so its scanned leaves are (R, L, ...) and
the layer axis is 1; with ``cfg.remat`` each period of layers runs under
``torch.utils.checkpoint``, the counterpart of JAX's ``jax.checkpoint`` of
the scan body: its activations are recomputed in the backward pass.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import PagedAttnCache
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm

PyTree = Any

_ATTENTION = ("global", "local")


def check_kind(cfg, kind: str) -> None:
    if kind not in _ATTENTION:
        raise NotImplementedError(
            f"{kind!r} layers are not ported yet (ROADMAP Queue 1 item 8)"
        )
    if cfg.arch_type == "moe" or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.arch_type} blocks are not ported yet (ROADMAP Queue 1 item 8)"
        )


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg, kind: str) -> dict:
    check_kind(cfg, kind)
    p: dict = {
        "ln1": init_norm(cfg, cfg.d_model, gen.device),
        "attn": attn_lib.init_attention(gen, cfg),
    }
    if cfg.d_ff > 0:
        p["ln2"] = init_norm(cfg, cfg.d_model, gen.device)
        p["mlp"] = init_mlp(gen, cfg)
    return p


def apply_block(
    p: dict,
    cfg,
    x: torch.Tensor,
    kind: str,
    *,
    positions: torch.Tensor | None = None,
    cache: PagedAttnCache | None = None,
    decode: bool = False,
    paged: attn_lib.PagedView | None = None,
    chunk_lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, PagedAttnCache]:
    """Pre-norm block.  Returns (x, cache)."""
    check_kind(cfg, kind)
    h = apply_norm(p["ln1"], x)
    y, cache = attn_lib.apply_attention(
        p["attn"], cfg, h, mode="local" if kind == "local" else "causal",
        positions=positions, cache=cache, paged=paged, decode=decode,
        chunk_lengths=chunk_lengths,
    )
    x = x + y
    if "mlp" in p:
        x = x + apply_mlp(p["mlp"], cfg, apply_norm(p["ln2"], x))
    return x, cache


# ---------------------------------------------------------------------------
# Stacked layers
# ---------------------------------------------------------------------------


def stack_trees(trees: list[PyTree]) -> PyTree:
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, PagedAttnCache):
        return PagedAttnCache(
            torch.stack([t.k_pages for t in trees]),
            torch.stack([t.v_pages for t in trees]),
        )
    return torch.stack(trees)


def _unstack(tree: PyTree, n: int, axis: int = 0) -> list[PyTree]:
    """Per-layer views of a tree stacked over layers on ``axis`` (``unbind``
    once per leaf)."""
    if isinstance(tree, dict):
        cols = {k: _unstack(v, n, axis) for k, v in tree.items()}
        return [{k: cols[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, PagedAttnCache):
        ks, vs = tree.k_pages.unbind(axis), tree.v_pages.unbind(axis)
        return [PagedAttnCache(ks[i], vs[i]) for i in range(n)]
    return list(tree.unbind(axis))


def layer_plan(cfg) -> tuple[tuple[str, ...], int, int]:
    """(period pattern, n_full periods, n remainder layers)."""
    period = cfg.attn_pattern
    n = len(period)
    return period, cfg.num_layers // n, cfg.num_layers % n


def init_stack(gen: torch.Generator, cfg) -> dict:
    period, n_full, rem = layer_plan(cfg)
    params: dict = {"scan": [], "rem": []}
    for kind in period:
        layers = [init_block(gen, cfg, kind) for _ in range(n_full)]
        params["scan"].append(stack_trees(layers) if n_full else None)
    for j in range(rem):
        params["rem"].append(init_block(gen, cfg, period[j]))
    return params


def apply_stack(
    params: dict,
    cfg,
    x: torch.Tensor,
    *,
    positions: torch.Tensor | None = None,
    caches: dict | None = None,
    decode: bool = False,
    paged: attn_lib.PagedView | None = None,
    chunk_lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Run all layers in the JAX package's order: every full period, then
    the remainder.  With ``caches`` None this is the training forward over
    replica-stacked parameters; otherwise ``caches`` mirrors the params
    structure with entries ``(PagedAttnCache, None)``, the pools are written
    in place and the same tree is returned."""
    period, n_full, rem = layer_plan(cfg)
    training = caches is None
    layer_axis = 1 if training else 0

    def cache_of(entry):
        return entry[0] if entry is not None else None

    kw = dict(positions=positions, decode=decode, paged=paged, chunk_lengths=chunk_lengths)
    if n_full:
        layer_params = [
            _unstack(params["scan"][pos], n_full, layer_axis) for pos in range(len(period))
        ]
        layer_caches = [
            [None] * n_full if training else _unstack(cache_of(caches["scan"][pos]), n_full)
            for pos in range(len(period))
        ]
        for i in range(n_full):
            def period_body(x, i=i):
                for pos, kind in enumerate(period):
                    x, _ = apply_block(
                        layer_params[pos][i], cfg, x, kind, cache=layer_caches[pos][i], **kw
                    )
                return x

            if training and cfg.remat:
                x = checkpoint(period_body, x, use_reentrant=False)
            else:
                x = period_body(x)
    for j in range(rem):
        c = None if training else cache_of(caches["rem"][j])
        x, _ = apply_block(params["rem"][j], cfg, x, period[j % len(period)], cache=c, **kw)
    return x, caches
