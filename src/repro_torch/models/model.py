"""Top-level model API of the port: init and the paged serving steps.

The port of ``repro/models/model.py`` for decoder-only token models:
``init_params``, ``init_paged_cache_tree``, ``paged_prefill_chunk`` and
``paged_decode_step``.  Parameters are a plain dict tree with the JAX value
tree's structure and layouts (``{"embed", "stack": {"scan", "rem"},
"final_norm"}``), so :mod:`repro_torch.models.convert` can load JAX weights.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.attention import PagedAttnCache, PagedView
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_norm,
    embed_tokens,
    init_embedding,
    init_norm,
    logits_sharded,
    sinusoidal_positions,
)

PyTree = Any

_SINUSOID_LEN = 2**15


def init_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """Random weights on ``gen``'s device: truncated normals with the JAX
    package's standard deviations, unit norm scales."""
    cfg.validate()
    if cfg.is_encoder_decoder or cfg.frontend == "vision":
        raise NotImplementedError(
            "encoder-decoder and vision models are not ported yet (ROADMAP Queue 1 item 8)"
        )
    return {
        "embed": init_embedding(gen, cfg),
        "stack": tfm.init_stack(gen, cfg),
        "final_norm": init_norm(cfg, cfg.d_model, gen.device),
    }


def init_paged_cache_tree(
    cfg: ModelConfig, num_slots: int, num_pages: int, page_size: int, device="cpu"
) -> dict:
    """Serving cache tree: paged K/V pools per attention layer, shared
    across request slots, plus the trash page.  ``num_slots`` sizes the
    per-slot recurrent states of the families still to be ported."""
    if cfg.is_encoder_decoder or cfg.frontend == "vision":
        raise ValueError(
            "paged serving supports decoder-only token models; "
            f"got frontend={cfg.frontend!r} enc-dec={cfg.is_encoder_decoder}"
        )
    period, n_full, rem = tfm.layer_plan(cfg)

    def one(kind):
        tfm.check_kind(cfg, kind)
        return PagedAttnCache.init(cfg, num_pages, page_size, device)

    caches: dict = {"scan": [], "rem": []}
    for kind in period:
        caches["scan"].append(
            (tfm.stack_trees([one(kind) for _ in range(n_full)]), None) if n_full else None
        )
    for j in range(rem):
        caches["rem"].append((one(period[j]), None))
    return caches


def _embed(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, positions: torch.Tensor):
    x = embed_tokens(params["embed"], cfg, tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    if not cfg.use_rope:
        table = sinusoidal_positions(_SINUSOID_LEN, cfg.d_model, x.device).to(x.dtype)
        x = x + table[positions.long().clamp(0, _SINUSOID_LEN - 1)]
    return x


def paged_prefill_chunk(
    params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, caches: PyTree,
    view: PagedView, *, lengths: torch.Tensor, collect: bool = False,
) -> tuple[torch.Tensor, PyTree]:
    """One CHUNK of prefill for all R slots at once: tokens (R, C), slot r's
    chunk starting at position ``view.positions[r]`` with only its first
    ``lengths[r]`` tokens real.  Returns (logits of each slot's last valid
    position (R, 1, V) fp32, caches written in place)."""
    if collect:
        raise NotImplementedError(
            "per-token verify logits serve speculative decode (ROADMAP Queue 1)"
        )
    c = tokens.shape[1]
    positions = view.positions.long()[:, None] + torch.arange(c, device=tokens.device)[None]
    x = _embed(params, cfg, tokens, positions)
    x, caches = tfm.apply_stack(
        params["stack"], cfg, x, positions=positions, caches=caches, paged=view,
        chunk_lengths=lengths,
    )
    x = apply_norm(params["final_norm"], x)
    sel = (lengths.long() - 1).clamp(0, c - 1)
    x_last = x[torch.arange(x.shape[0], device=x.device), sel][:, None]
    return logits_sharded(params["embed"], cfg, x_last), caches


def paged_decode_step(
    params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, caches: PyTree,
    view: PagedView,
) -> tuple[torch.Tensor, PyTree]:
    """One decode step for ALL request slots: tokens (R, 1), per-slot
    positions and activity in ``view``.  Inactive slots compute garbage that
    goes to the trash page.  Returns (logits (R, 1, V) fp32, caches)."""
    positions = view.positions.long()[:, None]
    x = _embed(params, cfg, tokens, positions)
    x, caches = tfm.apply_stack(
        params["stack"], cfg, x, positions=positions, caches=caches, decode=True,
        paged=view,
    )
    x = apply_norm(params["final_norm"], x)
    return logits_sharded(params["embed"], cfg, x), caches
