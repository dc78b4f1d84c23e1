"""Top-level model API of the port: init, the training loss and the paged
serving steps.

The port of ``repro/models/model.py`` for decoder-only token models:
``init_params``, ``embed_input``, ``loss_fn`` (with the chunked LM loss),
``init_paged_cache_tree``, ``paged_prefill_chunk`` and
``paged_decode_step``.  Parameters are a plain dict tree with the JAX value
tree's structure and layouts (``{"embed", "stack": {"scan", "rem"},
"final_norm"}``), so :mod:`repro_torch.models.convert` can load JAX weights.

The training loss runs on replica-stacked parameters (every leaf with a
leading replica axis R) and batches (R, B, S): :func:`stacked_loss` returns
the (R,) per-replica losses in one forward, where the JAX package vmaps
``loss_fn`` over R.  :func:`loss_fn` is the one-replica view of it.  An MoE
model's loss is the LM loss plus its blocks' auxiliary load-balance loss, as
in the reference; its paged serving steps route the rows the reference
routes together (a slot's chunk with the pad rows of a ragged last chunk;
the R decode rows with the idle slots'), since capacity is shared by them.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.attention import PagedAttnCache, PagedView
from repro_torch.models.common import torch_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_norm,
    embed_tokens,
    init_embedding,
    init_norm,
    logits_sharded,
    sinusoidal_positions,
    token_nll,
)
from repro_torch.models.rglru import RGLRUCache, lru_width
from repro_torch.models.ssd import SSDCache
from repro_torch.tree import tree_map

PyTree = Any

_SINUSOID_LEN = 2**15
LOSS_CHUNK = 2048  # seq chunk for the memory-bounded LM loss


def init_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """Random weights on ``gen``'s device: truncated normals with the JAX
    package's standard deviations, unit norm scales."""
    cfg.validate()
    if cfg.is_encoder_decoder or cfg.frontend == "vision":
        raise NotImplementedError(
            "encoder-decoder and vision models are not ported yet (ROADMAP Queue 1 item 8d)"
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
    across request slots, plus the trash page; per-slot recurrent states for
    RG-LRU layers (h (R, W) fp32, conv tail (R, 3, W)) and SSD layers (state
    (R, H, P, N) fp32, conv tail (R, K−1, d_inner)), ``num_slots`` rows
    each, the tails in the model dtype."""
    if cfg.is_encoder_decoder or cfg.frontend == "vision":
        raise ValueError(
            "paged serving supports decoder-only token models; "
            f"got frontend={cfg.frontend!r} enc-dec={cfg.is_encoder_decoder}"
        )
    period, n_full, rem = tfm.layer_plan(cfg)

    dt = torch_dtype(cfg.dtype)

    def one(kind):
        tfm.check_kind(cfg, kind)
        if kind == "rglru":
            return RGLRUCache.init(cfg, num_slots, lru_width(cfg), dt, device)
        if kind == "ssd":
            return SSDCache.init(cfg, num_slots, dt, device)
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


def _check_token_model(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder or cfg.frontend == "vision":
        raise NotImplementedError(
            "encoder-decoder and vision models are not ported yet (ROADMAP Queue 1 item 8d)"
        )


def embed_input(params: PyTree, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Token embedding (scaled, plus sinusoidal positions where the config
    has no RoPE) of ``batch["tokens"]`` (R, B, S) under stacked params."""
    _check_token_model(cfg)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[-1], device=tokens.device)
    return _embed(params, cfg, tokens, positions)


def _lm_loss(params: PyTree, cfg: ModelConfig, x: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor | None) -> torch.Tensor:
    """Per-replica mean token NLL (R,) of x (R, B, S, d), chunked over the
    sequence in LOSS_CHUNK pieces when S is a multiple of it, so (R, B, S, V)
    logits are never materialized for long sequences."""
    r, _, s, _ = x.shape
    step = LOSS_CHUNK if s > LOSS_CHUNK and s % LOSS_CHUNK == 0 else s
    nll = torch.zeros(r, dtype=torch.float32, device=x.device)
    cnt = torch.zeros(r, dtype=torch.float32, device=x.device)
    for c0 in range(0, s, step):
        tok = token_nll(logits_sharded(params["embed"], cfg, x[:, :, c0:c0 + step]),
                        labels[:, :, c0:c0 + step])
        if mask is None:
            nll = nll + tok.sum(dim=(1, 2))
            cnt = cnt + float(tok[0].numel())
        else:
            w = mask[:, :, c0:c0 + step].float()
            nll = nll + (tok * w).sum(dim=(1, 2))
            cnt = cnt + w.sum(dim=(1, 2))
    return nll / torch.clamp_min(cnt, 1.0)


def _stacked_parts(params: PyTree, cfg: ModelConfig, batch: dict):
    """(LM loss (R,), MoE auxiliary loss (R,) or None) of every replica."""
    x = embed_input(params, cfg, batch)
    positions = torch.arange(x.shape[2], device=x.device)
    x, _, aux = tfm.apply_stack(params["stack"], cfg, x, positions=positions)
    x = apply_norm(params["final_norm"], x)
    return _lm_loss(params, cfg, x, batch["labels"], batch.get("loss_mask")), aux


def stacked_loss(params: PyTree, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Next-token LM loss of every replica plus, for MoE models, its
    auxiliary loss, (R,) fp32: params with a leading replica axis,
    ``batch["tokens"]``/``["labels"]`` (R, B, S), optional
    ``["loss_mask"]``.  Backpropagating the sum gives each replica's slice of
    the gradient its own loss's gradient."""
    lm, aux = _stacked_parts(params, cfg, batch)
    return lm if aux is None else lm + aux


def loss_fn(params: PyTree, cfg: ModelConfig, batch: dict) -> tuple[torch.Tensor, dict]:
    """The JAX package's ``loss_fn`` for ONE replica: unstacked params,
    batch (B, S).  Returns (LM loss + aux, {"lm_loss", "aux_loss"}); models
    without MoE blocks have an auxiliary loss of 0."""
    one = {k: v[None] for k, v in batch.items()}
    lm, aux = _stacked_parts(tree_map(lambda t: t[None], params), cfg, one)
    if aux is None:
        return lm[0], {"lm_loss": lm[0], "aux_loss": torch.zeros((), device=lm.device)}
    return lm[0] + aux[0], {"lm_loss": lm[0], "aux_loss": aux[0]}


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
    x, caches, _ = tfm.apply_stack(
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
    x, caches, _ = tfm.apply_stack(
        params["stack"], cfg, x, positions=positions, caches=caches, decode=True,
        paged=view,
    )
    x = apply_norm(params["final_norm"], x)
    return logits_sharded(params["embed"], cfg, x), caches
