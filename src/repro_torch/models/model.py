"""Top-level model API of the port: init, the training loss, the dense-cache
serving functions and the paged serving steps.

The port of ``repro/models/model.py``: ``init_params``, ``encode``,
``embed_input``, ``loss_fn`` (with the chunked LM loss),
``init_cache_tree``, ``prefill`` and ``decode_step`` (the dense cache),
``init_paged_cache_tree``, ``paged_prefill`` (single-shot),
``paged_prefill_chunk`` (with the speculative verify's ``collect``) and
``paged_decode_step``.  Parameters are a plain dict tree with the JAX value
tree's structure and layouts (``{"embed", "stack": {"scan", "rem"},
"final_norm"}``, plus ``"encoder"``, ``"enc_norm"`` and ``"enc_proj"`` for
encoder-decoder models and ``"projector"`` for a vision frontend), so
:mod:`repro_torch.models.convert` can load JAX weights.

Batches are dicts: ``tokens``, ``labels`` (training), optional
``loss_mask``, ``encoder_embeds`` (B, S_enc, frontend_dim) for whisper and
``image_embeds`` (B, n_patches, frontend_dim) for internvl2.  The
frontends are stubs, as in the reference: batches carry their
precomputed frame or patch embeddings, and this module owns only the
projections that map them into d_model.  The image embeddings go in front
of the text; they predict nothing (labels padded with zeros, loss mask
False there).

The training loss runs on replica-stacked parameters (every leaf with a
leading replica axis R) and batches (R, B, ...): :func:`stacked_loss`
returns the (R,) per-replica losses in one forward, where the JAX package
vmaps ``loss_fn`` over R.  :func:`loss_fn` is the one-replica view of it.
An MoE model's loss is the LM loss plus its blocks' auxiliary load-balance
loss, as in the reference; its paged serving steps route the rows the
reference routes together (a slot's chunk with the pad rows of a ragged
last chunk; the R decode rows with the idle slots'), since capacity is
shared by them.  Paged serving takes decoder-only token models and refuses
the encoder-decoder and vision models with the reference's ``ValueError``;
those are served from the dense cache.

``loss_fn``, ``stacked_loss``, ``embed_input``, ``init_cache_tree``,
``prefill`` and ``decode_step`` take ``ctx`` (a :class:`~repro_torch.
parallel.sharding.ShardCtx`, default the local one) and pass it down: under
a model axis the parameters are the rank's shards
(``parallel.plans.shard_tree``), the caches its part of each layer's cache
(the sequence of a global layer's under ``kv_shard_seq``, the width or
heads of a recurrent one's), and ``decode_step`` returns the rank's
vocabulary slice of the logits, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.attention import AttnCache, PagedAttnCache, PagedView
from repro_torch.models.common import torch_dtype, truncated_normal
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_norm,
    embed_tokens,
    init_embedding,
    init_norm,
    logits_sharded,
    matmul,
    sinusoidal_at,
    sinusoidal_positions,
    token_nll,
)
from repro_torch.models.rglru import RGLRUCache, lru_width
from repro_torch.models.ssd import SSDCache, d_inner, num_heads_ssm
from repro_torch.parallel.sharding import ShardCtx
from repro_torch.tree import tree_map

_LOCAL = ShardCtx.local()

PyTree = Any

_SINUSOID_LEN = 2**15
LOSS_CHUNK = 2048  # seq chunk for the memory-bounded LM loss


def encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg,
        num_layers=cfg.num_encoder_layers,
        attn_pattern=("encoder",),
        arch_type="dense",
        use_rope=False,
    )


def init_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """Random weights on ``gen``'s device: truncated normals with the JAX
    package's standard deviations, unit norm scales."""
    cfg.validate()
    p = {
        "embed": init_embedding(gen, cfg),
        "stack": tfm.init_stack(gen, cfg, cross=cfg.is_encoder_decoder),
        "final_norm": init_norm(cfg, cfg.d_model, gen.device),
    }
    dt = torch_dtype(cfg.dtype)
    if cfg.is_encoder_decoder:
        p["encoder"] = tfm.init_stack(gen, encoder_cfg(cfg))
        p["enc_norm"] = init_norm(cfg, cfg.d_model, gen.device)
        if cfg.frontend_dim and cfg.frontend_dim != cfg.d_model:
            p["enc_proj"] = truncated_normal(gen, (cfg.frontend_dim, cfg.d_model),
                                             1.0 / math.sqrt(cfg.frontend_dim), dt)
    if cfg.frontend == "vision":
        p["projector"] = truncated_normal(gen, (cfg.frontend_dim, cfg.d_model),
                                          1.0 / math.sqrt(cfg.frontend_dim), dt)
    return p


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


def _embed(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, positions: torch.Tensor,
           prefix: torch.Tensor | None = None, ctx: ShardCtx = _LOCAL) -> torch.Tensor:
    """Token embedding (scaled where the config says so), with ``prefix``
    (projected frontend rows) in front of the tokens, plus the sinusoidal
    rows at ``positions`` where the config has no RoPE; ``positions`` cover
    the prefix and the tokens and are clamped to the reference's table of
    2**15 rows."""
    x = embed_tokens(params["embed"], cfg, tokens, ctx)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=-2)
    if not cfg.use_rope:
        rows = positions.long().clamp(0, _SINUSOID_LEN - 1)
        x = x + sinusoidal_at(rows, cfg.d_model).to(x.dtype)
    return x


def _frontend(embeds: torch.Tensor, w: torch.Tensor, ctx: ShardCtx = _LOCAL) -> torch.Tensor:
    """Stub embeddings times a projection (F, d), stacked (R, F, d) against
    (R, ...), in the promoted type of the two, as JAX promotes an fp32
    input against a bf16 weight; under ZeRO-3 the projection is gathered
    over the data axis on F first."""
    w = ctx.gather_param(w, -2, embeds.shape[-1])
    dt = torch.promote_types(embeds.dtype, w.dtype)
    return matmul(embeds.to(dt), w.to(dt))


def _encode(params: PyTree, cfg: ModelConfig, encoder_embeds: torch.Tensor,
            ctx: ShardCtx = _LOCAL) -> torch.Tensor:
    """The whisper encoder over stub frame embeddings (R, B, S_enc, F) under
    stacked params: ``enc_proj``, cast to the model dtype, sinusoidal
    positions, the bidirectional stack, ``enc_norm``."""
    x = encoder_embeds
    if "enc_proj" in params:
        x = _frontend(x, params["enc_proj"], ctx)
    x = x.to(torch_dtype(cfg.dtype))
    x = x + sinusoidal_positions(x.shape[-2], cfg.d_model, x.device).to(x.dtype)
    x, _, _ = tfm.apply_stack(params["encoder"], encoder_cfg(cfg), x, ctx=ctx)
    return apply_norm(params["enc_norm"], x)


def _one_replica(params: PyTree) -> PyTree:
    return tree_map(lambda t: t[None], params)


def encode(params: PyTree, cfg: ModelConfig, encoder_embeds: torch.Tensor,
           ctx: ShardCtx = _LOCAL) -> torch.Tensor:
    """The encoder output (B, S_enc, d) of ONE replica's params over stub
    frame embeddings (B, S_enc, F)."""
    sub = {k: params[k] for k in ("encoder", "enc_norm", "enc_proj") if k in params}
    return _encode(_one_replica(sub), cfg, encoder_embeds[None], ctx)[0]


def embed_input(params: PyTree, cfg: ModelConfig, batch: dict, ctx: ShardCtx = _LOCAL):
    """Token embedding (scaled where the config says so) of
    ``batch["tokens"]``, with the projected ``image_embeds`` in front for a
    vision model, plus sinusoidal positions over the whole length where the
    config has no RoPE.  Takes stacked params with (R, B, S) tokens or one
    replica's with (B, S).  Returns (x, mask_extra): mask_extra is False on
    the image rows and True on the text, None without an image."""
    tokens = batch["tokens"]
    img = mask_extra = None
    if cfg.frontend == "vision" and "image_embeds" in batch:
        img = _frontend(batch["image_embeds"], params["projector"], ctx)
        lead, n_img = tokens.shape[:-1], img.shape[-2]
        mask_extra = torch.cat([
            torch.zeros(lead + (n_img,), dtype=torch.bool, device=tokens.device),
            torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)], dim=-1)
    n = tokens.shape[-1] + (0 if img is None else img.shape[-2])
    x = _embed(params, cfg, tokens, torch.arange(n, device=tokens.device), prefix=img, ctx=ctx)
    return x, mask_extra


def _lm_loss(params: PyTree, cfg: ModelConfig, x: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor | None, ctx: ShardCtx = _LOCAL) -> torch.Tensor:
    """Per-replica mean token NLL (R,) of x (R, B, S, d), chunked over the
    sequence in LOSS_CHUNK pieces when S is a multiple of it, so (R, B, S, V)
    logits are never materialized for long sequences."""
    r, _, s, _ = x.shape
    step = LOSS_CHUNK if s > LOSS_CHUNK and s % LOSS_CHUNK == 0 else s
    nll = torch.zeros(r, dtype=torch.float32, device=x.device)
    cnt = torch.zeros(r, dtype=torch.float32, device=x.device)
    for c0 in range(0, s, step):
        tok = token_nll(logits_sharded(params["embed"], cfg, x[:, :, c0:c0 + step], ctx),
                        labels[:, :, c0:c0 + step], cfg, ctx)
        if mask is None:
            nll = nll + tok.sum(dim=(1, 2))
            cnt = cnt + float(tok[0].numel())
        else:
            w = mask[:, :, c0:c0 + step].float()
            nll = nll + (tok * w).sum(dim=(1, 2))
            cnt = cnt + w.sum(dim=(1, 2))
    return nll / torch.clamp_min(cnt, 1.0)


def _stacked_parts(params: PyTree, cfg: ModelConfig, batch: dict, ctx: ShardCtx = _LOCAL):
    """(LM loss (R,), MoE auxiliary loss (R,) or None) of every replica."""
    enc_out = None
    if cfg.is_encoder_decoder:
        if "encoder_embeds" not in batch:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder model: its batches carry the stub "
                "frontend's 'encoder_embeds'.  The token loader makes none, as the "
                "reference's does not: drive the loss with such batches")
        enc_out = _encode(params, cfg, batch["encoder_embeds"], ctx)
    x, mask_extra = embed_input(params, cfg, batch, ctx)
    positions = torch.arange(x.shape[2], device=x.device)
    x, _, aux = tfm.apply_stack(params["stack"], cfg, x, positions=positions, enc_out=enc_out,
                                ctx=ctx)
    x = apply_norm(params["final_norm"], x)
    labels, mask = batch["labels"], batch.get("loss_mask")
    if mask_extra is not None:
        # frontend rows predict nothing; labels align with the text rows
        pad = torch.zeros(labels.shape[:-1] + (mask_extra.shape[-1] - labels.shape[-1],),
                          dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=-1)
        mask = mask_extra if mask is None else torch.cat([pad.bool(), mask.bool()], dim=-1)
    return _lm_loss(params, cfg, x, labels, mask, ctx), aux


def stacked_loss(params: PyTree, cfg: ModelConfig, batch: dict,
                 ctx: ShardCtx = _LOCAL) -> torch.Tensor:
    """Next-token LM loss of every replica plus, for MoE models, its
    auxiliary loss, (R,) fp32: params with a leading replica axis,
    ``batch["tokens"]``/``["labels"]`` (R, B, S), optional
    ``["loss_mask"]``, ``["encoder_embeds"]`` or ``["image_embeds"]``
    (R, B, n, frontend_dim).  Backpropagating the sum gives each replica's slice of
    the gradient its own loss's gradient."""
    lm, aux = _stacked_parts(params, cfg, batch, ctx)
    return lm if aux is None else lm + aux


def loss_fn(params: PyTree, cfg: ModelConfig, batch: dict,
            ctx: ShardCtx = _LOCAL) -> tuple[torch.Tensor, dict]:
    """The JAX package's ``loss_fn`` for ONE replica: unstacked params,
    batch (B, S).  Returns (LM loss + aux, {"lm_loss", "aux_loss"}); models
    without MoE blocks have an auxiliary loss of 0."""
    one = {k: v[None] for k, v in batch.items()}
    lm, aux = _stacked_parts(_one_replica(params), cfg, one, ctx)
    if aux is None:
        return lm[0], {"lm_loss": lm[0], "aux_loss": torch.zeros((), device=lm.device)}
    return lm[0] + aux[0], {"lm_loss": lm[0], "aux_loss": aux[0]}


# ---------------------------------------------------------------------------
# Dense caches / serving
# ---------------------------------------------------------------------------


def init_cache_tree(cfg: ModelConfig, batch: int, length: int, device="cpu",
                    ctx: ShardCtx = _LOCAL) -> dict:
    """Dense cache tree mirroring the stack: per layer a ``(mixer, cross)``
    pair, the mixer an :class:`AttnCache` (global: ``length`` slots; local:
    a ring of min(length, window)), an RG-LRU or an SSD state of ``batch``
    rows, and for an encoder-decoder model the cross cache of
    ``cfg.encoder_seq`` frames (None otherwise).  Under a model axis, the
    rank's part, by the reference's cache specs: a global layer's
    ``length / tp`` slots under ``kv_shard_seq``, an RG-LRU's W/tp
    channels, an SSD's d_inner/tp channels and H/tp heads, each where it
    divides."""
    period, n_full, rem = tfm.layer_plan(cfg)
    dt = torch_dtype(cfg.dtype)
    seq_tp = ctx.tp if (ctx.kv_shard_seq and ctx.model_axis is not None
                        and length % ctx.tp == 0) else 1

    def one(kind):
        if kind == "rglru":
            w = lru_width(cfg)
            mixer = RGLRUCache.init(cfg, batch, w // ctx.ff_tp(w), dt, device)
        elif kind == "ssd":
            di, h = d_inner(cfg), num_heads_ssm(cfg)
            di, h = di // ctx.ff_tp(di), h // ctx.ff_tp(h)
            mixer = SSDCache(
                conv=torch.zeros((batch, cfg.ssm_conv_width - 1, di), dtype=dt, device=device),
                state=torch.zeros((batch, h, cfg.ssm_head_dim, cfg.ssm_state_dim),
                                  dtype=torch.float32, device=device))
        elif kind == "global" and seq_tp > 1:
            mixer = AttnCache.init(cfg, batch, length // seq_tp, kind, device)
        else:
            mixer = AttnCache.init(cfg, batch, length, kind, device)
        cross = (AttnCache.init(cfg, batch, cfg.encoder_seq, "global", device)
                 if cfg.is_encoder_decoder else None)
        return (mixer, cross)

    caches: dict = {"scan": [], "rem": []}
    for kind in period:
        caches["scan"].append(tfm.stack_trees([one(kind) for _ in range(n_full)])
                              if n_full else None)
    for j in range(rem):
        caches["rem"].append(one(period[j]))
    return caches


def prefill(params: PyTree, cfg: ModelConfig, batch: dict, caches: PyTree,
            ctx: ShardCtx = _LOCAL) -> tuple[torch.Tensor, PyTree]:
    """Fill the dense caches from whole prompts, ``batch["tokens"]`` (B, S)
    (with ``encoder_embeds`` or ``image_embeds`` where the model takes
    them); the encoder runs once and every cross block projects its K/V
    into its cache.  Returns (the hidden state of the last position after
    the final norm (B, 1, d), the caches written in place)."""
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encode(params, cfg, batch["encoder_embeds"], ctx)
        if enc_out.shape[1] != cfg.encoder_seq:
            raise ValueError(f"encoder_embeds hold {enc_out.shape[1]} frames; the cache tree "
                             f"holds cfg.encoder_seq = {cfg.encoder_seq}")
    x, _ = embed_input(params, cfg, batch, ctx)
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches, _ = tfm.apply_stack(params["stack"], cfg, x, positions=positions,
                                   caches=caches, enc_out=enc_out, ctx=ctx)
    x = apply_norm(params["final_norm"], x)
    return x[:, -1:], caches


def decode_step(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, index,
                caches: PyTree, ctx: ShardCtx = _LOCAL) -> tuple[torch.Tensor, PyTree]:
    """One-token decode over the dense caches: tokens (B, 1), ``index`` the
    number of tokens already cached, one scalar for every row.  Returns
    (logits (B, 1, V) fp32, the caches written in place)."""
    index = torch.as_tensor(index, device=tokens.device)
    if index.dim() != 0:
        raise ValueError(f"index must be one scalar for the batch, got shape {tuple(index.shape)}")
    positions = index.long().reshape(1)
    x = _embed(params, cfg, tokens, positions, ctx=ctx)
    x, caches, _ = tfm.apply_stack(params["stack"], cfg, x, positions=positions,
                                   caches=caches, decode=True, ctx=ctx)
    x = apply_norm(params["final_norm"], x)
    return logits_sharded(params["embed"], cfg, x, ctx), caches


def paged_prefill(
    params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, caches: PyTree,
    view: PagedView,
) -> tuple[torch.Tensor, PyTree]:
    """Prefill ONE request, tokens (1, S), into the paged caches in one
    call: every attention layer runs the flash op over the fresh K/V at
    canonical positions and scatters the prompt's K/V into the pages of
    ``view.block_tables`` (its single (1, MB) row).  The recurrent entries
    of ``caches`` must be batch-1 scratch states, advanced in place (the
    engine writes them into the slot's rows afterwards).  Returns (logits
    of the last prompt position (1, 1, V) fp32, caches)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(params, cfg, tokens, positions)
    x, caches, _ = tfm.apply_stack(params["stack"], cfg, x, positions=positions,
                                   caches=caches, paged=view)
    x = apply_norm(params["final_norm"], x)
    return logits_sharded(params["embed"], cfg, x[:, -1:]), caches


def paged_prefill_chunk(
    params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, caches: PyTree,
    view: PagedView, *, lengths: torch.Tensor, collect: bool = False,
) -> tuple[torch.Tensor, PyTree]:
    """One CHUNK of prefill for all R slots at once: tokens (R, C), slot r's
    chunk starting at position ``view.positions[r]`` with only its first
    ``lengths[r]`` tokens real.  Returns (logits of each slot's last valid
    position (R, 1, V) fp32, caches written in place).

    ``collect=True`` is the speculative verify: attention and the recurrent
    mixers run as C decode steps, so position c is computed as a decode
    step at ``positions + c`` would; returns (logits of all C positions
    (R, C, V) fp32, a new cache tree: the page pools, written, and per
    recurrent layer its per-token trajectory (R, C, ...), stacked over
    layers as the params are).  The recurrent caches passed in are not
    written."""
    c = tokens.shape[1]
    positions = view.positions.long()[:, None] + torch.arange(c, device=tokens.device)[None]
    x = _embed(params, cfg, tokens, positions)
    x, caches, _ = tfm.apply_stack(
        params["stack"], cfg, x, positions=positions, caches=caches, paged=view,
        chunk_lengths=lengths, chunk_exact=collect,
    )
    x = apply_norm(params["final_norm"], x)
    if collect:
        return logits_sharded(params["embed"], cfg, x), caches
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
