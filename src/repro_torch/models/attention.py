"""Attention over the paged serving cache: GQA with qk-norm and RoPE.

The port of the paged branch of ``repro/models/attention.py::apply_attention``
and the cache types it uses.  Chunked prefill and decode scatter the new
tokens' K/V into the page pools (masked tokens to the trash page) and then
run the paged-attention ops, which launch the CUDA kernels on the card.  The
training, dense-cache and cross-attention branches come with the slices that
need them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import torch_dtype, truncated_normal
from repro_torch.models.layers import apply_norm, apply_rope

# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg) -> dict:
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    std = 1.0 / math.sqrt(d)
    p = {
        "w_q": truncated_normal(gen, (d, h, hd), std, dt),
        "w_k": truncated_normal(gen, (d, kv, hd), std, dt),
        "w_v": truncated_normal(gen, (d, kv, hd), std, dt),
        "w_o": truncated_normal(gen, (h, hd, d), 1.0 / math.sqrt(h * hd), dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=gen.device)
    return p


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedAttnCache:
    """Serving KV cache: a pool of fixed-size pages shared by all request
    slots, addressed through the per-slot block tables in :class:`PagedView`.

    ``k_pages``/``v_pages`` are (num_pages + 1, page_size, KV, D); the LAST
    page is the TRASH page, which takes the writes of masked tokens so one
    batched scatter serves every slot.  Its contents are never read: the
    positional mask rejects every key past a slot's position."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor

    @staticmethod
    def init(cfg, num_pages: int, page_size: int, device="cpu") -> "PagedAttnCache":
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        shape = (num_pages + 1, page_size, kv, hd)
        dt = torch_dtype(cfg.dtype)
        return PagedAttnCache(
            k_pages=torch.zeros(shape, dtype=dt, device=device),
            v_pages=torch.zeros(shape, dtype=dt, device=device),
        )


@dataclasses.dataclass
class PagedView:
    """Per-step view of the paged cache, shared by every attention layer.

    ``block_tables`` (R, MB) int32 — physical page of each slot's logical
    block (entries past a request's allocation may be stale; the positional
    mask makes them unreachable).  ``positions`` (R,) int32 — position of
    the slot's first token this step.  ``active`` (R,) bool — slots owning a
    request; the others write to the trash page."""

    block_tables: torch.Tensor
    positions: torch.Tensor
    active: torch.Tensor


# ---------------------------------------------------------------------------
# Attention block (projections + paged attention + out-proj)
# ---------------------------------------------------------------------------


def apply_attention(
    p: dict,
    cfg,
    x: torch.Tensor,                          # (R, S, d)
    *,
    mode: str = "causal",                     # causal | local
    positions: torch.Tensor | None = None,    # (R, S) absolute positions of x
    cache: PagedAttnCache | None = None,
    paged: PagedView | None = None,
    decode: bool = False,                     # paged phase selector
    chunk_lengths: torch.Tensor | None = None,  # (R,) valid tokens per chunk row
) -> tuple[torch.Tensor, PagedAttnCache]:
    """Attention block over the paged cache: chunked prefill (``decode`` False,
    ``chunk_lengths`` given) or one decode token per slot (``decode`` True).

    The page pools are written in place (``index_put_``) where the JAX
    package donated the buffers and returned new ones; the cache returned is
    the one passed in."""
    if not isinstance(cache, PagedAttnCache) or paged is None:
        raise NotImplementedError(
            "the port's attention serves the paged cache only; training and "
            "dense-cache attention come with the flash slice (ROADMAP Queue 1 item 3)"
        )
    if not decode and chunk_lengths is None:
        raise NotImplementedError(
            "single-shot paged prefill needs flash attention (ROADMAP Queue 1); "
            "use chunked prefill"
        )
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)

    q = torch.einsum("bsd,dhk->bshk", x, p["w_q"])
    k = torch.einsum("bsd,dhk->bshk", x, p["w_k"])
    v = torch.einsum("bsd,dhk->bshk", x, p["w_v"])
    if cfg.qk_norm:  # RMSNorm over head_dim, as the JAX package's _rms
        q = apply_norm({"scale": p["q_norm"]}, q)
        k = apply_norm({"scale": p["k_norm"]}, k)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    window = cfg.sliding_window or 0
    trash = cache.k_pages.shape[0] - 1
    page_size = cache.k_pages.shape[1]
    mb = paged.block_tables.shape[1]
    tables = paged.block_tables
    if decode:
        pos = paged.positions.long()
        blk = (pos // page_size).clamp(0, mb - 1)
        pages_idx = tables.gather(1, blk[:, None])[:, 0].long()
        pages_idx = torch.where(paged.active, pages_idx, torch.full_like(pages_idx, trash))
        offs = pos % page_size
        cache.k_pages[pages_idx, offs] = k[:, 0]
        cache.v_pages[pages_idx, offs] = v[:, 0]
        out = kernel_ops.paged_attention(
            q[:, 0].contiguous(), cache.k_pages, cache.v_pages, tables, paged.positions,
            mode=mode, window=window,
        )[:, None]
    else:
        # Token (r, c) sits at position positions[r] + c and is real iff
        # c < chunk_lengths[r] on an active slot; ragged tails and idle slots
        # scatter to the trash page, and their output rows are garbage the
        # engine discards.
        c_idx = torch.arange(s, device=x.device)[None, :]
        tok_pos = paged.positions.long()[:, None] + c_idx                 # (R, C)
        valid = (c_idx < chunk_lengths.long()[:, None]) & paged.active[:, None]
        blk = (tok_pos // page_size).clamp(0, mb - 1)
        pages_idx = tables.gather(1, blk).long()
        pages_idx = torch.where(valid, pages_idx, torch.full_like(pages_idx, trash))
        offs = tok_pos % page_size
        cache.k_pages[pages_idx, offs] = k
        cache.v_pages[pages_idx, offs] = v
        out = kernel_ops.paged_chunk_attention(
            q.contiguous(), cache.k_pages, cache.v_pages, tables, paged.positions,
            mode=mode, window=window,
        )
    y = torch.einsum("bshk,hkd->bsd", out, p["w_o"])
    return y, cache
