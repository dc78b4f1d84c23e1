"""Attention: GQA with qk-norm and RoPE; causal, sliding-window and full
(encoder self-attention and cross-attention) modes; training, the dense KV
cache and the paged serving cache.

The port of ``repro/models/attention.py::apply_attention`` and the cache
types it uses.  Training runs every replica of the stacked simulation in
one forward: the parameters carry a leading replica axis R and x is
(R, B, S, d) (cross-attention's ``kv_source`` (R, B, S_enc, d)); R is
folded into the batch before the flash-attention op, so one kernel launch
serves every replica.  The dense cache (:class:`AttnCache`) serves
``models/model.py``'s ``prefill``/``decode_step``: prefill runs the flash
op over the fresh K/V and writes them into the cache, decode appends one
token and runs :func:`blockwise_attention`, the reference's
positions-aware online softmax in plain PyTorch (it is jnp there, not a
Pallas kernel).  Cross-attention with a cache reads the encoder K/V that
:func:`build_cross_cache` projected once, through the same plain function,
in prefill as in decode, as the reference does.  Chunked prefill and
decode over the paged cache scatter the new tokens' K/V into the page
pools (masked tokens to the trash page) and then run the paged-attention
ops; the speculative verify (``chunk_exact``) runs the decode op once per
chunk column.  Single-shot paged prefill of one slot runs the flash op over
the fresh K/V and then scatters them into the slot's pages.  On the card
the flash and paged ops launch the CUDA kernels.

Under a model axis (``ctx``, a :class:`~repro_torch.parallel.sharding.
ShardCtx`) the query heads are split over the ranks where they divide
(``ctx.heads_tp``): ``w_q`` and ``w_o`` are the rank's heads, ``w_k`` and
``w_v`` whole, so K/V are projected whole and then cut to the kv heads that
serve the rank's query groups, or, where a rank holds part of a group,
expanded by the head map (query head i reads kv head i·KV//H); the output
projection is row-parallel (``scatter_seq_sum``).  Under ``fsdp_hybrid``
each projection is gathered over the data axis on d just before its
product (``ctx.gather_param``, at the reference's sites).  The decode plan's
``kv_shard_seq`` keeps the heads whole and splits the dense cache of each
global layer over the ranks by sequence: prefill writes the rank's slice
of the prompt's positions, decode writes the new token on the rank that
owns its slot and combines the ranks' partial softmax (m, l, acc) by a
``pmax`` and two ``psum`` calls.  Paged serving keeps the reference's refusal
of split heads.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import torch_dtype, truncated_normal
from repro_torch.models.layers import apply_norm, apply_rope
from repro_torch.parallel.sharding import ShardCtx

_LOCAL = ShardCtx.local()

NEG_INF = -1e30
_NO_POSITION = -(10**9)   # kv position of padding and unwritten cache slots

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
# Blockwise (flash-style) attention in plain PyTorch, positions-aware
# ---------------------------------------------------------------------------


def _mask_block(mode: str, q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int):
    """(Sq, Bk) additive mask from absolute positions.  Negative kv
    positions mark padding and unwritten cache slots and are never valid."""
    qp = q_pos[:, None]
    kp = kv_pos[None, :]
    valid = (kp >= 0).expand(qp.shape[0], kp.shape[1])
    if mode == "causal":
        valid = valid & (kp <= qp)
    elif mode == "local":
        valid = valid & (kp <= qp) & (kp > qp - window)
    elif mode != "full":
        raise ValueError(mode)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF))


def blockwise_attention(
    q: torch.Tensor,             # (B, Sq, H, D)
    k: torch.Tensor,             # (B, Sk, H, D), kv heads already expanded to H
    v: torch.Tensor,             # (B, Sk, H, D)
    q_positions: torch.Tensor,   # (Sq,) absolute positions
    kv_positions: torch.Tensor,  # (Sk,)
    *,
    mode: str = "causal",
    window: int = 0,
    block_kv: int = 1024,
    return_stats: bool = False,
):
    """Online-softmax attention over KV blocks of ``block_kv``, the
    reference's ``blockwise_attention``: fp32 scores of q·scale, a -1e30
    additive mask from the positions, the (m, l, acc) recurrence in fp32
    and acc / max(l, 1e-30) cast to q's dtype.  ``return_stats``: the
    unnormalised acc (B, H, Sq, D) with m and l (B, H, Sq) instead, which
    the sequence-sharded decode combines over the model axis."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    q32 = (q.float() * (1.0 / math.sqrt(d))).transpose(1, 2)        # (B, H, Sq, D)
    nblk = max(1, math.ceil(sk / block_kv))
    pad = nblk * block_kv - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad), value=_NO_POSITION)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        blk = slice(i * block_kv, (i + 1) * block_kv)
        kb = k[:, blk].transpose(1, 2).float()                      # (B, H, Bk, D)
        vb = v[:, blk].transpose(1, 2).float()
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kb)
        s = s + _mask_block(mode, q_positions, kv_positions[blk], window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    if return_stats:
        return acc, m, l
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _expand_kv(x: torch.Tensor, h: int, first: int = 0, h_all: int | None = None
               ) -> torch.Tensor:
    """The kv head of each of ``h`` query heads, (B, S, KV, D) -> (B, S, h,
    D): query head i (global index ``first`` + i of ``h_all``, default h)
    reads kv head (i·KV)//H."""
    kv = x.shape[-2]
    h_all = h_all or h
    head_map = ((first + torch.arange(h, device=x.device)) * kv) // h_all
    return x.index_select(x.dim() - 2, head_map)


def _local_kv(cfg, ctx: ShardCtx, k: torch.Tensor, v: torch.Tensor, h_local: int):
    """Whole K/V (..., S, KV, D) cut to what the rank's ``h_local`` query
    heads read, for the flash op: the kv heads of the rank's whole groups,
    or, where a rank holds part of a group, K/V expanded by the head map
    (the reference's ``_dispatched_attention``).  Unsplit heads: as given."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if ctx.heads_tp(h) == 1:
        return k, v
    g = h // kv if kv and h % kv == 0 else 0
    first = ctx.model_index() * h_local
    if g and h_local % g == 0:
        n = h_local // g
        return k.narrow(-2, first // g, n), v.narrow(-2, first // g, n)
    return _expand_kv(k, h_local, first, h), _expand_kv(v, h_local, first, h)


def _out_proj(out: torch.Tensor, w_o: torch.Tensor, eq: str, cfg, ctx: ShardCtx) -> torch.Tensor:
    """The output projection; row-parallel (summed over the model axis)
    where the heads are split; ``w_o`` gathered over the data axis on d."""
    y = torch.einsum(eq, out, ctx.gather_param(w_o, -1, cfg.d_model))
    return ctx.scatter_seq_sum(y, axis=-2) if ctx.heads_tp(cfg.num_heads) > 1 else y


# ---------------------------------------------------------------------------
# Dense KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AttnCache:
    """Decode cache.  For "global" layers ``k``/``v`` hold the whole context
    (B, length, KV, D); for "local" layers they are a ring of
    min(length, window) slots written at ``index % size``; a cross-attention
    cache holds the encoder's K/V (B, S_enc, KV, D).  ``index`` is one int32
    scalar for the whole batch: the number of tokens already cached (every
    row sits at the same position).  Prefill and decode write the tensors
    in place."""

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor

    @staticmethod
    def init(cfg, batch: int, length: int, mode: str, device="cpu") -> "AttnCache":
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        size = min(length, cfg.sliding_window) if mode == "local" else length
        dt = torch_dtype(cfg.dtype)
        return AttnCache(
            k=torch.zeros((batch, size, kv, hd), dtype=dt, device=device),
            v=torch.zeros((batch, size, kv, hd), dtype=dt, device=device),
            index=torch.zeros((), dtype=torch.int32, device=device),
        )


def _project_kv(p: dict, cfg, kv_in: torch.Tensor, eq: str, ctx: ShardCtx = _LOCAL):
    d = kv_in.shape[-1]
    k = torch.einsum(eq, kv_in, ctx.gather_param(p["w_k"], -3, d))
    v = torch.einsum(eq, kv_in, ctx.gather_param(p["w_v"], -3, d))
    if cfg.qk_norm:  # RMSNorm over head_dim, as the JAX package's _rms
        k = apply_norm({"scale": p["k_norm"]}, k)
    return k, v


def build_cross_cache(p: dict, cfg, encoder_out: torch.Tensor, cache: AttnCache,
                      ctx: ShardCtx = _LOCAL) -> AttnCache:
    """Project the encoder output (B, S_enc, d) to cross-attention K/V once
    (``k_norm`` with qk-norm, no RoPE), into ``cache`` in place."""
    k, v = _project_kv(p, cfg, encoder_out, "bsd,dhk->bshk", ctx)
    cache.k.copy_(k)
    cache.v.copy_(v)
    cache.index.zero_()
    return cache


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
# Attention block (projections + attention + out-proj)
# ---------------------------------------------------------------------------


def _training_attention(p: dict, cfg, x: torch.Tensor, mode: str, positions,
                        kv_source: torch.Tensor | None, ctx: ShardCtx = _LOCAL) -> torch.Tensor:
    """Attention of the stacked training forward: p's leaves (R, ...), x
    (R, B, S, d), K/V from ``kv_source`` (R, B, S_enc, d) for
    cross-attention, canonical positions; the rank's heads under a model
    axis."""
    r, b, s, d = x.shape
    q = torch.einsum("rbsd,rdhk->rbshk", x, ctx.gather_param(p["w_q"], -3, d))
    if cfg.qk_norm:  # RMSNorm over head_dim, as the JAX package's _rms
        q = apply_norm({"scale": p["q_norm"]}, q)
    k, v = _project_kv(p, cfg, x if kv_source is None else kv_source, "rbsd,rdhk->rbshk", ctx)
    if cfg.use_rope and mode != "full":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    k, v = _local_kv(cfg, ctx, k, v, q.shape[3])
    window = (cfg.sliding_window or 0) if mode == "local" else 0
    out = kernel_ops.flash_attention(
        q.reshape(r * b, s, *q.shape[3:]).contiguous(),
        k.reshape(r * b, k.shape[2], *k.shape[3:]).contiguous(),
        v.reshape(r * b, v.shape[2], *v.shape[3:]).contiguous(),
        mode=mode, window=window,
    )
    return _out_proj(out.reshape(q.shape), p["w_o"], "rbshk,rhkd->rbsd", cfg, ctx)


def _seq_sharded(cfg, ctx: ShardCtx, mode: str) -> bool:
    """Whether this layer's dense cache is split over the model axis by
    sequence (``kv_shard_seq``: global layers only)."""
    return ctx.kv_shard_seq and ctx.model_axis is not None and mode == "causal"


def _sharded_decode(cfg, ctx: ShardCtx, q, k, v, cache: AttnCache, positions) -> torch.Tensor:
    """Decode over a sequence-sharded cache: the rank owning slot ``index``
    writes the token there (the others leave their slice as it was), each
    rank attends over its slice, and the partial softmax is combined: gm =
    pmax(m), l = psum(l·e^(m−gm)), acc = psum(acc·e^(m−gm)), out = acc/l."""
    size = cache.k.shape[1]
    start = ctx.model_index() * size
    index = cache.index.long()
    local = index - start
    owner = (local >= 0) & (local < size)
    slot = local.clamp(0, size - 1).reshape(1)
    for buf, new in ((cache.k, k), (cache.v, v)):   # the owner's write; others rewrite the row
        buf.index_copy_(1, slot, torch.where(owner, new.to(buf.dtype), buf.index_select(1, slot)))
    cache.index.add_(1)
    kv_positions = start + torch.arange(size, device=q.device)
    kv_positions = torch.where(kv_positions <= index, kv_positions,
                               torch.full_like(kv_positions, _NO_POSITION))
    h = q.shape[2]
    acc, m, l = blockwise_attention(q, _expand_kv(cache.k, h), _expand_kv(cache.v, h),
                                    positions, kv_positions, mode="causal", return_stats=True)
    gm = ctx.pmax_model(m)
    corr = torch.exp(m - gm)
    l = ctx.psum_model(l * corr)
    acc = ctx.psum_model(acc * corr[..., None])
    return (acc / torch.clamp_min(l[..., None], 1e-30)).transpose(1, 2).to(q.dtype)


def _dense_attention(cfg, q, k, v, cache: AttnCache, mode: str,
                     positions: torch.Tensor, ctx: ShardCtx = _LOCAL) -> torch.Tensor:
    """Dense-cache self-attention of one layer, the cache written in place.
    Prefill (S > 1, canonical positions): the flash op over the fresh K/V,
    then the cache filled, a local ring with the last ``size`` tokens in
    slot order pos % size, a sequence-sharded cache with the positions of
    the rank's slice; index = S.  Decode (S = 1): the token written at
    ``index`` (local: ``index % size``), then :func:`blockwise_attention`
    over the cache with each slot's position (unwritten slots and, on a
    ring, slots older than the window get none); a sequence-sharded cache
    by :func:`_sharded_decode`.  Under split heads the query heads are the
    rank's and the cache holds every kv head."""
    s, h = q.shape[1], q.shape[2]
    size = cache.k.shape[1]
    window = cfg.sliding_window or 0
    first, h_all = ctx.model_index() * h, cfg.num_heads
    if ctx.heads_tp(cfg.num_heads) == 1:
        first, h_all = 0, h
    if s > 1:
        kl, vl = _local_kv(cfg, ctx, k, v, h)
        out = kernel_ops.flash_attention(q.contiguous(), kl.contiguous(), vl.contiguous(),
                                         mode=mode, window=window if mode == "local" else 0)
        if _seq_sharded(cfg, ctx, mode):
            # the rank's slots are positions [start, start + size)
            start = ctx.model_index() * size
            n = max(0, min(s - start, size))
            if n:
                cache.k[:, :n] = k[:, start:start + n]
                cache.v[:, :n] = v[:, start:start + n]
        elif mode == "local" and s >= size:
            take = s - size
            roll = -(take % size)
            cache.k.copy_(torch.roll(k[:, take:], roll, 1))
            cache.v.copy_(torch.roll(v[:, take:], roll, 1))
        else:
            cache.k[:, :s] = k
            cache.v[:, :s] = v
        cache.index.fill_(s)
        return out
    if _seq_sharded(cfg, ctx, mode):
        return _sharded_decode(cfg, ctx, q, k, v, cache, positions)
    index = cache.index.long()
    slots = torch.arange(size, device=q.device)
    if mode == "local":
        slot = index % size
        kv_positions = index - (slot - slots) % size
        valid = kv_positions >= torch.clamp_min(index - size + 1, 0)
    else:
        slot = index
        kv_positions = slots
        valid = slots <= index
    kv_positions = torch.where(valid, kv_positions, torch.full_like(kv_positions, _NO_POSITION))
    cache.k.index_copy_(1, slot.reshape(1), k.to(cache.k.dtype))
    cache.v.index_copy_(1, slot.reshape(1), v.to(cache.v.dtype))
    cache.index.add_(1)
    return blockwise_attention(q, _expand_kv(cache.k, h, first, h_all),
                               _expand_kv(cache.v, h, first, h_all), positions,
                               kv_positions, mode=mode, window=window)


def apply_attention(
    p: dict,
    cfg,
    x: torch.Tensor,                          # (B, S, d); training: (R, B, S, d)
    *,
    mode: str = "causal",                     # causal | local | full
    positions: torch.Tensor | None = None,    # absolute positions of x
    kv_source: torch.Tensor | None = None,    # cross-attention: the encoder states
    cache: AttnCache | PagedAttnCache | None = None,
    paged: PagedView | None = None,
    decode: bool = False,                     # paged phase selector
    chunk_lengths: torch.Tensor | None = None,  # (R,) valid tokens per chunk row
    chunk_exact: bool = False,                # paged chunk as per-token decode steps
    ctx: ShardCtx = _LOCAL,
) -> tuple[torch.Tensor, AttnCache | PagedAttnCache | None]:
    """Attention block.  With no cache: the training (or encoder) forward
    over canonical positions, p's leaves and x stacked over replicas
    (R, B, S, d), ``kv_source`` (R, B, S_enc, d) for cross-attention;
    returns (y, None).  With an :class:`AttnCache` (unstacked p, x (B, S, d),
    ``positions`` (S,)): dense prefill (S > 1) or decode (S = 1); in
    ``"full"`` mode the cache holds the encoder K/V of
    :func:`build_cross_cache` and is only read.  Over the paged cache:
    single-shot prefill of one slot (``decode`` False, no ``chunk_lengths``:
    x (1, S, d) at canonical positions), chunked prefill (``chunk_lengths``
    given; with ``chunk_exact`` the chunk runs as C decode steps, the
    speculative verify) or one decode token per slot (``decode`` True).

    Caches are written in place (``index_put_``/``copy_``) where the JAX
    package returned new ones; the cache returned is the one passed in."""
    if cache is None and paged is None:
        if positions is None:
            positions = torch.arange(x.shape[2], device=x.device)
        return _training_attention(p, cfg, x, mode, positions, kv_source, ctx), None
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = torch.einsum("bsd,dhk->bshk", x, ctx.gather_param(p["w_q"], -3, x.shape[-1]))
    if cfg.qk_norm:
        q = apply_norm({"scale": p["q_norm"]}, q)
    if cfg.use_rope and mode != "full":
        q = apply_rope(q, positions, cfg.rope_theta)

    if isinstance(cache, AttnCache):
        if mode == "full":
            # Cross-attention over the cached encoder K/V, prefill and decode
            # alike: the reference runs its blockwise function here (its
            # ``reuse_cross`` branch), not the flash kernel, and so does the
            # port, on the card too.
            h = q.shape[2]
            first, h_all = ((ctx.model_index() * h, cfg.num_heads)
                            if ctx.heads_tp(cfg.num_heads) > 1 else (0, h))
            kv_positions = torch.arange(cache.k.shape[1], device=x.device)
            out = blockwise_attention(q, _expand_kv(cache.k, h, first, h_all),
                                      _expand_kv(cache.v, h, first, h_all),
                                      positions, kv_positions, mode="full")
        else:
            k, v = _project_kv(p, cfg, x, "bsd,dhk->bshk", ctx)
            if cfg.use_rope:
                k = apply_rope(k, positions, cfg.rope_theta)
            out = _dense_attention(cfg, q, k, v, cache, mode, positions, ctx)
        return _out_proj(out, p["w_o"], "bshk,hkd->bsd", cfg, ctx), cache

    if not isinstance(cache, PagedAttnCache) or paged is None:
        raise ValueError("paged attention needs a PagedAttnCache and a PagedView")
    if ctx.heads_tp(cfg.num_heads) > 1:
        raise NotImplementedError("paged serving assumes unsharded attention heads (tp=1)")
    if mode not in ("causal", "local"):
        raise ValueError(f"paged attention mode must be causal or local, got {mode!r}")
    k, v = _project_kv(p, cfg, x, "bsd,dhk->bshk")
    if cfg.use_rope:
        k = apply_rope(k, positions, cfg.rope_theta)

    window = cfg.sliding_window or 0
    trash = cache.k_pages.shape[0] - 1
    page_size = cache.k_pages.shape[1]
    mb = paged.block_tables.shape[1]
    tables = paged.block_tables
    if not decode and chunk_lengths is None:
        # Single-shot prefill of one slot (B 1, canonical positions): the
        # flash op over the fresh K/V, as the dense prefill, then every
        # prompt token's K/V scattered into the slot's pages.
        out = kernel_ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                         mode=mode, window=window if mode == "local" else 0)
        tok = torch.arange(s, device=x.device)
        pages_idx = tables[0, tok // page_size].long()
        offs = tok % page_size
        cache.k_pages[pages_idx, offs] = k[0]
        cache.v_pages[pages_idx, offs] = v[0]
    elif decode:
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
        if chunk_exact:
            # Speculative verify: the paged decode op once per column c at
            # positions + c, so row c is the decode step's own computation
            # (keys past base + c are masked by position).
            out = torch.stack([
                kernel_ops.paged_attention(
                    q[:, c].contiguous(), cache.k_pages, cache.v_pages, tables,
                    tok_pos[:, c].to(torch.int32).contiguous(), mode=mode, window=window,
                ) for c in range(s)], dim=1)
        else:
            out = kernel_ops.paged_chunk_attention(
                q.contiguous(), cache.k_pages, cache.v_pages, tables, paged.positions,
                mode=mode, window=window,
            )
    y = torch.einsum("bshk,hkd->bsd", out, p["w_o"])
    return y, cache
