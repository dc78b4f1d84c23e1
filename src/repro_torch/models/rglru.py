"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of ``repro/models/rglru.py``:

    x ── W_x ──► conv1d(w=4) ──► RG-LRU ──┐
    x ── W_gate ──────────► GeLU ──────── ⊙ ──► W_out ──► y

    r_t = σ(x_t W_r),  i_t = σ(x_t W_i),  a_t = σ(Λ)^(c·r_t)  (c = 8)
    h_t = a_t·h_{t−1} + sqrt(1 − a_t²)·(i_t ⊙ u_t)

The recurrence runs through :func:`repro_torch.kernels.ops.rglru_scan` over
a sequence (the CUDA scan kernel on the card) and
:func:`~repro_torch.kernels.ops.rglru_decode` for one token (the CUDA decode
kernel).  Three branches, as in the JAX package: the forward with no cache,
chunk-resumable serving prefill (``chunk_lengths``; with ``chunk_exact``
the speculative verify's per-token decode steps) and the decode step.  A
cache is updated in place and returned, as the port's paged attention does
with its page pools; the verify alone writes no cache and returns the
per-token trajectory.  The forward with no cache also takes replica-stacked
parameters (every leaf with a leading R) against x (R, B, S, d): the
projections are one batched product each and the scan runs once over the
R·B rows, where the JAX package vmaps the block over R.

Under a model axis (``ctx``) the rank holds its contiguous part of the
width W (every projection's columns, the conv, Λ, the output's rows): the
scan runs on W/tp channels and the output projection is row-parallel
(``scatter_seq_sum``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import torch_dtype, truncated_normal
from repro_torch.models.layers import matmul, over_replicas
from repro_torch.parallel.sharding import ShardCtx

C_EXP = 8.0
CONV_WIDTH = 4


def lru_width(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def init_rglru(gen: torch.Generator, cfg) -> dict:
    """Weights in the model dtype, Λ in fp32 (a = σ(Λ) drawn in [0.9, 0.999]),
    the conv an identity on its last tap."""
    d, w = cfg.d_model, lru_width(cfg)
    dt = torch_dtype(cfg.dtype)
    dev = gen.device
    std = 1.0 / math.sqrt(d)
    u = 0.9 + 0.099 * torch.rand((w,), generator=gen, device=dev, dtype=torch.float32)
    conv = torch.zeros((CONV_WIDTH, w), dtype=dt, device=dev)
    conv[-1] = 1.0
    return {
        "w_x": truncated_normal(gen, (d, w), std, dt),
        "w_gate": truncated_normal(gen, (d, w), std, dt),
        "w_r": truncated_normal(gen, (d, w), std, dt),
        "w_i": truncated_normal(gen, (d, w), std, dt),
        "conv": conv,
        "lam": torch.log(u / (1.0 - u)),
        "w_out": truncated_normal(gen, (w, d), 1.0 / math.sqrt(w), dt),
    }


@dataclasses.dataclass
class RGLRUCache:
    """Decode state of one layer: the conv tail (B, 3, W) in the model dtype
    and the LRU hidden state h (B, W) fp32."""

    conv: torch.Tensor
    h: torch.Tensor

    @staticmethod
    def init(cfg, batch: int, width: int, dtype: torch.dtype, device="cpu") -> "RGLRUCache":
        return RGLRUCache(
            conv=torch.zeros((batch, CONV_WIDTH - 1, width), dtype=dtype, device=device),
            h=torch.zeros((batch, width), dtype=torch.float32, device=device),
        )


def causal_conv(u: torch.Tensor, kernel: torch.Tensor, tail: torch.Tensor | None):
    """Depthwise causal conv of width K over u (..., S, W), the taps summed
    in the JAX package's order; returns (out, the last K−1 inputs).  A
    stacked kernel (R, K, W) convolves u (R, B, S, W) replica by replica."""
    k = kernel.shape[-2]
    pad = (torch.zeros(u.shape[:-2] + (k - 1, u.shape[-1]), dtype=u.dtype, device=u.device)
           if tail is None else tail.to(u.dtype))
    full = torch.cat([pad, u], dim=-2)
    s = u.shape[-2]
    out = full[..., 0:s, :] * over_replicas(kernel[..., 0, :], u)
    for i in range(1, k):
        out = out + full[..., i:i + s, :] * over_replicas(kernel[..., i, :], u)
    return out, full[..., -(k - 1):, :]


def tail_at(ext: torch.Tensor, lengths: torch.Tensor, k1: int) -> torch.Tensor:
    """The K−1 conv inputs that end at each row's last valid token: rows
    ``lengths[b] .. lengths[b] + k1 − 1`` of ``ext`` = [old tail, chunk]."""
    idx = lengths.long()[:, None] + torch.arange(k1, device=ext.device)[None, :]
    return ext.gather(1, idx[:, :, None].expand(-1, -1, ext.shape[2]))


def apply_rglru(
    p: dict,
    cfg,
    x: torch.Tensor,                               # (B, S, d)
    *,
    cache: RGLRUCache | None = None,
    chunk_lengths: torch.Tensor | None = None,     # (B,) valid tokens per chunk row
    chunk_exact: bool = False,
    ctx: ShardCtx = ShardCtx.local(),
) -> tuple[torch.Tensor, RGLRUCache | None]:
    """The block's output (B, S, d) and its cache (the one given, written in
    place).  With ``cache`` and ``chunk_lengths``: one chunk of serving
    prefill, row b real for its first ``chunk_lengths[b]`` tokens; with
    ``chunk_exact`` as well, the speculative verify: S decode steps, the
    cache left as it was and a new cache returned whose leaves carry the
    state after each token (h (B, S, W), conv tails (B, S, 3, W)); with
    ``cache`` and S = 1: a decode step; with no cache: the forward from a
    zero state, also on stacked ``p`` and x (R, B, S, d)."""
    d = x.shape[-1]
    w_x, w_gate, w_r, w_i = (ctx.gather_param(p[n], -2, d) for n in ("w_x", "w_gate", "w_r", "w_i"))
    w_out = ctx.gather_param(p["w_out"], -1, d)
    u_in = matmul(x, w_x)
    gate = F.gelu(matmul(x, w_gate).float(), approximate="tanh")
    u, new_conv = causal_conv(u_in, p["conv"], cache.conv if cache is not None else None)
    r = torch.sigmoid(matmul(x, w_r).float())
    i = torch.sigmoid(matmul(x, w_i).float())
    # a_t = σ(Λ)^(c·r_t)  ⇒  log a_t = −c·r_t·softplus(−Λ)
    a = torch.exp(C_EXP * r * over_replicas(-F.softplus(-p["lam"]), r))
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u.float())

    if cache is not None and chunk_lengths is not None and chunk_exact:
        # The decode kernel once per token from the cache's state, which
        # stays unwritten: a rejected proposal must leave the slot's row
        # as it was.  Tail c is the conv inputs that end at token c.
        s, k1 = x.shape[1], p["conv"].shape[0] - 1
        ext = torch.cat([cache.conv.to(u_in.dtype), u_in], dim=1)
        h = torch.empty(a.shape, dtype=torch.float32, device=x.device)
        h_prev = cache.h
        for c in range(s):
            h_prev = kernel_ops.rglru_decode(h_prev, a[:, c], b[:, c])
            h[:, c] = h_prev
        win = torch.arange(s, device=x.device)[:, None] + 1 + torch.arange(k1, device=x.device)
        cache = RGLRUCache(conv=ext[:, win], h=h)
    elif cache is not None and chunk_lengths is not None:
        s, k1 = x.shape[1], p["conv"].shape[0] - 1
        ext = torch.cat([cache.conv.to(u_in.dtype), u_in], dim=1)
        lengths = chunk_lengths.long()
        b = torch.cat([b[:, :1] + a[:, :1] * cache.h[:, None], b[:, 1:]], dim=1)
        h = kernel_ops.rglru_scan(a, b)
        sel = (lengths - 1).clamp(0, s - 1)
        h_last = h[torch.arange(h.shape[0], device=h.device), sel]
        h_last = torch.where(lengths[:, None] > 0, h_last, cache.h)
        cache.conv.copy_(tail_at(ext, lengths, k1))
        cache.h.copy_(h_last)
    elif cache is not None and x.shape[1] == 1:
        h_last = kernel_ops.rglru_decode(cache.h, a[:, 0], b[:, 0])
        h = h_last[:, None]
        cache.conv.copy_(new_conv)
        cache.h.copy_(h_last)
    else:
        if cache is not None:   # prefill continuing from the cache's state
            b = torch.cat([b[:, :1] + a[:, :1] * cache.h[:, None], b[:, 1:]], dim=1)
        # stacked training input (R, B, S, W): one scan over the R·B rows
        h = kernel_ops.rglru_scan(a.flatten(0, -3), b.flatten(0, -3)).view(a.shape)
        if cache is not None:
            cache.conv.copy_(new_conv)
            cache.h.copy_(h[:, -1])
    y = matmul((h * gate).to(x.dtype), w_out)
    if ctx.ff_tp(lru_width(cfg)) > 1:
        y = ctx.scatter_seq_sum(y, axis=-2)
    return y, cache
