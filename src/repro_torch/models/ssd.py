"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

The port of ``repro/models/ssd.py``: input and gate projections, a
depthwise causal conv, the selective state-space recurrence

    h_t = exp(dt_t·a)·h_{t−1} + dt_t·(x_t ⊗ B_t),   y_t = h_t·C_t + D·x_t

and the gated RMSNorm norm(y ⊙ silu(z)) before the output projection.  Over
a sequence the recurrence runs chunked (:func:`repro_torch.kernels.ops.
ssd_chunk`: the CUDA intra-chunk kernel on the card, the inter-chunk
recurrence in plain PyTorch); for one token it is
:func:`~repro_torch.kernels.ops.ssd_decode` (the CUDA decode kernel).  Three
branches, as in the JAX package: the forward with no cache, chunk-resumable
serving prefill (``chunk_lengths``; with ``chunk_exact`` the speculative
verify's per-token decode steps, which write no cache and return the
per-token trajectory) and the decode step.  A cache is updated in place and
returned.  Caches hold the state as (B, H, P, N); the chunk
kernel's states are (B, H, N, P), and ``ops.ssd_chunk`` turns them.  The
forward with no cache also takes replica-stacked parameters against x
(R, B, S, d): batched projections, and one chunked scan over the R·B rows
with each row's rates −exp(a_log) of its replica, where the JAX package
vmaps the block over R.

Under a model axis (``ctx``) the rank holds its contiguous part of the
heads and of d_inner (``w_z``, ``w_x``, ``w_dt``, the rates, skips, conv
and norm scale; ``w_b``/``w_c`` whole): the scans run on the local heads,
the gated norm's mean square is ``psum(ms) / tp`` (the mean over the whole
d_inner) and the output projection is row-parallel (``scatter_seq_sum``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import torch_dtype, truncated_normal
from repro_torch.models.layers import matmul, over_replicas
from repro_torch.models.rglru import causal_conv, tail_at
from repro_torch.parallel.sharding import ShardCtx


def d_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def num_heads_ssm(cfg) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def init_ssd(gen: torch.Generator, cfg) -> dict:
    """Weights in the model dtype; dt_bias, a_log, d_skip and norm_scale in
    fp32 at every model dtype, as in the JAX package: softplus(dt_bias)
    spans [1e-3, 1e-1] and −exp(a_log) [−16, −1]."""
    d, di, n, h = cfg.d_model, d_inner(cfg), cfg.ssm_state_dim, num_heads_ssm(cfg)
    dt = torch_dtype(cfg.dtype)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    std = 1.0 / math.sqrt(d)
    lo, hi = math.log(1e-3), math.log(1e-1)
    step = torch.exp(lo + (hi - lo) * torch.rand((h,), generator=gen, **f32))
    dt_bias = step + torch.log(-torch.expm1(-step))       # inverse softplus
    a_init = 1.0 + 15.0 * torch.rand((h,), generator=gen, **f32)
    conv = torch.zeros((cfg.ssm_conv_width, di), dtype=dt, device=dev)
    conv[-1] = 1.0
    return {
        "w_z": truncated_normal(gen, (d, di), std, dt),
        "w_x": truncated_normal(gen, (d, di), std, dt),
        "w_b": truncated_normal(gen, (d, n), std, dt),
        "w_c": truncated_normal(gen, (d, n), std, dt),
        "w_dt": truncated_normal(gen, (d, h), std, dt),
        "dt_bias": dt_bias,
        "a_log": torch.log(a_init),
        "d_skip": torch.ones((h,), **f32),
        "conv": conv,
        "norm_scale": torch.ones((di,), **f32),
        "w_out": truncated_normal(gen, (di, d), 1.0 / math.sqrt(di), dt),
    }


@dataclasses.dataclass
class SSDCache:
    """Decode state of one layer: the conv tail (B, K−1, d_inner) in the
    model dtype and the SSM state (B, H, P, N) fp32."""

    conv: torch.Tensor
    state: torch.Tensor

    @staticmethod
    def init(cfg, batch: int, dtype: torch.dtype, device="cpu") -> "SSDCache":
        return SSDCache(
            conv=torch.zeros((batch, cfg.ssm_conv_width - 1, d_inner(cfg)), dtype=dtype,
                             device=device),
            state=torch.zeros((batch, num_heads_ssm(cfg), cfg.ssm_head_dim, cfg.ssm_state_dim),
                              dtype=torch.float32, device=device),
        )


def apply_ssd(
    p: dict,
    cfg,
    x: torch.Tensor,                               # (B, S, d)
    *,
    cache: SSDCache | None = None,
    chunk_lengths: torch.Tensor | None = None,     # (B,) valid tokens per chunk row
    chunk_exact: bool = False,
    ctx: ShardCtx = ShardCtx.local(),
) -> tuple[torch.Tensor, SSDCache | None]:
    """The block's output (B, S, d) and its cache (the one given, written in
    place); branches as :func:`repro_torch.models.rglru.apply_rglru`'s (the
    verify's trajectory: state (B, S, H, P, N), conv tails (B, S, K−1,
    d_inner))."""
    lead, s, d = x.shape[:-2], x.shape[-2], x.shape[-1]
    hd = cfg.ssm_head_dim
    w_z, w_x, w_b, w_c, w_dt = (ctx.gather_param(p[n], -2, d)
                                for n in ("w_z", "w_x", "w_b", "w_c", "w_dt"))
    w_out = ctx.gather_param(p["w_out"], -1, d)
    z = matmul(x, w_z)
    u_in = matmul(x, w_x)
    u, new_conv = causal_conv(u_in, p["conv"], cache.conv if cache is not None else None)
    u = F.silu(u.float())
    b_mat = matmul(x, w_b).float()
    c_mat = matmul(x, w_c).float()
    dt_raw = matmul(x, w_dt).float()
    dt = F.softplus(dt_raw + over_replicas(p["dt_bias"], dt_raw))   # (..., S, H)
    a = -torch.exp(p["a_log"])
    heads = u.shape[-1] // hd
    u_heads = u.reshape(lead + (s, heads, hd))

    if cache is not None and chunk_lengths is not None and chunk_exact:
        # The decode kernel once per token from the cache's state, which
        # stays unwritten; the new cache carries the state after each token.
        k1 = p["conv"].shape[0] - 1
        ext = torch.cat([cache.conv.to(u_in.dtype), u_in], dim=1)
        states = torch.empty((x.shape[0], s) + cache.state.shape[1:], dtype=torch.float32,
                             device=x.device)
        y = torch.empty(u_heads.shape, dtype=torch.float32, device=x.device)
        state = cache.state
        for c in range(s):
            state, y[:, c] = kernel_ops.ssd_decode(state, dt[:, c], a, b_mat[:, c], c_mat[:, c],
                                                   u_heads[:, c])
            states[:, c] = state
        win = torch.arange(s, device=x.device)[:, None] + 1 + torch.arange(k1, device=x.device)
        cache = SSDCache(conv=ext[:, win], state=states)
    elif cache is not None and chunk_lengths is not None:
        # Row c of slot b is real iff c < chunk_lengths[b].  dt is masked to
        # exactly 0 on the ragged tail, which makes each pad token a no-op on
        # the recurrence (decay exp(0) = 1, input 0): the carried state is
        # the state at the last real token.  The conv tail is selected by
        # position.
        k1 = p["conv"].shape[0] - 1
        ext = torch.cat([cache.conv.to(u_in.dtype), u_in], dim=1)
        lengths = chunk_lengths.long()
        valid = torch.arange(s, device=x.device)[None, :] < lengths[:, None]
        dtm = torch.where(valid[..., None], dt, torch.zeros_like(dt))
        y, final = kernel_ops.ssd_chunk(u_heads, dtm, a, b_mat, c_mat, chunk=cfg.ssm_chunk,
                                        initial_state=cache.state)
        cache.conv.copy_(tail_at(ext, lengths, k1))
        cache.state.copy_(final)
    elif cache is not None and s == 1:
        state, y1 = kernel_ops.ssd_decode(cache.state, dt[:, 0], a, b_mat[:, 0], c_mat[:, 0],
                                          u_heads[:, 0])
        y = y1[:, None]
        cache.conv.copy_(new_conv)
        cache.state.copy_(state)
    else:
        # stacked training input (R, B, ...): the replicas folded into R·B
        # rows, each row with its replica's rates (R, H) → (R·B, H)
        rows = a if a.dim() == 1 else a[:, None].expand(lead + a.shape[-1:]).flatten(0, 1)
        y, final = kernel_ops.ssd_chunk(
            u_heads.flatten(0, -4), dt.flatten(0, -3), rows, b_mat.flatten(0, -3),
            c_mat.flatten(0, -3), chunk=cfg.ssm_chunk,
            initial_state=cache.state if cache is not None else None)
        y = y.view(u_heads.shape)
        if cache is not None:
            cache.conv.copy_(new_conv)
            cache.state.copy_(final)

    y = y + over_replicas(p["d_skip"], u_heads[..., 0])[..., None] * u_heads
    y = y.reshape(lead + (s, heads * hd))
    # gated RMSNorm (mamba2): norm(y ⊙ silu(z)), over the whole d_inner
    g = y * F.silu(z.float())
    ms = torch.mean(torch.square(g), dim=-1, keepdim=True)
    split = ctx.ff_tp(d_inner(cfg)) > 1
    if split:   # the mean over the whole d_inner: the ranks' means summed, over tp
        ms = ctx.psum_model(ms) / ctx.tp
    g = g * torch.rsqrt(ms + 1e-6) * over_replicas(p["norm_scale"], g)
    out = matmul(g.to(x.dtype), w_out)
    return (ctx.scatter_seq_sum(out, axis=-2) if split else out), cache
