"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, in fp32, with the
arithmetic of the JAX package's ``repro/kernels/ref.py`` twins: a dense
gather of each slot's K/V through its block table, a -1e30 mask (not -inf),
and a softmax normalised by ``max(l, 1e-30)``.  :mod:`repro_torch.kernels.ops`
runs them for tensors on the CPU; the tests and ``chip_smoke.py`` hold the
kernels against them.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _gather_kv(k_pages, v_pages, block_tables, h):
    """Dense (R, MB·BS, KVg, D) K/V of every slot, expanded to one kv head per
    query head when H % KV != 0 (query head h reads kv head (h·KV)//H)."""
    r, mb = block_tables.shape
    _, bs, kvh, d = k_pages.shape
    idx = block_tables.long()
    k = k_pages[idx].reshape(r, mb * bs, kvh, d)
    v = v_pages[idx].reshape(r, mb * bs, kvh, d)
    if h % kvh:
        head_map = (torch.arange(h, device=k.device) * kvh) // h
        k, v = k[:, :, head_map], v[:, :, head_map]
        kvh = h
    return k.float(), v.float(), kvh


def _softmax_av(s, valid, v, eq):
    """Masked fp32 softmax over the last axis of ``s`` and its product with V."""
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum(eq, p, v) / torch.clamp_min(l, 1e-30)


def torch_paged_attention(
    q: torch.Tensor,             # (R, H, D) one decode token per request slot
    k_pages: torch.Tensor,       # (NP+1, BS, KV, D) pages (last = trash)
    v_pages: torch.Tensor,       # (NP+1, BS, KV, D)
    block_tables: torch.Tensor,  # (R, MB) int page index per logical block
    positions: torch.Tensor,     # (R,) int position of the incoming token
    *,
    mode: str = "causal",
    window: int = 0,
) -> torch.Tensor:
    """Decode-step paged attention — the plain version of
    :func:`repro_torch.kernels.paged_attention.paged_decode_attention`.
    Key j of slot r counts iff ``j <= positions[r]`` (and within ``window``
    for local layers): pages past the context, stale table entries and the
    trash page are masked by position alone."""
    r, h, d = q.shape
    k, v, kvh = _gather_kv(k_pages, v_pages, block_tables, h)
    g = h // kvh
    qg = (q.float() * (1.0 / math.sqrt(d))).reshape(r, kvh, g, d)
    kv_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    pos = positions.long()[:, None]
    valid = kv_pos <= pos
    if mode == "local":
        valid &= kv_pos > pos - window
    s = torch.einsum("rkgd,rtkd->rkgt", qg, k)
    out = _softmax_av(s, valid[:, None, None], v, "rkgt,rtkd->rkgd")
    return out.reshape(r, h, d).to(q.dtype)


def torch_paged_chunk_attention(
    q: torch.Tensor,             # (R, C, H, D) one prefill chunk per slot
    k_pages: torch.Tensor,       # (NP+1, BS, KV, D)
    v_pages: torch.Tensor,       # (NP+1, BS, KV, D)
    block_tables: torch.Tensor,  # (R, MB) int
    positions: torch.Tensor,     # (R,) int base position of chunk token 0
    *,
    mode: str = "causal",
    window: int = 0,
) -> torch.Tensor:
    """Chunked paged prefill attention — the plain version of
    :func:`repro_torch.kernels.paged_attention.paged_chunk_attention`.
    Chunk token c of slot r queries at ``positions[r] + c`` and sees keys
    ``j <= positions[r] + c`` (windowed for local layers); rows past a slot's
    ragged length are garbage the caller discards."""
    r, c, h, d = q.shape
    k, v, kvh = _gather_kv(k_pages, v_pages, block_tables, h)
    g = h // kvh
    qg = (q.float() * (1.0 / math.sqrt(d))).reshape(r, c, kvh, g, d)
    kv_pos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    q_pos = positions.long()[:, None, None] + torch.arange(c, device=q.device)[None, :, None]
    valid = kv_pos <= q_pos                                           # (R, C, T)
    if mode == "local":
        valid &= kv_pos > q_pos - window
    s = torch.einsum("rckgd,rtkd->rckgt", qg, k)
    out = _softmax_av(s, valid[:, :, None, None], v, "rckgt,rtkd->rckgd")
    return out.reshape(r, c, h, d).to(q.dtype)
