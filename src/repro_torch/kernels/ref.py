"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, in fp32, with the
arithmetic of the JAX package's ``repro/kernels/ref.py`` twins: for the
attention kernels a -1e30 mask (not -inf) and a softmax normalised by
``max(l, 1e-30)``, the paged ones over a dense gather of each slot's K/V
through its block table; the flash backward recomputes the softmax from the
saved log-sum-exp.  :mod:`repro_torch.kernels.ops`
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


# ---------------------------------------------------------------------------
# Flash attention (training and prefill: canonical positions)
# ---------------------------------------------------------------------------


def _valid_keys(sq: int, sk: int, mode: str, window: int, device) -> torch.Tensor:
    """(Sq, Sk) mask of the keys each query row sees; query i and key j sit
    at positions i and j."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    if mode == "full":
        return torch.ones((sq, sk), dtype=torch.bool, device=device)
    valid = kp <= qp
    if mode == "local":
        valid &= kp > qp - window
    return valid


def _grouped(q, k, v):
    """fp32 q·scale as (B, Sq, KV, G, D) and K/V as (B, Sk, KV, D), K/V
    expanded to one kv head per query head when H % KV != 0 (query head h
    reads kv head (h·KV)//H).  Returns (qg, k, v, head_map or None)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    kf, vf = k.float(), v.float()
    head_map = None
    if h % kvh:
        head_map = (torch.arange(h, device=q.device) * kvh) // h
        kf, vf = kf[:, :, head_map], vf[:, :, head_map]
        kvh = h
    qg = (q.float() * (1.0 / math.sqrt(d))).reshape(b, sq, kvh, h // kvh, d)
    return qg, kf, vf, head_map


def torch_flash_attention_fwd(
    q: torch.Tensor,   # (B, Sq, H, D)
    k: torch.Tensor,   # (B, Sk, KV, D)
    v: torch.Tensor,   # (B, Sk, KV, D)
    *,
    mode: str = "causal",
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention and its per-row log-sum-exp — the plain version of
    :func:`repro_torch.kernels.flash_attention.flash_attention_fwd`.

    The arithmetic of the JAX package's ``ref.jnp_flash_attention`` in one
    block: fp32 q·scale, a -1e30 mask, a softmax normalised by
    ``max(l, 1e-30)``.  Returns (o (B, Sq, H, D) in q's dtype, lse (B, H, Sq)
    fp32 = m + log(l))."""
    b, sq, h, d = q.shape
    qg, kf, vf, _ = _grouped(q, k, v)
    valid = _valid_keys(sq, k.shape[1], mode, window, q.device)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, kf)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    o = torch.einsum("bkgqt,btkd->bkgqd", p, vf) / l
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype).contiguous()
    lse = (m + torch.log(l))[..., 0].reshape(b, h, sq)
    return o, lse


def torch_flash_attention(q, k, v, *, mode: str = "causal", window: int = 0) -> torch.Tensor:
    """Attention output alone (differentiable by autograd): what the CPU runs
    for :func:`repro_torch.kernels.ops.flash_attention`."""
    return torch_flash_attention_fwd(q, k, v, mode=mode, window=window)[0]


def torch_flash_attention_bwd(
    q: torch.Tensor,     # (B, Sq, H, D)
    k: torch.Tensor,     # (B, Sk, KV, D)
    v: torch.Tensor,     # (B, Sk, KV, D)
    o: torch.Tensor,     # (B, Sq, H, D) the forward's output
    lse: torch.Tensor,   # (B, H, Sq) fp32 the forward's log-sum-exp
    do: torch.Tensor,    # (B, Sq, H, D) gradient of o
    *,
    mode: str = "causal",
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) recomputed from the saved log-sum-exp — the plain version
    of :func:`repro_torch.kernels.flash_attention.flash_attention_bwd`:
    P = exp(s − lse), Di = rowsum(dO ∘ O), dS = P ∘ (dO·Vᵀ − Di),
    dQ = dS·K·scale, dK = dSᵀ·Q·scale, dV = Pᵀ·dO."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg, kf, vf, head_map = _grouped(q, k, v)
    kv_eff, g = qg.shape[2], qg.shape[3]
    valid = _valid_keys(sq, sk, mode, window, q.device)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, kf)
    lse_g = lse.reshape(b, kv_eff, g, sq)[..., None]
    p = torch.where(valid, torch.exp(s - lse_g), torch.zeros_like(s))
    dof = do.float().reshape(b, sq, kv_eff, g, d)
    di = (dof * o.float().reshape(b, sq, kv_eff, g, d)).sum(-1).permute(0, 2, 3, 1)
    dp = torch.einsum("bqkgd,btkd->bkgqt", dof, vf)
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, kf) * (1.0 / math.sqrt(d))
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, qg)
    dv = torch.einsum("bkgqt,bqkgd->btkd", p, dof)
    if head_map is not None:  # sum the expanded heads back onto their kv head
        dk = torch.zeros((b, sk, kvh, d), device=q.device).index_add_(2, head_map, dk)
        dv = torch.zeros((b, sk, kvh, d), device=q.device).index_add_(2, head_map, dv)
    return dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# NoLoCo outer update (Eqs. 2–3 over group means)
# ---------------------------------------------------------------------------


def torch_noloco_update(
    phi, delta_mom, mean_delta, mean_phi, *, alpha: float, beta: float, gamma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """δ′ = αδ + β·mean_Δ − γ(φ − mean_φ), φ′ = φ + δ′ in fp32, each cast back
    to its input's dtype — the plain version of
    :func:`repro_torch.kernels.noloco_update.noloco_update`, in the order of
    the JAX package's ``ref.reference_noloco_update``."""
    p = phi.float()
    new_delta = alpha * delta_mom.float() + beta * mean_delta.float() - gamma * (p - mean_phi.float())
    return (p + new_delta).to(phi.dtype), new_delta.to(delta_mom.dtype)
