"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, in fp32, with the
arithmetic of the JAX package's ``repro/kernels/ref.py`` twins: for the
attention kernels a -1e30 mask (not -inf) and a softmax normalised by
``max(l, 1e-30)``, the paged ones over a dense gather of each slot's K/V
through its block table; the flash backward recomputes the softmax from the
saved log-sum-exp; the int8 codec pair with the arithmetic XLA gives the
jitted reference (a product with f32(1/255) for the scale, one rounding for
the dequantize).  :mod:`repro_torch.kernels.ops`
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


# ---------------------------------------------------------------------------
# int8 per-chunk affine codec
# ---------------------------------------------------------------------------

# f32(1/255).  Under ``jit`` XLA turns the reference's ``(max − lo) / 255.0``
# into a product with this reciprocal, and that is what the training path
# runs; a true division differs in some scales.
INV255 = float.fromhex("0x1.010102p-8")
_BLOCK_ELEMS = 1 << 24   # elements per pass of the plain versions, to bound their temporaries


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rows, CHUNK) fp32 → (q uint8, safe scale fp32, lo fp32), one chunk per row."""
    lo = x.amin(dim=1)
    scale = (x.amax(dim=1) - lo) * torch.tensor(INV255, dtype=torch.float32, device=x.device)
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.round((x - lo[:, None]) / safe[:, None]).clamp(0.0, 255.0)   # round half to even
    return q.to(torch.uint8), safe, lo


def torch_int8_quantize(x: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-chunk affine uint8 quantization of each row of ``x`` — the plain
    version of :func:`repro_torch.kernels.quantize.int8_quantize`.

    ``x`` (R, N) fp32 or bf16: each row is read as fp32, padded to
    NC = ⌈N / chunk⌉ chunks by repeating its last value, and every chunk maps
    to uint8 with lo = min, scale = (max − lo)·f32(1/255) (1 where that is
    not > 0), q = clip(round_half_even((x − lo) / scale), 0, 255).  Returns
    (q (R, NC, chunk) uint8, scale (R, NC) fp32, lo (R, NC) fp32): with
    N = NC·chunk and R = 1 this is the JAX package's ``(NC, CHUNK)``
    contract, bit for bit its jitted ``ref.jnp_int8_quantize``."""
    rows, n = x.shape
    nc = -(-n // chunk)
    q = torch.empty((rows, nc, chunk), dtype=torch.uint8, device=x.device)
    scale = torch.empty((rows, nc), dtype=torch.float32, device=x.device)
    lo = torch.empty((rows, nc), dtype=torch.float32, device=x.device)
    step = max(1, _BLOCK_ELEMS // chunk)
    for r in range(rows):
        for c0 in range(0, nc, step):
            c1 = min(nc, c0 + step)
            seg = x[r, c0 * chunk:min(c1 * chunk, n)].float()
            pad = (c1 - c0) * chunk - seg.numel()
            if pad:
                seg = torch.cat([seg, seg[-1:].expand(pad)])
            q[r, c0:c1], scale[r, c0:c1], lo[r, c0:c1] = _quantize_rows(seg.view(c1 - c0, chunk))
    return q, scale, lo


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c in fp32 with ONE rounding, as XLA's fused multiply-add and
    CUDA's ``__fmaf_rn`` give it; ``a`` holds integers of at most 8 bits.

    a·b is exact in fp64 (8 + 24 significant bits).  The fp64 sum s is made
    round-to-odd (when it is inexact and its last bit is even, move it one
    ulp towards the exact value, whose residual ``err`` the TwoSum gives),
    and rounding a round-to-odd fp64 value to fp32 is the correct rounding
    of the exact sum (53 ≥ 24 + 2 bits).  A plain fp64 sum rounded to fp32
    would round twice; an fp32 ``a * b + c`` rounds twice too, and
    ``torch.addcmul`` is a single rounding on some builds only."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def torch_int8_dequantize(q: torch.Tensor, scale: torch.Tensor, lo: torch.Tensor, n: int,
                          dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`torch_int8_quantize` — the plain version of
    :func:`repro_torch.kernels.quantize.int8_dequantize`: q·scale + lo with
    one rounding (the jitted reference's fused multiply-add), the first
    ``n`` values of each row, cast to ``dtype`` (round to nearest even).
    q (R, NC, chunk) uint8; scale, lo (R, NC) fp32 → (R, n)."""
    rows, nc, chunk = q.shape
    out = torch.empty((rows, n), dtype=dtype, device=q.device)
    step = max(1, _BLOCK_ELEMS // chunk)
    for r in range(rows):
        for c0 in range(0, nc, step):
            c1 = min(nc, c0 + step)
            vals = _fma_f32(q[r, c0:c1].float(), scale[r, c0:c1, None], lo[r, c0:c1, None])
            end = min(c1 * chunk, n)
            out[r, c0 * chunk:end] = vals.reshape(-1)[:end - c0 * chunk].to(dtype)
    return out


# ---------------------------------------------------------------------------
# SSD (Mamba-2) intra-chunk form and its token-by-token oracle
# ---------------------------------------------------------------------------


def row_rates(a: torch.Tensor) -> torch.Tensor:
    """The decay rates against (B, NC, Q, H): a (H,) shared by every row, or
    (B, H), one set per row (replicas folded into the batch)."""
    af = a.float()
    return af[None, None, None, :] if af.dim() == 1 else af[:, None, None, :]


def torch_ssd_chunk_intra(
    x: torch.Tensor,      # (B, NC, Q, H, P)
    dt: torch.Tensor,     # (B, NC, Q, H)
    a: torch.Tensor,      # (H,) or (B, H)
    b_mat: torch.Tensor,  # (B, NC, Q, N)
    c_mat: torch.Tensor,  # (B, NC, Q, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk quadratic form and per-chunk end states — the plain
    version of :func:`repro_torch.kernels.ssd_scan.ssd_chunk`, the
    arithmetic of the JAX package's ``ref.jnp_ssd_chunk_intra``:
    cums = cumsum(dt·a) (inclusive), L[i, j] = exp(cums_i − cums_j)·[i ≥ j],
    y = (C Bᵀ ∘ L)(dt ∘ x), state = Σ_j exp(cums_Q − cums_j)·B_j ⊗ (dt_j·x_j).
    ``a`` is (H,), or (B, H) with rates of its own for each row.  Returns
    (y_diag (B, NC, Q, H, P) in x's dtype, states (B, NC, H, N, P) fp32).

    L masks the differences before the exponential (exp(−inf) = 0) where
    the JAX twin masks after it: the values are the same, but there a
    masked entry's exp(cums_i − cums_j) overflows to inf once the chunk's
    decay passes e^88 (Q 128 with |dt·a| ~ 1 a step), and its vjp then
    multiplies the zero cotangent by inf, a NaN in ddt and da.  Here the
    masked entries have exact zero gradients."""
    q = x.shape[2]
    xf, dtf, bf, cf = x.float(), dt.float(), b_mat.float(), c_mat.float()
    da = dtf * row_rates(a)                                       # (B, NC, Q, H)
    cums = torch.cumsum(da, dim=2)
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]      # (B, NC, Qi, Qj, H)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    l_kern = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                   torch.full_like(diff, -math.inf)))
    xdt = xf * dtf[..., None]                                   # dt_j · x_j
    scores = torch.einsum("bcin,bcjn->bcij", cf, bf)
    y_diag = torch.einsum("bcij,bcijh,bcjhp->bcihp", scores, l_kern, xdt)
    decay_states = torch.exp(cums[:, :, -1:, :] - cums)          # (B, NC, Q, H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bf, decay_states, xdt)
    return y_diag.to(x.dtype), states


def torch_ssd_chunk_intra_bwd(
    x: torch.Tensor,        # (B, NC, Q, H, P)
    dt: torch.Tensor,       # (B, NC, Q, H)
    a: torch.Tensor,        # (H,) or (B, H)
    b_mat: torch.Tensor,    # (B, NC, Q, N)
    c_mat: torch.Tensor,    # (B, NC, Q, N)
    dy: torch.Tensor,       # (B, NC, Q, H, P) gradient of y_diag
    dstates: torch.Tensor,  # (B, NC, H, N, P) gradient of the states
) -> tuple[torch.Tensor, ...]:
    """(dx, ddt, da, db_mat, dc_mat), each in its input's shape: the vjp of
    :func:`torch_ssd_chunk_intra` by autograd, the plain version of
    :func:`repro_torch.kernels.ssd_scan.ssd_chunk_bwd` (the JAX package's
    ``bwd`` of its SSD op, the vjp of the jnp twin)."""
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_() for t in (x, dt, a, b_mat, c_mat)]
        y, states = torch_ssd_chunk_intra(*ins)
        return torch.autograd.grad((y, states), ins, (dy.float(), dstates.float()))


def torch_reference_ssd(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)
    a: torch.Tensor,      # (H,) negative rates
    b_mat: torch.Tensor,  # (B, S, N)
    c_mat: torch.Tensor,  # (B, S, N)
    initial_state: torch.Tensor | None = None,   # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token SSM recurrence, the gold semantics of SSD (the JAX
    package's ``ref.reference_ssd``; tests only):
    h_t = exp(dt_t·a)·h_{t−1} + dt_t·(x_t ⊗ B_t), y_t = h_t·C_t.
    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) fp32)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    af = a.float()
    ys = []
    for t in range(s):
        dtt, xt = dt[:, t].float(), x[:, t].float()
        bt, ct = b_mat[:, t].float(), c_mat[:, t].float()
        decay = torch.exp(dtt * af[None, :])
        upd = torch.einsum("bh,bn,bhp->bhpn", dtt, bt, xt)
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", ct, state))
    return torch.stack(ys, dim=1).to(x.dtype), state


# ---------------------------------------------------------------------------
# RG-LRU linear recurrence
# ---------------------------------------------------------------------------


def torch_rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan h_t = a_t·h_{t−1} + b_t over axis 1 with h_0 = 0 —
    the plain version of :func:`repro_torch.kernels.rglru_scan.rglru_scan`.
    a, b (B, S, W); returns fp32 (B, S, W).  Sequential in fp32, one product
    and one sum per step, each rounded once: the kernel's order, so the two
    agree bit for bit; the JAX twin (an associative scan) differs from both
    by rounding order only.  The steps are views of one ``unbind``, whose
    backward stacks their gradients in one pass."""
    af, bf = a.float(), b.float()
    if af.shape[1] == 0:
        return bf.clone()
    h = torch.zeros_like(bf[:, 0])
    out = []
    for a_t, b_t in zip(af.unbind(1), bf.unbind(1)):
        h = a_t * h + b_t
        out.append(h)
    return torch.stack(out, dim=1)


def torch_rglru_scan_bwd(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(da, db) fp32 (B, S, W): the vjp of :func:`torch_rglru_scan` at
    (a, b) for g = dL/dh, by autograd — the plain version of
    :func:`repro_torch.kernels.rglru_scan.rglru_scan_bwd` (the JAX
    package's ``bwd`` of its RG-LRU op).  The kernel takes the forward's h
    where this takes b; it recomputes h in the kernel's order.  Autograd's
    arithmetic is dh_t = g_t + a_{t+1}·dh_{t+1}, da_t = dh_t·h_{t−1},
    db_t = dh_t, each product and sum rounded once, which the kernel
    repeats bit for bit."""
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_() for t in (a, b)]
        return torch.autograd.grad(torch_rglru_scan(*ins), ins, g.float())


# ---------------------------------------------------------------------------
# Single-token decode state updates (serving)
# ---------------------------------------------------------------------------


def torch_rglru_decode(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One RG-LRU decode step h′ = a·h + b over (R, W) slot states in fp32 —
    the plain version of :func:`repro_torch.kernels.decode_update.
    rglru_decode` (the JAX package's ``ref.jnp_rglru_decode``)."""
    return a.float() * h.float() + b.float()


def torch_ssd_decode(
    state: torch.Tensor,  # (R, H·P, N) fp32 slot states, heads folded into rows
    decay: torch.Tensor,  # (R, H·P) exp(dt·a) repeated over P
    dtx: torch.Tensor,    # (R, H·P) dt_h · x_{h,p}
    b: torch.Tensor,      # (R, N)
    c: torch.Tensor,      # (R, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """One SSD decode step over prepared per-slot operands — the plain
    version of :func:`repro_torch.kernels.decode_update.ssd_decode` (the
    JAX package's ``ref.jnp_ssd_decode``): state′ = decay ⊙ state + dtx ⊗ b,
    y = state′ · c.  Returns (state′ (R, H·P, N) fp32, y (R, H·P) fp32)."""
    st = state.float() * decay.float()[..., None] + dtx.float()[..., None] * b.float()[:, None, :]
    y = torch.einsum("rkn,rn->rk", st, c.float())
    return st, y
