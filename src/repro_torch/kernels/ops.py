"""The ops the models and the outer step call, dispatched by the device of
the tensors.

Tensors on the CPU go to the plain PyTorch version (:mod:`repro_torch.
kernels.ref`); tensors on a CUDA device launch the hand-written kernel
(:mod:`repro_torch.kernels.paged_attention`, :mod:`~repro_torch.kernels.
flash_attention`, :mod:`~repro_torch.kernels.noloco_update`,
:mod:`~repro_torch.kernels.quantize`, :mod:`~repro_torch.kernels.ssd_scan`,
:mod:`~repro_torch.kernels.rglru_scan`,
:mod:`~repro_torch.kernels.decode_update`), which raises
on anything it does not take.  There is no fallback from the card to the
plain version: a failed build or launch is an error, never a quiet switch to
other code.

Counterparts of ``flash_attention``, ``noloco_update_pytree``,
``paged_attention``, ``paged_chunk_attention``, ``int8_quantize``,
``int8_dequantize``, ``ssd_chunk``, ``rglru_scan``, ``rglru_decode`` and
``ssd_decode`` in the JAX package's
``repro/kernels/ops.py``.  Unlike there, ragged head counts (H % KV != 0)
run on the kernels too: query head h reads kv head (h·KV)//H.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import decode_update
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import noloco_update as noloco
from repro_torch.kernels import paged_attention as kernels
from repro_torch.kernels import quantize
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as rglru_kernel
from repro_torch.kernels import ssd_scan
from repro_torch.tree import tree_map

__all__ = [
    "flash_attention", "noloco_update_pytree", "paged_attention", "paged_chunk_attention",
    "int8_quantize", "int8_dequantize", "ssd_chunk", "rglru_scan", "rglru_decode", "ssd_decode",
]


def flash_attention(
    q: torch.Tensor,   # (B, Sq, H, D)
    k: torch.Tensor,   # (B, Sk, KV, D)
    v: torch.Tensor,   # (B, Sk, KV, D)
    *,
    mode: str = "causal",
    window: int = 0,
) -> torch.Tensor:
    """Differentiable GQA attention over canonical positions (query i and
    key j at positions i and j), causal, local (``window``) or full.  On the
    card the forward and the backward are the CUDA kernels; on the CPU
    autograd differentiates the plain version.  K/V stay at kv-head width."""
    if mode not in flash.MODES or (mode == "local" and window < 1):
        raise ValueError(f"mode must be causal, local (window >= 1) or full, got {mode!r}, {window}")
    if q.device.type == "cpu":
        return ref.torch_flash_attention(q, k, v, mode=mode, window=window)
    return flash.FlashAttention.apply(q, k, v, mode, window)


def noloco_update_pytree(phi, delta_mom, mean_delta, mean_phi, *, alpha: float, beta: float,
                         gamma: float):
    """Fused Eqs. 2–3 over whole trees, one launch per leaf (stacked leaves
    with a leading replica axis included); returns (φ′ tree, δ′ tree).  Not
    differentiated: the outer step runs outside autograd.  A zero-size
    leaf launches nothing (an empty grid)."""
    results = []

    def one(p, d, md, mp):
        if p.numel() == 0:
            results.append((torch.empty_like(p), torch.empty_like(d)))
        elif p.device.type == "cpu":
            results.append(ref.torch_noloco_update(p, d, md, mp, alpha=alpha, beta=beta, gamma=gamma))
        else:
            results.append(noloco.noloco_update(
                p.contiguous(), d.contiguous(), md.contiguous(), mp.contiguous(),
                alpha=alpha, beta=beta, gamma=gamma,
            ))
        return len(results) - 1

    index = tree_map(one, phi, delta_mom, mean_delta, mean_phi)
    return tree_map(lambda i: results[i][0], index), tree_map(lambda i: results[i][1], index)


def _check_mode(mode: str, window: int) -> None:
    if mode not in ("causal", "local"):
        raise ValueError(f"paged attention mode must be causal or local, got {mode!r}")
    if mode == "local" and window < 1:
        raise ValueError(f"local paged attention needs window >= 1, got {window}")


def paged_attention(
    q: torch.Tensor,             # (R, H, D) one decode token per request slot
    k_pages: torch.Tensor,       # (NP+1, BS, KV, D) page pool
    v_pages: torch.Tensor,       # (NP+1, BS, KV, D)
    block_tables: torch.Tensor,  # (R, MB) int32 page ids per slot
    positions: torch.Tensor,     # (R,) int32 current token position per slot
    *,
    mode: str = "causal",
    window: int = 0,
) -> torch.Tensor:
    """Paged decode attention: K/V read through per-slot block tables, key j
    valid iff j <= positions[r] (and inside the window on local layers)."""
    _check_mode(mode, window)
    if q.device.type == "cpu":
        return ref.torch_paged_attention(
            q, k_pages, v_pages, block_tables, positions, mode=mode, window=window
        )
    return kernels.paged_decode_attention(
        q, k_pages, v_pages, block_tables, positions, mode=mode, window=window
    )


def paged_chunk_attention(
    q: torch.Tensor,             # (R, C, H, D) one prefill chunk per request slot
    k_pages: torch.Tensor,       # (NP+1, BS, KV, D) page pool
    v_pages: torch.Tensor,       # (NP+1, BS, KV, D)
    block_tables: torch.Tensor,  # (R, MB) int32 page ids per slot
    positions: torch.Tensor,     # (R,) int32 base position of chunk token 0
    *,
    mode: str = "causal",
    window: int = 0,
) -> torch.Tensor:
    """Chunked paged prefill attention: C query tokens per slot, chunk token
    c querying at ``positions[r] + c``.  Ragged tails are handled upstream:
    their K/V went to the trash page and their output rows are discarded."""
    _check_mode(mode, window)
    if q.device.type == "cpu":
        return ref.torch_paged_chunk_attention(
            q, k_pages, v_pages, block_tables, positions, mode=mode, window=window
        )
    return kernels.paged_chunk_attention(
        q, k_pages, v_pages, block_tables, positions, mode=mode, window=window
    )


def int8_quantize(x: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-chunk affine uint8 quantization of each row of ``x`` (R, N) fp32
    or bf16, every row edge-padded to whole chunks of its own; returns
    (q (R, NC, chunk) uint8, scale (R, NC), lo (R, NC)).  A zero-size ``x``
    launches nothing."""
    if x.device.type == "cpu":
        return ref.torch_int8_quantize(x, chunk)
    if x.numel() == 0:
        rows, nc = x.shape[0], -(-x.shape[1] // chunk)
        meta = torch.empty((rows, nc), dtype=torch.float32, device=x.device)
        return (torch.empty((rows, nc, chunk), dtype=torch.uint8, device=x.device), meta,
                meta.clone())
    return quantize.int8_quantize(x.contiguous(), chunk)


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor, lo: torch.Tensor, n: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`int8_quantize`: the first ``n`` values of each row,
    q·scale + lo rounded once, in ``dtype``; returns (R, n).  A zero-size
    result launches nothing."""
    if q.device.type == "cpu":
        return ref.torch_int8_dequantize(q, scale, lo, n, dtype)
    if q.shape[0] == 0 or n == 0:
        return torch.empty((q.shape[0], n), dtype=dtype, device=q.device)
    return quantize.int8_dequantize(q, scale.contiguous(), lo.contiguous(), n, dtype)


# ---------------------------------------------------------------------------
# Recurrent families: the SSD chunk scan, the RG-LRU scan, the decode steps
# ---------------------------------------------------------------------------

class _SSDChunkIntra(torch.autograd.Function):
    """The SSD intra-chunk kernel on the card, whose backward is the
    backward kernel (the JAX package's custom vjp differentiates the jnp
    twin there).  It saves its inputs; under ``torch.utils.checkpoint``
    they are dropped and the forward runs again in the backward pass."""

    @staticmethod
    def forward(ctx, xc, dtc, a, bc, cc):
        ctx.save_for_backward(xc, dtc, a, bc, cc)
        return ssd_scan.ssd_chunk(xc, dtc, a, bc, cc)

    @staticmethod
    def backward(ctx, dy, dstates):
        return ssd_scan.ssd_chunk_bwd(*ctx.saved_tensors, dy.contiguous(), dstates.contiguous())


class _RGLRUScan(torch.autograd.Function):
    """The RG-LRU scan kernel on the card; its backward is the reverse-scan
    kernel, from a and the saved output h."""

    @staticmethod
    def forward(ctx, a, b):
        h = rglru_kernel.rglru_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, grad):
        a, h = ctx.saved_tensors
        return rglru_kernel.rglru_scan_bwd(a, h, grad.contiguous())


def _ssd_chunk_intra(xc, dtc, a, bc, cc):
    if xc.device.type == "cpu":
        return ref.torch_ssd_chunk_intra(xc, dtc, a, bc, cc)
    return _SSDChunkIntra.apply(*(t.float().contiguous() for t in (xc, dtc, a, bc, cc)))


def ssd_chunk(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)
    a: torch.Tensor,      # (H,) or (B, H)
    b_mat: torch.Tensor,  # (B, S, N)
    c_mat: torch.Tensor,  # (B, S, N)
    *,
    chunk: int,
    initial_state: torch.Tensor | None = None,   # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD, the structure of the JAX package's ``ops.ssd_chunk``:
    the sequence padded to chunks of q = min(chunk, S) (pad rows have dt 0,
    which leaves the state unchanged), the intra-chunk form by the kernel
    (card) or its plain version (CPU), then the inter-chunk state
    recurrence and the off-diagonal output in plain PyTorch, which autograd
    differentiates as JAX does.  ``a`` (B, H) gives each row rates of its
    own: the training forward folds the replicas into B.  Returns (y (B, S,
    H, P) in x's dtype, final state (B, H, P, N) fp32)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, s)
    nc = math.ceil(s / q)
    pad = nc * q - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b_mat = torch.nn.functional.pad(b_mat, (0, 0, 0, pad))
        c_mat = torch.nn.functional.pad(c_mat, (0, 0, 0, pad))
    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h)
    bc = b_mat.reshape(bsz, nc, q, n)
    cc = c_mat.reshape(bsz, nc, q, n)
    y_diag, states = _ssd_chunk_intra(xc, dtc, a, bc, cc)

    da = dtc.float() * ref.row_rates(a)
    chunk_decay = torch.exp(da.sum(dim=2))                 # (B, NC, H)
    cums = torch.cumsum(da, dim=2)
    # caches carry (B, H, P, N); the kernel's state layout is (B, H, N, P)
    prev = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
            if initial_state is None else initial_state.float().transpose(2, 3))
    entering = []
    for c in range(nc):
        entering.append(prev)   # the state entering chunk c
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)              # (B, NC, H, N, P)
    y_off = torch.einsum("bcin,bchnp,bcih->bcihp", cc.float(), prev_states, torch.exp(cums))
    y = (y_diag.float() + y_off).reshape(bsz, nc * q, h, p)[:, :s]
    return y.to(x.dtype), prev.transpose(2, 3)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan h_t = a_t·h_{t−1} + b_t over axis 1 (zero h_0) of
    a, b (B, S, W); fp32 (B, S, W)."""
    if a.device.type == "cpu":
        return ref.torch_rglru_scan(a, b)
    return _RGLRUScan.apply(a.float().contiguous(), b.float().contiguous())


def rglru_decode(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One RG-LRU decode step h′ = a·h + b across request slots (R, W),
    fp32.  Inference only: no gradient on the card."""
    if h.device.type == "cpu":
        return ref.torch_rglru_decode(h, a, b)
    return decode_update.rglru_decode(*(t.float().contiguous() for t in (h, a, b)))


def ssd_decode(
    state: torch.Tensor,  # (R, H, P, N) fp32 recurrent state
    dt1: torch.Tensor,    # (R, H) step sizes of this token
    a: torch.Tensor,      # (H,) negative decay rates
    b1: torch.Tensor,     # (R, N)
    c1: torch.Tensor,     # (R, N)
    x1: torch.Tensor,     # (R, H, P) the conv'd, silu'd input of this token
) -> tuple[torch.Tensor, torch.Tensor]:
    """One SSD decode step at model layout, the folding of the JAX package's
    ``ops.ssd_decode``: the per-head decay exp(dt·a) repeated over P and
    dt·x flattened to (R, H·P), the state viewed as (R, H·P, N).  Returns
    (state′ (R, H, P, N), y (R, H, P)), fp32.  Inference only."""
    r, h, p, n = state.shape
    decay = torch.exp(dt1.float() * a.float()[None, :]).repeat_interleave(p, dim=1)
    dtx = (dt1.float()[..., None] * x1.float()).reshape(r, h * p)
    flat = state.reshape(r, h * p, n)
    if state.device.type == "cpu":
        st, y = ref.torch_ssd_decode(flat, decay, dtx, b1, c1)
    else:
        st, y = decode_update.ssd_decode(
            *(t.float().contiguous() for t in (flat, decay, dtx, b1, c1)))
    return st.reshape(r, h, p, n), y.reshape(r, h, p)
