"""The ops the models and the outer step call, dispatched by the device of
the tensors.

Tensors on the CPU go to the plain PyTorch version (:mod:`repro_torch.
kernels.ref`); tensors on a CUDA device launch the hand-written kernel
(:mod:`repro_torch.kernels.paged_attention`, :mod:`~repro_torch.kernels.
flash_attention`, :mod:`~repro_torch.kernels.noloco_update`), which raises
on anything it does not take.  There is no fallback from the card to the
plain version: a failed build or launch is an error, never a quiet switch to
other code.

Counterparts of ``flash_attention``, ``noloco_update_pytree``,
``paged_attention`` and ``paged_chunk_attention`` in the JAX package's
``repro/kernels/ops.py``.  Unlike there, ragged head counts (H % KV != 0)
run on the kernels too: query head h reads kv head (h·KV)//H.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import noloco_update as noloco
from repro_torch.kernels import paged_attention as kernels
from repro_torch.kernels import ref
from repro_torch.tree import tree_map

__all__ = ["flash_attention", "noloco_update_pytree", "paged_attention", "paged_chunk_attention"]


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
    differentiated: the outer step runs outside autograd."""
    results = []

    def one(p, d, md, mp):
        if p.device.type == "cpu":
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
