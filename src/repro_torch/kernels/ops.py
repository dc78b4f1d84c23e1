"""The serving ops the models call, dispatched by the device of the tensors.

Tensors on the CPU go to the plain PyTorch version (:mod:`repro_torch.
kernels.ref`); tensors on a CUDA device launch the hand-written kernel
(:mod:`repro_torch.kernels.paged_attention`), which raises on anything it
does not take.  There is no fallback from the card to the plain version: a
failed build or launch is an error, never a quiet switch to other code.

Counterparts of ``paged_attention`` and ``paged_chunk_attention`` in the JAX
package's ``repro/kernels/ops.py``.  Unlike there, ragged head counts
(H % KV != 0) run on the kernel too: query head h reads kv head (h·KV)//H.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as kernels
from repro_torch.kernels import ref

__all__ = ["paged_attention", "paged_chunk_attention"]


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
