"""CUDA SSD (Mamba-2) intra-chunk kernel: per (batch, chunk, head) the
quadratic form y = (C Bᵀ ∘ L)(dt ∘ x) with L[i, j] = exp(cums_i −
cums_j)·[i ≥ j], and the chunk-end state Σ_j exp(cums_Q − cums_j)·B_j ⊗
(dt_j·x_j).

The kernel is ``csrc/ssd_scan.cu``, the Hopper counterpart of the Pallas
TPU kernel ``ssd_chunk_kernel`` (``repro/kernels/ssd_scan.py``); its header
says what bounds it.  The wrapper checks its arguments, allocates the
outputs with ``torch.empty`` and launches on PyTorch's current stream; the
library is built at the first launch (:mod:`repro_torch.kernels.build`).
``ssd_chunk.launches`` counts the launches.  The plain PyTorch version is
``ref.torch_ssd_chunk_intra``; :mod:`repro_torch.kernels.ops` runs the
inter-chunk recurrence around either.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan import check_f32_cuda


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel's shared library, built at the first call."""
    lib = build.load("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunk.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.ssd_chunk.restype = i
    return lib


def ssd_chunk(
    x: torch.Tensor,      # (B, NC, Q, H, P)
    dt: torch.Tensor,     # (B, NC, Q, H)
    a: torch.Tensor,      # (H,)
    b_mat: torch.Tensor,  # (B, NC, Q, N)
    c_mat: torch.Tensor,  # (B, NC, Q, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y_diag (B, NC, Q, H, P), states (B, NC, H, N, P)) fp32 on the card."""
    check_f32_cuda(x=x, dt=dt, a=a, b_mat=b_mat, c_mat=c_mat)
    if x.dim() != 5:
        raise ValueError(f"x must be (B, NC, Q, H, P), got {tuple(x.shape)}")
    bsz, nc, q, h, p = x.shape
    n = b_mat.shape[-1] if b_mat.dim() == 4 else -1
    if (dt.shape != (bsz, nc, q, h) or a.shape != (h,) or b_mat.shape != (bsz, nc, q, n)
            or c_mat.shape != b_mat.shape):
        raise ValueError(
            f"for x {tuple(x.shape)}: dt must be (B, NC, Q, H), a (H,), b_mat and c_mat "
            f"(B, NC, Q, N); got {tuple(dt.shape)}, {tuple(a.shape)}, {tuple(b_mat.shape)}, "
            f"{tuple(c_mat.shape)}")
    lib = library()
    y = torch.empty_like(x)
    states = torch.empty((bsz, nc, h, n, p), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_chunk(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            y.data_ptr(), states.data_ptr(), bsz, nc, q, h, p, n, stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_chunk launch failed: error {err} (-1: arguments the kernel does not take, "
            f"such as N {n} whose 64-row B and C tiles exceed a block's shared memory)")
    ssd_chunk.launches += 1
    return y, states


ssd_chunk.launches = 0
