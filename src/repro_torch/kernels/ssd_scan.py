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

:func:`ssd_chunk_bwd` is its backward (six kernels of the same source,
one call, one count): the gradients of x, dt, a, B and C from those of
y_diag and the states, the counterpart of the JAX package's vjp of its jnp
twin, with its products on the tensor cores.  Its plain version is
``ref.torch_ssd_chunk_intra_bwd``.  Its tile and grid rule lives in the
source's host code; :func:`library_bwd_plan` reads it.  Both kernels take
the rates ``a`` as (H,) or as (B, H), one set per row.
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
    lib.ssd_chunk.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.ssd_chunk.restype = i
    lib.ssd_chunk_bwd.argtypes = [p] * 13 + [i] * 7 + [p]
    lib.ssd_chunk_bwd.restype = i
    lib.ssd_chunk_bwd_workspace.argtypes = [i, i, i, i]
    lib.ssd_chunk_bwd_workspace.restype = ctypes.c_longlong
    lib.ssd_chunk_bwd_plan.argtypes = [i] * 7 + [p]
    lib.ssd_chunk_bwd_plan.restype = i
    return lib


BWD_GRIDS = ("cums", "pairs", "keys", "bc", "dt", "da")


def library_bwd_plan(b: int, nc: int, q: int, h: int, p: int, n: int, a_rows: bool) -> dict:
    """The built library's tile and grid rule for ``ssd_chunk_bwd`` at a
    shape: ``tile`` rows, the pairs kernel's ``head_groups`` of
    ``heads_per_group``, and the blocks of each of its six grids."""
    out = (ctypes.c_int * 9)()
    if library().ssd_chunk_bwd_plan(b, nc, q, h, p, n, int(a_rows), out) != 0:
        raise ValueError(f"ssd_chunk_bwd does not take B {b}, NC {nc}, Q {q}, H {h}, P {p}, N {n}")
    return {"tile": out[0], "head_groups": out[1], "heads_per_group": out[2],
            "blocks": dict(zip(BWD_GRIDS, out[3:]))}


def _check(x, dt, a, b_mat, c_mat) -> tuple[int, ...]:
    """(B, NC, Q, H, P, N, a_rows) of checked forward inputs."""
    check_f32_cuda(x=x, dt=dt, a=a, b_mat=b_mat, c_mat=c_mat)
    if x.dim() != 5:
        raise ValueError(f"x must be (B, NC, Q, H, P), got {tuple(x.shape)}")
    bsz, nc, q, h, p = x.shape
    n = b_mat.shape[-1] if b_mat.dim() == 4 else -1
    if (dt.shape != (bsz, nc, q, h) or a.shape not in ((h,), (bsz, h))
            or b_mat.shape != (bsz, nc, q, n) or c_mat.shape != b_mat.shape):
        raise ValueError(
            f"for x {tuple(x.shape)}: dt must be (B, NC, Q, H), a (H,) or (B, H), b_mat and "
            f"c_mat (B, NC, Q, N); got {tuple(dt.shape)}, {tuple(a.shape)}, "
            f"{tuple(b_mat.shape)}, {tuple(c_mat.shape)}")
    return bsz, nc, q, h, p, n, int(a.dim() == 2)


def ssd_chunk(
    x: torch.Tensor,      # (B, NC, Q, H, P)
    dt: torch.Tensor,     # (B, NC, Q, H)
    a: torch.Tensor,      # (H,) or (B, H)
    b_mat: torch.Tensor,  # (B, NC, Q, N)
    c_mat: torch.Tensor,  # (B, NC, Q, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y_diag (B, NC, Q, H, P), states (B, NC, H, N, P)) fp32 on the card."""
    bsz, nc, q, h, p, n, a_rows = _check(x, dt, a, b_mat, c_mat)
    lib = library()
    y = torch.empty_like(x)
    states = torch.empty((bsz, nc, h, n, p), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_chunk(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            y.data_ptr(), states.data_ptr(), bsz, nc, q, h, p, n, a_rows, stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_chunk launch failed: error {err} (-1: arguments the kernel does not take, "
            f"such as N {n} whose 64-row B and C tiles exceed a block's shared memory)")
    ssd_chunk.launches += 1
    return y, states


def ssd_chunk_bwd(
    x: torch.Tensor,        # (B, NC, Q, H, P)
    dt: torch.Tensor,       # (B, NC, Q, H)
    a: torch.Tensor,        # (H,) or (B, H)
    b_mat: torch.Tensor,    # (B, NC, Q, N)
    c_mat: torch.Tensor,    # (B, NC, Q, N)
    dy: torch.Tensor,       # (B, NC, Q, H, P) gradient of y_diag
    dstates: torch.Tensor,  # (B, NC, H, N, P) gradient of the states
) -> tuple[torch.Tensor, ...]:
    """(dx, ddt, da, db_mat, dc_mat) fp32 on the card, each in its input's
    shape; the workspace is allocated here with ``torch.empty``."""
    bsz, nc, q, h, p, n, a_rows = _check(x, dt, a, b_mat, c_mat)
    check_f32_cuda(x=x, dy=dy, dstates=dstates)
    if dy.shape != x.shape or dstates.shape != (bsz, nc, h, n, p):
        raise ValueError(f"dy must be {tuple(x.shape)} and dstates {(bsz, nc, h, n, p)}, got "
                         f"{tuple(dy.shape)}, {tuple(dstates.shape)}")
    lib = library()
    outs = [torch.empty_like(t) for t in (x, dt, a, b_mat, c_mat)]
    work = torch.empty(max(0, lib.ssd_chunk_bwd_workspace(bsz, nc, q, h)), dtype=torch.uint8,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_chunk_bwd(
            *(t.data_ptr() for t in (x, dt, a, b_mat, c_mat, dy, dstates, *outs, work)),
            bsz, nc, q, h, p, n, a_rows, stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_chunk_bwd launch failed: error {err} (-1: arguments the kernels do not take, "
            f"such as B·NC {bsz * nc} above 65,535)")
    ssd_chunk_bwd.launches += 1
    return tuple(outs)


ssd_chunk.launches = 0
ssd_chunk_bwd.launches = 0
