"""CUDA RG-LRU scan: the inclusive recurrence h_t = a_t·h_{t−1} + b_t over
the sequence axis, channelwise, from h_0 = 0.

The kernel is ``csrc/rglru_scan.cu``, the Hopper counterpart of the Pallas
TPU kernel ``pallas_rglru_scan`` (``repro/kernels/rglru_scan.py``); its
header says what bounds it.  The wrapper checks its arguments, allocates
the output with ``torch.empty`` and launches on PyTorch's current stream;
the library is built at the first launch (:mod:`repro_torch.kernels.build`).
The source picks its launch from the sequence length (:func:`library_path`
reads the built library's choice).  ``rglru_scan.launches`` counts the
launches.  The plain PyTorch version is ``ref.torch_rglru_scan``;
:mod:`repro_torch.kernels.ops` picks between the two by device.

:func:`rglru_scan_bwd` is its backward, a reverse scan from the saved h
that reads a, g and h through a ring of step boxes in shared memory (same
source, ``rglru_scan_bwd.launches``; :func:`library_bwd_ring` reads the
ring's shape); its plain version is ``ref.torch_rglru_scan_bwd``, which it
matches bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel's shared library, built at the first call."""
    lib = build.load("rglru_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan.argtypes = [p, p, p, i, i, i, p]
    lib.rglru_scan.restype = i
    lib.rglru_scan_steps.argtypes = [i]
    lib.rglru_scan_steps.restype = i
    lib.rglru_scan_bwd.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.rglru_scan_bwd.restype = i
    lib.rglru_scan_bwd_ring.argtypes = [p]
    lib.rglru_scan_bwd_ring.restype = None
    return lib


def library_bwd_ring() -> dict:
    """The built library's ring for ``rglru_scan_bwd``: channels per block
    (one warp), steps per box and boxes in the ring."""
    out = (ctypes.c_int * 3)()
    library().rglru_scan_bwd_ring(out)
    return {"channels": out[0], "box_steps": out[1], "depth": out[2]}


def library_path(s: int) -> str:
    """The launch the built library makes for a sequence of ``s`` steps:
    "whole" (every step's loads issued before the first step) or "ring"
    (step groups, the next in flight while the current one is stepped)."""
    return "whole" if library().rglru_scan_steps(s) else "ring"


def check_f32_cuda(**tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous fp32 CUDA tensor on the
    device of the first."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, the other arguments on {first.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h (B, S, W) fp32 of the scan over a, b (B, S, W) fp32 on the card."""
    check_f32_cuda(a=a, b=b)
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a and b must be (B, S, W) and equal, got {tuple(a.shape)}, {tuple(b.shape)}")
    bsz, s, w = a.shape
    lib = library()
    h = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan(a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, s, w, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: error {err}")
    rglru_scan.launches += 1
    return h


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(da, db) (B, S, W) fp32 on the card from a, the forward's output h
    and g = dL/dh, all (B, S, W) fp32."""
    check_f32_cuda(a=a, h=h, g=g)
    if a.dim() != 3 or h.shape != a.shape or g.shape != a.shape:
        raise ValueError(f"a, h and g must be (B, S, W) and equal, got {tuple(a.shape)}, "
                         f"{tuple(h.shape)}, {tuple(g.shape)}")
    bsz, s, w = a.shape
    lib = library()
    da, db = torch.empty_like(a), torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_bwd(a.data_ptr(), h.data_ptr(), g.data_ptr(), da.data_ptr(),
                                 db.data_ptr(), bsz, s, w, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd launch failed: error {err}")
    rglru_scan_bwd.launches += 1
    return da, db


rglru_scan.launches = 0
rglru_scan_bwd.launches = 0
