"""CUDA fused NoLoCo outer update: δ′ = αδ + β·mean_Δ − γ(φ − mean_φ) and
φ′ = φ + δ′ in one pass, 4 reads and 2 writes per element.

The kernel is ``csrc/noloco_update.cu``, the Hopper counterpart of the
Pallas TPU kernel ``noloco_update_flat`` (``repro/kernels/noloco_update.py``);
its header says what bounds it.  The wrapper checks its arguments, allocates
the two outputs with ``torch.empty`` and launches on PyTorch's current
stream; the library is built at the first launch
(:mod:`repro_torch.kernels.build`).  ``noloco_update.launches`` counts the
launches.  The plain PyTorch version is ``ref.torch_noloco_update``;
:mod:`repro_torch.kernels.ops` picks between the two by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel's shared library, built at the first call."""
    lib = build.load("noloco_update")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.noloco_update.argtypes = [i, p, p, p, p, p, p, ctypes.c_longlong, f, f, f, i, i, p]
    lib.noloco_update.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def noloco_update(
    phi: torch.Tensor,
    delta_mom: torch.Tensor,
    mean_delta: torch.Tensor,
    mean_phi: torch.Tensor,
    *,
    alpha: float,
    beta: float,
    gamma: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Eqs. 2-3 elementwise on the card; returns (φ′, δ′) in the inputs'
    dtype and shape (any shape: the arrays are read flat)."""
    tensors = {"phi": phi, "delta_mom": delta_mom, "mean_delta": mean_delta, "mean_phi": mean_phi}
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != phi.device:
            raise ValueError(f"{name} is on {t.device}, phi on {phi.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != phi.dtype or t.shape != phi.shape:
            raise ValueError(
                f"{name} must match phi ({phi.dtype}, {tuple(phi.shape)}), "
                f"got {t.dtype}, {tuple(t.shape)}"
            )
    if phi.dtype not in _DTYPES:
        raise ValueError(f"phi must be float32 or bfloat16, got {phi.dtype}")
    lib = library()
    phi_out, delta_out = torch.empty_like(phi), torch.empty_like(delta_mom)
    ptrs = [t.data_ptr() for t in (phi, delta_mom, mean_delta, mean_phi, phi_out, delta_out)]
    vectorised = all(ptr % 16 == 0 for ptr in ptrs)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = lib.noloco_update(
            _DTYPES[phi.dtype], *ptrs, phi.numel(), float(alpha), float(beta), float(gamma),
            int(vectorised), _sm_count(phi.device.index), stream,
        )
    if err != 0:
        raise RuntimeError(f"noloco_update launch failed: cudaError_t {err}")
    noloco_update.launches += 1
    return phi_out, delta_out


noloco_update.launches = 0
