"""CUDA single-token recurrent-state updates of the serving decode step:
the RG-LRU step h′ = a·h + b and the SSD step state′ = decay·state +
dtx ⊗ b, y = state′·c.

The kernels are ``csrc/decode_update.cu``, the Hopper counterparts of the
Pallas TPU kernels ``pallas_rglru_decode`` and ``pallas_ssd_decode``
(``repro/kernels/decode_update.py``); the source's header says what bounds
them.  The wrappers check their arguments, allocate the outputs with
``torch.empty`` and launch on PyTorch's current stream; the library is built
at the first launch (:mod:`repro_torch.kernels.build`).
``rglru_decode.launches`` and ``ssd_decode.launches`` count the launches.
The plain PyTorch versions are ``ref.torch_rglru_decode`` and
``ref.torch_ssd_decode``; :mod:`repro_torch.kernels.ops` picks between them
and the kernels by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan import check_f32_cuda


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built at the first call."""
    lib = build.load("decode_update")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rglru_decode.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, p]
    lib.rglru_decode.restype = i
    lib.ssd_decode.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    lib.ssd_decode.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rglru_decode(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h′ = a·h + b (R, W) fp32 on the card, the plain version's bits."""
    check_f32_cuda(h=h, a=a, b=b)
    if h.dim() != 2 or a.shape != h.shape or b.shape != h.shape:
        raise ValueError(f"h, a, b must be (R, W) and equal, got "
                         f"{tuple(h.shape)}, {tuple(a.shape)}, {tuple(b.shape)}")
    lib = library()
    out = torch.empty_like(h)
    ptrs = [t.data_ptr() for t in (h, a, b, out)]
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.rglru_decode(*ptrs, h.numel(), int(all(p % 16 == 0 for p in ptrs)),
                                     _sm_count(h.device.index), stream)
    if err != 0:
        raise RuntimeError(f"rglru_decode launch failed: error {err}")
    rglru_decode.launches += 1
    return out


def ssd_decode(
    state: torch.Tensor,  # (R, HP, N)
    decay: torch.Tensor,  # (R, HP)
    dtx: torch.Tensor,    # (R, HP)
    b: torch.Tensor,      # (R, N)
    c: torch.Tensor,      # (R, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(state′ (R, HP, N), y (R, HP)) fp32 on the card; state′ has the
    plain version's bits, y sums its N products in another order."""
    check_f32_cuda(state=state, decay=decay, dtx=dtx, b=b, c=c)
    if state.dim() != 3:
        raise ValueError(f"state must be (R, HP, N), got {tuple(state.shape)}")
    r, hp, n = state.shape
    if decay.shape != (r, hp) or dtx.shape != (r, hp) or b.shape != (r, n) or c.shape != (r, n):
        raise ValueError(
            f"for state (R={r}, HP={hp}, N={n}): decay and dtx must be (R, HP), b and c (R, N); "
            f"got {tuple(decay.shape)}, {tuple(dtx.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    lib = library()
    out_state = torch.empty_like(state)
    y = torch.empty((r, hp), dtype=torch.float32, device=state.device)
    rows = [t.data_ptr() for t in (state, b, c, out_state)]   # the N-wide rows
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.ssd_decode(
            state.data_ptr(), decay.data_ptr(), dtx.data_ptr(), b.data_ptr(), c.data_ptr(),
            out_state.data_ptr(), y.data_ptr(), r, hp, n,
            int(n % 4 == 0 and all(p % 16 == 0 for p in rows)), stream)
    if err != 0:
        raise RuntimeError(f"ssd_decode launch failed: error {err}")
    ssd_decode.launches += 1
    return out_state, y


rglru_decode.launches = 0
ssd_decode.launches = 0
