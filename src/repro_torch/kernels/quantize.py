"""CUDA int8 per-chunk affine quantize and dequantize of the gossip wire
codec.

The kernels are ``csrc/quantize.cu``, the Hopper counterparts of the Pallas
TPU kernels ``pallas_int8_quantize`` and ``pallas_int8_dequantize``
(``repro/kernels/quantize.py``); its header says what bounds them.  Both
work on R rows at once, one replica's packed buffer per row, each row cut
into chunks of its own (the last edge-padded inside the kernel), so one
launch serves every replica of the stacked exchange with the chunks that a
per-replica call would give.  The wrappers check their arguments, allocate
the outputs with ``torch.empty`` and launch on PyTorch's current stream;
the library is built at the first launch (:mod:`repro_torch.kernels.
build`).  The quantize kernel reads whole 16-byte-aligned chunks with
16-byte loads and every other chunk one value at a time
(:func:`library_wide_chunks` reads the built library's count).
``int8_quantize.launches`` and ``int8_dequantize.launches`` count the
launches.  The plain versions are ``ref.torch_int8_quantize`` and
``ref.torch_int8_dequantize``; :mod:`repro_torch.kernels.ops` picks by
device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built at the first call."""
    lib = build.load("quantize")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.int8_quantize.argtypes = [i, p, ll, ll, i, p, p, p, p]
    lib.int8_quantize.restype = i
    lib.int8_quantize_wide_chunks.argtypes = [i, p, ll, ll, i]
    lib.int8_quantize_wide_chunks.restype = ll
    lib.int8_dequantize.argtypes = [i, p, ll, p, p, ll, ll, i, p, p]
    lib.int8_dequantize.restype = i
    return lib


def library_wide_chunks(x: torch.Tensor, chunk: int) -> int:
    """How many of the R·⌈N/chunk⌉ chunks of ``int8_quantize`` on ``x``
    (R, N) the built library puts on its 16-byte kernel; the rest take the
    scalar kernel, with the same arithmetic."""
    rows, n = x.shape
    return library().int8_quantize_wide_chunks(_DTYPES[x.dtype], x.data_ptr(), rows, n, int(chunk))


def _check_cuda(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def int8_quantize(x: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize each row of ``x`` (R, N) fp32 or bf16 in chunks of ``chunk``
    on the card; returns (q (R, NC, chunk) uint8, scale (R, NC) fp32,
    lo (R, NC) fp32) with NC = ⌈N / chunk⌉, the last chunk of each row
    padded with the row's last value."""
    _check_cuda("x", x, x.device)
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (R, N) tensor, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    rows, n = x.shape
    if rows < 1 or n < 1 or chunk < 1:
        raise ValueError(f"need R, N, chunk >= 1, got {rows}, {n}, {chunk}")
    nc = -(-n // chunk)
    lib = library()
    q = torch.empty((rows, nc, chunk), dtype=torch.uint8, device=x.device)
    scale = torch.empty((rows, nc), dtype=torch.float32, device=x.device)
    lo = torch.empty((rows, nc), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int8_quantize(_DTYPES[x.dtype], x.data_ptr(), rows, n, int(chunk),
                                q.data_ptr(), scale.data_ptr(), lo.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"int8_quantize launch failed: cudaError_t {err}")
    int8_quantize.launches += 1
    return q, scale, lo


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor, lo: torch.Tensor, n: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """q·scale + lo with one rounding, the first ``n`` values of each row,
    in ``dtype`` (fp32 or bf16), on the card.  ``q`` (R, NC, chunk) uint8
    may be a view whose rows are strided (a slice of the wire array), each
    row's codes contiguous; ``scale`` and ``lo`` are contiguous (R, NC)
    fp32.  Returns (R, n)."""
    for name, t in (("q", q), ("scale", scale), ("lo", lo)):
        _check_cuda(name, t, q.device)
    if q.dim() != 3 or q.dtype != torch.uint8:
        raise ValueError(f"q must be (R, NC, chunk) uint8, got {q.dtype} {tuple(q.shape)}")
    rows, nc, chunk = q.shape
    if q.stride(2) != 1 or q.stride(1) != chunk or q.stride(0) < nc * chunk:
        raise ValueError(f"q's chunks must be contiguous within a row, got strides {q.stride()}")
    for name, t in (("scale", scale), ("lo", lo)):
        if t.shape != (rows, nc) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({rows}, {nc}) float32, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    if n < 1 or -(-n // chunk) != nc:
        raise ValueError(f"n = {n} does not fill {nc} chunks of {chunk}")
    lib = library()
    out = torch.empty((rows, n), dtype=dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.int8_dequantize(_DTYPES[dtype], q.data_ptr(), q.stride(0), scale.data_ptr(),
                                  lo.data_ptr(), rows, n, chunk, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"int8_dequantize launch failed: cudaError_t {err}")
    int8_dequantize.launches += 1
    return out


int8_quantize.launches = 0
int8_dequantize.launches = 0
