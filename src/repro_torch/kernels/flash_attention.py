"""CUDA flash attention for training: the forward with its per-row
log-sum-exp, the backward recomputed from it, and the autograd function that
joins them.

The kernels are ``csrc/flash_attention.cu``: ``flash_attention_fwd`` is the
Hopper counterpart of the Pallas TPU kernel ``flash_attention_bhsd`` with its
wrapper ``pallas_flash_attention`` (``repro/kernels/flash_attention.py``);
``flash_attention_bwd`` stands where the JAX package differentiates the jnp
twin (``repro/kernels/ops.py``), which has no Pallas kernel.  The source's
header says what bounds them on the card and how they fold the query heads
of a kv head into rows.  Two sets of kernels serve the calls, chosen by
type and head dim in the source's host code (:func:`path_for` states the
rule): bf16 with D % 8 == 0 runs on the tensor cores, fp32 and bf16 with
D % 8 != 0 on the CUDA cores.  The wrappers check their arguments, allocate
outputs with ``torch.empty`` and launch on PyTorch's current stream; the
library is built at the first launch (:mod:`repro_torch.kernels.build`).

Each wrapper counts its launches in a plain integer attribute,
``flash_attention_fwd.launches`` and ``flash_attention_bwd.launches``: one
per call, whatever the call launches inside (the tensor-core backward is a
Di pre-pass, the dK/dV blocks and the dQ blocks).  The plain PyTorch versions are in
:mod:`repro_torch.kernels.ref`; :mod:`repro_torch.kernels.ops` picks between
the two by the device of the tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MODES = {"causal": 0, "local": 1, "full": 2}
MAX_HEAD_DIM = 256


def path_for(dtype: torch.dtype, d: int) -> str:
    """Which kernels serve a call on the card: ``"tensor_core"`` for bf16
    with ``d % 8 == 0``, ``"cuda_core"`` for fp32 and for bf16 with other
    head dims.  The source's host code makes the same choice; fp32 stays off
    the tensor cores so that fp32 training keeps fp32 products."""
    return "tensor_core" if dtype == torch.bfloat16 and d % 8 == 0 else "cuda_core"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built at the first call.  Its
    ``*_cuda_core`` entry points run the CUDA-core kernels whatever the type;
    the wrappers never call them (``chip_smoke.py`` times them)."""
    lib = build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for suffix in ("", "_cuda_core"):
        fwd, bwd = getattr(lib, "flash_attention_fwd" + suffix), getattr(lib, "flash_attention_bwd" + suffix)
        fwd.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i, i, f, p]
        bwd.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, p, p]
        fwd.restype = bwd.restype = i
    return lib


def _check(tensors: dict, q, k, v, mode: str, window: int):
    """Validate the launch arguments; returns (B, Sq, Sk, H, KV, D)."""
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q (B, Sq, H, D) and k, v (B, Sk, KV, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, sq, h, d = q.shape
    _, sk, kvh, dk = k.shape
    if k.shape[0] != b or dk != d or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} (D <= {MAX_HEAD_DIM})")
    if not 1 <= kvh <= h:
        raise ValueError(f"need 1 <= KV <= H, got KV {kvh}, H {h}")
    if mode not in MODES or (mode == "local" and window < 1):
        raise ValueError(f"mode must be causal, local (window >= 1) or full, got {mode!r}, {window}")
    if path_for(q.dtype, d) == "tensor_core":   # rows are copied in 16-byte pieces
        for name, t in tensors.items():
            if name != "lse" and t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned for the tensor-core kernels")
    return b, sq, sk, h, kvh, d


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def flash_attention_fwd(
    q: torch.Tensor,   # (B, Sq, H, D)
    k: torch.Tensor,   # (B, Sk, KV, D)
    v: torch.Tensor,   # (B, Sk, KV, D)
    *,
    mode: str = "causal",
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention on the card; returns (o (B, Sq, H, D) in q's dtype,
    lse (B, H, Sq) fp32)."""
    tensors = {"q": q, "k": k, "v": v}
    for name, t in tensors.items():
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must match q's dtype {q.dtype}, got {t.dtype}")
    b, sq, sk, h, kvh, d = _check(tensors, q, k, v, mode, window)
    lib = library()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, sq, sk, h, kvh, d, MODES[mode], int(window),
            1.0 / math.sqrt(d), stream,
        )
    _raise_on(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd(
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
    """Gradients (dq, dk, dv) on the card, in the inputs' dtype."""
    tensors = {"q": q, "k": k, "v": v, "o": o, "lse": lse, "do": do}
    for name in ("k", "v", "o", "do"):
        if tensors[name].dtype != q.dtype:
            raise ValueError(f"{name} must match q's dtype {q.dtype}, got {tensors[name].dtype}")
    b, sq, sk, h, kvh, d = _check(tensors, q, k, v, mode, window)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must be {tuple(q.shape)}, got {tuple(o.shape)}, {tuple(do.shape)}")
    if lse.dtype != torch.float32 or lse.shape != (b, h, sq):
        raise ValueError(f"lse must be float32 {(b, h, sq)}, got {lse.dtype} {tuple(lse.shape)}")
    lib = library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the tensor-core path's Di = rowsum(dO ∘ O), written by its pre-pass
    di = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
          if path_for(q.dtype, d) == "tensor_core" else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, sk, h, kvh, d, MODES[mode], int(window), 1.0 / math.sqrt(d), stream,
            None if di is None else di.data_ptr(),
        )
    _raise_on(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention whose forward and backward are the CUDA kernels.  It saves
    (q, k, v, o, lse); under ``torch.utils.checkpoint`` those are dropped
    and the forward runs again in the backward pass."""

    @staticmethod
    def forward(ctx, q, k, v, mode: str, window: int):
        o, lse = flash_attention_fwd(q, k, v, mode=mode, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mode, ctx.window = mode, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), mode=ctx.mode, window=ctx.window
        )
        return dq, dk, dv, None, None
