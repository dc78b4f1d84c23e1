"""CUDA paged attention: decode (one query token per request slot) and
chunked prefill (C query tokens per slot), with K/V read from fixed-size
pages through per-request block tables.

The kernels are ``csrc/paged_attention.cu``, the Hopper counterparts of the
Pallas TPU kernels ``pallas_paged_attention`` and
``pallas_paged_chunk_attention`` in ``repro/kernels/paged_attention.py``.
The source's header says what bounds them on the card and what the design
does about it: each slot's visible keys are split into runs of a fixed
number of keys at absolute positions, one block per (split, row tile, slot
and kv head) writes f32 partials to a workspace, and a second kernel merges
them.  The split rule lives in the source alone; :func:`split_plan` asks the
library for it (keys per split, the grid's split axis, the splits one slot
runs, a function of its own position only, so a slot's result does not
depend on the other slots), and :func:`workspace_shapes` gives the
partials' shapes for that split axis.  The wrappers check their
arguments, allocate the output and the workspace with ``torch.empty`` and
launch both kernels on PyTorch's current stream; the library is built at
the first launch (:mod:`repro_torch.kernels.build`).

Each wrapper counts its launches in a plain integer attribute,
``paged_decode_attention.launches`` and ``paged_chunk_attention.launches``
(one per call: the split pass and its merge), so a run can show that the
serving path went through the kernels.  The plain PyTorch versions of the
same functions are in :mod:`repro_torch.kernels.ref`;
:mod:`repro_torch.kernels.ops` picks between the two by the device of the
tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def workspace_shapes(r: int, c: int, h: int, kvh: int, d: int, splits: int) -> tuple[tuple, tuple]:
    """Shapes of the f32 partials: (m, l) and acc of every (slot·kv head,
    split, row), rows c·ceil(H/KV)."""
    rows = c * -(-h // kvh)
    return (r * kvh, splits, rows, 2), (r * kvh, splits, rows, d)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built at the first call."""
    lib = build.load("paged_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_decode.argtypes = [
        i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, p,
    ]
    lib.paged_attention_decode.restype = i
    lib.paged_attention_chunk.argtypes = [
        i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, p,
    ]
    lib.paged_attention_chunk.restype = i
    lib.paged_attention_split_plan.argtypes = [i, i, i, i, i, i, p]
    lib.paged_attention_split_plan.restype = i
    return lib


def split_plan(position: int, c: int, mb: int, bs: int, mode: str, window: int) -> tuple[int, int, int]:
    """The kernels' split plan for slots of ``c`` query tokens (1 for
    decode) over a table of ``mb`` pages of ``bs``: (keys per split, the
    grid's split axis, the splits a slot at ``position`` runs), from the
    library."""
    plan = (ctypes.c_int * 3)()
    err = library().paged_attention_split_plan(
        position, c, bs, mb, int(mode == "local"), int(window), plan)
    if err != 0:
        raise ValueError(f"no split plan for position {position}, c {c}, mb {mb}, bs {bs}, "
                         f"{mode} {window}")
    return plan[0], plan[1], plan[2]


def _check(q, k_pages, v_pages, block_tables, positions, mode, window, q_dims):
    """Validate the launch arguments; returns (R, MB, NP1, BS, KV, D)."""
    tensors = {
        "q": q, "k_pages": k_pages, "v_pages": v_pages,
        "block_tables": block_tables, "positions": positions,
    }
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(
            f"page pools must match q's dtype {q.dtype}, "
            f"got {k_pages.dtype} and {v_pages.dtype}"
        )
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("block_tables and positions must be int32")
    if q.dim() != q_dims:
        raise ValueError(f"q must have {q_dims} dims, got shape {tuple(q.shape)}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"pools must be (NP+1, BS, KV, D) and equal, got "
            f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}"
        )
    np1, bs, kvh, d = k_pages.shape
    r = q.shape[0]
    if q.shape[-1] != d or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]} vs pools' {d}; need 1..{MAX_HEAD_DIM}")
    if block_tables.dim() != 2 or block_tables.shape[0] != r or block_tables.shape[1] < 1:
        raise ValueError(f"block_tables must be (R={r}, MB>=1), got {tuple(block_tables.shape)}")
    if positions.shape != (r,):
        raise ValueError(f"positions must be (R={r},), got {tuple(positions.shape)}")
    if mode not in ("causal", "local") or (mode == "local" and window < 1):
        raise ValueError(f"mode must be causal or local with window >= 1, got {mode!r}, {window}")
    return r, block_tables.shape[1], np1, bs, kvh, d


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _launch(chunk: bool, q, k_pages, v_pages, block_tables, positions, mode, window) -> torch.Tensor:
    """Check, allocate output and workspace, launch the split pass and its
    merge, count one launch."""
    r, mb, _, bs, kvh, d = _check(
        q, k_pages, v_pages, block_tables, positions, mode, window, 4 if chunk else 3
    )
    lib = library()
    c, h = (q.shape[1], q.shape[2]) if chunk else (1, q.shape[1])
    splits = split_plan(0, c, mb, bs, mode, window)[1]
    ml_shape, acc_shape = workspace_shapes(r, c, h, kvh, d, splits)
    ws_ml = torch.empty(ml_shape, dtype=torch.float32, device=q.device)
    ws_acc = torch.empty(acc_shape, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    args = (_DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            ws_ml.data_ptr(), ws_acc.data_ptr(), r)
    tail = (kvh, d, bs, mb, int(mode == "local"), int(window), 1.0 / math.sqrt(d))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if chunk:
            err = lib.paged_attention_chunk(*args, c, h, *tail, stream)
        else:
            err = lib.paged_attention_decode(*args, h, *tail, stream)
    _raise_on(err, "paged_attention_chunk" if chunk else "paged_attention_decode")
    (paged_chunk_attention if chunk else paged_decode_attention).launches += 1
    return out


def paged_decode_attention(
    q: torch.Tensor,             # (R, H, D) one decode token per request slot
    k_pages: torch.Tensor,       # (NP+1, BS, KV, D)
    v_pages: torch.Tensor,       # (NP+1, BS, KV, D)
    block_tables: torch.Tensor,  # (R, MB) int32
    positions: torch.Tensor,     # (R,) int32
    *,
    mode: str = "causal",
    window: int = 0,
) -> torch.Tensor:
    """Paged decode attention on the card; (R, H, D) in q's dtype."""
    return _launch(False, q, k_pages, v_pages, block_tables, positions, mode, window)


def paged_chunk_attention(
    q: torch.Tensor,             # (R, C, H, D) one prefill chunk per slot
    k_pages: torch.Tensor,       # (NP+1, BS, KV, D)
    v_pages: torch.Tensor,       # (NP+1, BS, KV, D)
    block_tables: torch.Tensor,  # (R, MB) int32
    positions: torch.Tensor,     # (R,) int32 base position of chunk token 0
    *,
    mode: str = "causal",
    window: int = 0,
) -> torch.Tensor:
    """Chunked paged prefill attention on the card; (R, C, H, D) in q's
    dtype.  Rows past a slot's ragged length are garbage the caller drops."""
    return _launch(True, q, k_pages, v_pages, block_tables, positions, mode, window)


paged_decode_attention.launches = 0
paged_chunk_attention.launches = 0
