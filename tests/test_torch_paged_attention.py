"""The port's paged-attention ops against the JAX package's.

On the CPU the port's ops run their plain PyTorch versions; they must agree
with the JAX package's jnp twins and with its Pallas kernels in interpret
mode on the same inputs (made with numpy from a seed).  fp32 tolerances
atol 2e-5 / rtol 1e-4: XLA and ATen sum in different orders.  The CUDA
kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jax_ops
from repro.kernels.dispatch import KernelConfig
from repro.kernels.paged_attention import (
    pallas_paged_attention,
    pallas_paged_chunk_attention,
)
from repro_torch.kernels import ops

JNP = KernelConfig(impl="jnp")
ATOL, RTOL = 2e-5, 1e-4
CASES = [(4, 4, "causal", 0), (4, 2, "causal", 0), (4, 1, "local", 5), (6, 4, "causal", 0)]

NP, BS, MB = 7, 4, 5   # 7 pages + trash (id 7), 4 tokens each, 5 table entries
# Slot 0 owns pages 0-2 and keeps stale ids past them, slot 1 owns 3-6 and a
# stale 1, slot 2 holds one page and trash fill.
TABLES = np.array([[0, 1, 2, 5, 6], [3, 4, 5, 6, 1], [2, 7, 7, 7, 7]], np.int32)
DECODE_POS = np.array([9, 17, 2], np.int32)
CHUNK_BASE = np.array([3, 12, 0], np.int32)   # chunk of C=5: rows up to 16
C = 5


def _inputs(seed, h, kv, d, chunk):
    rng = np.random.default_rng(seed)
    r = TABLES.shape[0]
    qshape = (r, C, h, d) if chunk else (r, h, d)
    q = rng.normal(size=qshape).astype(np.float32)
    kp = rng.normal(size=(NP + 1, BS, kv, d)).astype(np.float32)
    vp = rng.normal(size=(NP + 1, BS, kv, d)).astype(np.float32)
    pos = CHUNK_BASE if chunk else DECODE_POS
    return q, kp, vp, TABLES, pos


def _port(fn, arrays, **kw):
    return fn(*(torch.from_numpy(a) for a in arrays), **kw).numpy()


@pytest.mark.parametrize("d", [48, 64])
@pytest.mark.parametrize("h,kv,mode,window", CASES)
@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_port_matches_jax(chunk, h, kv, mode, window, d):
    arrays = _inputs(d + 7 * h + kv, h, kv, d, chunk)
    port_op = ops.paged_chunk_attention if chunk else ops.paged_attention
    jax_op = jax_ops.paged_chunk_attention if chunk else jax_ops.paged_attention
    got = _port(port_op, arrays, mode=mode, window=window)
    want = np.asarray(jax_op(*map(jnp.asarray, arrays), mode=mode, window=window, config=JNP))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    if h % kv == 0:  # the Pallas kernels take divisible head counts only
        pallas = pallas_paged_chunk_attention if chunk else pallas_paged_attention
        want_k = np.asarray(
            pallas(*map(jnp.asarray, arrays), mode=mode, window=window, interpret=True)
        )
        np.testing.assert_allclose(got, want_k, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_paged_attention_masks_unallocated_pages(chunk):
    """Keys past every row's position (stale pages, trash fill) must not
    leak: scrambling them leaves the output bit-identical."""
    q, kp, vp, tables, pos = _inputs(3, 4, 2, 16, chunk)
    op = ops.paged_chunk_attention if chunk else ops.paged_attention
    base = _port(op, (q, kp, vp, tables, pos))
    last = pos + (C - 1 if chunk else 0)   # last query position per slot
    kp2, vp2 = kp.copy(), vp.copy()
    for r in range(tables.shape[0]):
        for t in range(int(last[r]) + 1, MB * BS):
            page, off = tables[r, t // BS], t % BS
            if all(  # only keys no slot can see
                not (tables[o, u // BS] == page and u % BS == off and u <= last[o])
                for o in range(tables.shape[0]) for u in range(MB * BS)
            ):
                kp2[page, off], vp2[page, off] = 99.0, -99.0
    assert not np.array_equal(kp, kp2)
    got = _port(op, (q, kp2, vp2, tables, pos))
    np.testing.assert_array_equal(base, got)
