"""The CUDA kernels against their plain PyTorch versions, on the card: paged
attention (decode and chunk), flash attention (forward and backward), the
fused NoLoCo outer update and the int8 codec pair.  Every test here needs a CUDA device and ``nvcc`` and skips
elsewhere; on a machine with the card run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py

The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed.  Tolerances: fp32 atol 1e-4 (the kernel and the plain
version sum in different orders); bf16 atol 2e-2, from rounding the output
to bf16 (values are O(1), one bf16 ulp there is 2**-7); bf16 gradients of
flash attention also get rtol 2e-2, since dK/dV sum over every query row and
grow with it while bf16 rounding is relative.  The outer update and the
int8 pair are exact: both versions round the same fp32 operations once.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    dispatch, flash_attention, noloco_update, ops, paged_attention, quantize, ref,
)

CASES = [(4, 4, "causal", 0), (4, 2, "causal", 0), (4, 1, "local", 5), (6, 4, "causal", 0),
         (16, 8, "causal", 0), (16, 8, "local", 7)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

NP, BS, MB, C = 9, 4, 6, 5
# Stale ids past each slot's context, trash fill (id NP) and a slot at 0.
TABLES = np.array([[0, 1, 2, 5, 6, 8], [3, 4, 5, 6, 1, 7], [2, NP, NP, NP, NP, NP],
                   [7, 8, 0, 1, 2, 3]], np.int32)
DECODE_POS = np.array([9, 23, 2, 0], np.int32)
CHUNK_BASE = np.array([3, 17, 0, 12], np.int32)   # rows up to 21 < MB·BS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _inputs(seed, h, kv, d, chunk, dtype, device):
    rng = np.random.default_rng(seed)
    r = TABLES.shape[0]
    qshape = (r, C, h, d) if chunk else (r, h, d)
    q = torch.from_numpy(rng.normal(size=qshape).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(NP + 1, BS, kv, d)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(NP + 1, BS, kv, d)).astype(np.float32))
    pos = torch.from_numpy(CHUNK_BASE if chunk else DECODE_POS)
    return ([t.to(device, dtype) for t in (q, kp, vp)]
            + [torch.from_numpy(TABLES).to(device), pos.to(device)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [48, 64, 128])
@pytest.mark.parametrize("h,kv,mode,window", CASES)
@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_kernel_matches_plain(cuda, chunk, h, kv, mode, window, d, dtype):
    args = _inputs(d + h + kv, h, kv, d, chunk, dtype, cuda)
    op = ops.paged_chunk_attention if chunk else ops.paged_attention
    plain = ref.torch_paged_chunk_attention if chunk else ref.torch_paged_attention
    kernel = paged_attention.paged_chunk_attention if chunk else paged_attention.paged_decode_attention
    before = kernel.launches
    got = op(*args, mode=mode, window=window)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(*args, mode=mode, window=window)
    assert got.dtype == dtype and got.shape == args[0].shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_kernel_ignores_keys_past_position(cuda, chunk):
    """Scrambling pool entries that no row can see leaves the output
    bit-identical."""
    args = _inputs(5, 4, 2, 64, chunk, torch.float32, cuda)
    op = ops.paged_chunk_attention if chunk else ops.paged_attention
    base = op(*args)
    q, kp, vp, tables, pos = args
    last = pos.cpu().numpy() + (C - 1 if chunk else 0)
    seen = {(int(TABLES[r, t // BS]), t % BS)
            for r in range(len(TABLES)) for t in range(int(last[r]) + 1)}
    kp2, vp2 = kp.clone(), vp.clone()
    for page in range(NP + 1):
        for off in range(BS):
            if (page, off) not in seen:
                kp2[page, off], vp2[page, off] = 99.0, -99.0
    got = op(q, kp2, vp2, tables, pos)
    assert torch.equal(base, got)


@pytest.mark.cuda
def test_kernel_rejects_bad_arguments(cuda):
    q, kp, vp, tables, pos = _inputs(1, 4, 2, 64, False, torch.float32, cuda)
    kernel = paged_attention.paged_decode_attention
    with pytest.raises(ValueError, match="contiguous"):
        kernel(q.transpose(0, 1), kp, vp, tables, pos)
    with pytest.raises(ValueError, match="dtype"):
        kernel(q, kp.half(), vp.half(), tables, pos)
    with pytest.raises(ValueError, match="int32"):
        kernel(q, kp, vp, tables.long(), pos)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernel(q.half(), kp.half(), vp.half(), tables, pos)


FLASH_CASES = [  # (B, S, H, KV, D, mode, window)
    (2, 37, 4, 2, 48, "causal", 0), (1, 100, 16, 8, 128, "causal", 0),
    (2, 70, 6, 4, 64, "causal", 0), (1, 130, 4, 1, 48, "local", 64),
    (2, 33, 4, 4, 64, "full", 0), (1, 40, 2, 2, 256, "causal", 0),
    (4, 128, 16, 16, 48, "causal", 0),
]


def _flash_inputs(seed, b, s, h, kv, d, dtype, device):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)]
    return [torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(device, dtype)
            for sh in shapes]


def _assert_grad_close(got, want, dtype):
    rtol = 0 if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernels_match_plain(cuda, case, dtype):
    b, s, h, kv, d, mode, window = case
    q, k, v, do = _flash_inputs(d + s, b, s, h, kv, d, dtype, cuda)
    fwd, bwd = flash_attention.flash_attention_fwd, flash_attention.flash_attention_bwd
    before = (fwd.launches, bwd.launches)
    o, lse = fwd(q, k, v, mode=mode, window=window)
    grads = bwd(q, k, v, o, lse, do, mode=mode, window=window)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    o_want, lse_want = ref.torch_flash_attention_fwd(q, k, v, mode=mode, window=window)
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == (b, h, s)
    torch.testing.assert_close(o.float(), o_want.float(), atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_want, atol=1e-4, rtol=1e-5)
    # the backward from the kernel's own o and lse, against the plain one
    want = ref.torch_flash_attention_bwd(q, k, v, o, lse, do, mode=mode, window=window)
    for got_g, want_g, t in zip(grads, want, (q, k, v)):
        assert got_g.dtype == dtype and got_g.shape == t.shape
        _assert_grad_close(got_g, want_g, dtype)


@pytest.mark.cuda
def test_flash_autograd_uses_both_kernels(cuda):
    q, k, v, do = _flash_inputs(3, 2, 50, 4, 2, 48, torch.float32, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    dispatch.reset_launches()
    ops.flash_attention(*leaves).backward(do)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.torch_flash_attention(*plain).backward(do)
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,offset", [(4096 * 3 + 5, 0), (1000, 1), (7, 0)])
def test_noloco_update_matches_plain(cuda, dtype, n, offset):
    """Odd lengths take the tail path; an offset of one element makes the
    arrays misaligned for 16-byte access."""
    rng = np.random.default_rng(n)
    args = [torch.from_numpy(rng.normal(size=n + offset).astype(np.float32)).to(cuda, dtype)[offset:]
            for _ in range(4)]
    coef = dict(alpha=0.5, beta=0.7, gamma=0.9)
    got = noloco_update.noloco_update(*args, **coef)
    torch.cuda.synchronize()
    want = ref.torch_noloco_update(*args, **coef)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_registry_kernels_launch(cuda):
    inputs = {
        "paged_attention": lambda: _inputs(2, 4, 2, 64, False, torch.bfloat16, cuda),
        "paged_chunk_attention": lambda: _inputs(2, 4, 2, 64, True, torch.bfloat16, cuda),
        "flash_attention": lambda: _flash_inputs(2, 2, 40, 4, 2, 48, torch.bfloat16, cuda)[:3],
        "noloco_update": lambda: _flash_inputs(2, 2, 40, 4, 4, 48, torch.bfloat16, cuda),
    }
    q, k, v, do = _flash_inputs(2, 2, 40, 4, 2, 48, torch.bfloat16, cuda)
    o, lse = ref.torch_flash_attention_fwd(q, k, v)
    inputs["flash_attention_bwd"] = lambda: [q, k, v, o, lse, do]
    x = torch.randn(2, 3000, device=cuda, dtype=torch.bfloat16)
    inputs["int8_quantize"] = lambda: [x, 1024]
    inputs["int8_dequantize"] = lambda: [*ref.torch_int8_quantize(x, 1024), 3000, torch.bfloat16]
    coef = dict(alpha=0.5, beta=0.7, gamma=0.9)
    dispatch.reset_launches()
    for name, op in dispatch.registry().items():
        op.kernel(*inputs[name](), **(coef if name == "noloco_update" else {}))
    torch.cuda.synchronize()
    assert dispatch.launch_counts() == {name: 1 for name in dispatch.registry()}


def _payload(rows, n, chunk, dtype, device, seed=0):
    """Rows whose chunks have magnitudes from 1e-30 to 1e4 and offsets of
    their own size, the first chunk constant (scale 1)."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-30, 4, size=(rows, n // chunk + 1)).repeat(chunk, axis=1)[:, :n]
    x = (rng.normal(size=(rows, n)) + rng.normal(size=(rows, n // chunk + 1)).repeat(
        chunk, axis=1)[:, :n]) * mag
    x[:, :min(chunk, n)] = 3.25
    return torch.from_numpy(x.astype(np.float32)).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,n,chunk", [(1, 8 * 1024, 1024), (4, 5 * 1024 + 17, 1024),
                                          (3, 1000, 7), (2, 9001, 3000), (1, 5, 1024)])
def test_int8_pair_matches_plain_bit_for_bit(cuda, dtype, rows, n, chunk):
    """Whole and ragged rows (the tail chunk edge-padded), constant chunks,
    chunks held in registers (<= 1024), read twice (3000) and a small odd
    chunk; the dequantize reads the codes through the wire's row stride."""
    x = _payload(rows, n, chunk, dtype, cuda, seed=n)
    q, scale, lo = quantize.int8_quantize(x, chunk)
    torch.cuda.synchronize()
    want = ref.torch_int8_quantize(x, chunk)
    for got, w in zip((q, scale, lo), want):
        assert got.dtype == w.dtype and got.shape == w.shape
        assert torch.equal(got, w)
    nc = q.shape[1]
    wire = torch.zeros((rows, nc * chunk + 13), dtype=torch.uint8, device=cuda)
    wire[:, :nc * chunk] = q.reshape(rows, -1)
    strided = wire[:, :nc * chunk].reshape(rows, nc, chunk)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = quantize.int8_dequantize(strided, scale, lo, n, out_dtype)
        torch.cuda.synchronize()
        w = ref.torch_int8_dequantize(q, scale, lo, n, out_dtype)
        assert got.dtype == out_dtype and got.shape == (rows, n)
        assert torch.equal(got, w)


@pytest.mark.cuda
def test_int8_nan_poisons_its_chunk_like_the_plain_version(cuda):
    x = _payload(2, 4096, 1024, torch.float32, cuda, seed=3)
    x[1, 2000] = float("nan")
    q, scale, lo = quantize.int8_quantize(x, 1024)
    want = ref.torch_int8_quantize(x, 1024)
    for got, w in ((scale, want[1]), (lo, want[2])):
        torch.testing.assert_close(got, w, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(lo[1, 1]) and torch.equal(q[0], want[0][0])
    out = quantize.int8_dequantize(q, scale, lo, 4096, torch.float32)
    torch.testing.assert_close(out, ref.torch_int8_dequantize(*want, 4096, torch.float32),
                               rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(out[1, 1024:2048]).all() and not torch.isnan(out[1, :1024]).any()


@pytest.mark.cuda
def test_int8_ops_launch_the_kernels(cuda):
    x = _payload(2, 3000, 1024, torch.float32, cuda)
    before = (quantize.int8_quantize.launches, quantize.int8_dequantize.launches)
    q, scale, lo = ops.int8_quantize(x, 1024)
    out = ops.int8_dequantize(q, scale, lo, 3000, torch.float32)
    torch.cuda.synchronize()
    assert (quantize.int8_quantize.launches, quantize.int8_dequantize.launches) == (
        before[0] + 1, before[1] + 1)
    assert (out - x).abs().max().item() <= 0.51 * scale.max().item()   # half a code


@pytest.mark.cuda
def test_int8_kernels_reject_bad_arguments(cuda):
    x = torch.randn(2, 100, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        quantize.int8_quantize(x.half(), 16)
    with pytest.raises(ValueError, match="contiguous"):
        quantize.int8_quantize(x.t(), 16)
    q, scale, lo = quantize.int8_quantize(x, 16)
    with pytest.raises(ValueError, match="does not fill"):
        quantize.int8_dequantize(q, scale, lo, 50, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        quantize.int8_dequantize(q.cpu(), scale, lo, 100, torch.float32)
