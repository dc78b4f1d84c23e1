"""The CUDA kernels against their plain PyTorch versions, on the card: paged
attention (decode and chunk), flash attention (forward and backward), the
fused NoLoCo outer update, the int8 codec pair, the SSD chunk and RG-LRU
scans and the two recurrent decode steps.  Every test here needs a CUDA
device and ``nvcc`` and skips elsewhere; on a machine with the card run them
with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py

The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed.  Tolerances: fp32 atol 1e-4 (the kernel and the plain
version sum in different orders); bf16 atol 2e-2, from rounding the output
to bf16 (values are O(1), one bf16 ulp there is 2**-7); bf16 gradients of
flash attention also get rtol 2e-2, since dK/dV sum over every query row and
grow with it while bf16 rounding is relative.  The outer update and the
int8 pair are exact: both versions round the same fp32 operations once.
So are the RG-LRU scan, the RG-LRU decode step and the SSD decode state
(the same fp32 products and sums in the same order); the SSD decode output
sums its N products in another order (within 1e-5 of Σ|state′·c|), and the
SSD chunk kernel agrees with its plain version within atol and rtol 1e-4
(fp32 sums of up to Q·N products in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    decode_update, dispatch, flash_attention, noloco_update, ops, paged_attention, quantize, ref,
    rglru_scan, ssd_scan,
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
    # the tensor-core kernels' edges: D 16/48/128/256 at S 1024, S no multiple
    # of the row or key tiles (64, 128), a window across key tiles, MQA,
    # ragged heads; D 36 in bf16 takes the CUDA-core kernels
    (1, 1024, 4, 4, 16, "causal", 0), (2, 1024, 4, 2, 48, "causal", 0),
    (1, 1024, 4, 2, 128, "causal", 0), (1, 1024, 2, 1, 256, "causal", 0),
    (1, 1000, 4, 4, 64, "causal", 0), (1, 300, 4, 2, 64, "local", 100),
    (2, 200, 8, 1, 128, "causal", 0), (1, 257, 6, 4, 48, "full", 0),
    (1, 130, 6, 4, 256, "local", 70), (2, 100, 4, 2, 36, "causal", 0),
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
@pytest.mark.parametrize("case", [(2, 1024, 4, 2, 48, "causal", 0), (1, 300, 6, 4, 128, "local", 100)],
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_bf16_is_bit_identical_across_calls(cuda, case):
    """One writer per output element and a fixed order of sums: the same
    inputs give the same gradients, bit for bit."""
    b, s, h, kv, d, mode, window = case
    q, k, v, do = _flash_inputs(11, b, s, h, kv, d, torch.bfloat16, cuda)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, mode=mode, window=window)
    first = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, mode=mode, window=window)
    second = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, mode=mode, window=window)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 48), (torch.bfloat16, 256),
                                     (torch.bfloat16, 36), (torch.float32, 48)],
                         ids=["bf16-48", "bf16-256", "bf16-36", "fp32-48"])
def test_flash_path_for_names_the_kernels_that_ran(cuda, dtype, d):
    """The profiler's device kernels of one forward and one backward call are
    the tensor-core kernels exactly when ``path_for`` says so."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, do = _flash_inputs(7, 1, 100, 4, 2, d, dtype, cuda)
    fwd, bwd = flash_attention.flash_attention_fwd, flash_attention.flash_attention_bwd
    o, lse = fwd(q, k, v)    # builds the library outside the profiled window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o, lse = fwd(q, k, v)
        bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    flash = {n for n in names if "flash_" in n}
    assert flash, f"no flash kernel among the profiled device ops {sorted(names)}"
    on_tc = {n for n in flash if "_tc_kernel" in n or "prepass" in n}
    if flash_attention.path_for(dtype, d) == "tensor_core":
        assert on_tc == flash and len(flash) == 4, sorted(flash)   # fwd, pre-pass, dK/dV, dQ
    else:
        assert not on_tc and len(flash) == 2, sorted(flash)


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
    inputs["ssd_chunk"] = lambda: _ssd_chunk_inputs(0, 1, 2, 8, 2, 16, 8, cuda)
    inputs["rglru_scan"] = lambda: _f32(cuda, 0, (2, 9, 40), (2, 9, 40))
    inputs["rglru_decode"] = lambda: _f32(cuda, 0, (2, 40), (2, 40), (2, 40))
    inputs["ssd_decode"] = lambda: _f32(cuda, 0, (2, 12, 8), (2, 12), (2, 12), (2, 8), (2, 8))
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


# ---------------------------------------------------------------------------
# the recurrent families: SSD chunk scan, RG-LRU scan, the decode steps
# ---------------------------------------------------------------------------


def _f32(device, seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device) for s in shapes]


def _ssd_chunk_inputs(seed, b, nc, q, h, p, n, device, pad=0):
    """x, dt (softplus · 0.1, exactly 0 on the last ``pad`` rows of the last
    chunk), a in [−16, −1], B, C: the distributions of the model's."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, nc, q, h, p))
    dt = np.log1p(np.exp(rng.normal(size=(b, nc, q, h)) - 2.0))
    if pad:
        dt[:, -1, q - pad:] = 0.0
    a = -np.exp(rng.uniform(0.0, np.log(16.0), size=h))
    bm, cm = rng.normal(size=(2, b, nc, q, n))
    return [torch.from_numpy(v.astype(np.float32)).to(device) for v in (x, dt, a, bm, cm)]


SSD_CASES = [(1, 1, 32, 32, 64, 128), (2, 3, 16, 4, 64, 32), (1, 2, 64, 3, 32, 128),
             (1, 1, 128, 2, 64, 128), (2, 2, 7, 5, 33, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_chunk_matches_plain(cuda, case):
    args = _ssd_chunk_inputs(sum(case), *case, cuda, pad=case[2] // 3)
    before = ssd_scan.ssd_chunk.launches
    y, st = ssd_scan.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_chunk.launches == before + 1
    wy, wst = ref.torch_ssd_chunk_intra(*args)
    assert y.shape == wy.shape and st.shape == wst.shape and st.dtype == torch.float32
    torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, wst, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_ssd_chunk_pad_rows_leave_the_state_exactly_unchanged(cuda):
    """Rows with dt = 0 add exact zeros, whatever their x, B and C hold."""
    x, dt, a, bm, cm = _ssd_chunk_inputs(3, 1, 1, 32, 4, 64, 128, cuda, pad=11)
    y0, st0 = ssd_scan.ssd_chunk(x, dt, a, bm, cm)
    noisy = [t.clone() for t in (x, bm, cm)]
    for t in noisy:
        t[:, :, 21:] = 1e3 * torch.randn_like(t[:, :, 21:])
    y1, st1 = ssd_scan.ssd_chunk(noisy[0], dt, a, noisy[1], noisy[2])
    assert torch.equal(st0, st1) and torch.equal(y0[:, :, :21], y1[:, :, :21])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 32, 4096), (2, 37, 130), (3, 5, 33), (2, 300, 1000)])
def test_rglru_scan_is_the_plain_version_bit_for_bit(cuda, shape):
    a, b = _f32(cuda, shape[2], shape, shape)
    a = torch.sigmoid(a) * 0.5 + 0.45
    h = ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert h.dtype == torch.float32 and h.shape == shape
    assert torch.equal(h, ref.torch_rglru_scan(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((4, 4096), 0), ((3, 130), 0), ((1, 7), 0),
                                          ((4, 4096), 1)])
def test_rglru_decode_is_the_plain_version_bit_for_bit(cuda, shape, offset):
    """Aligned rows take 16-byte words, an offset buffer one value at a
    time; each slot's row is the bits it gets alone."""
    n = shape[0] * shape[1]
    h, a, b = (t[offset:offset + n].view(shape) for t in _f32(cuda, n, (n + 1,), (n + 1,), (n + 1,)))
    out = decode_update.rglru_decode(h, a, b)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.torch_rglru_decode(h, a, b))
    solo = decode_update.rglru_decode(h[-1:].contiguous(), a[-1:].contiguous(), b[-1:].contiguous())
    assert torch.equal(solo[0], out[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 2048, 128), (3, 70, 16), (1, 5, 33), (2, 64, 300)])
def test_ssd_decode_matches_plain(cuda, shape):
    r, hp, n = shape
    state, decay, dtx, b, c = _f32(cuda, hp, shape, (r, hp), (r, hp), (r, n), (r, n))
    decay = torch.exp(-decay.abs())
    st, y = decode_update.ssd_decode(state, decay, dtx, b, c)
    torch.cuda.synchronize()
    wst, wy = ref.torch_ssd_decode(state, decay, dtx, b, c)
    assert torch.equal(st, wst)
    bound = 1e-5 * torch.einsum("rkn,rn->rk", wst.abs(), c.abs())
    assert bool(((y - wy).abs() <= bound).all())
    solo = decode_update.ssd_decode(*(t[-1:].contiguous() for t in (state, decay, dtx, b, c)))
    assert torch.equal(solo[0][0], st[-1]) and torch.equal(solo[1][0], y[-1])


@pytest.mark.cuda
def test_recurrent_kernels_reject_bad_arguments(cuda):
    a, b = _f32(cuda, 0, (2, 5, 8), (2, 5, 8))
    with pytest.raises(ValueError, match="float32"):
        rglru_scan.rglru_scan(a.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan.rglru_scan(a.transpose(1, 2), b.transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_update.rglru_decode(a[:, 0].cpu(), a[:, 0], b[:, 0])
    x, dt, aa, bm, cm = _ssd_chunk_inputs(0, 1, 1, 8, 2, 16, 8, cuda)
    with pytest.raises(ValueError, match="must be"):
        ssd_scan.ssd_chunk(x, dt[..., :1], aa, bm, cm)
    big = _ssd_chunk_inputs(0, 1, 1, 256, 1, 64, 160, cuda)   # 260 KB of shared memory
    with pytest.raises(RuntimeError, match="ssd_chunk launch failed"):
        ssd_scan.ssd_chunk(*big)


def _long_context_inputs(seed, chunk, dtype, device, positions=(2500, 3100), h=16, kv=1, d=256,
                         bs=16):
    """recurrentgemma-9b's local layers: MQA with 16 heads of 256 over
    contexts longer than the 2,048-token window, each slot's pages in a
    random order."""
    rng = np.random.default_rng(seed)
    c = 32 if chunk else 1
    need = [(p + c - 1) // bs + 1 for p in positions]
    num_pages = sum(need) + 3
    perm = rng.permutation(num_pages).astype(np.int32)
    tables = np.full((len(positions), max(need) + 2), num_pages, np.int32)
    start = 0
    for i, n_i in enumerate(need):
        tables[i, :n_i] = perm[start:start + n_i]
        start += n_i
    qshape = (len(positions), c, h, d) if chunk else (len(positions), h, d)
    q, kp, vp = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, dtype)
                 for s in (qshape, (num_pages + 1, bs, kv, d), (num_pages + 1, bs, kv, d)))
    return [q, kp, vp, torch.from_numpy(tables).to(device),
            torch.tensor(positions, dtype=torch.int32, device=device)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode,window", [("local", 2048), ("causal", 0)])
@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_paged_kernels_at_recurrentgemma_shape(cuda, chunk, mode, window, dtype):
    args = _long_context_inputs(7, chunk, dtype, cuda)
    op = ops.paged_chunk_attention if chunk else ops.paged_attention
    plain = ref.torch_paged_chunk_attention if chunk else ref.torch_paged_attention
    got = op(*args, mode=mode, window=window)
    torch.cuda.synchronize()
    want = plain(*args, mode=mode, window=window)
    assert got.dtype == dtype and got.shape == args[0].shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
