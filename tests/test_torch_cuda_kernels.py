"""The CUDA kernels against their plain PyTorch versions, on the card: paged
attention (decode and chunk; also across split boundaries, contexts up to
2048, a slot alone bit for bit as batched), flash attention (forward and backward), the
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
int8 pair are exact: both versions round the same fp32 operations once,
and so is the torch threefry on the card against its numpy twin.
So are the RG-LRU scan, its backward, the RG-LRU decode step and the SSD
decode state (the same fp32 products and sums in the same order); the SSD
decode output sums its N products in another order (within 1e-5 of
Σ|state′·c|), and the SSD chunk kernel agrees with its plain version within
atol and rtol 1e-4 (fp32 sums of up to Q·N products in another order).  The
SSD chunk backward is held normwise: each gradient within 1e-4 of its
largest magnitude (its sums over heads and through a reverse cumsum of
cancelling row and column sums run in other orders).
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


# The split kernels at serving sizes: pages of 16, each slot's pages in its
# own random order, tables wide enough for 2,048-key contexts plus a chunk.
KS = 64  # kKeysPerSplit in csrc/paged_attention.cu (paged_attention.split_plan reports it)
LONG_BS, LONG_MB, LONG_C = 16, 132, 32


def _long_inputs(seed, positions, h, kv, d, chunk, dtype, device):
    gen = torch.Generator().manual_seed(seed)
    r = len(positions)
    pages = r * LONG_MB
    tables = torch.randperm(pages, generator=gen)[:pages].reshape(r, LONG_MB).to(torch.int32)
    qshape = (r, LONG_C, h, d) if chunk else (r, h, d)
    q = torch.randn(qshape, generator=gen)
    kp = torch.randn((pages + 1, LONG_BS, kv, d), generator=gen)
    vp = torch.randn((pages + 1, LONG_BS, kv, d), generator=gen)
    return ([t.to(device, dtype) for t in (q, kp, vp)]
            + [tables.to(device), torch.tensor(positions, dtype=torch.int32, device=device)])


# contexts of 1, one key below, at and above a split boundary, the serve
# mix's 231, and 2047 / 2048 keys (a full window of 2048 and one past it)
LONG_POSITIONS = [0, KS - 2, KS - 1, KS, 230, 2046, 2047]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("h,kv,d", [(16, 8, 128), (16, 1, 256)], ids=["qwen3", "recurrentgemma"])
@pytest.mark.parametrize("mode,window", [("causal", 0), ("local", 2048), ("local", 100)])
@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_split_kernels_match_plain_across_split_boundaries(cuda, chunk, mode, window, h, kv, d, dtype):
    """Split boundaries, contexts 1 to 2048, windows of 2048 and of 100 whose
    first key falls inside a split (position 230: key 131, split 2)."""
    positions = [p - (LONG_C - 1 if chunk and p >= LONG_C else 0) for p in LONG_POSITIONS]
    args = _long_inputs(h + d + len(positions), positions, h, kv, d, chunk, dtype, cuda)
    assert paged_attention.split_plan(0, 1, LONG_MB, LONG_BS, mode, window)[0] == KS
    op = ops.paged_chunk_attention if chunk else ops.paged_attention
    plain = ref.torch_paged_chunk_attention if chunk else ref.torch_paged_attention
    got = op(*args, mode=mode, window=window)
    torch.cuda.synchronize()
    want = plain(*args, mode=mode, window=window)
    assert got.dtype == dtype and got.shape == args[0].shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 20], ids=["R·KV 16", "R·KV 160"])
@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_split_kernels_below_and_above_one_block_per_sm(cuda, chunk, r):
    """R·KV below and above the card's 132 SMs, with several splits each."""
    positions = [(97 * i) % 1900 + 40 for i in range(r)]
    args = _long_inputs(r, positions, 16, 8, 128, chunk, torch.bfloat16, cuda)
    op = ops.paged_chunk_attention if chunk else ops.paged_attention
    plain = ref.torch_paged_chunk_attention if chunk else ref.torch_paged_attention
    got = op(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), plain(*args).float(), atol=TOL[torch.bfloat16], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("h,kv,d,mode,window", [(16, 8, 128, "causal", 0), (16, 1, 256, "local", 100)],
                         ids=["qwen3", "recurrentgemma"])
@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_slot_alone_is_bit_identical_to_batched(cuda, chunk, h, kv, d, mode, window, dtype):
    """A slot's splits depend on its own position only: R = 1 and R = 4
    give the same bits for it."""
    args = _long_inputs(5, [230, 70, 1500, 3], h, kv, d, chunk, dtype, cuda)
    op = ops.paged_chunk_attention if chunk else ops.paged_attention
    batched = op(*args, mode=mode, window=window)
    q, kp, vp, tables, pos = args
    for s in range(4):
        alone = op(q[s:s + 1].contiguous(), kp, vp, tables[s:s + 1].contiguous(),
                   pos[s:s + 1].contiguous(), mode=mode, window=window)
        assert torch.equal(alone[0], batched[s]), f"slot {s}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d,offset", [(30, 0), (36, 0), (128, 1)],
                         ids=["D30", "D36", "D128-q-off-by-one"])
@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_split_kernels_copy_rows_that_are_not_16_byte_aligned(cuda, chunk, d, offset, dtype):
    """Rows whose start is not 16-byte aligned (a head dim no multiple of 16
    bytes, or q one element into its buffer) are copied without cp.async."""
    args = _long_inputs(d, [230, 64, 0], 4, 2, d, chunk, dtype, cuda)
    if offset:
        buf = torch.empty(args[0].numel() + offset, dtype=dtype, device=cuda)
        buf[offset:] = args[0].flatten()
        args[0] = buf[offset:].view(args[0].shape)
    op = ops.paged_chunk_attention if chunk else ops.paged_attention
    plain = ref.torch_paged_chunk_attention if chunk else ref.torch_paged_attention
    got = op(*args, mode="local", window=100)
    torch.cuda.synchronize()
    want = plain(*args, mode="local", window=100)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
def test_random_bits_torch_on_the_card_equal_numpy(cuda):
    from repro_torch.core import pairing

    keys = np.stack([pairing.fold_in(pairing.fold_in(pairing.prng_key(17), rid), i)
                     for rid in range(3) for i in range(3)])
    got = pairing.random_bits_torch(torch.from_numpy(keys.astype(np.int64)), 151_936, cuda)
    assert got.device.type == "cuda"
    want = np.stack([pairing.random_bits(k, 151_936) for k in keys])
    np.testing.assert_array_equal(got.cpu().numpy().astype(np.uint32), want)


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


# Cross-attention's regime: full mode with Sq != Sk (448 decoder queries over
# 1,500 encoder keys, Sk no multiple of any tile), single queries, and GQA
# 64/8 at D 128 (internvl2-76b's heads); (B, Sq, Sk, H, KV, D)
FLASH_CROSS_CASES = [(2, 1, 37, 8, 8, 64), (2, 5, 1500, 8, 8, 64), (2, 448, 1500, 8, 8, 64),
                     (1, 100, 1500, 64, 8, 128), (1, 70, 37, 6, 4, 48), (1, 5, 1500, 8, 8, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CROSS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernels_full_mode_with_sq_ne_sk_match_plain(cuda, case, dtype):
    b, sq, sk, h, kv, d = case
    rng = np.random.default_rng(sq + sk + d)
    q, do = (torch.from_numpy(rng.normal(size=(b, sq, h, d)).astype(np.float32)).to(cuda, dtype)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, sk, kv, d)).astype(np.float32)).to(cuda, dtype)
            for _ in range(2))
    o, lse = flash_attention.flash_attention_fwd(q, k, v, mode="full")
    grads = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, mode="full")
    torch.cuda.synchronize()
    o_want, lse_want = ref.torch_flash_attention_fwd(q, k, v, mode="full")
    assert o.shape == q.shape and lse.shape == (b, h, sq)
    torch.testing.assert_close(o.float(), o_want.float(), atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(lse, lse_want, atol=1e-4, rtol=1e-5)
    want = ref.torch_flash_attention_bwd(q, k, v, o, lse, do, mode="full")
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
    inputs["ssd_chunk_bwd"] = lambda: _ssd_bwd_inputs(0, 1, 2, 8, 2, 16, 8, cuda)
    inputs["rglru_scan"] = lambda: _f32(cuda, 0, (2, 9, 40), (2, 9, 40))
    inputs["rglru_scan_bwd"] = lambda: _f32(cuda, 0, (2, 9, 40), (2, 9, 40), (2, 9, 40))
    inputs["rglru_decode"] = lambda: _f32(cuda, 0, (2, 40), (2, 40), (2, 40))
    inputs["ssd_decode"] = lambda: _f32(cuda, 0, (2, 12, 8), (2, 12), (2, 12), (2, 8), (2, 8))
    coef = dict(alpha=0.5, beta=0.7, gamma=0.9)
    dispatch.reset_launches()
    for name, op in dispatch.registry().items():
        op.kernel(*inputs[name](), **(coef if name == "noloco_update" else {}))
    torch.cuda.synchronize()
    assert dispatch.launch_counts() == {name: 1 for name in dispatch.registry()}


def _payload(rows, n, chunk, dtype, device, seed=0, exponents=(-30, 4)):
    """Rows whose chunks have magnitudes 10**e, e uniform in ``exponents``
    (default 1e-30 to 1e4), and offsets of their own size, the first chunk
    constant (scale 1)."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(*exponents, size=(rows, n // chunk + 1)).repeat(chunk, axis=1)[:, :n]
    x = (rng.normal(size=(rows, n)) + rng.normal(size=(rows, n // chunk + 1)).repeat(
        chunk, axis=1)[:, :n]) * mag
    x[:, :min(chunk, n)] = 3.25
    return torch.from_numpy(x.astype(np.float32)).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,n,chunk", [(1, 8 * 1024, 1024), (4, 5 * 1024 + 17, 1024),
                                          (3, 1000, 7), (2, 9001, 3000), (1, 5, 1024),
                                          (4, 8 * 1024, 1024), (3, 8 * 1024 + 3, 1024),
                                          (2, 1000, 1024), (2, 6144, 2048), (3, 4100, 256)])
def test_int8_pair_matches_plain_bit_for_bit(cuda, dtype, rows, n, chunk):
    """Whole and ragged rows (the tail chunk edge-padded), constant chunks,
    whole aligned chunks (the 16-byte kernel), rows that start misaligned
    (n % 8 != 0), n < chunk, chunks held in registers (<= 1024), read twice
    (2048, 3000), CHUNK 256 and a small odd chunk; the dequantize reads the
    codes through the wire's row stride."""
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


def _near_ties(rows, nb, chunk, seed):
    """fp32 chunks from 0 to hi = 10**e (e uniform in [-25, 20]) whose other
    values put (x − lo)/safe within 2 ulp of a half-integer."""
    rng = np.random.default_rng(seed)
    hi = (10.0 ** rng.uniform(-25, 20, size=(rows, nb, 1))).astype(np.float32)
    safe = hi * np.float32(ref.INV255)
    x = ((rng.integers(0, 255, size=(rows, nb, chunk)) + 0.5) * safe).astype(np.float32)
    for _ in range(2):   # move each value up to 2 ulp either way
        step = rng.integers(-1, 2, size=x.shape)
        x = np.where(step > 0, np.nextafter(x, np.float32(np.inf)), x)
        x = np.where(step < 0, np.nextafter(x, np.float32(0)), x)
    x = np.minimum(x, hi)
    x[..., 0], x[..., 1] = 0.0, hi[..., 0]
    return x.reshape(rows, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["denormal", "denormal-edge", "near-ties"])
@pytest.mark.parametrize("chunk", [1024, 3000])
def test_int8_quantize_division_cases_match_plain(cuda, dtype, kind, chunk):
    """Chunks of denormal range (the scale itself denormal: each value takes
    the true division), chunks across the normal/denormal edge, and
    quotients within 2 ulp of a half-integer, where a quotient that is not
    correctly rounded would give another code; on both kernels."""
    if kind == "near-ties":
        x = torch.from_numpy(_near_ties(3, 16, chunk, seed=chunk)).to(cuda, dtype)
    else:
        exponents = (-44, -38) if kind == "denormal" else (-39, -30)
        x = _payload(3, 16 * chunk, chunk, dtype, cuda, seed=chunk, exponents=exponents)
    q, scale, lo = quantize.int8_quantize(x, chunk)
    torch.cuda.synchronize()
    for got, w in zip((q, scale, lo), ref.torch_int8_quantize(x, chunk)):
        assert torch.equal(got, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_int8_nan_in_a_whole_aligned_chunk_poisons_it(cuda, dtype):
    x = _payload(2, 4096, 1024, dtype, cuda, seed=4)
    x[1, 2000] = float("nan")
    assert quantize.library_wide_chunks(x, 1024) == 8   # all four chunks of each row
    q, scale, lo = quantize.int8_quantize(x, 1024)
    want = ref.torch_int8_quantize(x, 1024)
    for got, w in ((scale, want[1]), (lo, want[2])):
        torch.testing.assert_close(got, w, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(lo[1, 1]) and (q[1, 1] == 0).all()
    assert torch.equal(q[0], want[0][0]) and torch.equal(q[1, [0, 2, 3]], want[0][1, [0, 2, 3]])


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


# (B, NC, Q, H, P, N).  The kernel walks Q in 64-row tiles and splits P into
# slabs of 64, 32 or 16 columns by the grid's size: Q 1, 50, 100 and 200
# (ragged last tiles), H 3 and 5, P 33 / N 17 and P 130 (4-byte copies, a
# ragged slab), and the training shape cut to B 2, NC 2 (64-column slabs).
SSD_CASES = [(1, 1, 32, 32, 64, 128), (2, 3, 16, 4, 64, 32), (1, 2, 64, 3, 32, 128),
             (1, 1, 128, 2, 64, 128), (2, 2, 7, 5, 33, 17), (2, 2, 1, 3, 16, 8),
             (1, 2, 50, 5, 64, 128), (1, 1, 100, 3, 64, 128), (1, 1, 200, 2, 32, 64),
             (1, 2, 128, 5, 33, 17), (1, 1, 40, 2, 130, 64), (2, 2, 128, 32, 64, 128)]


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
def test_ssd_chunk_slice_alone_is_bit_identical_to_batched(cuda):
    """A (b, c) slice run alone (8 heads: 16-column slabs) equals the same
    slice of the batched call (128 heads: 64-column slabs), bit for bit."""
    x, dt, a, bm, cm = _ssd_chunk_inputs(5, 4, 4, 64, 8, 64, 128, cuda, pad=9)
    y, st = ssd_scan.ssd_chunk(x, dt, a, bm, cm)
    for b, c in ((0, 0), (3, 3), (1, 2)):
        ys, sts = ssd_scan.ssd_chunk(*(t[b:b + 1, c:c + 1].contiguous() for t in (x, dt)), a,
                                     *(t[b:b + 1, c:c + 1].contiguous() for t in (bm, cm)))
        torch.cuda.synchronize()
        assert torch.equal(ys[0, 0], y[b, c]) and torch.equal(sts[0, 0], st[b, c]), (b, c)


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
@pytest.mark.parametrize("w", [4095, 4096, 4097])
@pytest.mark.parametrize("s", [1, 8, 24, 32, 33, 1024])
def test_rglru_scan_paths_are_the_plain_version_bit_for_bit(cuda, s, w):
    """S up to 32 loaded whole (S = 32 unpredicated), 33 and 1,024 on the
    ring of step groups; widths around 4,096; B 2."""
    a, b = _f32(cuda, s + w, (2, s, w), (2, s, w))
    a = torch.sigmoid(a) * 0.5 + 0.45
    h = rglru_scan.rglru_scan(a, b)
    torch.cuda.synchronize()
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
@pytest.mark.parametrize("shape,offset", [((4, 2048, 128), 0), ((3, 70, 16), 0), ((1, 5, 33), 0),
                                          ((2, 64, 300), 0), ((4, 2048, 128), 1), ((3, 70, 16), 1)])
def test_ssd_decode_matches_plain(cuda, shape, offset):
    """Aligned rows with N % 4 == 0 take 16-byte words; N 33, N 300 and a
    state offset by one element into its buffer go one value at a time.
    Every slot alone (R 1) gets the bits it gets among the R."""
    r, hp, n = shape
    buf, decay, dtx, b, c = _f32(cuda, hp, (r * hp * n + 1,), (r, hp), (r, hp), (r, n), (r, n))
    state = buf[offset:offset + r * hp * n].view(shape)
    decay = torch.exp(-decay.abs())
    st, y = decode_update.ssd_decode(state, decay, dtx, b, c)
    torch.cuda.synchronize()
    wst, wy = ref.torch_ssd_decode(state, decay, dtx, b, c)
    assert torch.equal(st, wst)
    bound = 1e-5 * torch.einsum("rkn,rn->rk", wst.abs(), c.abs())
    assert bool(((y - wy).abs() <= bound).all())
    for i in range(r):
        solo = decode_update.ssd_decode(*(t[i:i + 1].contiguous() for t in (state, decay, dtx, b, c)))
        assert torch.equal(solo[0][0], st[i]) and torch.equal(solo[1][0], y[i]), i


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
    # Q is walked in 64-row tiles, so Q 256 with N 160 runs; N 1024 (two
    # 64 × 1028 tiles, 526 KB) exceeds a block's shared memory.
    big = _ssd_chunk_inputs(0, 1, 1, 256, 1, 64, 160, cuda)
    y, st = ssd_scan.ssd_chunk(*big)
    torch.cuda.synchronize()
    wy, wst = ref.torch_ssd_chunk_intra(*big)
    torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, wst, atol=1e-4, rtol=1e-4)
    wide = _ssd_chunk_inputs(0, 1, 1, 16, 1, 64, 1024, cuda)
    with pytest.raises(RuntimeError, match="ssd_chunk launch failed"):
        ssd_scan.ssd_chunk(*wide)


def _ssd_bwd_inputs(seed, b, nc, q, h, p, n, device, pad=0, a_rows=True):
    """_ssd_chunk_inputs with a per row (B, H) unless ``a_rows`` is False,
    plus the gradients dy and dstates; a ragged tail has x, B, C, dt and dy
    zero on its ``pad`` rows, as ops.ssd_chunk pads a sequence."""
    x, dt, a, bm, cm = _ssd_chunk_inputs(seed, b, nc, q, h, p, n, device, pad=pad)
    rng = np.random.default_rng(seed + 1)
    if a_rows:
        a = torch.from_numpy(-np.exp(rng.uniform(0.0, np.log(16.0), size=(b, h))).astype(np.float32)).to(device)
    dy, dst = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
               for s in ((b, nc, q, h, p), (b, nc, h, n, p)))
    if pad:
        for t in (x, bm, cm, dy):
            t[:, -1, q - pad:] = 0.0
    return [x, dt, a, bm, cm, dy, dst]


def _normwise(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30)).item()


# (B, NC, Q, H, P, N, pad, a per row): the training shape cut to B 2, a
# ragged tail, mamba2-370m.reduced's, a (H,), Q 100 / 50 / 1 with odd P and N;
# then the backward's 64-row tiles and 64-deep steps crossed: Q 256 (four
# row tiles, ten tile pairs, N and P in two steps each), Q 200 (a ragged
# last tile) with P 20 and N 36 (one partial step each, 16-byte copies),
# H 1 with Q 130 (a 2-row last tile), P 30 and N 66 (4-byte copies, N's
# second step 2 columns wide; a per row, four of them, since one head's da
# under a (H,) is a single cancelling sum), and H 3 split into head groups
# of one
SSD_BWD_CASES = [(2, 2, 128, 32, 64, 128, 0, True), (2, 3, 128, 8, 64, 128, 37, True),
                 (8, 4, 16, 8, 64, 32, 0, True), (2, 2, 64, 4, 64, 128, 0, False),
                 (1, 2, 100, 3, 33, 17, 13, True), (2, 1, 50, 5, 64, 128, 0, False),
                 (2, 2, 1, 3, 16, 8, 0, True), (1, 1, 40, 2, 130, 64, 0, True),
                 (1, 2, 256, 4, 128, 128, 0, True), (1, 1, 200, 2, 20, 36, 0, True),
                 (4, 2, 130, 1, 30, 66, 5, True), (1, 1, 64, 3, 64, 64, 0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_chunk_bwd_matches_plain(cuda, case):
    *shape, pad, a_rows = case
    args = _ssd_bwd_inputs(sum(shape), *shape, cuda, pad=pad, a_rows=a_rows)
    before = ssd_scan.ssd_chunk_bwd.launches
    got = ssd_scan.ssd_chunk_bwd(*args)
    again = ssd_scan.ssd_chunk_bwd(*args)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_chunk_bwd.launches == before + 2
    want = ref.torch_ssd_chunk_intra_bwd(*args)
    for g, w, arg, a2 in zip(got, want, args, again):
        assert g.shape == arg.shape and g.dtype == torch.float32
        assert torch.equal(g, a2)   # deterministic: no atomics
        assert _normwise(g, w) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1024, 4096), (3, 37, 130), (1, 1, 4097), (2, 33, 4095),
                                   (2, 17, 40), (1, 64, 33), (2, 1001, 256)])
def test_rglru_scan_bwd_is_the_plain_version_bit_for_bit(cuda, shape):
    a, b, g = _f32(cuda, shape[1], shape, shape, shape)
    a = torch.sigmoid(a) * 0.5 + 0.45
    h = rglru_scan.rglru_scan(a, b)
    before = rglru_scan.rglru_scan_bwd.launches
    da, db = rglru_scan.rglru_scan_bwd(a, h, g)
    da2, db2 = rglru_scan.rglru_scan_bwd(a, h, g)
    torch.cuda.synchronize()
    assert rglru_scan.rglru_scan_bwd.launches == before + 2
    wda, wdb = ref.torch_rglru_scan_bwd(a, b, g)
    assert torch.equal(da, wda) and torch.equal(db, wdb)
    assert torch.equal(da, da2) and torch.equal(db, db2)


@pytest.mark.cuda
def test_ssd_chunk_per_row_rates_are_each_rows_own(cuda):
    """a (B, H) in the forward kernel: row b alone with a[b] (H,) gets the
    bits it gets in the batch."""
    x, dt, a, bm, cm, _, _ = _ssd_bwd_inputs(4, 3, 2, 64, 4, 64, 128, cuda)
    y, st = ssd_scan.ssd_chunk(x, dt, a, bm, cm)
    for b in range(3):
        ys, sts = ssd_scan.ssd_chunk(*(t[b:b + 1].contiguous() for t in (x, dt)), a[b].contiguous(),
                                     *(t[b:b + 1].contiguous() for t in (bm, cm)))
        torch.cuda.synchronize()
        assert torch.equal(ys[0], y[b]) and torch.equal(sts[0], st[b]), b
    wy, wst = ref.torch_ssd_chunk_intra(x, dt, a, bm, cm)
    torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, wst, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ssd_chunk", "rglru_scan"])
def test_scan_autograd_launches_both_kernels(cuda, name):
    """ops.ssd_chunk / ops.rglru_scan under autograd on the card: the
    forward and the backward kernel each launch once (launch counters and
    the profiler's kernel names), and the gradients match the plain
    version's autograd on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    if name == "ssd_chunk":
        x, dt, a, bm, cm, _, _ = _ssd_bwd_inputs(6, 2, 1, 40, 4, 32, 16, cuda)
        inputs = [t.reshape(2, 40, *t.shape[3:]) if t.dim() > 2 else t for t in (x, dt, a, bm, cm)]
        call = lambda *t: ops.ssd_chunk(*t, chunk=16)[0]
        fwd, bwd = ssd_scan.ssd_chunk, ssd_scan.ssd_chunk_bwd
        names = {"ssd_chunk_kernel": 1, "ssd_bwd_cums_kernel": 1, "ssd_bwd_pairs_mma_kernel": 1,
                 "ssd_bwd_keys_mma_kernel": 1, "ssd_bwd_bc_mma_kernel": 1, "ssd_bwd_dt_kernel": 1}
    else:
        a, b = _f32(cuda, 7, (2, 50, 40), (2, 50, 40))
        inputs = [torch.sigmoid(a) * 0.5 + 0.45, b]
        call = ops.rglru_scan
        fwd, bwd = rglru_scan.rglru_scan, rglru_scan.rglru_scan_bwd
        names = {"rglru_scan_kernel": 1, "rglru_scan_bwd_ring_kernel": 1}
    card = [t.detach().clone().requires_grad_() for t in inputs]
    cpu = [t.detach().cpu().requires_grad_() for t in inputs]
    before = fwd.launches, bwd.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a first kernel of no interest: after earlier profiled tests in the
        # same process, the trace can lose the first kernel of a window
        torch.zeros(1, device=cuda).add_(1.0)
        torch.cuda.synchronize()
        out = call(*card)
        out.backward(torch.ones_like(out))
        torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    ran = {}
    for e in prof.events():
        for n in names:
            if n + "<" in e.name or n + "(" in e.name:
                ran[n] = ran.get(n, 0) + 1
    assert ran == names, [e.name[:60] for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA]
    want = call(*cpu)
    want.backward(torch.ones_like(want))
    for t, w in zip(card, cpu):
        torch.testing.assert_close(t.grad.cpu(), w.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_scan_backward_kernels_reject_bad_arguments(cuda):
    a, h, g = _f32(cuda, 0, (2, 5, 8), (2, 5, 8), (2, 5, 8))
    with pytest.raises(ValueError, match="float32"):
        rglru_scan.rglru_scan_bwd(a.bfloat16(), h, g)
    with pytest.raises(ValueError, match="equal"):
        rglru_scan.rglru_scan_bwd(a, h, g[:, :4].contiguous())
    with pytest.raises(ValueError, match="CUDA tensor"):
        rglru_scan.rglru_scan_bwd(a, h, g.cpu())
    args = _ssd_bwd_inputs(0, 1, 1, 8, 2, 16, 8, cuda)
    with pytest.raises(ValueError, match="dstates"):
        ssd_scan.ssd_chunk_bwd(*args[:6], args[6][..., :4].contiguous())
    with pytest.raises(ValueError, match="must be"):
        ssd_scan.ssd_chunk_bwd(args[0], args[1], args[2][:, :1].contiguous(), *args[3:])
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.ssd_chunk_bwd(*args[:5], args[5].transpose(3, 4), args[6])
    # N is walked in 64-column steps, so N 1024 runs; B·NC above 65,535
    # exceeds the grids' second dimension
    wide = _ssd_bwd_inputs(0, 1, 1, 16, 1, 64, 1024, cuda)
    got = ssd_scan.ssd_chunk_bwd(*wide)
    torch.cuda.synchronize()
    for g, w in zip(got, ref.torch_ssd_chunk_intra_bwd(*wide)):
        assert _normwise(g, w) <= 1e-4
    many = _ssd_bwd_inputs(0, 1, 65536, 1, 1, 1, 1, cuda)
    with pytest.raises(RuntimeError, match="ssd_chunk_bwd launch failed"):
        ssd_scan.ssd_chunk_bwd(*many)


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
