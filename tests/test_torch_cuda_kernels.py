"""The CUDA kernels against their plain PyTorch versions, on the card: paged
attention (decode and chunk), flash attention (forward and backward) and the
fused NoLoCo outer update.  Every test here needs a CUDA device and ``nvcc`` and skips
elsewhere; on a machine with the card run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py

The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed.  Tolerances: fp32 atol 1e-4 (the kernel and the plain
version sum in different orders); bf16 atol 2e-2, from rounding the output
to bf16 (values are O(1), one bf16 ulp there is 2**-7); bf16 gradients of
flash attention also get rtol 2e-2, since dK/dV sum over every query row and
grow with it while bf16 rounding is relative.  The outer update is exact:
both versions round the same fp32 operations once to the dtype.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch, flash_attention, noloco_update, ops, paged_attention, ref

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
    coef = dict(alpha=0.5, beta=0.7, gamma=0.9)
    dispatch.reset_launches()
    for name, op in dispatch.registry().items():
        op.kernel(*inputs[name](), **(coef if name == "noloco_update" else {}))
    torch.cuda.synchronize()
    assert dispatch.launch_counts() == {name: 1 for name in dispatch.registry()}
