"""The CUDA paged-attention kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA device and ``nvcc`` and skips
elsewhere; on a machine with the card run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py

The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed.  Tolerances: fp32 atol 1e-4 (the kernel and the plain
version sum in different orders); bf16 atol 2e-2, from rounding the output
to bf16 (values are O(1), one bf16 ulp there is 2**-7).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch, ops, paged_attention, ref

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


@pytest.mark.cuda
def test_registry_kernels_launch(cuda):
    dispatch.reset_launches()
    for name, op in dispatch.registry().items():
        chunk = name == "paged_chunk_attention"
        op.kernel(*_inputs(2, 4, 2, 64, chunk, torch.bfloat16, cuda))
    torch.cuda.synchronize()
    assert dispatch.launch_counts() == {name: 1 for name in dispatch.registry()}
