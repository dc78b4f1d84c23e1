"""The split plan of the CUDA paged-attention kernels.

The kernels split each slot's visible keys into runs of KS = 64 keys at
absolute positions (``kKeysPerSplit`` in ``csrc/paged_attention.cu``, the
one home of the rule) and merge the runs' f32 partial softmaxes.  Here the
rule is restated plainly (:func:`plain_splits`, :func:`plain_split_axis`)
and checked on the CPU: a slot's splits are a function of its own position
only, never of the batch, and the grid and the wrapper's workspace
(``paged_attention.workspace_shapes``) hold every split any slot can have.
On the card, the library's own plan (``paged_attention.split_plan``) is
held against the plain rule.  A plain torch emulation of split-and-merge,
with the kernel's arithmetic (a -1e30 mask, m = -1e30 and l = 0 for a split
a row cannot see, the merge in split order), equals the plain version
within 1e-6 in fp32 at any split size: the two sum the same terms in
another grouping.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

NEG = -1e30
KS = 64  # kKeysPerSplit


def plain_splits(position, c, mb, bs, mode, window, ks=KS):
    """The splits of one slot, as the kernel runs them: the runs
    [s·KS, (s+1)·KS) ∩ [lo, hi) of the keys its c rows see together, in
    order (split i of the slot is grid index i).  Only the slot's own
    position enters."""
    lo = max(0, position - window + 1) if mode == "local" else 0
    hi = min(position + c, mb * bs)
    return [(max(s * ks, lo), min((s + 1) * ks, hi)) for s in range(lo // ks, -(-hi // ks))] if hi > lo else []


def plain_split_axis(c, mb, bs, mode, window, ks=KS):
    """The grid's split axis: the most splits any slot of a table MB pages
    of BS wide can have (a local slot's keys span window + c − 1 positions)."""
    n = -(-(mb * bs) // ks)
    if mode == "local":
        n = min(n, -(-(window + c - 1) // ks) + 1)
    return max(n, 1)


def test_slot_splits_cover_the_visible_keys_at_absolute_boundaries():
    ks = 64
    for pos in (0, 1, 62, 63, 64, 65, 127, 128, 230, 2046, 2047):
        for c, mode, window in ((1, "causal", 0), (32, "causal", 0), (1, "local", 2048),
                                (32, "local", 2048), (5, "local", 100)):
            splits = plain_splits(pos, c, 256, 16, mode, window, ks)
            lo = max(0, pos - window + 1) if mode == "local" else 0
            hi = min(pos + c, 256 * 16)
            assert splits[0][0] == lo and splits[-1][1] == hi
            for (a, b), (a2, _) in zip(splits, splits[1:]):
                assert b == a2 and b % ks == 0          # consecutive, cut at multiples of KS
            assert all(b - a <= ks and a // ks == (b - 1) // ks for a, b in splits)
            assert len(splits) <= plain_split_axis(c, 256, 16, mode, window, ks)


def test_local_window_starting_inside_a_split():
    # position 2100, window 2048: the first visible key is 53, inside split 0
    splits = plain_splits(2100, 1, 256, 16, "local", 2048, 64)
    assert splits[0] == (53, 64) and splits[-1] == (2048, 2101)
    assert len(splits) == 33 == plain_split_axis(1, 256, 16, "local", 2048, 64)


@pytest.mark.parametrize("ks", [64, 128, 1024])
@pytest.mark.parametrize("mode,window,c", [("causal", 0, 1), ("causal", 0, 32),
                                           ("local", 2048, 1), ("local", 64, 32)])
def test_grid_holds_every_slot_and_ignores_the_batch(ks, mode, window, c):
    mb, bs = 128, 16
    grid = plain_split_axis(c, mb, bs, mode, window, ks)
    positions = np.random.default_rng(ks + c).integers(0, mb * bs - c + 1, size=64)
    for pos in positions.tolist() + [0, mb * bs - c]:
        assert 1 <= len(plain_splits(pos, c, mb, bs, mode, window, ks)) <= grid
    # the plan of one slot is its plan in any batch: R enters only the
    # workspace's leading axis, never the split axis or the rows
    (ml1, acc1), (ml4, acc4) = (pa.workspace_shapes(r, c, 16, 8, 128, grid) for r in (1, 4))
    assert ml1[1:] == ml4[1:] and acc1[1:] == acc4[1:]
    assert (ml4[0], acc4[0]) == (4 * 8, 4 * 8) and ml1[0] == 8
    assert ml4 == (32, grid, c * 2, 2) and acc4 == (32, grid, c * 2, 128)


def test_workspace_rows_cover_ragged_heads():
    # H 6 / KV 4: kv heads serve 2, 1, 2 and 1 query heads; rows c·ceil(H/KV)
    assert pa.workspace_shapes(3, 5, 6, 4, 48, 7) == ((12, 7, 10, 2), (12, 7, 10, 48))


@pytest.mark.parametrize("chunk", [False, True], ids=["decode", "chunk"])
def test_launch_rejects_cpu_tensors_before_it_builds(chunk):
    q = torch.zeros((1, 3, 2, 8) if chunk else (1, 2, 8))
    kp = torch.zeros(3, 4, 1, 8)
    args = (q, kp, kp, torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        pa._launch(chunk, *args, "causal", 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,window,c", [("causal", 0, 1), ("causal", 0, 32), ("local", 2048, 1),
                                           ("local", 2048, 32), ("local", 100, 1), ("local", 64, 32)])
def test_library_split_plan_equals_the_plain_rule(cuda, mode, window, c):
    for mb, bs in ((128, 16), (132, 16), (6, 16)):
        for pos in sorted({0, 1, KS - 2, KS - 1, KS, 230, 2046, 2047, 2100, mb * bs - c}):
            if not 0 <= pos <= mb * bs - c:
                continue
            ks, axis, n = pa.split_plan(pos, c, mb, bs, mode, window)
            assert (ks, axis, n) == (KS, plain_split_axis(c, mb, bs, mode, window),
                                     len(plain_splits(pos, c, mb, bs, mode, window))), (mb, bs, pos)


# ---------------------------------------------------------------------------
# split-and-merge in plain torch against the plain version
# ---------------------------------------------------------------------------


def emulate(q, k_pages, v_pages, tables, positions, mode, window, ks):
    """The kernels' split-and-merge in plain fp32 torch; q (R, C, H, D)."""
    r, c, h, d = q.shape
    _, bs, kvh, _ = k_pages.shape
    mb = tables.shape[1]
    out = torch.empty(r, c, h, d)
    for s in range(r):
        k = k_pages[tables[s].long()].reshape(mb * bs, kvh, d)
        v = v_pages[tables[s].long()].reshape(mb * bs, kvh, d)
        pos = int(positions[s])
        qpos = pos + torch.arange(c)[:, None]                         # (C, 1)
        parts = []
        for lo, hi in plain_splits(pos, c, mb, bs, mode, window, ks):
            t = torch.arange(lo, hi)[None]
            valid = t <= qpos
            if mode == "local":
                valid &= t > qpos - window
            for hh in range(h):
                kh = hh * kvh // h
                sc = (q[s, :, hh].float() * (1.0 / math.sqrt(d))) @ k[lo:hi, kh].float().T
                sc = torch.where(valid, sc, torch.full_like(sc, NEG))
                m = sc.amax(dim=1)
                p = torch.exp(sc - m[:, None])
                l = torch.where(m == NEG, torch.zeros_like(m), p.sum(dim=1))
                parts.append((hh, m, l, p @ v[lo:hi, kh].float()))
        for hh in range(h):
            mine = [(m, l, acc) for j, m, l, acc in parts if j == hh]
            if not mine:
                out[s, :, hh] = 0
                continue
            ms = torch.stack([m for m, _, _ in mine])                 # (splits, C)
            ls = torch.stack([l for _, l, _ in mine])
            seen = ls > 0
            mx = torch.where(seen, ms, torch.full_like(ms, NEG)).amax(dim=0)
            w = torch.where(seen, torch.exp(ms - mx), torch.zeros_like(ms))
            acc = sum(acc * w[i][:, None] for i, (_, _, acc) in enumerate(mine))
            out[s, :, hh] = acc / torch.clamp_min((ls * w).sum(dim=0), 1e-30)[:, None]
    return out


def _inputs(seed, r, c, h, kvh, d, bs, mb, positions):
    rng = np.random.default_rng(seed)
    n_pages = r * mb
    tables = rng.permutation(n_pages + 1)[: r * mb].reshape(r, mb).astype(np.int32)
    q = rng.normal(size=(r, c, h, d)).astype(np.float32)
    kp = rng.normal(size=(n_pages + 1, bs, kvh, d)).astype(np.float32)
    vp = rng.normal(size=(n_pages + 1, bs, kvh, d)).astype(np.float32)
    return [torch.from_numpy(a) for a in (q, kp, vp, tables, np.asarray(positions, np.int32))]


@pytest.mark.parametrize("ks", [1, 5, 16, 64, 1024])
@pytest.mark.parametrize("mode,window", [("causal", 0), ("local", 7), ("local", 40)])
@pytest.mark.parametrize("c,h,kvh", [(1, 4, 2), (1, 16, 1), (5, 6, 4), (8, 4, 4)])
def test_split_and_merge_equals_the_plain_version(ks, mode, window, c, h, kvh):
    bs, mb = 4, 12
    positions = [0, 1, 15, 16, 47 - c + 1][: 5]
    q, kp, vp, tables, pos = _inputs(ks + 7 * c + h, len(positions), c, h, kvh, 16, bs, mb, positions)
    got = emulate(q, kp, vp, tables, pos, mode, window, ks)
    if c == 1:
        want = ref.torch_paged_attention(q[:, 0], kp, vp, tables, pos, mode=mode, window=window)[:, None]
    else:
        want = ref.torch_paged_chunk_attention(q, kp, vp, tables, pos, mode=mode, window=window)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_split_and_merge_of_a_slot_is_the_same_alone_and_batched():
    bs, mb, ks = 4, 12, 8
    q, kp, vp, tables, pos = _inputs(3, 4, 3, 4, 2, 16, bs, mb, [9, 30, 2, 44])
    batched = emulate(q, kp, vp, tables, pos, "local", 11, ks)
    for s in range(4):
        alone = emulate(q[s:s + 1], kp, vp, tables[s:s + 1], pos[s:s + 1], "local", 11, ks)
        assert torch.equal(alone[0], batched[s])
