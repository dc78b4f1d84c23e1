"""The launch plans of the CUDA int8 quantize, RG-LRU scan and the two scan
backwards.

Each kernel's source picks its path in its host code, the one home of the
rule: ``int8_quantize_wide_chunks`` in ``csrc/quantize.cu`` counts the
chunks the 16-byte kernel takes, ``rglru_scan_steps`` in
``csrc/rglru_scan.cu`` says whether a sequence is loaded whole or goes
through the ring of step groups, ``ssd_chunk_bwd_plan`` in
``csrc/ssd_scan.cu`` gives the SSD backward's tiles, head groups and grids,
and ``rglru_scan_bwd_ring`` the RG-LRU backward's ring.  Here each rule is
restated plainly (:func:`plain_wide_chunks`, :func:`plain_scan_path`,
:func:`plain_ssd_bwd_plan`, ``RING``) and checked on the CPU at the main
path's shapes; on the card, the built library's own choice
(``quantize.library_wide_chunks``, ``rglru_scan.library_path``,
``ssd_scan.library_bwd_plan``, ``rglru_scan.library_bwd_ring``) is held
against the plain rule.  The file imports neither JAX nor the JAX package,
so its ``cuda`` tests run where only PyTorch is installed.
"""
import math

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import quantize, rglru_scan, ssd_scan
from repro_torch.serve.engine import ServeConfig

WIDE_MAX_CHUNK = 1024   # the 16-byte kernel holds a chunk in registers
WHOLE_STEPS = 32        # kWholeSteps: sequences this short are loaded whole
BWD_TILE = 64           # kBT: rows of an SSD backward tile, and the depth of a step
BWD_MIN_BLOCKS = 264    # kBwdMinBlocks: two blocks per SM of the H100's 132
RING = {"channels": 32, "box_steps": 16, "depth": 6}   # the RG-LRU backward's ring
SMS = 132               # the H100's streaming multiprocessors
HBM_BYTES_PER_S = 3.35e12


def plain_wide_chunks(esize, rows, n, chunk, data_ptr=0):
    """How many of the rows·⌈n/chunk⌉ chunks of an (rows, n) tensor of
    ``esize``-byte values at address ``data_ptr`` take the 16-byte kernel:
    whole chunks (not a row's ragged last one) of rows that start 16-byte
    aligned, when ``chunk`` is a multiple of 32 16-byte words (256 bf16 or
    128 fp32 values) and at most WIDE_MAX_CHUNK."""
    if chunk % (32 * (16 // esize)) or chunk > WIDE_MAX_CHUNK:
        return 0
    return (n // chunk) * sum((data_ptr + r * n * esize) % 16 == 0 for r in range(rows))


def plain_scan_path(s):
    """The scan's launch for a sequence of ``s`` steps: "whole" (every
    step's loads issued before the first step) up to WHOLE_STEPS, else
    "ring"."""
    return "whole" if s <= WHOLE_STEPS else "ring"


def plain_ssd_bwd_plan(b, nc, q, h, p, n, a_rows):
    """The SSD backward's rule: row tiles of BWD_TILE, tile pairs i >= j,
    N in slabs of BWD_TILE; the pairs kernel's heads in groups, their count
    doubled from 1 (stopping at H) until its grid reaches BWD_MIN_BLOCKS,
    then as many groups of ⌈H / groups⌉ heads as H needs.  The six grids:
    cums ⌈H/4⌉ per chunk, pairs per (tile pair, group), keys per (row tile,
    head), bc per (row tile, N slab), dt per (head, chunk), and da one
    thread per entry of da in blocks of 128."""
    nt = -(-q // BWD_TILE)
    pairs = nt * (nt + 1) // 2
    groups = 1
    while groups < h and pairs * b * nc * groups < BWD_MIN_BLOCKS:
        groups *= 2
    per_group = -(-h // groups)
    groups = -(-h // per_group)
    bnc = b * nc
    return {"tile": BWD_TILE, "head_groups": groups, "heads_per_group": per_group,
            "blocks": {"cums": -(-h // 4) * bnc, "pairs": pairs * groups * bnc, "keys": nt * h * bnc,
                       "bc": nt * -(-n // BWD_TILE) * bnc, "dt": h * bnc,
                       "da": -(-h * (b if a_rows else 1) // 128)}}


def mamba2_shape(rows, seq, cfg=None):
    """(B, NC, Q, H, P, N) of mamba2-370m's SSD chunks for ``rows`` folded
    sequences of ``seq`` tokens."""
    cfg = cfg or registry.get_config("mamba2-370m")
    q = min(cfg.ssm_chunk, seq)
    return (rows, seq // q, q, cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim,
            cfg.ssm_state_dim)


def test_ssd_bwd_plan_at_the_training_shape():
    """mamba2-370m's training step (4 replicas × batch 4 × 1,024 tokens,
    folded into 16 rows of 8 chunks of 128): one head group, and every grid
    at least two blocks per SM but da's (512 sums of 8 chunks)."""
    shape = mamba2_shape(16, 1024)
    assert shape == (16, 8, 128, 32, 64, 128)
    plan = plain_ssd_bwd_plan(*shape, a_rows=True)
    assert plan["head_groups"] == 1 and plan["heads_per_group"] == 32
    assert plan["blocks"] == {"cums": 1024, "pairs": 384, "keys": 8192, "bc": 512, "dt": 4096,
                              "da": 4}
    assert min(v for k, v in plan["blocks"].items() if k != "da") >= 2 * SMS


def test_ssd_bwd_plan_at_the_reduced_shape():
    """mamba2-370m.reduced in the card-vs-CPU run (4 replicas × batch 2 × 64
    tokens, chunks of 16): one tile pair per chunk, so the heads split into
    groups of one to give the pairs kernel 256 blocks."""
    cfg = registry.get_config("mamba2-370m").reduced(dtype="float32", remat=False)
    shape = mamba2_shape(8, 64, cfg)
    plan = plain_ssd_bwd_plan(*shape, a_rows=True)
    assert plan["head_groups"] * plan["heads_per_group"] >= shape[3]
    assert plan["blocks"]["pairs"] == shape[0] * shape[1] * plan["head_groups"]
    assert plan["heads_per_group"] == 1 and plan["head_groups"] == shape[3]


@pytest.mark.parametrize("h", [1, 2, 3, 5, 7, 8, 32, 33])
@pytest.mark.parametrize("bnc,q", [(1, 1), (1, 64), (2, 130), (32, 16), (128, 128), (300, 128)])
def test_ssd_bwd_head_groups_cover_every_head_once(h, bnc, q):
    plan = plain_ssd_bwd_plan(bnc, 1, q, h, 64, 128, True)
    g, per = plan["head_groups"], plan["heads_per_group"]
    assert (g - 1) * per < h <= g * per   # no empty group, every head in one


def test_rglru_bwd_ring_keeps_the_card_busy():
    """recurrentgemma-9b's training shape (2 rows of 1,024 steps, width
    4,096): a one-warp block per 32 channels gives 256 blocks, and the boxes
    in flight (depth − 1 of 3 arrays × 16 steps × 32 channels) hold more
    than the ~3.35 MB the card's memory moves in a microsecond, about its
    latency under load."""
    b, s, w = 2, 1024, 4096
    blocks = -(-w // RING["channels"]) * b
    in_flight = blocks * (RING["depth"] - 1) * 3 * RING["box_steps"] * RING["channels"] * 4
    assert blocks == 256 and in_flight > HBM_BYTES_PER_S * 1e-6
    assert RING["depth"] * 3 * RING["box_steps"] * RING["channels"] * 4 <= 48 * 1024   # static smem


def test_wide_chunks_of_the_main_path_payload():
    """Every chunk of the full-width payload (4 replicas of 366,477,312 bf16
    values in chunks of 1,024) and of the fp32 norm buffer (76,800 values)
    takes the 16-byte path."""
    assert plain_wide_chunks(2, 4, 366_477_312, 1024, 256) == 4 * 357_888
    assert plain_wide_chunks(4, 4, 76_800, 1024, 512) == 4 * 75


@pytest.mark.parametrize("esize", [4, 2], ids=["fp32", "bf16"])
def test_wide_chunks_rule(esize):
    # a ragged last chunk stays on the scalar path
    assert plain_wide_chunks(esize, 3, 4 * 1024 + 8, 1024) == 3 * 4
    # n < chunk: no whole chunk
    assert plain_wide_chunks(esize, 5, 1000, 1024) == 0
    # CHUNK not a multiple of 32 16-byte words, or above 1,024 values
    for chunk in (7, 3000, 2048, 16 * esize):
        assert plain_wide_chunks(esize, 2, 3 * chunk, chunk) == 0
    # the smallest CHUNK that is: 32 words
    assert plain_wide_chunks(esize, 2, 3 * 512 // esize, 512 // esize) == 6
    # a tensor that starts off a 16-byte boundary
    assert plain_wide_chunks(esize, 4, 8192, 1024, data_ptr=esize) == 0
    # rows of n values with n·esize not a multiple of 16: rows start aligned
    # every 16 / gcd(n·esize, 16) rows
    n = 8 * 1024 + 1
    assert plain_wide_chunks(esize, 16, n, 1024) == 8 * (16 * esize // 16)


def test_rglru_scan_path_for():
    """The serving engine pads every prefill chunk to its width, so every
    served scan has S = prefill_chunk: the whole path, with no step
    predicated off.  Training's 1,024 steps take the ring."""
    assert ServeConfig().prefill_chunk == WHOLE_STEPS
    assert all(plain_scan_path(s) == "whole" for s in range(1, WHOLE_STEPS + 1))
    for s in (WHOLE_STEPS + 1, 64, 1024):
        assert plain_scan_path(s) == "ring"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,n,chunk,offset", [(4, 8192, 1024, 0), (4, 8192, 1024, 1),
                                                 (5, 8195, 1024, 0), (3, 4100, 256, 0),
                                                 (2, 9001, 3000, 0), (2, 1000, 1024, 0)])
def test_int8_quantize_wide_chunks_is_the_library_rule(cuda, dtype, rows, n, chunk, offset):
    """The library puts on its 16-byte kernel the chunks the plain rule
    counts, for tensors that start ``offset`` elements into their buffer."""
    x = torch.zeros(rows * n + offset, dtype=dtype, device=cuda)[offset:].view(rows, n)
    assert quantize.library_wide_chunks(x, chunk) == plain_wide_chunks(
        x.element_size(), rows, n, chunk, x.data_ptr())


@pytest.mark.cuda
def test_rglru_scan_path_for_is_the_library_rule(cuda):
    for s in range(1, 70):
        assert rglru_scan.library_path(s) == plain_scan_path(s), s


@pytest.mark.cuda
@pytest.mark.parametrize("shape,a_rows", [((16, 8, 128, 32, 64, 128), True),
                                          ((8, 4, 16, 8, 64, 32), True),
                                          ((1, 2, 256, 4, 128, 128), True),
                                          ((1, 1, 64, 3, 64, 64), False),
                                          ((2, 1, 130, 1, 30, 66), False)])
def test_ssd_bwd_plan_is_the_library_rule(cuda, shape, a_rows):
    assert ssd_scan.library_bwd_plan(*shape, a_rows) == plain_ssd_bwd_plan(*shape, a_rows)


@pytest.mark.cuda
def test_rglru_bwd_ring_is_the_library_ring(cuda):
    assert rglru_scan.library_bwd_ring() == RING
