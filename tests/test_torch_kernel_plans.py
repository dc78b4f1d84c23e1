"""The launch plans of the CUDA int8 quantize and RG-LRU scan.

Each kernel's source picks its path in its host code, the one home of the
rule: ``int8_quantize_wide_chunks`` in ``csrc/quantize.cu`` counts the
chunks the 16-byte kernel takes, ``rglru_scan_steps`` in
``csrc/rglru_scan.cu`` says whether a sequence is loaded whole or goes
through the ring of step groups.  Here each rule is restated plainly
(:func:`plain_wide_chunks`, :func:`plain_scan_path`) and checked on the CPU
at the main path's shapes; on the card, the built library's own choice
(``quantize.library_wide_chunks``, ``rglru_scan.library_path``) is held
against the plain rule.  The file imports neither JAX nor the JAX package,
so its ``cuda`` tests run where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.kernels import quantize, rglru_scan
from repro_torch.serve.engine import ServeConfig

WIDE_MAX_CHUNK = 1024   # the 16-byte kernel holds a chunk in registers
WHOLE_STEPS = 32        # kWholeSteps: sequences this short are loaded whole


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
