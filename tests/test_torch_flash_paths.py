"""Which flash kernels serve a call, on the CPU: the rule
``flash_attention.path_for`` states (bf16 with D % 8 == 0 on the tensor
cores, fp32 and bf16 with other head dims on the CUDA cores), and what the
wrappers check before they reach the library.  A CPU tensor that reports a
CUDA device stands in for one; the library is replaced by a stub that
raises, so nothing is built or launched.  The kernels themselves are held
against their plain versions on the card (``tests/test_torch_cuda_kernels.py``).
"""
import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import flash_attention

# bf16 head dims that run on the tensor cores: whole 16-byte rows.
TENSOR_CORE_DIMS = {8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128, 136, 144,
                    152, 160, 168, 176, 184, 192, 200, 208, 216, 224, 232, 240, 248, 256}


class _FakeCuda(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda", 0)


class _Launched(Exception):
    pass


def _launched():
    raise _Launched


def _qkv(d, dtype, offset=0):
    """(q, k, v) of shape (2, 5, 4 | 2, d); ``offset`` elements into their
    storage, which leaves them contiguous but moves their first byte."""
    g = torch.Generator().manual_seed(d)
    shapes = [(2, 5, 4, d), (2, 5, 2, d), (2, 5, 2, d)]
    out = []
    for shape in shapes:
        n = torch.Size(shape).numel()
        flat = torch.randn(n + offset, generator=g).to(dtype)[offset:]
        out.append(flat.view(shape).as_subclass(_FakeCuda))
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_path_for_every_head_dim(dtype):
    on_tc = {d for d in range(1, flash_attention.MAX_HEAD_DIM + 1)
             if flash_attention.path_for(dtype, d) == "tensor_core"}
    assert on_tc == (TENSOR_CORE_DIMS if dtype == torch.bfloat16 else set())
    assert {flash_attention.path_for(dtype, d) for d in range(1, 257)} <= {"tensor_core", "cuda_core"}


def test_every_attention_config_runs_on_the_tensor_cores_in_bf16():
    """The head dims of the repo's attention models (48, 64, 128, 256) all
    take the tensor-core kernels when they train or prefill in bf16."""
    dims = {cfg.resolved_head_dim for cfg in ARCHS.values()
            if {"global", "local"} & set(cfg.layer_types)}
    assert dims == {48, 64, 128, 256}
    for d in dims:
        assert flash_attention.path_for(torch.bfloat16, d) == "tensor_core", d


@pytest.mark.parametrize("d", [16, 48, 128, 256, 36, 1])
def test_bf16_calls_reach_the_library(monkeypatch, d):
    monkeypatch.setattr(flash_attention, "library", _launched)
    q, k, v = _qkv(d, torch.bfloat16)
    with pytest.raises(_Launched):
        flash_attention.flash_attention_fwd(q, k, v)


def test_tensor_core_path_needs_16_byte_rows(monkeypatch):
    """Tensor-core copies move 16 bytes at a time: a bf16 tensor whose first
    byte is 2 bytes off raises before any launch; on the CUDA-core path
    (D 36) the same offset is fine."""
    monkeypatch.setattr(flash_attention, "library", _launched)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention.flash_attention_fwd(*_qkv(48, torch.bfloat16, offset=1))
    with pytest.raises(_Launched):
        flash_attention.flash_attention_fwd(*_qkv(36, torch.bfloat16, offset=1))


@pytest.mark.parametrize("d", [48, 36])
def test_bwd_checks_before_it_reaches_the_library(monkeypatch, d):
    """The backward wrapper holds o, dO and lse to q's shape and lse to fp32
    before any launch, on either path; well-formed arguments reach the
    library."""
    monkeypatch.setattr(flash_attention, "library", _launched)
    q, k, v = _qkv(d, torch.bfloat16)
    lse = torch.zeros(2, 4, 5).as_subclass(_FakeCuda)
    o, do = torch.zeros_like(q).as_subclass(_FakeCuda), torch.zeros_like(q).as_subclass(_FakeCuda)
    with pytest.raises(_Launched):
        flash_attention.flash_attention_bwd(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_attention.flash_attention_bwd(q, k, v, o, lse.to(torch.bfloat16), do)
    with pytest.raises(ValueError, match="o and do must be"):
        flash_attention.flash_attention_bwd(q, k, v, o[:, :4].contiguous(), lse, do)
