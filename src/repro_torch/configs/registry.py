"""Architecture registry of the port: ``--arch <id>`` resolution.

It holds every decoder-only family of the JAX package's registry: the dense
qwen3-0.6b, gemma-2b, stablelm-1.6b and minitron-8b, the paper's
Llama-style models, the MoE granite-moe-1b-a400m and qwen3-moe-235b-a22b,
and the recurrent mamba2-370m (SSD) and recurrentgemma-9b (RG-LRU with
local attention).  The encoder-decoder and vision-frontend architectures
need model code the port does not have yet and raise
``NotImplementedError`` naming the ROADMAP item that brings them.  The
reference's ``variant_for_shape`` takes its input shapes, which come with
ROADMAP Queue 1 item 13b.
"""

from __future__ import annotations

from repro_torch.configs import (
    gemma_2b,
    granite_moe_1b,
    mamba2_370m,
    minitron_8b,
    paper_llama,
    qwen3_0_6b,
    qwen3_moe_235b,
    recurrentgemma_9b,
    stablelm_1_6b,
)
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config"]

ARCHS: dict[str, ModelConfig] = {
    "qwen3-0.6b": qwen3_0_6b.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
    "gemma-2b": gemma_2b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b.CONFIG,
    "stablelm-1.6b": stablelm_1_6b.CONFIG,
    "minitron-8b": minitron_8b.CONFIG,
    "mamba2-370m": mamba2_370m.CONFIG,
    "paper-small-125m": paper_llama.SMALL,
    "paper-medium-1.3b": paper_llama.MEDIUM,
    "paper-large-6.8b": paper_llama.LARGE,
}

_LATER = {
    "whisper-base": "encoder-decoder",
    "internvl2-76b": "vision-frontend",
}


def get_config(arch: str) -> ModelConfig:
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in _LATER:
        raise NotImplementedError(
            f"{arch} ({_LATER[arch]}) is not ported yet: ROADMAP Queue 1 item 8d "
            "(encoder-decoder and vision models, with dense-cache attention) brings it"
        )
    raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
