"""Architecture registry of the port: ``--arch <id>`` resolution.

It holds every architecture of the JAX package's registry: the dense
qwen3-0.6b, gemma-2b, stablelm-1.6b and minitron-8b, the paper's
Llama-style models, the MoE granite-moe-1b-a400m and qwen3-moe-235b-a22b,
the recurrent mamba2-370m (SSD) and recurrentgemma-9b (RG-LRU with local
attention), the encoder-decoder whisper-base and internvl2-76b, a decoder
with a vision prefix.  Both frontends are stubs, as in the reference:
batches carry the precomputed frame or patch embeddings.  The reference's
``variant_for_shape`` takes its input shapes, which come with ROADMAP
Queue 1 item 13b.
"""

from __future__ import annotations

from repro_torch.configs import (
    gemma_2b,
    granite_moe_1b,
    internvl2_76b,
    mamba2_370m,
    minitron_8b,
    paper_llama,
    qwen3_0_6b,
    qwen3_moe_235b,
    recurrentgemma_9b,
    stablelm_1_6b,
    whisper_base,
)
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config"]

ARCHS: dict[str, ModelConfig] = {
    "whisper-base": whisper_base.CONFIG,
    "qwen3-0.6b": qwen3_0_6b.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
    "gemma-2b": gemma_2b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b.CONFIG,
    "stablelm-1.6b": stablelm_1_6b.CONFIG,
    "minitron-8b": minitron_8b.CONFIG,
    "internvl2-76b": internvl2_76b.CONFIG,
    "mamba2-370m": mamba2_370m.CONFIG,
    "paper-small-125m": paper_llama.SMALL,
    "paper-medium-1.3b": paper_llama.MEDIUM,
    "paper-large-6.8b": paper_llama.LARGE,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]
