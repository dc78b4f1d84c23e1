"""Architecture registry of the port: ``--arch <id>`` resolution.

It holds the families the port serves so far: qwen3-0.6b, the paper's
Llama-style models, and the recurrent mamba2-370m (SSD) and
recurrentgemma-9b (RG-LRU with local attention).  The other architectures of the JAX package's
registry need model code the port does not have yet and raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

from repro_torch.configs import mamba2_370m, paper_llama, qwen3_0_6b, recurrentgemma_9b
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config"]

ARCHS: dict[str, ModelConfig] = {
    "qwen3-0.6b": qwen3_0_6b.CONFIG,
    "paper-small-125m": paper_llama.SMALL,
    "paper-medium-1.3b": paper_llama.MEDIUM,
    "paper-large-6.8b": paper_llama.LARGE,
    "mamba2-370m": mamba2_370m.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
}

_LATER = {
    "whisper-base": "encoder-decoder",
    "granite-moe-1b-a400m": "MoE",
    "gemma-2b": "dense with local attention and soft-capped logits",
    "qwen3-moe-235b-a22b": "MoE",
    "stablelm-1.6b": "dense",
    "minitron-8b": "dense",
    "internvl2-76b": "vision-frontend",
}


def get_config(arch: str) -> ModelConfig:
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in _LATER:
        raise NotImplementedError(
            f"{arch} ({_LATER[arch]}) is not ported yet: ROADMAP Queue 1 item 8 "
            "(other model families) brings it"
        )
    raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
