"""The paper's own Llama-style models (Table 1): small 125M / medium 1.3B /
large 6.8B, vocab 128k, seq 1024, trained with AdamW inner + NoLoCo/DiLoCo
outer (OPT hyper-parameters)."""

from repro_torch.models.config import ModelConfig


def _paper(name, hidden, layers, inter, heads):
    return ModelConfig(
        name=name,
        arch_type="dense",
        num_layers=layers,
        d_model=hidden,
        num_heads=heads,
        num_kv_heads=heads,
        d_ff=inter,
        vocab_size=128_000,
        mlp_variant="gelu",       # OPT/llama-era baseline MLP
        norm_type="layernorm",
        tie_embeddings=True,
    )


SMALL = _paper("paper-small-125m", 768, 12, 3072, 16)
MEDIUM = _paper("paper-medium-1.3b", 2048, 24, 8192, 32)
LARGE = _paper("paper-large-6.8b", 4096, 32, 16384, 32)
CONFIG = SMALL
PLAN = "gossip_dp"
