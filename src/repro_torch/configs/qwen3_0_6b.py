"""qwen3-0.6b [dense]: qk_norm, GQA. [hf:Qwen/Qwen3-8B]
28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,            # qwen3 signature: head_dim 128 > d_model/heads
    d_ff=3072,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_variant="swiglu",
)
PLAN = "gossip_dp"
