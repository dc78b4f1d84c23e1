"""stablelm-1.6b [dense]: full MHA. [hf:stabilityai/stablelm-2-1_6b]
24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100_352,
    norm_type="layernorm",
    mlp_variant="swiglu",
    tie_embeddings=False,
)
PLAN = "gossip_dp"
