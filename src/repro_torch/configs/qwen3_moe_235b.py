"""qwen3-moe-235b-a22b [moe]: 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]
94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936, MoE 128e top-8."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    num_layers=94,           # 94 = 1-layer period scanned 94x
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,               # per-expert hidden dim
    moe_d_ff=1536,
    num_experts=128,
    num_experts_per_token=8,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_variant="swiglu",
)
PLAN = "fsdp_hybrid"
