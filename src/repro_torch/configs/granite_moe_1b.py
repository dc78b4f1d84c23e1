"""granite-moe-1b-a400m [moe]: 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,                # per-expert hidden dim
    moe_d_ff=512,
    num_experts=32,
    num_experts_per_token=8,
    vocab_size=49_155,
    mlp_variant="swiglu",
)
PLAN = "gossip_dp"
