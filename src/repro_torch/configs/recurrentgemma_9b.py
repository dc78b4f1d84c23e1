"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 2:1 pattern.
[arXiv:2402.19427] 38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,           # 12 full (rglru, rglru, local) periods + 2 remainder
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,          # MQA on the local-attention layers
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    mlp_variant="geglu",
    attn_pattern=("rglru", "rglru", "local"),
    sliding_window=2048,
    lru_width=4096,
    embed_scale=True,
)
PLAN = "gossip_dp"
