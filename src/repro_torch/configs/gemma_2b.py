"""gemma-2b [dense]: GeGLU, head_dim=256, MQA. [arXiv:2403.08295]
18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000.

The base config attends globally.  The reference runs the long_500k shape
through a sliding-window variant (window 4096, its
``registry.variant_for_shape``); the port's shapes come with ROADMAP Queue 1
item 13b."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    arch_type="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=256_000,
    mlp_variant="geglu",
    embed_scale=True,
)
PLAN = "gossip_dp"
