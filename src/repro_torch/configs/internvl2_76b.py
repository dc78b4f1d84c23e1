"""internvl2-76b [vlm]: InternViT (STUB) + InternLM2/llama3-style decoder.
[arXiv:2404.16821] 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    mlp_variant="swiglu",
    frontend="vision",
    frontend_dim=3200,       # InternViT-6B hidden size (stub patch embeds)
    frontend_tokens=256,
    tie_embeddings=False,
)
PLAN = "fsdp_hybrid"
