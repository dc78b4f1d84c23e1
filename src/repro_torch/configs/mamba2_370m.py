"""mamba2-370m [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060] 48L d_model=1024 d_ff=0 vocab=50280, ssm_state=128."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=1,             # attention-free; SSD heads derive from d_inner
    num_kv_heads=1,
    d_ff=0,                  # no MLP: block = norm + SSD mixer
    vocab_size=50_280,
    attn_pattern=("ssd",),
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    use_rope=False,
)
PLAN = "gossip_dp"
