"""whisper-base [audio]: enc-dec transformer backbone, conv/mel frontend STUB.
[arXiv:2212.04356] 6L d_model=512 8H (GQA kv=8) d_ff=2048 vocab=51865."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="encdec",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    mlp_variant="gelu",
    norm_type="layernorm",
    use_rope=False,          # whisper: absolute sinusoidal positions
    is_encoder_decoder=True,
    num_encoder_layers=6,
    encoder_seq=1500,        # 30 s of mel frames after the (stubbed) conv stack
    frontend="audio",
    frontend_dim=512,        # stub provides post-conv frame embeddings
    frontend_tokens=1500,
)
PLAN = "gossip_dp"
