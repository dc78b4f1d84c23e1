"""Unified architecture configuration covering all assigned architectures and
the paper's own Llama-style models.

One ``ModelConfig`` describes: dense decoders (llama/qwen/gemma/stablelm/
minitron), MoE decoders (granite/qwen3-moe), hybrid recurrent (recurrentgemma
RG-LRU + local attention), pure SSM (mamba2 SSD), encoder-decoder audio
(whisper) and VLM decoders with a stubbed vision frontend (internvl2).

The PyTorch port's copy of ``repro/models/config.py``: the same fields and
the same ``reduced()``, without the JAX tracing fields ``kernels`` and
``unroll_scans``.  Kernels are chosen by the device of the tensors, so the
config carries no implementation switch.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int | None = None  # default d_model // num_heads (gemma: 256)

    # -- block features -------------------------------------------------
    mlp_variant: str = "swiglu"  # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    qk_norm: bool = False        # qwen3-style per-head RMS norm on q,k
    rope_theta: float = 10_000.0
    use_rope: bool = True        # whisper uses sinusoidal absolute positions
    tie_embeddings: bool = True
    logit_softcap: float | None = None  # gemma-style tanh soft-capping
    embed_scale: bool = False           # multiply embeddings by sqrt(d_model) (gemma)

    # -- attention pattern ------------------------------------------------
    # cycled over layers; entries: "global" | "local" | "rglru" | "ssd"
    attn_pattern: tuple[str, ...] = ("global",)
    sliding_window: int | None = None  # window for "local" layers

    # -- MoE ---------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_d_ff: int | None = None          # per-expert hidden dim
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01        # load-balance loss coefficient

    # -- SSM (mamba2 SSD) ----------------------------------------------------
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv_width: int = 4

    # -- RG-LRU (recurrentgemma) ----------------------------------------------
    lru_width: int | None = None  # default d_model

    # -- encoder-decoder --------------------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 0  # whisper: 1500 mel frames after the (stubbed) conv

    # -- modality frontend (STUB per assignment carve-out) ----------------------
    frontend: str | None = None  # "audio" | "vision"
    frontend_dim: int = 0        # raw embedding dim produced by the stub
    frontend_tokens: int = 0     # patches / frames consumed by the decoder

    # -- numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True

    # ------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def layer_types(self) -> tuple[str, ...]:
        pat = self.attn_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def is_subquadratic(self) -> bool:
        """True iff no layer attends globally — required for long_500k."""
        return all(t != "global" for t in self.layer_types)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decoder (whisper is enc-dec)

    def validate(self) -> None:
        checks = [
            (self.num_heads % max(self.num_kv_heads, 1) == 0 or self.arch_type == "ssm",
             "num_heads must be a multiple of num_kv_heads"),
            ("local" not in self.attn_pattern or bool(self.sliding_window),
             "local attention needs sliding_window"),
            (self.arch_type != "moe"
             or (self.num_experts > 0 and self.num_experts_per_token > 0),
             "moe needs experts"),
            (self.arch_type != "ssm" or self.ssm_state_dim > 0, "ssm needs a state dim"),
            (not self.is_encoder_decoder
             or (self.num_encoder_layers > 0 and self.encoder_seq > 0),
             "encoder-decoder needs encoder layers and frames"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(f"{self.name}: {msg}")

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts, same family."""
        small: dict = dict(
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads > 1 else 1,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.head_dim else None,
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            num_encoder_layers=min(self.num_encoder_layers, 2)
            if self.num_encoder_layers
            else 0,
            frontend_dim=min(self.frontend_dim, 128) if self.frontend_dim else 0,
            frontend_tokens=min(self.frontend_tokens, 16) if self.frontend_tokens else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            ssm_state_dim=min(self.ssm_state_dim, 32) if self.ssm_state_dim else 0,
            ssm_chunk=16 if self.ssm_state_dim else self.ssm_chunk,
            lru_width=min(self.lru_width, 256) if self.lru_width else None,
        )
        if self.num_experts:
            small.update(
                num_experts=min(self.num_experts, 4),
                num_experts_per_token=min(self.num_experts_per_token, 2),
                moe_d_ff=min(self.moe_d_ff or self.d_ff, 128),
            )
        # keep the pattern representative at 2 layers: first + last type
        # (e.g. recurrentgemma ("rglru","rglru","local") -> ("rglru","local"))
        if len(self.attn_pattern) > 1:
            small["attn_pattern"] = (self.attn_pattern[0], self.attn_pattern[-1])
        small.update(overrides)
        return dataclasses.replace(self, **small)
