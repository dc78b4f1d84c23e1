"""Norms, positional encodings, MLPs, the embedding and the logits.

The port of ``repro/models/layers.py`` at tensor parallelism 1: parameters
are plain dicts of tensors with the JAX package's layouts (``w_in (d, f)``,
``w_out (f, d)``, ``table (V, d)``, ...), and the functions that took a
``ShardCtx`` there compute the unsharded case here.

The norms, the MLP, the embedding and the logits also take replica-stacked
parameters, every leaf with a leading replica axis R (``w_in (R, d, f)``,
``table (R, V, d)``) against activations ``(R, ...)``: the port's training
path runs all replicas of the stacked simulation in one batched forward,
where the JAX package vmaps over R.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import torch_dtype, truncated_normal

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg, dim: int, device: torch.device | str = "cpu") -> dict:
    p = {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def _over_replicas(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A stacked (R, n) vector viewed as (R, 1, ..., 1, n) against x
    (R, ..., n); an unstacked (n,) one as it is."""
    if w.dim() == 1:
        return w
    return w.reshape((w.shape[0],) + (1,) * (x.dim() - 2) + (w.shape[-1],))


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, or LayerNorm when ``p`` has a bias; fp32 inside."""
    x32 = x.float()
    scale = _over_replicas(p["scale"], x)
    if "bias" in p:
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, correction=0)
        y = (x32 - mean) * torch.rsqrt(var + eps) * scale + _over_replicas(p["bias"], x)
    else:
        ms = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + eps) * scale
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half RoPE.  x: (..., S, H, D); positions broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)                   # (D/2,)
    angles = positions.float()[..., :, None, None] * freqs             # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (S, D)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    half = torch.arange(dim // 2, dtype=torch.float32, device=device)
    inv = torch.exp(-math.log(10_000.0) * half / max(dim // 2 - 1, 1))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg, d_model: int | None = None, d_ff: int | None = None) -> dict:
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    p = {
        "w_in": truncated_normal(gen, (d, f), 1.0 / math.sqrt(d), dt),
        "w_out": truncated_normal(gen, (f, d), 1.0 / math.sqrt(f), dt),
    }
    if cfg.mlp_variant in ("swiglu", "geglu"):
        p["w_gate"] = truncated_normal(gen, (d, f), 1.0 / math.sqrt(d), dt)
    return p


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w, with a stacked w (R, d, f) applied to x (R, ..., d) replica by
    replica (one batched product)."""
    if w.dim() == 2:
        return x @ w
    return torch.einsum("r...d,rdf->r...f", x, w)


def apply_mlp(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    h = matmul(x, p["w_in"])
    if cfg.mlp_variant == "swiglu":
        h = F.silu(matmul(x, p["w_gate"])) * h
    elif cfg.mlp_variant == "geglu":
        h = F.gelu(matmul(x, p["w_gate"]), approximate="tanh") * h
    elif cfg.mlp_variant == "relu2":  # nemotron/minitron squared ReLU
        h = F.relu(h).square()
    else:
        h = F.gelu(h, approximate="tanh")
    return matmul(h, p["w_out"])


# ---------------------------------------------------------------------------
# Embedding and logits
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, cfg) -> dict:
    std = 1.0 / math.sqrt(cfg.d_model)
    dt = torch_dtype(cfg.dtype)
    p = {"table": truncated_normal(gen, (cfg.vocab_size, cfg.d_model), std, dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = truncated_normal(gen, (cfg.d_model, cfg.vocab_size), std, dt)
    return p


def embed_tokens(p: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table; with a stacked table (R, V, d), replica r's tokens
    (R, ...) read replica r's rows."""
    table = p["table"]
    if table.dim() == 2:
        return F.embedding(tokens.long(), table)
    r, v, d = table.shape
    offsets = (torch.arange(r, device=tokens.device) * v).reshape((r,) + (1,) * (tokens.dim() - 1))
    return F.embedding(tokens.long() + offsets, table.reshape(r * v, d))


def logits_sharded(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Logits over the whole vocabulary (tp = 1), cast to fp32 after the
    product."""
    if cfg.tie_embeddings:
        table = p["table"]
        logits = x @ table.T if table.dim() == 2 else torch.einsum("r...d,rvd->r...v", x, table)
    else:
        logits = matmul(x, p["unembed"])
    logits = logits.float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """NLL of each label; stable log-softmax with a detached max, as the JAX
    package computes it."""
    m = logits.amax(dim=-1, keepdim=True).detach()
    denom = torch.exp(logits - m).sum(dim=-1)
    hit = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.log(denom) + m[..., 0] - hit


def cross_entropy_parts(
    logits: torch.Tensor, labels: torch.Tensor, cfg, mask: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of token NLL, token count)."""
    nll = token_nll(logits, labels)
    if mask is None:
        return nll.sum(), torch.tensor(float(nll.numel()), device=nll.device)
    w = mask.float()
    return (nll * w).sum(), w.sum()


def cross_entropy_sharded(
    logits: torch.Tensor, labels: torch.Tensor, cfg, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean token NLL."""
    s, n = cross_entropy_parts(logits, labels, cfg, mask)
    return s / torch.clamp_min(n, 1.0)
