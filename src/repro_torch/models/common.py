"""Parameter helpers shared by the port's models."""

from __future__ import annotations

import math

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

# Φ(-2) and Φ(2): the uniform range that maps onto a normal truncated at 2σ
_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; options: {sorted(_DTYPES)}") from None


def truncated_normal(
    gen: torch.Generator, shape: tuple[int, ...], std: float, dtype: torch.dtype
) -> torch.Tensor:
    """Normal truncated at ±2σ, times ``std``, drawn on ``gen``'s device by
    the inverse CDF (fan-in scaled init, like the JAX package's).  The draws
    differ from JAX's for the same seed; tests convert JAX's weights."""
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (_LO + (_HI - _LO) * u) - 1.0)
    return (x.clamp_(-2.0, 2.0) * std).to(dtype)
