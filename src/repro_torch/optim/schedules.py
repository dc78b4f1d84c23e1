"""Learning-rate schedules (paper §4: linear warm-up, then cosine decay to
10% of peak over the remaining steps).

The port's ``repro/optim/schedules.py``: a schedule maps a step tensor to an
fp32 learning-rate tensor of the same shape, computed on the step's device
in fp32 as the JAX package computes it.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["Schedule", "warmup_cosine"]

Schedule = Callable[[torch.Tensor], torch.Tensor]


def warmup_cosine(
    peak: float,
    total_steps: int,
    warmup_steps: int = 1000,
    final_ratio: float = 0.1,
) -> Schedule:
    """Linear warm-up to ``peak`` over ``warmup_steps``; cosine decay to
    ``final_ratio * peak`` at ``total_steps``."""

    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        progress = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
        )
        floor = final_ratio * peak
        cos = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * progress))
        return torch.where(step < warmup_steps, warm, cos)

    return fn
