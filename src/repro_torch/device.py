"""Where the port's entry points run: on the card unless asked for the CPU."""

from __future__ import annotations

import torch


def resolve_device(name: torch.device | str) -> torch.device:
    """``name`` as a torch device.  A CUDA device must exist: with no GPU
    this raises rather than running on the CPU unasked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name}: no CUDA device is available; pass --device cpu "
            "(device='cpu') to run on the CPU with the plain versions"
        )
    return device
