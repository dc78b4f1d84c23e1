"""Registry of the port's kernels: for each op, its hand-written kernel, its
plain PyTorch version, where the kernel's source lives and which TPU kernel
of the JAX package it replaces.

Dispatch itself is by device (see :mod:`repro_torch.kernels.ops`), so there
is no implementation switch here.  The registry is what ``chip_smoke.py``
and the tests walk to build, check, time and count every kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

from repro_torch.kernels import flash_attention as flash_attention_mod
from repro_torch.kernels import noloco_update as noloco_update_mod
from repro_torch.kernels import paged_attention as paged_attention_mod
from repro_torch.kernels import ref

__all__ = ["KernelOp", "registry", "reset_launches", "launch_counts"]


@dataclasses.dataclass(frozen=True)
class KernelOp:
    """One ported op.  ``kernel`` carries a ``launches`` integer."""

    name: str
    kernel: Callable[..., Any]
    plain: Callable[..., Any]
    route: str       # "cuda" | "triton"
    source: str      # the kernel's source, relative to the repo root
    replaces: str    # file:line of the Pallas TPU kernel it replaces


_REGISTRY: dict[str, KernelOp] = {
    op.name: op
    for op in (
        KernelOp(
            name="paged_attention",
            kernel=paged_attention_mod.paged_decode_attention,
            plain=ref.torch_paged_attention,
            route="cuda",
            source="src/repro_torch/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:110",
        ),
        KernelOp(
            name="paged_chunk_attention",
            kernel=paged_attention_mod.paged_chunk_attention,
            plain=ref.torch_paged_chunk_attention,
            route="cuda",
            source="src/repro_torch/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:226",
        ),
        KernelOp(
            name="flash_attention",
            kernel=flash_attention_mod.flash_attention_fwd,
            plain=ref.torch_flash_attention_fwd,
            route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:96",
        ),
        KernelOp(
            name="flash_attention_bwd",
            kernel=flash_attention_mod.flash_attention_bwd,
            plain=ref.torch_flash_attention_bwd,
            route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/ops.py:74",
        ),
        KernelOp(
            name="noloco_update",
            kernel=noloco_update_mod.noloco_update,
            plain=ref.torch_noloco_update,
            route="cuda",
            source="src/repro_torch/csrc/noloco_update.cu",
            replaces="src/repro/kernels/noloco_update.py:47",
        ),
    )
}


def registry() -> Mapping[str, KernelOp]:
    return dict(_REGISTRY)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for op in _REGISTRY.values():
        op.kernel.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: op.kernel.launches for name, op in _REGISTRY.items()}
