"""Ensemble diagnostics over replica-stacked parameter trees (the port of
``repro/core/metrics.py``)."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_leaves

PyTree = Any

__all__ = ["replica_weight_std"]

_SLICE = 1 << 26   # columns per pass over a leaf of more than 2^30 elements


def _mean_std(x: torch.Tensor) -> torch.Tensor:
    """Mean over a leaf's elements of their std across replicas.  A leaf of
    more than 2^30 elements (recurrentgemma-9b's stacked embedding) goes in
    slices of columns, so its fp32 copy is never whole; each element's std
    is the same, only the mean sums in another order."""
    if x.numel() <= 1 << 30:
        return x.float().std(dim=0, correction=0).mean()
    flat = x.flatten(1)
    sums = [flat[:, i:i + _SLICE].float().std(dim=0, correction=0).sum()
            for i in range(0, flat.shape[1], _SLICE)]
    return torch.stack(sums).sum() / flat.shape[1]


def replica_weight_std(tree: PyTree) -> torch.Tensor:
    """Mean over parameters of the std across replicas (leading axis 0) —
    the quantity of the paper's Fig. 3B / Fig. 4A; fp32 scalar."""
    stds = [_mean_std(x) for x in tree_leaves(tree)]
    if not stds:
        raise ValueError("replica_weight_std: no tensor leaves found")
    return torch.stack(stds).mean()
