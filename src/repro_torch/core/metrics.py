"""Ensemble diagnostics over replica-stacked parameter trees (the port of
``repro/core/metrics.py``)."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_leaves

PyTree = Any

__all__ = ["replica_weight_std"]


def replica_weight_std(tree: PyTree) -> torch.Tensor:
    """Mean over parameters of the std across replicas (leading axis 0) —
    the quantity of the paper's Fig. 3B / Fig. 4A; fp32 scalar."""
    stds = [x.float().std(dim=0, correction=0).mean() for x in tree_leaves(tree)]
    if not stds:
        raise ValueError("replica_weight_std: no tensor leaves found")
    return torch.stack(stds).mean()
