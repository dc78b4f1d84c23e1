"""AdamW (the paper's inner optimizer) over replica-stacked parameter trees.

The port of ``repro/optim/adamw.py``: decoupled weight decay with bias
correction, fp32 moments whatever the parameter dtype, the update computed
in fp32 and cast back to each parameter's dtype.  Every leaf carries a
leading replica axis R; the JAX package vmaps ``adamw_update`` over that
axis, so clipping by the global norm is per replica and the step counter is
an (R,) tensor.  The functions are pure (new tensors out), like the JAX
package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "global_norm", "clip_by_global_norm",
    "adamw_update",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # Paper §4: "gradient clipping for gradients larger than unity".
    clip_norm: float | None = 1.0

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step).float()
        return torch.full(step.shape, self.lr, dtype=torch.float32, device=step.device)


@dataclasses.dataclass
class AdamWState:
    mu: PyTree            # first moment (fp32), leading replica axis
    nu: PyTree            # second moment (fp32), leading replica axis
    count: torch.Tensor   # (R,) int32 step counter


def _per_replica(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(R,) → (R, 1, ..., 1) broadcastable against ``like``."""
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


def adamw_init(params: PyTree) -> AdamWState:
    leaves = tree_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
        count=torch.zeros(leaves[0].shape[0], dtype=torch.int32, device=leaves[0].device),
    )


def global_norm(tree: PyTree) -> torch.Tensor:
    """(R,) fp32 norm of each replica's slice of the tree."""
    sums = [x.float().square().flatten(1).sum(1) for x in tree_leaves(tree)]
    return torch.stack(sums).sum(0).sqrt()


def clip_by_global_norm(grads: PyTree, max_norm: float) -> tuple[PyTree, torch.Tensor]:
    """Each replica's grads scaled to norm ≤ ``max_norm`` (in fp32, cast back
    to the grad dtype); returns (clipped, pre-clip (R,) norms)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    clipped = tree_map(lambda g: (g.float() * _per_replica(scale, g)).to(g.dtype), grads)
    return clipped, norm


def adamw_update(
    grads: PyTree, state: AdamWState, params: PyTree, cfg: AdamWConfig
) -> tuple[PyTree, AdamWState, torch.Tensor]:
    """Returns (new_params, new_state, pre-clip (R,) grad norms)."""
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)

    count = state.count + 1
    lr = cfg.lr_at(count)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), count.float())
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), count.float())

    mu = tree_map(lambda m, g: cfg.b1 * m + (1.0 - cfg.b1) * g.float(), state.mu, grads)
    nu = tree_map(lambda v, g: cfg.b2 * v + (1.0 - cfg.b2) * g.float() * g.float(), state.nu, grads)

    def _param(p, m, v):
        update = (m / _per_replica(c1, m)) / (torch.sqrt(v / _per_replica(c2, v)) + cfg.eps)
        p32 = p.float()
        p32 = p32 - _per_replica(lr, p32) * (update + cfg.weight_decay * p32)
        return p32.to(p.dtype)

    new_params = tree_map(_param, params, mu, nu)
    return new_params, AdamWState(mu=mu, nu=nu, count=count), gnorm
