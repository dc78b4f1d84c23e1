"""AdamW (the paper's inner optimizer) over replica-stacked parameter trees.

The port of ``repro/optim/adamw.py``: decoupled weight decay with bias
correction, fp32 moments whatever the parameter dtype, the update computed
in fp32 and cast back to each parameter's dtype.  Every leaf carries a
leading replica axis R; the JAX package vmaps ``adamw_update`` over that
axis, so clipping by the global norm is per replica and the step counter is
an (R,) tensor.  The update donates the moments, as a jitted JAX step with
donated buffers does: they are updated in place, and the parameters' new
values computed leaf by leaf in slices of at most ``SLICE`` elements, so no
whole-tree or whole-leaf fp32 temporary exists (recurrentgemma-9b's stacked
embedding is 2.1 B values).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

SLICE = 1 << 26   # elements per in-place pass over a donated leaf (fp32 temporaries: 256 MB)

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


def adamw_init(params: PyTree) -> AdamWState:
    leaves = tree_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
        count=torch.zeros(leaves[0].shape[0], dtype=torch.int32, device=leaves[0].device),
    )


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    """(R,) fp32 Σ x² of each replica's slice, each slice reduced on its
    own in parts of at most SLICE elements: a replica's sum does not depend
    on how many replicas are stacked beside it (a rank of the replica group
    holds one), and no fp32 square of more than SLICE elements exists
    (recurrentgemma-9b's embedding row is 1.05 B values)."""
    flat = x.flatten(1)
    n = flat.shape[1]

    def one(row: torch.Tensor) -> torch.Tensor:
        if n <= SLICE:
            return row.float().square().sum()
        return torch.stack([row[i:i + SLICE].float().square().sum()
                            for i in range(0, n, SLICE)]).sum()

    return torch.stack([one(row) for row in flat])


def global_norm(tree: PyTree) -> torch.Tensor:
    """(R,) fp32 norm of each replica's slice of the tree, each replica's
    leaf sums added on their own."""
    sums = torch.stack([_square_sum(x) for x in tree_leaves(tree)], dim=1)   # (R, leaves)
    return torch.stack([row.sum() for row in sums]).sqrt()


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """(R,) fp32 min(1, max_norm / max(norm, 1e-12))."""
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> tuple[PyTree, torch.Tensor]:
    """(clipped, (R,) pre-clip norms): each replica's slice of every leaf
    scaled by min(1, max_norm / max(norm, 1e-12)) of that replica's global
    norm, in fp32 and cast back to the leaf's dtype, as the JAX package's
    ``clip_by_global_norm`` under its vmap over replicas."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)

    def one(g: torch.Tensor) -> torch.Tensor:
        s = scale.reshape((-1,) + (1,) * (g.dim() - 1))
        return (g.float() * s).to(g.dtype)

    return tree_map(one, grads), norm


def adamw_update(
    grads: PyTree, state: AdamWState, params: PyTree, cfg: AdamWConfig,
    active: torch.Tensor | None = None, norm: torch.Tensor | None = None,
) -> tuple[PyTree, AdamWState, torch.Tensor]:
    """Returns (new_params, new_state, pre-clip (R,) grad norms).  The moments
    of ``state`` are donated: the returned state holds the same tensors,
    updated in place, one slice of at most SLICE elements of one leaf at a
    time; the parameters are new tensors (the stacked trainer's θ may share
    its storage with φ).  Each element's clipping, moments and step are the
    JAX package's operations in its order.

    ``active`` ((R,) bool) freezes the other replicas, as the JAX package's
    elastic trainer selects the old values for them: their parameters, both
    moments and ``count`` stay as they were, and the active rows keep the
    bits of the unmasked update.

    ``norm`` ((R,) fp32): the global norm to clip by, in place of
    ``global_norm(grads)`` (a rank that holds a shard of each replica
    passes the norm of the whole replica's gradient)."""
    gnorm = global_norm(grads) if norm is None else norm
    scale = _clip_scale(gnorm, cfg.clip_norm)[:, None] if cfg.clip_norm is not None else None
    count = state.count + 1
    act = None if active is None else active.to(count.device, torch.bool)[:, None]
    lr = cfg.lr_at(count)[:, None]
    c1 = (1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), count.float()))[:, None]
    c2 = (1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), count.float()))[:, None]

    def one(g, m, v, p):
        out = torch.empty(p.shape, dtype=p.dtype, device=p.device)
        r = p.shape[0]
        g2, p2 = g.reshape(r, -1), p.reshape(r, -1)   # FSDP's mean gradients are expanded views
        m2, v2, o2 = (t.view(r, -1) for t in (m, v, out))
        for i in range(0, p2.shape[1], SLICE):
            cols = slice(i, i + SLICE)
            gs = g2[:, cols]
            if scale is not None:   # clipped in fp32, cast back to the grad dtype
                gs = (gs.float() * scale).to(gs.dtype)
            ms = cfg.b1 * m2[:, cols] + (1.0 - cfg.b1) * gs.float()
            vs = cfg.b2 * v2[:, cols] + (1.0 - cfg.b2) * gs.float() * gs.float()
            update = (ms / c1) / (torch.sqrt(vs / c2) + cfg.eps)
            p32 = p2[:, cols].float()
            new = (p32 - lr * (update + cfg.weight_decay * p32)).to(p.dtype)
            if act is not None:   # frozen rows: the old moments and parameters
                ms = torch.where(act, ms, m2[:, cols])
                vs = torch.where(act, vs, v2[:, cols])
                new = torch.where(act, new, p2[:, cols])
            m2[:, cols] = ms
            v2[:, cols] = vs
            o2[:, cols] = new
        return out

    new_params = tree_map(one, grads, state.mu, state.nu, params)
    if act is not None:
        count = torch.where(act[:, 0], count, state.count)
    return new_params, AdamWState(mu=state.mu, nu=state.nu, count=count), gnorm
