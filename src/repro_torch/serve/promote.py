"""Train→serve checkpoint promotion: take ONE replica's weights out of a
NoLoCo training checkpoint and hand them to the serving engine (the port of
``repro/serve/promote.py``).

A NoLoCo checkpoint holds an ensemble: R distinct weight sets stacked on a
leading replica axis, plus each replica's outer anchor φ.  Promotion picks

  * ``replica`` — which ensemble member;
  * ``source`` — ``"theta"`` (the fast inner weights, with the last partial
    inner loop) or ``"phi"`` (the outer anchor of Eqs. 2–3).

The saved membership mask is validated: a replica that was frozen (dropped
from the gossip) or out of range warns and falls back to the first active
one, as in the JAX package.  Layouts (either package's checkpoints):
gossip ``{"theta", "outer": {"phi", ...}, "membership", ...}`` and
distributed ``{"theta", "phi", "delta", ...}``; a pipeline checkpoint
(``{"params": [per stage], ...}``) cannot be served as one model and
raises.  Depth-truncated drafts (``truncate_layers``) come with speculative
decode.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.device import resolve_device
from repro_torch.models import convert
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["promote", "resolve_replica"]


def resolve_replica(membership: dict | None, replica: int, world: int) -> int:
    """Validate ``replica`` against the checkpoint's membership; warn and
    fall back to the first active replica when it is frozen or out of range."""
    mask = None
    if membership is not None:
        mask = np.asarray(membership["mask"], dtype=bool)
        world = int(mask.shape[0])
    if 0 <= replica < world and (mask is None or mask[replica]):
        return replica
    if mask is not None and mask.any():
        fallback = int(np.flatnonzero(mask)[0])
        reason = (
            f"out of range (world={world})"
            if not 0 <= replica < world
            else "frozen in the saved membership (dropped from the gossip)"
        )
        warnings.warn(
            f"replica {replica} is {reason}; promoting first active replica "
            f"{fallback} instead",
            stacklevel=2,
        )
        return fallback
    if 0 <= replica < world:
        return replica
    warnings.warn(f"replica {replica} out of range (world={world}); promoting replica 0",
                  stacklevel=2)
    return 0


def promote(
    ckpt_dir: str,
    cfg,
    *,
    step: int | None = None,
    replica: int = 0,
    source: str = "theta",
    device: torch.device | str = "cuda",
) -> tuple[Any, dict]:
    """Load a training checkpoint and take one replica's serving weights.

    Returns ``(params, info)``: the port's parameter tree for ``cfg`` on
    ``device`` (through :func:`repro_torch.models.convert.
    params_from_jax_numpy`; a tree that does not have ``cfg``'s shapes
    raises, naming the leaf's shape and the config's), and the resolved
    ``{"step", "replica", "source", "world"}``.  ``device`` defaults to the
    card; with no GPU that raises."""
    device = resolve_device(device)
    if source not in ("theta", "phi"):
        raise ValueError(f"source must be 'theta' or 'phi', got {source!r}")
    if step is None:
        step = ckpt_lib.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    tree = ckpt_lib.restore(ckpt_dir, step)
    prog = tree.get("program", tree)

    if "params" in prog and "theta" not in prog:
        raise ValueError(
            "pipeline checkpoints hold stage-partitioned params and cannot "
            "be promoted to a single serving model; re-train with the gossip "
            "or distributed runtime, or stitch stages offline"
        )
    if "theta" not in prog:
        raise ValueError(
            f"unrecognized checkpoint layout: keys {sorted(prog)} — expected "
            "a gossip/distributed training checkpoint"
        )

    if source == "theta":
        stacked = prog["theta"]
    elif "outer" in prog:           # gossip layout
        stacked = prog["outer"]["phi"]
    elif "phi" in prog:             # distributed layout
        stacked = prog["phi"]
    else:
        raise ValueError("checkpoint has no outer state; use source='theta'")

    leaves = tree_leaves(stacked)
    if not leaves:
        raise ValueError("checkpoint weight tree is empty")
    world = int(leaves[0].shape[0])
    replica = resolve_replica(prog.get("membership"), replica, world)

    one = tree_map(lambda x: x[replica], stacked)
    try:
        params = convert.params_from_jax_numpy(one, cfg, device)
    except ValueError as e:
        raise ValueError(
            f"checkpoint {ckpt_dir} (step {step}) does not fit {cfg.name} with "
            f"{cfg.num_layers} layers of d_model {cfg.d_model}, vocab {cfg.vocab_size}: {e}"
        ) from e
    info = {"step": int(step), "replica": int(replica), "source": source, "world": world}
    return params, info
