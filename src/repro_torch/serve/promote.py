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
raises.  :func:`truncate_layers` cuts a promoted tree to its first layers,
the depth-sliced draft of speculative decode.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.device import resolve_device
from repro_torch.models import convert
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["promote", "resolve_replica", "truncate_layers"]


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


def truncate_layers(params: Any, cfg, num_layers: int) -> tuple[Any, Any]:
    """Depth-truncated draft model: the FIRST ``num_layers`` blocks of a
    promoted parameter tree, sharing the embedding and final norm (the
    unembedding, where tied).  The layer cycle is kept: whole periods of
    ``cfg.attn_pattern`` slice the stacks' depth axis, and the layers of a
    last partial period are taken out of the stacks (depth ``n_full2`` of
    stack j) or, when the target has no such period, from its remainder.

    Every leaf of the draft is a view of the target's tensors (a slice or
    an index of the layer axis), so the draft costs no weight memory and
    sees any in-place change of the target's weights.  Returns
    ``(draft_params, draft_cfg)`` for :class:`repro_torch.serve.spec.
    SpecServeEngine`."""
    if not 1 <= num_layers <= cfg.num_layers:
        raise ValueError(
            f"num_layers must be in [1, {cfg.num_layers}], got {num_layers}"
        )
    period, n_full, _rem = tfm.layer_plan(cfg)
    p = len(period)
    n_full2, rem2 = num_layers // p, num_layers % p
    stack = params["stack"]
    scan2 = [
        tree_map(lambda x: x[:n_full2], s) if n_full2 and s is not None else None
        for s in stack["scan"]
    ]
    rem_list = []
    for j in range(rem2):
        if n_full2 < n_full:
            # layer n_full2·p + j lives at depth n_full2 of scan stack j
            rem_list.append(tree_map(lambda x: x[n_full2], stack["scan"][j]))
        else:
            rem_list.append(stack["rem"][j])
    draft_params = dict(params)
    draft_params["stack"] = {"scan": scan2, "rem": rem_list}
    return draft_params, dataclasses.replace(cfg, num_layers=num_layers)
