"""The logical axes of the port's parameter trees.

The JAX package keeps each weight's logical axes beside its value (a
``Param``, ``repro/models/common.py``); the port's parameters are plain
tensors, so this module gives, for any config, the tree of logical axes
with the structure of the port's parameter tree (``models.convert.
expected_shapes``).  Each leaf is an :class:`Axes`, the names of the
leaf's dimensions, as the reference's ``init_*`` functions annotate them:

    None      whole on every rank
    "tp"      split over the model axis (tensor parallelism)
    "expert"  split over the model axis (expert parallelism)
    "fsdp"    split over the data axis by ZeRO-3 (``fsdp_hybrid`` only)
    "replica" the stacked replica axis

Scanned layers carry a leading None (the layer axis), as the reference's
``_stack_trees`` prepends.  ``parallel.plans.shard_tree`` reads this tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models import transformer as tfm
from repro_torch.models.model import encoder_cfg

PyTree = Any

__all__ = ["Axes", "logical_axes", "stacked"]


@dataclasses.dataclass(frozen=True)
class Axes:
    """One leaf's logical axes (a tree leaf: ``tree_map`` does not enter it)."""

    names: tuple

    def __len__(self) -> int:
        return len(self.names)


def _ax(*names) -> Axes:
    return Axes(tuple(names))


def _norm(cfg) -> dict:
    p = {"scale": _ax(None)}
    if cfg.norm_type == "layernorm":
        p["bias"] = _ax(None)
    return p


def _attn(cfg) -> dict:
    p = {"w_q": _ax("fsdp", "tp", None), "w_k": _ax("fsdp", None, None),
         "w_v": _ax("fsdp", None, None), "w_o": _ax("tp", None, "fsdp")}
    if cfg.qk_norm:
        p.update(q_norm=_ax(None), k_norm=_ax(None))
    return p


def _mixer(kind: str) -> dict:
    if kind == "rglru":
        return {"w_x": _ax("fsdp", "tp"), "w_gate": _ax("fsdp", "tp"), "w_r": _ax("fsdp", "tp"),
                "w_i": _ax("fsdp", "tp"), "conv": _ax(None, "tp"), "lam": _ax("tp"),
                "w_out": _ax("tp", "fsdp")}
    return {"w_z": _ax("fsdp", "tp"), "w_x": _ax("fsdp", "tp"), "w_b": _ax("fsdp", None),
            "w_c": _ax("fsdp", None), "w_dt": _ax("fsdp", "tp"), "dt_bias": _ax("tp"),
            "a_log": _ax("tp"), "d_skip": _ax("tp"), "conv": _ax(None, "tp"),
            "norm_scale": _ax("tp"), "w_out": _ax("tp", "fsdp")}


def _block(cfg, kind: str, cross: bool) -> dict:
    tfm.check_kind(kind)
    p: dict = {"ln1": _norm(cfg)}
    if kind in ("rglru", "ssd"):
        p["mixer"] = _mixer(kind)
    else:
        p["attn"] = _attn(cfg)
    if cross:
        p.update(ln_cross=_norm(cfg), cross_attn=_attn(cfg))
    if cfg.arch_type == "moe":
        moe = {"router": _ax(None, None), "w_in": _ax("expert", "fsdp", None),
               "w_out": _ax("expert", None, "fsdp")}
        if cfg.mlp_variant in ("swiglu", "geglu"):
            moe["w_gate"] = _ax("expert", "fsdp", None)
        p.update(ln2=_norm(cfg), moe=moe)
    elif cfg.d_ff > 0:
        mlp = {"w_in": _ax("fsdp", "tp"), "w_out": _ax("tp", "fsdp")}
        if cfg.mlp_variant in ("swiglu", "geglu"):
            mlp["w_gate"] = _ax("fsdp", "tp")
        p.update(ln2=_norm(cfg), mlp=mlp)
    return p


def _lead(tree: PyTree, *names) -> PyTree:
    """``tree`` with ``names`` in front of every leaf's axes."""
    if isinstance(tree, dict):
        return {k: _lead(v, *names) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_lead(v, *names) for v in tree]
    if tree is None:
        return None
    return Axes(tuple(names) + tree.names)


def _stack(cfg, cross: bool = False) -> dict:
    period, n_full, rem = tfm.layer_plan(cfg)
    return {"scan": [_lead(_block(cfg, kind, cross), None) if n_full else None
                     for kind in period],
            "rem": [_block(cfg, period[j], cross) for j in range(rem)]}


def logical_axes(cfg) -> PyTree:
    """The logical-axes tree of ``init_params(cfg)``'s parameters."""
    embed = {"table": _ax("tp", "fsdp")}
    if not cfg.tie_embeddings:
        embed["unembed"] = _ax("fsdp", "tp")
    out = {"embed": embed, "stack": _stack(cfg, cross=cfg.is_encoder_decoder),
           "final_norm": _norm(cfg)}
    if cfg.is_encoder_decoder:
        out.update(encoder=_stack(encoder_cfg(cfg)), enc_norm=_norm(cfg))
        if cfg.frontend_dim and cfg.frontend_dim != cfg.d_model:
            out["enc_proj"] = _ax("fsdp", None)
    if cfg.frontend == "vision":
        out["projector"] = _ax("fsdp", None)
    return out


def stacked(logical: PyTree) -> PyTree:
    """The tree with the stacked replica axis in front of every leaf."""
    return _lead(logical, "replica")
