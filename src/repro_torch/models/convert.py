"""Load the JAX package's weights into the port.

``params_from_jax_numpy`` takes the JAX model's value tree with numpy
leaves, as ``jax.tree.map(np.asarray, values_of(params))`` gives it, and
returns the port's parameter tree: the same nested dicts and lists, each
leaf a tensor on ``device``.  Norm scales and biases (fp32 in both packages)
stay fp32; every other weight takes ``dtype``.  The structure and every
shape are checked against what the port's own ``init_params`` makes for
``cfg``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.common import torch_dtype

PyTree = Any

_FP32_LEAVES = {"scale", "bias", "q_norm", "k_norm"}


def _to_tensor(arr, device, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())  # JAX's host arrays are read-only
    return t.to(device=device, dtype=dtype)


def expected_shapes(cfg) -> PyTree:
    """The shape tree the port's ``init_params`` makes for ``cfg``."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def norm():
        p = {"scale": (d,)}
        if cfg.norm_type == "layernorm":
            p["bias"] = (d,)
        return p

    def block(kind, lead):
        tfm.check_kind(cfg, kind)
        attn = {"w_q": (d, h, hd), "w_k": (d, kv, hd), "w_v": (d, kv, hd), "w_o": (h, hd, d)}
        if cfg.qk_norm:
            attn.update(q_norm=(hd,), k_norm=(hd,))
        p = {"ln1": norm(), "attn": attn}
        if cfg.d_ff > 0:
            mlp = {"w_in": (d, cfg.d_ff), "w_out": (cfg.d_ff, d)}
            if cfg.mlp_variant in ("swiglu", "geglu"):
                mlp["w_gate"] = (d, cfg.d_ff)
            p.update(ln2=norm(), mlp=mlp)
        return _map(lambda s: lead + s, p)

    period, n_full, rem = tfm.layer_plan(cfg)
    embed = {"table": (cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        embed["unembed"] = (d, cfg.vocab_size)
    return {
        "embed": embed,
        "stack": {
            "scan": [block(kind, (n_full,)) if n_full else None for kind in period],
            "rem": [block(period[j], ()) for j in range(rem)],
        },
        "final_norm": norm(),
    }


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax_numpy(
    tree: PyTree, cfg, device="cpu", dtype: torch.dtype | None = None
) -> PyTree:
    """The port's parameters from the JAX value tree (numpy leaves)."""
    dtype = dtype or torch_dtype(cfg.dtype)

    def walk(src, shape, path):
        if isinstance(shape, dict):
            if not isinstance(src, dict) or set(src) != set(shape):
                raise ValueError(
                    f"{path or 'params'}: keys {sorted(src) if isinstance(src, dict) else type(src)} "
                    f"!= expected {sorted(shape)}"
                )
            return {k: walk(src[k], shape[k], f"{path}/{k}") for k in shape}
        if isinstance(shape, list):
            if not isinstance(src, (list, tuple)) or len(src) != len(shape):
                raise ValueError(f"{path}: expected a list of {len(shape)}")
            return [walk(s, e, f"{path}/{i}") for i, (s, e) in enumerate(zip(src, shape))]
        if shape is None:
            if src is not None:
                raise ValueError(f"{path}: expected None")
            return None
        arr = np.asarray(src)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {arr.shape} != expected {shape}")
        leaf = path.rsplit("/", 1)[-1]
        return _to_tensor(arr, device, torch.float32 if leaf in _FP32_LEAVES else dtype)

    return walk(tree, expected_shapes(cfg), "")
