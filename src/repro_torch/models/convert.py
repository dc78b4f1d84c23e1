"""Load the JAX package's weights and training state into the port.

``params_from_jax_numpy`` takes the JAX model's value tree with numpy
leaves, as ``jax.tree.map(np.asarray, values_of(params))`` gives it, and
returns the port's parameter tree: the same nested dicts and lists, each
leaf a tensor on ``device``.  Norm scales and biases, the recurrent
mixers' rates, skips, norm scales and Λ, and the MoE router (fp32 in both
packages at every model dtype) stay fp32; every other weight takes
``dtype``.  The structure
and every shape are checked against what the port's own ``init_params``
makes for ``cfg``, the encoder (``encoder``, ``enc_norm``, ``enc_proj``),
the cross-attention blocks (``ln_cross``, ``cross_attn``) and the vision
``projector`` included.

``train_state_from_jax_numpy`` does the same for the stacked trainer's
whole state (θ, AdamW μ/ν/count, φ, δ and the two step counters), given as
the JAX ``GossipProgram.state_pytree`` tree with numpy leaves, so both
packages can continue training from one point; ``train_state_to_numpy`` is
its inverse, the tree a checkpoint holds, with the streaming runtime's
in-flight ``stream`` subtree (the prefetched φ loads through
``stacked_params_from_jax_numpy``).  ``shard_from_jax_numpy`` cuts a model
rank's shard out of the loaded tree.  ``gossip_tree_from_distributed``
rearranges the distributed runtime's checkpoint (JAX's
``DistributedProgram`` layout) into that one.  ``pipeline_state_from_jax_numpy`` /
``pipeline_state_to_numpy`` carry the routed pipeline's state (per-stage
lists, each stage checked against :func:`stage_shapes`) in the layout of
JAX's ``PipelineProgram.state_pytree``.  Host leaves are numpy arrays,
except bfloat16 ones, which numpy holds only through ``ml_dtypes`` (a JAX
dependency the port does without): those are CPU tensors.  Both loaders
take either.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.common import torch_dtype
from repro_torch.models.model import encoder_cfg
from repro_torch.models.rglru import CONV_WIDTH, lru_width
from repro_torch.models.ssd import d_inner, num_heads_ssm
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

FP32_LEAVES = {"scale", "bias", "q_norm", "k_norm",
               "dt_bias", "a_log", "d_skip", "norm_scale", "lam", "router"}


def _to_tensor(arr, device, dtype) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.detach().to(device=device, dtype=dtype, copy=True)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())  # JAX's host arrays are read-only
    return t.to(device=device, dtype=dtype)


def _shape_builders(cfg):
    """(norm, stack, embed) shape builders at ``cfg``'s widths: ``norm()``,
    ``stack(c, cross)`` for a stack config ``c`` and the embedding dict."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def norm():
        p = {"scale": (d,)}
        if cfg.norm_type == "layernorm":
            p["bias"] = (d,)
        return p

    def mixer(kind):
        if kind == "rglru":
            w = lru_width(cfg)
            return {"w_x": (d, w), "w_gate": (d, w), "w_r": (d, w), "w_i": (d, w),
                    "conv": (CONV_WIDTH, w), "lam": (w,), "w_out": (w, d)}
        di, n, nh = d_inner(cfg), cfg.ssm_state_dim, num_heads_ssm(cfg)
        return {"w_z": (d, di), "w_x": (d, di), "w_b": (d, n), "w_c": (d, n),
                "w_dt": (d, nh), "dt_bias": (nh,), "a_log": (nh,), "d_skip": (nh,),
                "conv": (cfg.ssm_conv_width, di), "norm_scale": (di,), "w_out": (di, d)}

    def attn():
        p = {"w_q": (d, h, hd), "w_k": (d, kv, hd), "w_v": (d, kv, hd), "w_o": (h, hd, d)}
        if cfg.qk_norm:
            p.update(q_norm=(hd,), k_norm=(hd,))
        return p

    def block(kind, lead, cross):
        tfm.check_kind(kind)
        if kind in ("rglru", "ssd"):
            p = {"ln1": norm(), "mixer": mixer(kind)}
        else:
            p = {"ln1": norm(), "attn": attn()}
        if cross:
            p.update(ln_cross=norm(), cross_attn=attn())
        if cfg.arch_type == "moe":
            e, f = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
            moe = {"router": (d, e), "w_in": (e, d, f), "w_out": (e, f, d)}
            if cfg.mlp_variant in ("swiglu", "geglu"):
                moe["w_gate"] = (e, d, f)
            p.update(ln2=norm(), moe=moe)
        elif cfg.d_ff > 0:
            mlp = {"w_in": (d, cfg.d_ff), "w_out": (cfg.d_ff, d)}
            if cfg.mlp_variant in ("swiglu", "geglu"):
                mlp["w_gate"] = (d, cfg.d_ff)
            p.update(ln2=norm(), mlp=mlp)
        return _map(lambda s: lead + s, p)

    def stack(c, cross=False):
        period, n_full, rem = tfm.layer_plan(c)
        return {
            "scan": [block(kind, (n_full,), cross) if n_full else None for kind in period],
            "rem": [block(period[j], (), cross) for j in range(rem)],
        }

    embed = {"table": (cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        embed["unembed"] = (d, cfg.vocab_size)
    return norm, stack, embed


def expected_shapes(cfg) -> PyTree:
    """The shape tree the port's ``init_params`` makes for ``cfg``."""
    norm, stack, embed = _shape_builders(cfg)
    d = cfg.d_model
    out = {"embed": embed, "stack": stack(cfg, cross=cfg.is_encoder_decoder),
           "final_norm": norm()}
    if cfg.is_encoder_decoder:
        out.update(encoder=stack(encoder_cfg(cfg)), enc_norm=norm())
        if cfg.frontend_dim and cfg.frontend_dim != d:
            out["enc_proj"] = (cfg.frontend_dim, d)
    if cfg.frontend == "vision":
        out["projector"] = (cfg.frontend_dim, d)
    return out


def stage_shapes(cfg, stage: int, num_stages: int) -> PyTree:
    """The shape tree of one replica's parameters of pipeline stage
    ``stage`` (``pipeline.runner.init_stage_params``): the stage's stack;
    ``embed`` in stage 0; ``final_norm`` and ``unembed`` (a whole embedding
    dict) in the last stage."""
    from repro_torch.pipeline.runner import split_stages

    norm, stack, embed = _shape_builders(cfg)
    out = {"stack": stack(split_stages(cfg, num_stages)[stage])}
    if stage == 0:
        out["embed"] = embed
    if stage == num_stages - 1:
        out["final_norm"] = norm()
        out["unembed"] = dict(embed)
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax_numpy(
    tree: PyTree, cfg, device="cpu", dtype: torch.dtype | None = None
) -> PyTree:
    """The port's parameters from the JAX value tree (numpy leaves)."""
    return _load(tree, expected_shapes(cfg), device, dtype or torch_dtype(cfg.dtype))


def shard_from_jax_numpy(tree: PyTree, cfg, plan, model_index: int, device="cpu",
                         dtype: torch.dtype | None = None, data_index: int = 0) -> PyTree:
    """The shard at (``data_index``, ``model_index``) of one replica's
    parameters from the JAX value tree (numpy leaves): the port's whole
    tree (:func:`params_from_jax_numpy`), then the rank's block of each
    leaf the ``plan`` splits, on the model and on the data axis
    (``parallel.plans.shard_tree``, the plan's attention specs)."""
    from repro_torch.models.logical import logical_axes
    from repro_torch.parallel import plans

    logical = plans.adjust_attn_specs_for_decode(plan, logical_axes(cfg))
    return plans.shard_tree(params_from_jax_numpy(tree, cfg, device, dtype), logical, plan,
                            model_index, data_index)


def _load(tree: PyTree, shapes: PyTree, device, dtype: torch.dtype,
          lead: tuple[int, ...] = (), fp32: bool = False) -> PyTree:
    """``tree`` checked against the shape tree ``shapes`` with ``lead``
    prepended, as tensors on ``device``: fp32 where ``fp32`` or for norm
    leaves, ``dtype`` otherwise."""
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
        if tuple(src.shape) != lead + tuple(shape):
            raise ValueError(f"{path}: shape {tuple(src.shape)} != expected {lead + tuple(shape)}")
        leaf = path.rsplit("/", 1)[-1]
        return _to_tensor(src, device, torch.float32 if fp32 or leaf in FP32_LEAVES else dtype)

    return walk(tree, shapes, "")


def stacked_params_from_jax_numpy(tree: PyTree, cfg, device="cpu",
                                  dtype: torch.dtype | None = None) -> PyTree:
    """A replica-stacked parameter tree (θ's layout: a leading replica
    axis, norm leaves fp32, the rest ``dtype``, default ``cfg.dtype``) from
    the JAX layout with host leaves."""
    lead = (int(tree_leaves(tree)[0].shape[0]),)
    return _load(tree, expected_shapes(cfg), device, dtype or torch_dtype(cfg.dtype), lead)


def train_state_from_jax_numpy(tree: dict, cfg, device="cpu", dtype: torch.dtype | None = None):
    """The port's :class:`~repro_torch.core.noloco.TrainState` from the JAX
    stacked trainer's state, as ``jax.tree.map(np.asarray,
    program.state_pytree(state))`` gives it: ``{"theta", "opt": {"mu",
    "nu", "count"}, "outer": {"phi", "delta", "step"}, "inner_step"}``, every
    parameter-shaped leaf with a leading replica axis.  θ, φ and δ take
    ``dtype`` (default ``cfg.dtype``; norm leaves fp32), μ and ν stay fp32."""
    from repro_torch.core.noloco import TrainState
    from repro_torch.core.outer import OuterState
    from repro_torch.optim import AdamWState

    dtype = dtype or torch_dtype(cfg.dtype)
    count = _host(tree["opt"]["count"])
    lead = (count.shape[0],)
    shapes = expected_shapes(cfg)
    params = lambda t, fp32=False: _load(t, shapes, device, dtype, lead, fp32)
    return TrainState(
        theta=params(tree["theta"]),
        opt=AdamWState(
            mu=params(tree["opt"]["mu"], fp32=True),
            nu=params(tree["opt"]["nu"], fp32=True),
            count=torch.from_numpy(count.astype(np.int32)).to(device),
        ),
        outer=OuterState(
            phi=params(tree["outer"]["phi"]),
            delta=params(tree["outer"]["delta"]),
            step=int(tree["outer"]["step"]),
        ),
        inner_step=int(tree["inner_step"]),
    )


def gossip_tree_from_distributed(tree: dict) -> dict:
    """The JAX ``GossipProgram.state_pytree`` layout of a distributed
    runtime's checkpoint tree (``{"theta", "opt", "phi", "delta",
    "outer_step", "inner_step"}``, the layout of JAX's
    ``DistributedProgram.state_pytree``): φ, δ and the outer counter move
    under ``outer``.  Every replica's outer counter must agree."""
    counters = np.unique(_host(tree["outer_step"]))
    if counters.size != 1:
        raise ValueError(f"replicas at different outer steps {counters.tolist()} do not make "
                         "one stacked state")
    out = {"theta": tree["theta"], "opt": tree["opt"],
           "outer": {"phi": tree["phi"], "delta": tree["delta"],
                     "step": np.int32(counters[0])},
           "inner_step": np.int32(int(tree["inner_step"]))}
    if "membership" in tree:
        out["membership"] = tree["membership"]
    return out


def _host(leaf) -> np.ndarray:
    """A numpy array of an integer or bool leaf given as numpy or torch."""
    return leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def to_host(t: torch.Tensor):
    """A tensor as a host array: numpy, or a CPU tensor for bfloat16."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def train_state_to_numpy(state, membership: dict | None = None,
                         stream: dict | None = None) -> dict:
    """The JAX ``GossipProgram.state_pytree`` tree of a port
    :class:`~repro_torch.core.noloco.TrainState`, with host leaves (see the
    module docstring): ``{"theta", "opt": {"mu", "nu", "count"}, "outer":
    {"phi", "delta", "step"}, "inner_step", "membership": {"mask", "epoch",
    "partition"}}``, parameter dicts in sorted key order, the step counters
    int32 scalars as JAX writes them.  ``membership`` is the program's
    :meth:`~repro_torch.core.elastic.ElasticContext.state_dict`; None gives
    the full membership (every replica active, epoch 0, no partition).
    ``stream`` (a streaming program's in-flight state: ``pre_partner``
    (S, R) and ``pre_epoch`` (S,) int64, and ``phi_pre``, a stacked
    parameter tree, once a φ′ was pre-sent) becomes the ``stream``
    subtree."""
    params = lambda t: tree_map(to_host, t)
    world = int(state.opt.count.shape[0])
    if membership is None:
        membership = {"mask": np.ones((world,), dtype=bool), "epoch": np.int64(0),
                      "partition": np.full((world,), -1, dtype=np.int64)}
    tree = {
        "theta": params(state.theta),
        "opt": {"mu": params(state.opt.mu), "nu": params(state.opt.nu),
                "count": state.opt.count.detach().cpu().to(torch.int32).numpy()},
        "outer": {"phi": params(state.outer.phi), "delta": params(state.outer.delta),
                  "step": np.int32(state.outer.step)},
        "inner_step": np.int32(state.inner_step),
        "membership": membership,
    }
    if stream is not None:
        tree["stream"] = {"pre_partner": np.asarray(stream["pre_partner"], dtype=np.int64),
                          "pre_epoch": np.asarray(stream["pre_epoch"], dtype=np.int64)}
        if stream.get("phi_pre") is not None:
            tree["stream"]["phi_pre"] = params(stream["phi_pre"])
    return tree


def stage_params_from_jax_numpy(tree: PyTree, cfg, stage: int, num_stages: int,
                                device="cpu", dtype: torch.dtype | None = None) -> PyTree:
    """One replica's parameters of pipeline stage ``stage`` from the JAX
    value tree of ``init_stage_params`` (numpy leaves)."""
    return _load(tree, stage_shapes(cfg, stage, num_stages), device,
                 dtype or torch_dtype(cfg.dtype))


def pipeline_state_from_jax_numpy(tree: dict, cfg, num_stages: int, device="cpu",
                                  dtype: torch.dtype | None = None) -> dict:
    """The port's :class:`~repro_torch.pipeline.PipelineTrainer` state from
    the JAX ``PipelineProgram.state_pytree`` tree with host leaves:
    ``{"params": [stage trees], "opt": [{"mu", "nu", "count"}], "step"}``
    and, with an outer step, ``"outer": {"phi", "delta", "step"}``.  Every
    stage tree is checked against :func:`stage_shapes` with a leading
    replica axis; parameters, φ and δ take ``dtype`` (default
    ``cfg.dtype``; norm leaves fp32), μ and ν stay fp32."""
    from repro_torch.optim import AdamWState

    if len(tree["params"]) != num_stages or len(tree["opt"]) != num_stages:
        raise ValueError(f"checkpoint holds {len(tree['params'])} stages, this run {num_stages}")
    dtype = dtype or torch_dtype(cfg.dtype)
    lead = (int(_host(tree["opt"][0]["count"]).shape[0]),)
    shapes = [stage_shapes(cfg, s, num_stages) for s in range(num_stages)]

    def stages(trees, fp32=False):
        return [_load(t, sh, device, dtype, lead, fp32) for t, sh in zip(trees, shapes)]

    state = {
        "params": stages(tree["params"]),
        "opt": [AdamWState(mu=m, nu=v, count=torch.from_numpy(
                    _host(o["count"]).astype(np.int32)).to(device))
                for m, v, o in zip(stages([o["mu"] for o in tree["opt"]], fp32=True),
                                   stages([o["nu"] for o in tree["opt"]], fp32=True),
                                   tree["opt"])],
        "step": int(tree["step"]),
    }
    if "outer" in tree:
        state["outer"] = {"phi": stages(tree["outer"]["phi"]),
                          "delta": stages(tree["outer"]["delta"]),
                          "step": int(tree["outer"]["step"])}
    return state


def pipeline_state_to_numpy(state: dict, membership: dict | None = None) -> dict:
    """The JAX ``PipelineProgram.state_pytree`` tree of a pipeline state,
    with host leaves: per-stage lists, ``opt`` as ``{"mu", "nu", "count"}``
    dicts (``count`` int32, as JAX's AdamW holds it), ``step`` and the
    outer ``step`` int64, and ``membership`` when given (an elastic
    context's ``state_dict``)."""
    params = lambda t: tree_map(to_host, t)
    tree = {
        "params": [params(p) for p in state["params"]],
        "opt": [{"mu": params(o.mu), "nu": params(o.nu),
                 "count": o.count.detach().cpu().to(torch.int32).numpy()} for o in state["opt"]],
        "step": np.int64(state["step"]),
    }
    if "outer" in state:
        tree["outer"] = {"phi": [params(p) for p in state["outer"]["phi"]],
                         "delta": [params(d) for d in state["outer"]["delta"]],
                         "step": np.int64(state["outer"]["step"])}
    if membership is not None:
        tree["membership"] = membership
    return tree
