"""Dynamic pipeline routing (paper §3.1) with the per-stage gossip outer
step (§3.2): the port of ``repro/pipeline/runner.py``.

The model is split into consecutive stages, each stage replicated over the
replica axis, and at every step each microbatch is routed from a random
replica of stage s to a random replica of stage s + 1; its backward follows
the same path.  This mixes the weights of different replicas with no outer
step at all (the paper's §5.2 ablation: ``routing="fixed"`` is classic
pipelining, where replicas never exchange anything).

One-process simulation, as in the reference: every stage's parameters carry
a leading replica axis and all replicas of a stage run in one batched
forward (the reference vmaps over them).  Routing is a gather along the
replica axis by a per-step permutation, ``index_select``, whose backward
adds each microbatch's gradient back into the replica that computed it:
with a permutation each row receives exactly one term, so it is exact and
deterministic on the card.  Every outer step runs one
:func:`~repro_torch.core.outer.outer_step_stacked` per stage, each stage
drawing its own pairing, through the port's outer-step core (on the card:
``noloco_update`` per leaf, and the int8 codec's kernels on that wire).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.comm import CommConfig
from repro_torch.core import metrics as metrics_lib
from repro_torch.core import pairing
from repro_torch.core.elastic import ElasticContext
from repro_torch.core.outer import OuterConfig, OuterState, outer_step_stacked
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_norm, embed_tokens, init_embedding, init_norm, logits_sharded, token_nll,
)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = ["split_stages", "init_stage_params", "apply_stage", "stage_loss", "PipelineTrainer"]


# ---------------------------------------------------------------------------
# Stage splitting of a ModelConfig transformer
# ---------------------------------------------------------------------------


def split_stages(cfg: ModelConfig, num_stages: int) -> list[ModelConfig]:
    """``num_stages`` equal stage configs.  The layer pattern starts over in
    every stage: each gets the whole stack's plan for its layer count."""
    if cfg.num_layers % num_stages:
        raise ValueError("num_layers must divide evenly into stages")
    per = cfg.num_layers // num_stages
    return [dataclasses.replace(cfg, num_layers=per) for _ in range(num_stages)]


def init_stage_params(gen: torch.Generator, cfg: ModelConfig, stage: int,
                      num_stages: int) -> PyTree:
    """One replica's stage parameters: the stage's stack; stage 0 owns the
    embedding; the last stage owns the final norm and an unembedding of its
    own (a whole embedding dict, not tied to stage 0's table)."""
    scfg = split_stages(cfg, num_stages)[stage]
    p: dict = {"stack": tfm.init_stack(gen, scfg)}
    if stage == 0:
        p["embed"] = init_embedding(gen, cfg)
    if stage == num_stages - 1:
        p["final_norm"] = init_norm(cfg, cfg.d_model, gen.device)
        p["unembed"] = init_embedding(gen, cfg)
    return p


def apply_stage(params: PyTree, cfg: ModelConfig, stage: int, num_stages: int,
                x: torch.Tensor) -> torch.Tensor:
    """One stage over stacked params: tokens (R, B, S) into stage 0 (the
    plain embedding lookup: no scale, no sinusoidal rows), activations
    (R, B, S, d) into the others.  The MoE auxiliary loss is dropped, as in
    the reference."""
    scfg = split_stages(cfg, num_stages)[stage]
    if stage == 0:
        x = embed_tokens(params["embed"], cfg, x)
    positions = torch.arange(x.shape[2], device=x.device)
    x, _, _ = tfm.apply_stack(params["stack"], scfg, x, positions=positions)
    return x


def stage_loss(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """(R,) fp32 mean token NLL of each replica's last-stage output."""
    h = apply_norm(params["final_norm"], x)
    nll = token_nll(logits_sharded(params["unembed"], cfg, h), labels)
    cnt = float(nll[0].numel())
    return nll.sum(dim=(1, 2)) / max(cnt, 1.0)


# ---------------------------------------------------------------------------
# Routed pipeline trainer (stacked replicas)
# ---------------------------------------------------------------------------


def _stack_replicas(tree: PyTree, replicas: int, device) -> PyTree:
    return tree_map(lambda p: p.to(device).unsqueeze(0).repeat((replicas,) + (1,) * p.dim()),
                    tree)


@dataclasses.dataclass
class PipelineTrainer:
    """DP×PP trainer with per-step random routing; inner AdamW per replica.

    ``routing``: "random" (paper §3.1) or "fixed" (classic pipelining).
    ``outer``: the per-stage NoLoCo / DiLoCo outer step every
    ``outer.inner_steps`` steps, None (or method "none") for the
    routing-only trainer.  ``elastic``: an :class:`~repro_torch.core.
    elastic.ElasticContext`; routes then restrict to the active replicas
    (the others route to themselves and freeze), every stage's pairing is
    drawn over the round's participants, and loss, eval and weight std
    cover the active replicas.  ``device``: the card unless the caller asks
    for the CPU.

    The state is a dict: ``params`` and ``opt`` (per-stage lists of stacked
    trees and :class:`~repro_torch.optim.AdamWState`), ``step``, and with an
    outer step ``outer``: ``{"phi", "delta"`` (per-stage lists), ``"step"}``.
    ``partners`` records each NoLoCo round's per-stage partner tables."""

    cfg: ModelConfig
    num_stages: int
    replicas: int
    inner: AdamWConfig = dataclasses.field(
        default_factory=lambda: AdamWConfig(lr=1e-3, weight_decay=0.0))
    routing: str = "random"
    outer: OuterConfig | None = None
    comm: CommConfig = dataclasses.field(default_factory=CommConfig)
    device: torch.device | str = "cuda"
    seed: int = 0
    elastic: ElasticContext | None = None

    def __post_init__(self):
        if self.elastic is not None and self.elastic.world != self.replicas:
            raise ValueError(f"elastic world {self.elastic.world} != replicas {self.replicas}")
        self.device = resolve_device(self.device)
        self.partners: list[list[np.ndarray]] = []

    @property
    def outer_enabled(self) -> bool:
        return self.outer is not None and self.outer.method != "none"

    def initial_params(self) -> list[PyTree]:
        """One replica's starting weights of every stage, on the CPU: stage
        s drawn from a generator seeded from (seed, s)."""
        out = []
        for s in range(self.num_stages):
            key = int(np.random.SeedSequence((self.seed, s)).generate_state(1)[0])
            out.append(init_stage_params(torch.Generator().manual_seed(key), self.cfg, s,
                                         self.num_stages))
        return out

    def init(self) -> dict:
        """Every replica of a stage starts from the same weights (φ_{0,i} ≡
        φ_0, paper §A)."""
        params = [_stack_replicas(one, self.replicas, self.device)
                  for one in self.initial_params()]
        state = {"params": params, "opt": [adamw_init(p) for p in params], "step": 0}
        if self.outer_enabled:
            state["outer"] = {"phi": [tree_map(lambda t: t.clone(), p) for p in params],
                              "delta": [tree_map(torch.zeros_like, p) for p in params],
                              "step": 0}
        return state

    # -- routing --------------------------------------------------------

    def routes(self, step: int) -> list[np.ndarray]:
        """One permutation per stage boundary: ``route[i]`` is the replica
        whose activations replica i consumes.  Under a partial membership a
        bijection on the active ids (inactive replicas route to
        themselves); at full membership the elastic draw is the static
        one."""
        r = self.replicas
        if self.routing == "fixed":
            return [np.arange(r, dtype=np.int64)] * (self.num_stages - 1)
        view = None
        if self.elastic is not None and not self.elastic.is_full:
            view = self.elastic.membership
        out = []
        for b in range(self.num_stages - 1):
            key = step * 97 + b
            if view is not None:
                out.append(pairing.elastic_route_permutation(key, view, seed=self.seed))
            else:
                out.append(pairing.pairing_permutation(key, r, seed=self.seed))
        return [np.asarray(p, dtype=np.int64) for p in out]

    def _active_weights(self) -> torch.Tensor:
        """(R,) fp32 participation weights of the loss."""
        if self.elastic is None or self.elastic.is_full:
            return torch.ones(self.replicas, dtype=torch.float32, device=self.device)
        mask = self.elastic.membership.active_array()
        return torch.from_numpy(np.asarray(mask, dtype=np.float32)).to(self.device)

    def _batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v,
                                   device=self.device) for k, v in batch.items()}

    # -- loss over routed paths ------------------------------------------

    def loss(self, params: list, batch: dict, routes, weights: torch.Tensor | None = None
             ) -> torch.Tensor:
        """Active-weighted mean loss over replicas, fp32 scalar: the tokens
        (R, B, S) go through stage 0, then before each later stage the
        activations are gathered by the boundary's route; the labels follow
        every route in turn.  ``weights=None`` is the plain mean."""
        batch = self._batch(batch)
        idx = [torch.as_tensor(np.asarray(r), dtype=torch.int64, device=self.device)
               for r in routes]
        x = batch["tokens"]
        for s in range(self.num_stages):
            if s > 0:
                x = x.index_select(0, idx[s - 1])
            x = apply_stage(params[s], self.cfg, s, self.num_stages, x)
        lab = batch["labels"]
        for r in idx:
            lab = lab.index_select(0, r)
        losses = stage_loss(params[-1], self.cfg, x, lab)
        if weights is None:
            return losses.mean()
        return (losses * weights).sum() / torch.clamp_min(weights.sum(), 1.0)

    # -- one SGD step -------------------------------------------------------

    def train_step(self, state: dict, batch: dict) -> tuple[dict, float]:
        """Backpropagate the weighted mean loss (each replica's gradient is
        1/Σw of its own) and step every stage's AdamW once, so clipping uses
        each stage's own per-replica norm.  Frozen replicas keep their
        parameters, moments and count.  The AdamW moments of ``state`` are
        donated (updated in place); the parameters are new tensors, so no
        tensor that ``outer.phi`` holds is written."""
        routes = self.routes(state["step"])
        weights = self._active_weights()
        params = [tree_map(lambda p: p.detach().requires_grad_(), ps) for ps in state["params"]]
        loss = self.loss(params, batch, routes, weights)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        active = None
        if self.elastic is not None and not self.elastic.is_full:
            active = weights > 0
        new_params, new_opt, start = [], [], 0
        with torch.no_grad():
            for p, o in zip(state["params"], state["opt"]):
                n = len(tree_leaves(p))
                g = tree_unflatten(p, list(grads[start:start + n]))
                start += n
                np_, no_, _ = adamw_update(g, o, p, self.inner, active=active)
                new_params.append(np_)
                new_opt.append(no_)
        new_state = dict(state, params=new_params, opt=new_opt, step=state["step"] + 1)
        return new_state, float(loss.detach())

    # -- outer optimizer (§3.2 gossip, per stage over the replica axis) -----

    def stage_seed(self, stage: int) -> int:
        """The pairing seed of stage ``stage``: each stage draws its own
        matching for every round."""
        return self.seed + 1_000_003 * (stage + 1)

    def maybe_outer_step(self, state: dict) -> tuple[dict, bool]:
        """Outer round k fires once ``step >= (k + 1)·m``; a second call at
        the same step does nothing.  One participation decision per round,
        shared by all stages; every stage runs one stacked outer step with
        its own pairing (DiLoCo: none).  The fast weights restart from the
        new slow weights; AdamW moments persist."""
        if not self.outer_enabled:
            return state, False
        m = self.outer.inner_steps
        k = int(state["outer"]["step"])
        if state["step"] < (k + 1) * m:
            return state, False
        plan = self.elastic.plan_round(None) if self.elastic is not None else None
        active = None if plan is None else plan.active
        new_params, new_phi, new_delta, tables = [], [], [], []
        for s in range(self.num_stages):
            partner = None
            if self.outer.method == "noloco":
                if plan is not None:
                    partner = pairing.elastic_partner_table(
                        k, plan.participants, seed=self.stage_seed(s),
                        groups=self.elastic.partition)
                else:
                    partner = pairing.partner_table(k, self.replicas, seed=self.stage_seed(s))
                tables.append(np.asarray(partner))
            ost = OuterState(phi=state["outer"]["phi"][s], delta=state["outer"]["delta"][s],
                             step=k)
            new_ost, new_theta = outer_step_stacked(
                ost, state["params"][s], self.outer, partner=partner, active=active,
                comm_cfg=self.comm)
            new_params.append(new_theta)
            new_phi.append(new_ost.phi)
            new_delta.append(new_ost.delta)
        if tables:
            self.partners.append(tables)
        return dict(state, params=new_params,
                    outer={"phi": new_phi, "delta": new_delta, "step": k + 1}), True

    # -- grad-free eval --------------------------------------------------------

    @torch.no_grad()
    def eval_loss(self, params: list, batch: dict) -> torch.Tensor:
        """Active-weighted mean loss with identity routes: each replica
        evaluated as a self-contained pipeline."""
        fixed = [np.arange(self.replicas)] * (self.num_stages - 1)
        return self.loss(params, batch, fixed, self._active_weights())

    # -- §5.2 metric -----------------------------------------------------------

    @torch.no_grad()
    def weight_std(self, state: dict) -> float:
        """Mean over the leaves of every stage of the std across the active
        replicas."""
        params = state["params"]
        if self.elastic is not None and not self.elastic.is_full:
            ids = self.elastic.active_ids()
            if len(ids) < 2:
                return 0.0
            idx = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
            params = [tree_map(lambda x: x.index_select(0, idx), p) for p in params]
        return float(metrics_lib.replica_weight_std(params))
