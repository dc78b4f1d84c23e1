"""Outer optimizers: NoLoCo (gossip, modified Nesterov), DiLoCo (all-reduce
Nesterov) and none (the slow weights track the fast ones).

The port of ``repro/core/outer.py`` for the stacked simulation: replicas on
a leading axis of every leaf, partner values from an index gather
(:class:`~repro_torch.comm.exchange.StackedGather`), the NoLoCo update
through the fused kernel op (:func:`repro_torch.kernels.ops.
noloco_update_pytree`).  Equations (paper §3.2), with the appendix-
consistent +β sign the JAX package documents::

    Δ_{t,i}   = θ_{t+1,i} − φ_{t,i}                                  (1)
    δ_{t,i}   = α δ_{t−1,i} + β·mean_j Δ_{t,j} − γ (φ_{t,i} − mean_j φ_{t,j})  (2)
    φ_{t+1,i} = φ_{t,i} + δ_{t,i}                                    (3)

The arithmetic keeps the JAX package's dtypes and order: Δ and the group
means in the parameters' dtype (``mean = 0.5·(a + b)`` rounded there), the
momentum update in fp32 cast back.  Stale-Δ discounting, streaming and the
sharded steps come with the elastic and multi-GPU runtimes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.comm import CommConfig
from repro_torch.comm import exchange as exchange_lib
from repro_torch.core import pairing
from repro_torch.kernels import ops as kernel_ops
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = [
    "OuterConfig", "OuterState", "gamma_band", "default_gamma", "init_outer_state",
    "outer_gradient", "noloco_momentum_update", "diloco_momentum_update", "outer_step",
    "outer_step_stacked",
]

_LATER = "ROADMAP Queue 1 item 10 (elasticity, streaming and async)"


def gamma_band(alpha: float, n: int = 2) -> tuple[float, float]:
    """Stability band for γ from Eq. 74: sqrt(n/(2(n−1)))·α < γ <
    sqrt(n/(2(n−1))·(2+α²))."""
    if n < 2:
        raise ValueError("group size must be >= 2 for the γ term to exist")
    scale = math.sqrt(n / (2.0 * (n - 1)))
    return scale * alpha, scale * math.sqrt(2.0 + alpha * alpha)


def default_gamma(alpha: float, n: int = 2) -> float:
    """Midpoint of the Eq. 74 stability band."""
    lo, hi = gamma_band(alpha, n)
    return 0.5 * (lo + hi)


@dataclasses.dataclass(frozen=True)
class OuterConfig:
    """Hyper-parameters of the outer optimizer (paper §4 defaults)."""

    method: str = "noloco"  # "noloco" | "diloco" | "none"
    alpha: float = 0.5      # Nesterov momentum (NoLoCo: 0.5; DiLoCo: 0.3)
    beta: float = 0.7       # outer learning rate
    gamma: float | None = None  # local-averaging strength; None -> Eq. 74 midpoint
    group_size: int = 2     # n; the paper uses 2
    inner_steps: int = 50   # m
    seed: int = 0           # pairing seed
    stale: str = "naive"    # async stale-Δ rule: "naive" | "momentum"

    def resolved_gamma(self) -> float:
        if self.method != "noloco":
            return 0.0
        if self.gamma is not None:
            return float(self.gamma)
        return default_gamma(self.alpha, self.group_size)

    def validate(self) -> None:
        if self.method not in ("noloco", "diloco", "none"):
            raise ValueError(f"unknown outer method: {self.method}")
        if not 0.0 <= self.alpha < 1.0:
            raise ValueError("alpha must be in [0, 1)")
        if self.method == "noloco":
            lo, hi = gamma_band(self.alpha, self.group_size)
            g = self.resolved_gamma()
            if not (lo < g < hi):
                raise ValueError(
                    f"gamma={g:.4f} outside stability band ({lo:.4f}, {hi:.4f}) "
                    "from Eq. 74 — the slow-weight variance would diverge"
                )
        if self.beta <= self.alpha:
            raise ValueError("outer learning rate beta must exceed alpha (App. A.2)")
        if self.stale not in ("naive", "momentum"):
            raise ValueError(f"unknown stale-Δ rule: {self.stale!r}")


@dataclasses.dataclass
class OuterState:
    """Slow weights φ and outer momentum δ (leading replica axis), and the
    outer step counter (host int: it keys the pairing)."""

    phi: PyTree
    delta: PyTree
    step: int = 0


def init_outer_state(params: PyTree) -> OuterState:
    return OuterState(
        phi=tree_map(lambda p: p.detach().clone(), params),
        delta=tree_map(torch.zeros_like, params),
        step=0,
    )


def outer_gradient(theta: PyTree, phi: PyTree) -> PyTree:
    """Eq. 1: Δ = θ − φ (computed in θ's dtype, stored in φ's)."""
    return tree_map(lambda t, p: (t - p.to(t.dtype)).to(p.dtype), theta, phi)


def noloco_momentum_update(phi, delta_mom, mean_delta, mean_phi, *, alpha: float,
                           beta: float, gamma: float) -> tuple[PyTree, PyTree]:
    """Eqs. 2–3 given the group means, through the fused kernel op.
    Returns (φ′, δ′)."""
    return kernel_ops.noloco_update_pytree(
        phi, delta_mom, mean_delta, mean_phi, alpha=alpha, beta=beta, gamma=gamma
    )


def diloco_momentum_update(phi, delta_mom, mean_delta, *, alpha: float, beta: float):
    """DiLoCo outer Nesterov: δ′ = αδ + β·mean(Δ); φ′ = φ + δ′, fp32 inside."""
    new_delta = tree_map(lambda d, md: alpha * d.float() + beta * md.float(), delta_mom, mean_delta)
    new_phi = tree_map(lambda p, nd: (p.float() + nd).to(p.dtype), phi, new_delta)
    return new_phi, tree_map(lambda nd, d: nd.to(d.dtype), new_delta, delta_mom)


def outer_step(state: OuterState, theta: PyTree, cfg: OuterConfig,
               comm: exchange_lib.Communicator | None, *,
               staleness: torch.Tensor | None = None) -> tuple[OuterState, PyTree]:
    """One outer step against a communicator.  Returns (new_state,
    new_theta): the fast weights restart from the new slow weights."""
    cfg.validate()
    if staleness is not None:
        raise NotImplementedError(f"stale-Δ outer steps are not ported yet ({_LATER})")
    if cfg.method == "none":
        return OuterState(phi=theta, delta=state.delta, step=state.step + 1), theta
    delta = outer_gradient(theta, state.phi)
    if cfg.method == "diloco":
        mean_delta = comm.allreduce_mean(delta)
        phi_next, delta_next = diloco_momentum_update(
            state.phi, state.delta, mean_delta, alpha=cfg.alpha, beta=cfg.beta
        )
    else:  # noloco
        delta_p, phi_p = exchange_lib.exchange_gossip(comm, delta, state.phi)
        mean_delta = tree_map(lambda a, b: 0.5 * (a + b), delta, delta_p)
        mean_phi = tree_map(lambda a, b: 0.5 * (a + b), state.phi, phi_p)
        phi_next, delta_next = noloco_momentum_update(
            state.phi, state.delta, mean_delta, mean_phi,
            alpha=cfg.alpha, beta=cfg.beta, gamma=cfg.resolved_gamma(),
        )
    return OuterState(phi=phi_next, delta=delta_next, step=state.step + 1), phi_next


@torch.no_grad()
def outer_step_stacked(state: OuterState, theta: PyTree, cfg: OuterConfig, *,
                       partner=None, active=None, comm_cfg: CommConfig | None = None,
                       staleness=None) -> tuple[OuterState, PyTree]:
    """One outer step with replicas stacked on axis 0 of every leaf.

    ``partner``: (world,) partner table; None derives it from the state's
    outer step (:func:`repro_torch.core.pairing.partner_table`).
    ``active``: (world,) bool mask of this round's participants; the others
    keep (φ, δ, θ) as they were.  A participant paired with itself runs the
    self-group update (its own Δ and φ are the group means).
    Returns (new_state, new_theta)."""
    cfg.validate()
    world = tree_leaves(theta)[0].shape[0]
    device = tree_leaves(theta)[0].device
    comm = None
    if cfg.method == "noloco":
        if partner is None:
            partner = pairing.partner_table(state.step, world, seed=cfg.seed)
        comm = exchange_lib.StackedGather(torch.as_tensor(partner, device=device), comm_cfg)
    elif cfg.method == "diloco":
        act = None if active is None else torch.as_tensor(active, dtype=torch.bool, device=device)
        comm = exchange_lib.StackedGather(None, comm_cfg, active=act)
    new_state, new_theta = outer_step(state, theta, cfg, comm, staleness=staleness)
    if active is not None:
        act = torch.as_tensor(active, dtype=torch.bool, device=device)

        def _sel(new, old):
            return torch.where(act.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

        new_theta = tree_map(_sel, new_theta, theta)
        new_state = OuterState(
            phi=tree_map(_sel, new_state.phi, state.phi),
            delta=tree_map(_sel, new_state.delta, state.delta),
            step=new_state.step,
        )
    return new_state, new_theta
