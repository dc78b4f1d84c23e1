"""Appendix A machinery (the port of ``repro/core/theory.py``): convergence analysis of the modified Nesterov outer
step on the stochastic quadratic loss

    L(θ) = ½ (θ − c)ᵀ A (θ − c),   c ~ N(0, Σ),  A ≻ 0 symmetric.

These utilities are used by tests and benchmarks to validate Theorem 1
empirically:

  * ``expected_phi_spectrum``  — eigenvalues 𝒟_i of D = (1+α)I + β(Bᵐ − I)
    (Eq. 53); |roots of r² − 𝒟 r + α| < 1  ⇔  E(φ_t) → 0.
  * ``variance_coefficient``   — d_V = 1 + α² − 2γ²(n−1)/n (Eq. 69); |d_V| < 1
    is the boundedness condition that yields the γ band of Eq. 74.
  * ``simulate_quadratic``     — direct Monte-Carlo of the full NoLoCo
    iteration (inner SGD + gossip outer) on the quadratic model, returning the
    trajectory of E‖φ‖ and V(φ) across replicas so tests can check
    E(φ)→0 and V(φ) ∝ ω².

The Monte-Carlo draws the JAX package's ``jax.random.normal`` from the
port's own threefry (:func:`repro_torch.core.pairing.split`,
:func:`~repro_torch.core.pairing.random_bits_torch`): the uniform on
[nextafter(−1, 0), 1) from the top 23 bits of each word, then
√2·erfinv(u).  The inner SGD steps are torch ops on ``device`` and every
outer step is :func:`repro_torch.core.outer.outer_step_stacked`, so on the
card each launches the ``noloco_update`` kernel.  ``erfinv`` may differ from
XLA's in the last bits, so the trajectories match the JAX package's within
a tolerance, not bit for bit.
"""

from __future__ import annotations

import dataclasses

import math

import numpy as np
import torch

from repro_torch.core import outer as outer_lib
from repro_torch.core import pairing
from repro_torch.device import resolve_device

__all__ = [
    "QuadraticModel",
    "expected_phi_spectrum",
    "expected_phi_converges",
    "variance_coefficient",
    "variance_bounded",
    "simulate_quadratic",
    "staleness_floor",
]


def staleness_floor(
    omega: float, sigma: float, dim: int, tau_bar: float, stale: str = "naive"
) -> float:
    """Predicted stationary floor of the tail-averaged ‖E(φ)‖ under
    asynchronous merged-tick rounds with mean staleness τ̄.

    The synchronous floor is the O(ω σ √d) stochastic level of Thm. 1 (the
    1.5 prefactor is the Monte-Carlo calibration the synchronous tests pin).
    ``stale="naive"`` applies a delayed Δ undiscounted, so a replica that is
    τ ticks late injects a contribution accumulated over (1+τ) rounds of
    drift — the floor grows as O(ω σ · (1+τ̄)).  ``stale="momentum"``
    rescales each Δ by 1/(1+τ) before the exchange, recovering the
    synchronous floor."""
    base = 1.5 * omega * sigma * float(np.sqrt(dim))
    if stale == "momentum":
        return base
    return base * (1.0 + tau_bar)


@dataclasses.dataclass(frozen=True)
class QuadraticModel:
    """The App. A toy problem. ``a_eigs`` are the eigenvalues of A (we work in
    A's eigenbasis WLOG); ``sigma`` the isotropic std of c."""

    a_eigs: tuple[float, ...] = (1.0, 0.25, 0.05)
    sigma: float = 1.0

    @property
    def dim(self) -> int:
        return len(self.a_eigs)


def expected_phi_spectrum(
    alpha: float, beta: float, omega: float, m: int, a_eigs
) -> np.ndarray:
    """Eigenvalues 𝒟_i = 1 + α − (1 − (1 − ω Λ_i)ᵐ) β of D (Eq. 53)."""
    lam = np.asarray(a_eigs, dtype=np.float64)
    return 1.0 + alpha - (1.0 - (1.0 - omega * lam) ** m) * beta


def expected_phi_converges(
    alpha: float, beta: float, omega: float, m: int, a_eigs
) -> bool:
    """E(φ_t) → 0 iff both roots of r² − 𝒟 r + α = 0 lie inside the unit
    circle for every eigenvalue 𝒟 (Eq. 44-46)."""
    for d in expected_phi_spectrum(alpha, beta, omega, m, a_eigs):
        disc = complex(d * d - 4.0 * alpha)
        sq = disc ** 0.5
        r1 = 0.5 * (d + sq)
        r2 = 0.5 * (d - sq)
        if max(abs(r1), abs(r2)) >= 1.0:
            return False
    return True


def variance_coefficient(alpha: float, gamma: float, n: int = 2) -> float:
    """d_V = 1 + α² − 2 γ² (n−1)/n (Eq. 69). |d_V| < 1 ⇔ γ in Eq. 74 band."""
    return 1.0 + alpha * alpha - 2.0 * gamma * gamma * (n - 1) / n


def variance_bounded(alpha: float, gamma: float, n: int = 2) -> bool:
    return abs(variance_coefficient(alpha, gamma, n)) < 1.0


_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))   # the normal's uniform: [lo, 1)
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key: np.ndarray, shape: tuple[int, ...], device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on ``device``: threefry
    bits of the flat index, the uniform on [nextafter(−1, 0), 1) built from
    the top 23 bits of each word under the exponent of 1.0, then
    √2·erfinv(u)."""
    n = math.prod(shape)
    keys = torch.from_numpy(np.asarray(key, dtype=np.int64)[None])
    bits = pairing.random_bits_torch(keys, n, device)[0]
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(_LO, dtype=torch.float32, device=device)
    span = torch.tensor(1.0, dtype=torch.float32, device=device) - lo
    u = torch.maximum(lo, f * span + lo)
    return (_SQRT2 * torch.special.erfinv(u)).reshape(shape)


def simulate_quadratic(
    model: QuadraticModel,
    *,
    world: int = 8,
    outer_steps: int = 200,
    inner_steps: int = 10,
    omega: float = 0.1,
    cfg: outer_lib.OuterConfig | None = None,
    seed: int = 0,
    phi0_scale: float = 5.0,
    rates: tuple[float, ...] | None = None,
    device: torch.device | str = "cuda",
) -> dict[str, np.ndarray]:
    """Run the full NoLoCo/DiLoCo iteration on the quadratic model.

    Inner optimizer: SGD with constant LR ω on the stochastic gradient
    A(θ − c), c ~ N(0, σ² I) redrawn per inner step (Eq. 9-10).

    Returns trajectories of length ``outer_steps + 1`` — entry 0 is the
    INITIAL condition (before any step), entry t >= 1 the state after outer
    step t:
      ``mean_norm``  — ‖ mean over replicas of φ ‖ (→ 0 per Thm. 2)
      ``replica_std``— mean over dims of std over replicas of φ (Fig. 3B)
      ``var``        — mean variance of φ entries over replicas (∝ ω², Thm. 3)

    The iteration is stochastic: ``mean_norm`` decays geometrically to a
    stationary noise floor of scale O(ω σ), not to machine zero.

    ``rates`` (per-replica step-rate multipliers in (0, 1]) switches to the
    asynchronous merged-tick clock: replica r earns inner steps at rate
    ``rates[r]``, a merged sync tick fires whenever any replica completes
    its m-th inner step since its last sync, and only the due set applies
    the outer update; ``cfg.stale`` picks the stale-Δ rule and
    ``outer_steps`` counts merged ticks.  The result then also carries
    ``staleness``, the per-sync mean τ over the due set.  ``rates=None``
    (or all ones) runs the synchronous path.  ``device`` is the card unless
    the caller asks for the CPU."""
    cfg = cfg or outer_lib.OuterConfig()
    dev = resolve_device(device)
    key = pairing.prng_key(seed)
    a = torch.tensor(model.a_eigs, dtype=torch.float32, device=dev)

    key, k0 = pairing.split(key)
    phi = phi0_scale * normal(k0, (world, model.dim), dev)
    state = outer_lib.init_outer_state(phi)
    theta = phi

    def inner_sweep(th, k):
        for kk in pairing.split(k, inner_steps):
            c = model.sigma * normal(kk, tuple(th.shape), dev)
            grad = a[None, :] * (th - c)
            th = th - omega * grad
        return th

    mean_norm, replica_std, var = [], [], []

    def record(phi_t):
        phi_np = phi_t.cpu().numpy()
        mean_norm.append(np.linalg.norm(phi_np.mean(axis=0)))
        replica_std.append(phi_np.std(axis=0).mean())
        var.append(phi_np.var(axis=0).mean())

    record(phi)  # t = 0: the initial condition the transient decays from
    if rates is not None and any(float(r) != 1.0 for r in rates):
        staleness = _simulate_async(
            model, cfg, state, theta, key, a,
            world=world, outer_steps=outer_steps, inner_steps=inner_steps,
            omega=omega, rates=rates, record=record, device=dev,
        )
        return {
            "mean_norm": np.asarray(mean_norm),
            "replica_std": np.asarray(replica_std),
            "var": np.asarray(var),
            "staleness": np.asarray(staleness),
        }
    for t in range(outer_steps):
        key, k = pairing.split(key)
        theta = inner_sweep(theta, k)
        partner = pairing.partner_table(t, world, seed=cfg.seed)
        state, theta = outer_lib.outer_step_stacked(state, theta, cfg, partner=partner)
        record(state.phi)

    out = {
        "mean_norm": np.asarray(mean_norm),
        "replica_std": np.asarray(replica_std),
        "var": np.asarray(var),
    }
    if rates is not None:  # all ones: the synchronous path, zero staleness
        out["staleness"] = np.zeros(outer_steps, dtype=np.float64)
    return out


def _simulate_async(
    model, cfg, state, theta, key, a, *,
    world, outer_steps, inner_steps, omega, rates, record, device,
):
    """Merged-tick loop of :func:`simulate_quadratic` (``rates`` path): the
    credit accumulation, due-at-m and τ of :class:`repro_torch.sim.cluster.
    ReplicaClock`, on the quadratic model.  Returns the per-sync mean τ over
    the due set."""
    rate = np.asarray(rates, dtype=np.float64)
    if rate.shape != (world,):
        raise ValueError(f"rates must have shape ({world},), got {rate.shape}")
    if (rate <= 0).any() or (rate > 1).any():
        raise ValueError("rates must lie in (0, 1]")
    credit = np.zeros(world)
    local = np.zeros(world, np.int64)
    sync_count = np.zeros(world, np.int64)
    last_sync = np.full(world, -1, np.int64)
    merged_tick = 0
    staleness_trace = []
    while merged_tick < outer_steps:
        credit += rate
        grant = credit >= 1.0 - 1e-9
        credit[grant] -= 1.0
        local[grant] += 1
        key, k = pairing.split(key)
        c = model.sigma * normal(k, tuple(theta.shape), device)
        new = theta - omega * (a[None, :] * (theta - c))
        theta = torch.where(torch.from_numpy(grant).to(device)[:, None], new, theta)
        due = local >= (sync_count + 1) * inner_steps
        if not due.any():
            continue
        tau = np.maximum(merged_tick - last_sync - 1, 0)
        partner = pairing.partner_table(merged_tick, world, seed=cfg.seed)
        stale = None
        if cfg.stale == "momentum" and tau.any():
            stale = torch.as_tensor(tau, dtype=torch.float32)
        state, theta = outer_lib.outer_step_stacked(
            state, theta, cfg, partner=partner, active=due, staleness=stale)
        staleness_trace.append(float(tau[due].mean()))
        sync_count[due] += 1
        last_sync[due] = merged_tick
        merged_tick += 1
        record(state.phi)
    return staleness_trace
