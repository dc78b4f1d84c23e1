"""Section 5.3 latency models: tree all-reduce vs NoLoCo pair averaging, and
the global-blocking (straggler) overhead of DiLoCo-style synchronization.

Message send times are modeled log-normal, t ~ LogNormal(μ, σ²), following the
paper.  Key closed forms:

  * tree all-reduce:           t_all ≈ 2 t_c log2(n)                  (Eq. 5)
  * max of two iid lognormals: E[max(t1,t2)] = (1+erf(σ/2)) exp(μ+σ²/2) (Eq. 7)
  * pair averaging:            2 E[max(t1,t2)]  (one leaf-level exchange)

``simulate_tree_allreduce`` Monte-Carlos the actual reduce+broadcast over a
binary tree (each level waits for the max of its children), which is what
Fig. 5A plots; ``simulate_blocking_overhead`` reproduces Fig. 5B: total time of
R outer rounds when DiLoCo must wait for the slowest of n workers each round
while NoLoCo only waits pairwise.

Size-aware variants: the closed forms above model LATENCY only (the paper's
per-message t_c).  ``pair_average_time_bytes`` / ``tree_allreduce_time_bytes``
add a bandwidth term ``payload_bytes / bandwidth`` per message, with the byte
counts supplied by :mod:`repro_torch.comm.bytes_model` so the estimate reflects the
configured codec / fusing / overlap (fp16 halves the serialization term, int8
quarters it, overlap removes the φ half from the blocking path).

A copy of the JAX package's ``repro/core/latency.py`` (numpy only), so the
port computes the same numbers for the same numpy seed without importing
that package.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "expected_message_time",
    "expected_pairwise_max",
    "tree_allreduce_time_closed_form",
    "pair_average_time_closed_form",
    "speedup_closed_form",
    "transfer_time",
    "pair_average_time_bytes",
    "tree_allreduce_time_bytes",
    "simulate_tree_allreduce",
    "simulate_pair_average",
    "simulate_blocking_overhead",
    "WAN_BANDWIDTH",
]

# Default slow-link bandwidth for the internet-scale setting the paper targets:
# 1 Gbit/s in bytes per second.
WAN_BANDWIDTH = 1.25e8


def expected_message_time(mu: float, sigma: float) -> float:
    """E[t] for t ~ LogNormal(μ, σ²): exp(μ + σ²/2). This is the paper's t_c."""
    return math.exp(mu + sigma * sigma / 2.0)


def expected_pairwise_max(mu: float, sigma: float) -> float:
    """Eq. 7: E[max(t1, t2)] = (1 + erf(σ/2)) · exp(μ + σ²/2)."""
    return (1.0 + math.erf(sigma / 2.0)) * math.exp(mu + sigma * sigma / 2.0)


def tree_allreduce_time_closed_form(n: int, mu: float, sigma: float) -> float:
    """Eq. 5 with the level-max refinement: reduce+broadcast over a binary
    tree of n leaves ≈ 2 · log2(n) · E[max of two children]."""
    return 2.0 * math.log2(max(n, 2)) * expected_pairwise_max(mu, sigma)


def pair_average_time_closed_form(mu: float, sigma: float) -> float:
    """NoLoCo local averaging: 2 E[t_local] (one exchange each way)."""
    return 2.0 * expected_pairwise_max(mu, sigma)


def speedup_closed_form(n: int, mu: float, sigma: float) -> float:
    """Expected tree-allreduce time / pair-average time ≈ log2(n)."""
    return tree_allreduce_time_closed_form(n, mu, sigma) / pair_average_time_closed_form(
        mu, sigma
    )


def transfer_time(payload_bytes: float, bandwidth: float = WAN_BANDWIDTH) -> float:
    """Serialization time of one message: bytes / (bytes per second)."""
    return float(payload_bytes) / float(bandwidth)


def pair_average_time_bytes(
    mu: float,
    sigma: float,
    *,
    payload_bytes: float,
    bandwidth: float = WAN_BANDWIDTH,
) -> float:
    """NoLoCo gossip round with a size-aware message model: the Eq. 7 latency
    term plus the serialization of the BLOCKING payload each way.

    ``payload_bytes`` should be ``CommCost.blocking_bytes`` from
    :func:`repro_torch.comm.bytes_model.outer_step_cost` — with overlap enabled only
    the Δ half serializes on the blocking path."""
    return pair_average_time_closed_form(mu, sigma) + 2.0 * transfer_time(
        payload_bytes, bandwidth
    )


def tree_allreduce_time_bytes(
    n: int,
    mu: float,
    sigma: float,
    *,
    payload_bytes: float,
    bandwidth: float = WAN_BANDWIDTH,
) -> float:
    """Binary-tree all-reduce with a size-aware message model: each of the
    2·log2(n) levels pays the level latency plus one payload serialization."""
    levels = 2.0 * math.log2(max(n, 2))
    return tree_allreduce_time_closed_form(n, mu, sigma) + levels * transfer_time(
        payload_bytes, bandwidth
    )


def _lognormal(rng: np.random.Generator, mu: float, sigma: float, size) -> np.ndarray:
    return rng.lognormal(mean=mu, sigma=sigma, size=size)


def simulate_tree_allreduce(
    n: int, mu: float, sigma: float, *, rounds: int = 1000, seed: int = 0
) -> float:
    """Monte-Carlo expected completion time of a binary-tree all-reduce over n
    workers (reduce to root, then broadcast back down)."""
    rng = np.random.default_rng(seed)
    depth = int(math.ceil(math.log2(max(n, 2))))
    total = 0.0
    for _ in range(rounds):
        t = 0.0
        width = n
        # Reduce phase: at each level, each parent waits for max of children.
        for _lvl in range(depth):
            pairs = max(width // 2, 1)
            sends = _lognormal(rng, mu, sigma, (pairs, 2))
            t += sends.max(axis=1).max()
            width = pairs
        # Broadcast phase mirrors the reduce phase.
        width = 1
        for _lvl in range(depth):
            fanout = min(width * 2, n)
            sends = _lognormal(rng, mu, sigma, fanout)
            t += sends.max()
            width = fanout
        total += t
    return total / rounds


def simulate_pair_average(
    mu: float, sigma: float, *, rounds: int = 1000, seed: int = 0
) -> float:
    """Monte-Carlo expected completion time of one gossip pair exchange
    (send Δ,φ to partner; receive theirs): 2 × max of the two directions."""
    rng = np.random.default_rng(seed)
    sends = _lognormal(rng, mu, sigma, (rounds, 2, 2))
    return float((sends.max(axis=2).sum(axis=1)).mean())


def simulate_blocking_overhead(
    world: int,
    *,
    outer_rounds: int = 500,
    inner_steps: int = 100,
    mu: float = 1.0,
    sigma2: float = 0.5,
    seed: int = 0,
) -> dict[str, float]:
    """Fig. 5B: ratio of DiLoCo to NoLoCo total training time from global
    blocking alone (communication itself excluded, as in the paper).

    Each worker's inner-step durations are iid LogNormal(μ, σ²).  DiLoCo's
    outer step is a barrier: every round costs max over workers of their inner
    phase.  NoLoCo only synchronizes pairs: a pair's round costs the max of
    the two members; workers then proceed (we track per-worker clocks and
    return the time the LAST worker finishes, which is what wall-clock is).
    """
    rng = np.random.default_rng(seed)
    sigma = math.sqrt(sigma2)

    durations = rng.lognormal(mu, sigma, size=(outer_rounds, world, inner_steps)).sum(
        axis=2
    )

    # DiLoCo: global barrier per round.
    diloco_total = durations.max(axis=1).sum()

    # NoLoCo: pairwise barrier per round.
    clocks = np.zeros(world)
    perm_rng = np.random.default_rng(seed + 1)
    for r in range(outer_rounds):
        clocks += durations[r]
        order = perm_rng.permutation(world)
        for k in range(0, (world // 2) * 2, 2):
            a, b = order[k], order[k + 1]
            t = max(clocks[a], clocks[b])
            clocks[a] = clocks[b] = t
    noloco_total = clocks.max()

    return {
        "diloco": float(diloco_total),
        "noloco": float(noloco_total),
        "ratio": float(diloco_total / noloco_total),
    }
