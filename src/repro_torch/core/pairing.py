"""Gossip pair selection for the NoLoCo outer step, drawn exactly as the JAX
package draws it.

The reference pairs replicas by a random permutation of the world,
``jax.random.permutation(fold_in(PRNGKey(seed), step), world)``
(``repro/core/pairing.py``), taken two by two.  This module reproduces those
permutations bit for bit without JAX: a numpy threefry2x32 with JAX's key
derivation under ``jax_threefry_partitionable`` (the default of the jax the
reference runs on), and JAX's sort-based shuffle — per round, split the key,
draw 32 random bits per element and stable-sort the elements by them.  So
every replica of a port run, and the JAX package itself, derive the same
partner tables from (seed, step) with no communication.

Only full membership is ported (what the stacked trainer uses when no
replica has dropped out); partitions, the hypercube schedule and churn come
with the elastic runtime.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "threefry2x32",
    "prng_key",
    "fold_in",
    "split",
    "random_bits",
    "pairing_permutation",
    "partner_table",
    "Membership",
    "elastic_partner_table",
]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x1: np.ndarray, x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) of counters (x1, x2) under
    ``key`` (2,) uint32, as JAX's ``threefry2x32_p`` computes it."""
    k1, k2 = _U32(key[0]), _U32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        a = np.asarray(x1, _U32) + ks[0]
        b = np.asarray(x2, _U32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=_U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the cipher of the counter pair (0, data)."""
    a, b = threefry2x32(key, np.array([0], _U32), np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([a[0], b[0]], dtype=_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (partitionable): key i is the cipher of the
    64-bit counter i, as (high, low) words."""
    a, b = threefry2x32(key, np.zeros(num, _U32), np.arange(num, dtype=_U32))
    return np.stack([a, b], axis=1)


def random_bits(key: np.ndarray, n: int) -> np.ndarray:
    """32 random bits per element (partitionable): the XOR of the two words
    of the cipher of counter i."""
    a, b = threefry2x32(key, np.zeros(n, _U32), np.arange(n, dtype=_U32))
    return a ^ b


def pairing_permutation(step: int, world: int, *, seed: int = 0) -> np.ndarray:
    """``jax.random.permutation(fold_in(PRNGKey(seed), step), world)``.

    JAX shuffles by ``ceil(3·ln(world) / ln(2**32 − 1))`` rounds of a stable
    sort on fresh 32-bit keys (one round up to world ≈ 1,600)."""
    key = fold_in(prng_key(seed), step)
    x = np.arange(world, dtype=np.int64)
    rounds = int(np.ceil(3 * np.log(max(1, world)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, world), kind="stable")]
    return x


def partner_table(step: int, world: int, *, seed: int = 0) -> np.ndarray:
    """Pairwise partner id per replica (group size 2): consecutive entries of
    the step's permutation pair up; ``partner[i] == i`` for the odd one out."""
    perm = pairing_permutation(step, world, seed=seed)
    partner = np.arange(world, dtype=np.int64)
    for k in range(0, (world // 2) * 2, 2):
        a, b = int(perm[k]), int(perm[k + 1])
        partner[a] = b
        partner[b] = a
    return partner


@dataclasses.dataclass(frozen=True)
class Membership:
    """Epoch-stamped view of which replica slots are alive; only the full
    view is constructed in this port (:meth:`full`)."""

    world: int
    mask: tuple[bool, ...]
    epoch: int = 0

    def __post_init__(self):
        if self.world < 1:
            raise ValueError("membership needs world >= 1")
        if len(self.mask) != self.world:
            raise ValueError(f"mask length {len(self.mask)} != world {self.world}")
        if not any(self.mask):
            raise ValueError("membership must keep at least one active replica")

    @classmethod
    def full(cls, world: int) -> "Membership":
        return cls(world=world, mask=(True,) * world, epoch=0)

    @property
    def active_ids(self) -> tuple[int, ...]:
        return tuple(i for i, m in enumerate(self.mask) if m)


def elastic_partner_table(step: int, membership: Membership, *, seed: int = 0) -> np.ndarray:
    """Partner table over the active replicas of ``membership``: the world's
    permutation filtered to the active ids (order kept), consecutive actives
    paired; inactive replicas and the odd active out map to themselves.  With
    full membership it equals :func:`partner_table`."""
    perm = pairing_permutation(step, membership.world, seed=seed)
    partner = np.arange(membership.world, dtype=np.int64)
    active = set(membership.active_ids)
    order = [int(r) for r in perm if int(r) in active]
    for k in range(0, len(order) - 1, 2):
        a, b = order[k], order[k + 1]
        partner[a] = b
        partner[b] = a
    return partner
