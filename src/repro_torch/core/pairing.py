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

The serving engine draws its sampling noise from the same cipher:
:func:`random_bits_torch` is :func:`random_bits` for a batch of keys, in
torch integer ops on any device, so a decode step draws every sampled row's
bits on the card in one fixed sequence of ops.

Elastic scheduling (:class:`Membership`, :func:`elastic_partner_table`)
filters the same full-world permutation to the active replicas, optionally
within partition components, so a schedule under churn is still a pure
function of ``(seed, step, membership, groups)``, and with full membership
it is the static one.  The hypercube tables are pure numpy, as in the
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

__all__ = [
    "threefry2x32",
    "prng_key",
    "fold_in",
    "split",
    "random_bits",
    "random_bits_torch",
    "pairing_permutation",
    "partner_table",
    "ppermute_pairs",
    "hypercube_dim",
    "hypercube_partner_table",
    "hypercube_ppermute_pairs",
    "all_pairs_seen",
    "Membership",
    "elastic_partner_table",
    "elastic_ppermute_pairs",
    "elastic_hypercube_partner_table",
    "elastic_hypercube_ppermute_pairs",
    "elastic_route_permutation",
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


_MASK32 = 0xFFFFFFFF


def random_bits_torch(keys: torch.Tensor, n: int, device: torch.device | str) -> torch.Tensor:
    """:func:`random_bits` of each row of ``keys`` (k, 2), as (k, n) int64
    holding uint32 values: threefry2x32 over the counters 0..n−1 in torch
    integer ops on ``device``.  Words are kept in int64 and masked to 32 bits
    after every add and rotate (torch has no uint32 arithmetic)."""
    keys = torch.as_tensor(keys, dtype=torch.int64).to(device)
    k1, k2 = keys[:, :1], keys[:, 1:]
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = k1.expand(-1, n).clone()
    b = torch.arange(n, dtype=torch.int64, device=device)[None].add(k2).bitwise_and_(_MASK32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a.add_(b).bitwise_and_(_MASK32)
            b = ((b << r).bitwise_and_(_MASK32) | (b >> (32 - r))).bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK32)
        b.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_MASK32)
    return a.bitwise_xor_(b)


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


def ppermute_pairs(step: int, world: int, *, seed: int = 0) -> list[tuple[int, int]]:
    """(source, destination) pairs of outer step ``step``'s exchange: each
    replica sends its payload to its partner and receives the partner's,
    so the list is an involution (the odd one out of an odd world addresses
    itself and moves nothing)."""
    partner = partner_table(step, world, seed=seed)
    return [(int(src), int(partner[src])) for src in range(world)]


def hypercube_dim(step: int, world: int, *, seed: int = 0) -> int:
    """The hypercube dimension ``j`` used at outer step ``step``: a random
    cyclic order over the log2(world) dimensions, refreshed every log2(world)
    steps (numpy's generator, as the JAX package draws it)."""
    if world & (world - 1):
        raise ValueError("hypercube schedule needs a power-of-two world size")
    dims = max(int(np.log2(world)), 1)
    cycle, slot = divmod(step, dims)
    order = np.random.default_rng((seed + 1) * 7_919 + cycle).permutation(dims)
    return int(order[slot])


def hypercube_partner_table(step: int, world: int, *, seed: int = 0) -> np.ndarray:
    """The hypercube gossip schedule: partner = id XOR 2^j, with ``j`` from
    :func:`hypercube_dim`.  After any log2(world) consecutive distinct
    dimensions every pair of replicas has exchanged information.  Needs a
    power-of-two world."""
    j = hypercube_dim(step, world, seed=seed)
    ids = np.arange(world, dtype=np.int64)
    if world == 1:
        return ids
    return ids ^ (1 << j)


def hypercube_ppermute_pairs(step: int, world: int, *, seed: int = 0) -> list[tuple[int, int]]:
    """(source, destination) pairs of :func:`hypercube_partner_table`."""
    partner = hypercube_partner_table(step, world, seed=seed)
    return [(int(src), int(partner[src])) for src in range(world)]


def all_pairs_seen(steps: int, world: int, *, seed: int = 0) -> np.ndarray:
    """Symmetric boolean matrix: which (i, j) pairs met within ``steps`` outer
    steps of :func:`partner_table` (the mixing diagnostic)."""
    seen = np.eye(world, dtype=bool)
    for t in range(steps):
        partner = partner_table(t, world, seed=seed)
        for i in range(world):
            seen[i, partner[i]] = True
            seen[partner[i], i] = True
    return seen


# ---------------------------------------------------------------------------
# Elastic (membership-aware) scheduling
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Membership:
    """Epoch-stamped view of which replica slots are alive.

    ``mask[i]`` is True iff replica ``i`` participates in training.  The
    ``epoch`` increments on every membership change (drop / rejoin); the
    pairing is a pure function of ``(seed, step, mask)``, so two epochs with
    identical masks schedule identically."""

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

    @property
    def num_active(self) -> int:
        return sum(self.mask)

    @property
    def is_full(self) -> bool:
        return all(self.mask)

    def active_array(self) -> np.ndarray:
        """(world,) bool mask of the active replicas."""
        return np.asarray(self.mask, dtype=bool)

    def drop(self, replicas: Iterable[int]) -> "Membership":
        """New membership with ``replicas`` deactivated; epoch bumped."""
        ids = self._check_ids(replicas)
        for r in ids:
            if not self.mask[r]:
                raise ValueError(f"replica {r} is already inactive")
        mask = tuple(m and i not in ids for i, m in enumerate(self.mask))
        return Membership(world=self.world, mask=mask, epoch=self.epoch + 1)

    def add(self, replicas: Iterable[int]) -> "Membership":
        """New membership with ``replicas`` (re)activated; epoch bumped."""
        ids = self._check_ids(replicas)
        for r in ids:
            if self.mask[r]:
                raise ValueError(f"replica {r} is already active")
        mask = tuple(m or i in ids for i, m in enumerate(self.mask))
        return Membership(world=self.world, mask=mask, epoch=self.epoch + 1)

    def without(self, replicas: Iterable[int]) -> "Membership":
        """Transient view excluding ``replicas`` (stragglers missing one
        round): the epoch is not bumped, only this round's participation
        changed."""
        ids = self._check_ids(replicas)
        if not ids:
            return self
        mask = tuple(m and i not in ids for i, m in enumerate(self.mask))
        return Membership(world=self.world, mask=mask, epoch=self.epoch)

    def _check_ids(self, replicas: Iterable[int]) -> frozenset[int]:
        ids = frozenset(int(r) for r in replicas)
        for r in ids:
            if not 0 <= r < self.world:
                raise ValueError(f"replica id {r} outside world {self.world}")
        return ids


def elastic_partner_table(step: int, membership: Membership, *, seed: int = 0,
                          groups: Sequence[Sequence[int]] | None = None) -> np.ndarray:
    """Partner table over the active replicas of ``membership``: the world's
    permutation filtered to the active ids (order kept), consecutive actives
    paired; inactive replicas and the odd active out map to themselves.  With
    full membership and no groups it equals :func:`partner_table`.

    ``groups`` restricts pairing to network-partition components: each group
    pairs its active members internally and no pair crosses a component.
    Groups must be disjoint; active replicas in no group sit out."""
    world = membership.world
    perm = pairing_permutation(step, world, seed=seed)
    partner = np.arange(world, dtype=np.int64)
    if groups is None:
        components = [membership.active_ids]
    else:
        components = [tuple(int(r) for r in g) for g in groups]
        flat = [r for g in components for r in g]
        if len(flat) != len(set(flat)):
            raise ValueError("partition groups must be disjoint")
        for r in flat:
            if not 0 <= r < world:
                raise ValueError(f"partition replica id {r} outside world {world}")
    active = set(membership.active_ids)
    for comp in components:
        members = set(comp) & active
        order = [int(r) for r in perm if int(r) in members]
        for k in range(0, len(order) - 1, 2):
            a, b = order[k], order[k + 1]
            partner[a] = b
            partner[b] = a
    return partner


def elastic_ppermute_pairs(step: int, membership: Membership, *, seed: int = 0,
                           groups: Sequence[Sequence[int]] | None = None
                           ) -> list[tuple[int, int]]:
    """(source, destination) list of the elastic matching: sit-outs and
    inactive replicas address themselves, so the permutation is total."""
    table = elastic_partner_table(step, membership, seed=seed, groups=groups)
    return [(int(src), int(table[src])) for src in range(membership.world)]


def elastic_hypercube_partner_table(step: int, membership: Membership, *, seed: int = 0,
                                    groups: Sequence[Sequence[int]] | None = None
                                    ) -> np.ndarray:
    """Membership-filtered hypercube matching: partner = id XOR 2^j, with any
    pair that touches an inactive replica or crosses a partition component
    (or has a replica in no component) degraded to two self-loops.  With full
    membership and no groups it equals :func:`hypercube_partner_table`."""
    world = membership.world
    j = hypercube_dim(step, world, seed=seed)
    ids = np.arange(world, dtype=np.int64)
    if world == 1:
        return ids
    raw = ids ^ (1 << j)
    comp = np.zeros(world, dtype=np.int64)
    if groups is not None:
        comp[:] = -1
        for gid, g in enumerate(groups):
            for r in g:
                comp[int(r)] = gid
    active = np.asarray(membership.mask, dtype=bool)
    ok = active & active[raw] & (comp == comp[raw]) & (comp >= 0)
    return np.where(ok, raw, ids)


def elastic_hypercube_ppermute_pairs(step: int, membership: Membership, *, seed: int = 0,
                                     groups: Sequence[Sequence[int]] | None = None
                                     ) -> list[tuple[int, int]]:
    """(source, destination) list of the elastic hypercube matching: sit-outs
    and inactive replicas address themselves, so the permutation is total."""
    table = elastic_hypercube_partner_table(step, membership, seed=seed, groups=groups)
    return [(int(src), int(table[src])) for src in range(membership.world)]


def elastic_route_permutation(step: int, membership: Membership, *, seed: int = 0) -> np.ndarray:
    """The routed pipeline's permutation restricted to the active ids:
    ``route[i]`` is the replica whose activations replica ``i`` consumes;
    inactive replicas route to themselves.  With full membership it equals
    :func:`pairing_permutation`."""
    world = membership.world
    perm = pairing_permutation(step, world, seed=seed)
    route = np.arange(world, dtype=np.int64)
    active = set(membership.active_ids)
    targets = [int(r) for r in perm if int(r) in active]
    for slot, src in zip(sorted(active), targets):
        route[slot] = src
    return route
