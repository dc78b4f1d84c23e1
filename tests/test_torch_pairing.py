"""The port's gossip pairing against the JAX package's, on the CPU.

The JAX package draws each outer step's pairing as
``jax.random.permutation(fold_in(PRNGKey(seed), step), world)``; the port
reproduces it with a numpy threefry2x32 (``repro_torch.core.pairing``).
The tables must be identical, not close: a different pairing is a different
training run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import pairing as jpairing
from repro_torch.core import pairing

STEPS = np.arange(201)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pairing_permutations_identical(seed):
    """Every (step 0–200, world 1–33) permutation of the seed: JAX's, drawn
    with one vmapped call per world, against the port's numpy threefry."""
    base = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda s: jax.random.fold_in(base, s))(jnp.asarray(STEPS))
    for world in range(1, 34):
        want = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, world))(keys))
        got = np.stack([pairing.pairing_permutation(int(s), world, seed=seed) for s in STEPS])
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed} world {world}")


def test_partner_tables_identical():
    """partner_table and the full-membership elastic_partner_table, odd
    worlds included, against the JAX package's."""
    for seed in range(4):
        for world in (1, 2, 3, 4, 5, 7, 8, 9, 16, 31, 33):
            full = pairing.Membership.full(world)
            jfull = jpairing.Membership.full(world)
            for step in range(0, 201, 20):
                want = jpairing.partner_table(step, world, seed=seed)
                np.testing.assert_array_equal(pairing.partner_table(step, world, seed=seed), want)
                np.testing.assert_array_equal(
                    pairing.elastic_partner_table(step, full, seed=seed),
                    jpairing.elastic_partner_table(step, jfull, seed=seed))


def test_key_derivation_matches_jax():
    key = pairing.fold_in(pairing.prng_key(7), 123)
    jkey = jax.random.fold_in(jax.random.PRNGKey(7), 123)
    np.testing.assert_array_equal(key, np.asarray(jax.random.key_data(jkey)))
    np.testing.assert_array_equal(pairing.split(key), np.asarray(jax.random.split(jkey)))


