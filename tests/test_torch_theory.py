"""The port's ``core/theory.py`` and ``core/latency.py`` against the JAX
package's, on the CPU.

``theory.normal`` draws ``jax.random.normal`` from the port's threefry: the
same keys give normals within NORMAL_RTOL relative plus NORMAL_ATOL
(torch's ``erfinv`` and XLA's may differ in the last bits, most in the
tails: 2.7e-6 relative at |x| 3.9).
``simulate_quadratic`` at a small size (world 8, dim 32, 40 outer steps of
m 5), synchronous and with a 2× slow replica (``rates``) under both stale
rules, gives every trajectory within TRAJ_RTOL relative of JAX's and the
same staleness trace; the closed forms are the reference's functions of
the same arguments.  ``latency`` is a numpy copy: every function equals
JAX's for the same arguments and numpy seed.
"""
import jax
import numpy as np
import pytest

from repro.core import latency as jlatency
from repro.core import outer as jouter
from repro.core import theory as jtheory
from repro_torch.core import latency, outer, pairing, theory

NORMAL_RTOL, NORMAL_ATOL = 1e-5, 1e-6
TRAJ_RTOL = 1e-5
DIM = 32
EIGS = tuple(np.linspace(0.05, 1.0, DIM))
RUN = dict(world=8, outer_steps=40, inner_steps=5, seed=0)


@pytest.mark.parametrize("seed,shape", [(0, (8, 32)), (3, (5, 7)), (11, (1000,))])
def test_normal_matches_jax(seed, shape):
    key = pairing.prng_key(seed)
    for k in pairing.split(key, 3):
        got = theory.normal(k, shape, "cpu").numpy()
        want = np.asarray(jax.random.normal(jax.random.wrap_key_data(k.astype(np.uint32)),
                                            shape))
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_allclose(got, want, atol=NORMAL_ATOL, rtol=NORMAL_RTOL)


@pytest.mark.parametrize("case", ["sync", "rates-naive", "rates-momentum"])
def test_simulate_quadratic_matches_jax(case):
    stale = case.split("-")[1] if "-" in case else "naive"
    rates = None if case == "sync" else (1.0,) * 7 + (0.5,)
    got = theory.simulate_quadratic(theory.QuadraticModel(a_eigs=EIGS), rates=rates,
                                    cfg=outer.OuterConfig(stale=stale), device="cpu", **RUN)
    want = jtheory.simulate_quadratic(jtheory.QuadraticModel(a_eigs=EIGS), rates=rates,
                                      cfg=jouter.OuterConfig(stale=stale), **RUN)
    assert set(got) == set(want)
    for k in ("mean_norm", "replica_std", "var"):
        assert got[k].shape == want[k].shape == (RUN["outer_steps"] + 1,)
        np.testing.assert_allclose(got[k], want[k], rtol=TRAJ_RTOL, atol=0)
    if rates is not None:
        np.testing.assert_array_equal(got["staleness"], want["staleness"])
        assert got["staleness"].max() > 0   # the slow replica's Δ arrives a tick late
    assert got["mean_norm"][-1] < 0.2 * got["mean_norm"][0]   # E(φ) decays to its floor


def test_theory_closed_forms_and_refusals_match_jax():
    for alpha, beta, omega, m in ((0.5, 0.7, 0.1, 10), (0.3, 0.9, 0.5, 3), (0.9, 0.95, 2.0, 50)):
        np.testing.assert_array_equal(theory.expected_phi_spectrum(alpha, beta, omega, m, EIGS),
                                      jtheory.expected_phi_spectrum(alpha, beta, omega, m, EIGS))
        assert theory.expected_phi_converges(alpha, beta, omega, m, EIGS) \
            == jtheory.expected_phi_converges(alpha, beta, omega, m, EIGS)
    for alpha, gamma, n in ((0.5, 0.8, 2), (0.5, 2.0, 2), (0.3, 0.5, 4)):
        assert theory.variance_coefficient(alpha, gamma, n) \
            == jtheory.variance_coefficient(alpha, gamma, n)
        assert theory.variance_bounded(alpha, gamma, n) == jtheory.variance_bounded(alpha, gamma, n)
    for stale in ("naive", "momentum"):
        assert theory.staleness_floor(0.1, 1.0, 32, 0.5, stale) \
            == jtheory.staleness_floor(0.1, 1.0, 32, 0.5, stale)
    for rates, match in (((0.5,) * 7, "shape"), ((1.0,) * 7 + (1.5,), "lie in")):
        with pytest.raises(ValueError, match=match):
            theory.simulate_quadratic(theory.QuadraticModel(), rates=rates, device="cpu",
                                      **dict(RUN, outer_steps=1))


def test_latency_matches_jax():
    for name in ("expected_message_time", "expected_pairwise_max",
                 "pair_average_time_closed_form"):
        assert getattr(latency, name)(1.0, 0.7) == getattr(jlatency, name)(1.0, 0.7)
    for n in (2, 8, 64):
        assert latency.tree_allreduce_time_closed_form(n, 1.0, 0.7) \
            == jlatency.tree_allreduce_time_closed_form(n, 1.0, 0.7)
        assert latency.speedup_closed_form(n, 1.0, 0.7) == jlatency.speedup_closed_form(n, 1.0, 0.7)
        assert latency.tree_allreduce_time_bytes(n, 1.0, 0.7, payload_bytes=3e8) \
            == jlatency.tree_allreduce_time_bytes(n, 1.0, 0.7, payload_bytes=3e8)
        assert latency.simulate_tree_allreduce(n, 1.0, 0.7, rounds=50, seed=n) \
            == jlatency.simulate_tree_allreduce(n, 1.0, 0.7, rounds=50, seed=n)
    assert latency.transfer_time(1e9) == jlatency.transfer_time(1e9)
    assert latency.pair_average_time_bytes(1.0, 0.7, payload_bytes=1e8, bandwidth=1e9) \
        == jlatency.pair_average_time_bytes(1.0, 0.7, payload_bytes=1e8, bandwidth=1e9)
    assert latency.simulate_pair_average(1.0, 0.7, rounds=200, seed=4) \
        == jlatency.simulate_pair_average(1.0, 0.7, rounds=200, seed=4)
    assert latency.simulate_blocking_overhead(6, outer_rounds=20, inner_steps=10, seed=2) \
        == jlatency.simulate_blocking_overhead(6, outer_rounds=20, inner_steps=10, seed=2)
    assert latency.WAN_BANDWIDTH == jlatency.WAN_BANDWIDTH
    assert latency.__all__ == jlatency.__all__
