"""The recurrent families' NoLoCo runs against the JAX package's, on the CPU:
``test_torch_train.py``'s ``test_run_training_matches_jax`` for
mamba2-370m.reduced and recurrentgemma-9b.reduced at 3 layers (rglru,
local, rglru), in a file of their own so that a parallel run (one file a
worker) spreads the two packages' runs over workers.  Same inputs, same
tolerances: per-step losses within 1e-4 relative, final weight std within
1e-3, identical partner tables, bytes and telemetry.
"""
import pytest

from test_torch_train import check_run_training


@pytest.mark.parametrize("kind", ["mamba2-370m.reduced", "recurrentgemma-9b.reduced3"])
def test_run_training_matches_jax(kind, tmp_path, monkeypatch):
    """mamba2-370m: the JAX package's run turns NaN at step 10 here (its SSD
    twin's vjp, see ``test_torch_train._nan_safe_jnp_ssd_intra``), so its
    SSD op runs with that vjp made NaN-safe, the forward unchanged.  Its
    training then amplifies rounding: a one-ulp change of the port's own
    fp32 initial weights moves its losses by up to 3.2e-5 relative over
    these 20 steps, and the two packages' step-1 gradients, which differ by
    ~1e-6 relative (summation orders), put 1.8e-4 between their step-16
    losses.  Its losses are held to 1e-4 up to the first outer sync (step
    10: 2.7e-5) and must be finite at every step; the weight std (1.1e-4
    relative), partner tables, bytes and telemetry are held as for the
    other cases."""
    check_run_training("noloco", kind, tmp_path, monkeypatch)
