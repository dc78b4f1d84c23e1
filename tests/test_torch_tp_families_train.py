"""The model axis through outer steps for the MoE and a recurrent family.

granite-moe-1b-a400m and recurrentgemma-9b, each ``reduced()`` in fp32, on
two replicas of two model ranks: the port through the CLI's trainer
(``--data 2 --model 2``) on four ``gloo`` CPU ranks, JAX's
``DistributedTrainer`` on ``make_test_mesh(2, 2)`` over four forced host
devices in one subprocess, both from the port's initial weights, 4 steps of
m = 2 (two NoLoCo rounds: the MoE block's all-to-all over the model axis
and the RG-LRU scan's split width meet the outer step).  Identical partner
tables, losses within 1e-5 relative at every step, the weight std and
``comm_bytes`` equal, and the final φ and θ within ``CHURN_PHI_ATOL`` but
for a share ``MOVED`` of the values, each within ``FAR``.

Those few values are AdamW's: its first steps move a weight by about
lr · g / (|g| + eps), so where a gradient sits near zero a last-bit
difference of the two packages' sums moves the weight by a share of lr
(2e-3), and the outer step carries that into φ.  TINY (width 64) shows
none beyond ``CHURN_PHI_ATOL``; these configs (width 256, d_ff 512) show a
few in the weights of every layer, in pairs (the two replicas share the
NoLoCo update).  Measured on the CPU from the port's weights: 18 of
granite's 2,628,096 values beyond 2e-5 (the largest 7.28e-5 off) and 30 of
recurrentgemma-9b's 2,823,168 (the largest 1.58e-4); the losses within
3.6e-7 relative.  From JAX's weights: 6 (1.03e-4) and 32 (6.96e-5).
"""
import numpy as np
import pytest

import torch_dist_helpers as H

DATA, MODEL = 2, 2
ARCHS = ["granite-moe-1b-a400m", "recurrentgemma-9b"]
CASES = [(arch, {"arch": arch, "steps": 4, "params": H.port_params(H.arch_config(arch))})
         for arch in ARCHS]
MOVED = 1e-4
FAR = 5e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_families")
    # one reference run per arch, both running while the port's ranks do
    refs = []
    for case in CASES:
        (root / case[0]).mkdir()
        refs.append(H.start_jax_reference(str(root / case[0]), [case], data=DATA, model=MODEL,
                                          fast_compile=True))
    port = H.spawn_port([(n, dict(c, data=DATA, model=MODEL)) for n, c in CASES], None,
                        str(root), data=DATA, model=MODEL)
    jax = {}
    for ref in refs:
        jax.update(ref.result())
    return {"jax": jax, "port": port}


@pytest.mark.parametrize("arch", ARCHS)
def test_matches_the_reference_through_outer_steps(runs, arch):
    jax, port = runs["jax"][arch], runs["port"]
    assert len(jax["partners"]) == 2
    for rank in port:
        assert rank[arch]["partners"] == [p.tolist() for p in jax["partners"]]
        assert rank[arch]["comm_bytes"] == jax["summary"]["comm_bytes"]
        assert rank[arch]["calls"]["outer"]["batch_isend_irecv"] == 2
        np.testing.assert_allclose(rank[arch]["wstd"], jax["wstd"], rtol=1e-5, atol=1e-8)
    got = H.losses(port, arch, MODEL)
    assert got.shape == jax["losses"].shape == (4, DATA)
    np.testing.assert_allclose(got, jax["losses"], rtol=1e-5, atol=0)
    for key in ("phi", "theta"):
        got, want = H.leaves(H.rows(port, arch, key, MODEL)), H.leaves(jax[key])
        assert len(got) == len(want)
        diff = np.concatenate([np.abs(g - w).reshape(-1) for g, w in zip(got, want)])
        assert diff.max() <= FAR, diff.max()
        assert (diff > H.CHURN_PHI_ATOL).mean() <= MOVED, (diff > H.CHURN_PHI_ATOL).sum()
