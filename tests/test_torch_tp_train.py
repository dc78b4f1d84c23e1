"""The replica group with a model axis against JAX's ``DistributedTrainer``.

TINY on two replicas of two model ranks: the port through the CLI's
trainer (``--data 2 --model 2``) on four ``gloo`` CPU ranks, JAX on
``make_test_mesh(2, 2)`` over four forced host devices in one subprocess,
both from JAX's initial weights, 8 steps of m = 2 with a pairing pool of 2
(``tests/torch_dist_helpers.py``).  NoLoCo on the plain and the int8 wire,
DiLoCo and the FSDP baseline (``--method fsdp``): identical partner tables,
losses within 1e-5 relative at every step, final φ and θ within
``CHURN_PHI_ATOL`` (2e-5; the int8 wire by the existing int8 rule: 1e-4
but for 0.1% of the values, each within ``INT8_PHI_ATOL``), and the weight
std, pool stats and ``comm_bytes`` equal.  Each rank's outer step makes one
batched send/receive (NoLoCo) or one all-reduce (DiLoCo) with the rank of
its model index in the other replica, carrying its shards: the two model
ranks of a replica together hand over the replica's payload once, plus
the whole leaves that each holds a copy of.  The measured maxima are in
``CHANGES.md``.
"""
import numpy as np
import pytest

import torch_dist_helpers as H

DATA, MODEL = 2, 2
LOSS_RTOL = 1e-5
# the weight std over 2 replicas after the int8 wire is ~7.7e-6, a
# difference of the replicas, so a moved code of a chunk shows in it:
# measured 6.3e-5 relative (4.8e-10 absolute)
INT8_WSTD_RTOL = 1e-3
# each model rank's copy of a whole leaf takes its own codes on the int8
# wire every round and trains on from there: after 4 rounds the copies of
# TINY's w_k differ by up to 5.3e-3 (measured)
INT8_COPY_ATOL = 1e-2
CASES = [("noloco", {}), ("int8", {"codec": "int8"}), ("diloco", {"method": "diloco"}),
         ("fsdp", {"method": "fsdp"})]
PORT = [(n, dict(c, data=DATA, model=MODEL)) for n, c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_train"))
    ref = H.jax_reference(root, CASES, data=DATA, model=MODEL)
    return {"jax": ref, "port": H.spawn_port(PORT, ref["params"], root, data=DATA, model=MODEL)}


@pytest.mark.parametrize("case", [n for n, _ in CASES])
def test_matches_the_reference(runs, case):
    jax, port = runs["jax"][case], runs["port"]
    for rank in port:
        assert rank[case]["partners"] == [p.tolist() for p in jax["partners"]]
        assert rank[case]["pool"] == jax["pool"]
        assert rank[case]["comm_bytes"] == jax["summary"]["comm_bytes"]
        np.testing.assert_allclose(rank[case]["wstd"], jax["wstd"],
                                   rtol=INT8_WSTD_RTOL if case == "int8" else 1e-5)
    got = H.losses(port, case, MODEL)
    assert got.shape == jax["losses"].shape == (H.RUN["steps"], DATA)
    np.testing.assert_allclose(got, jax["losses"], rtol=LOSS_RTOL, atol=0)
    codec = "int8" if case == "int8" else "none"
    for key in ("phi", "theta"):
        H.assert_phi_close(H.rows(port, case, key, MODEL), jax[key], codec=codec,
                           atol=H.CHURN_PHI_ATOL)


@pytest.mark.parametrize("case", [n for n, _ in CASES])
def test_model_ranks_of_a_replica_agree(runs, case):
    """A replica's two model ranks report the same losses and hold the same
    whole replica once their shards are put together.  On the int8 wire
    each rank codes its own fused buffer (its shards and its copy of the
    whole leaves), so the chunks' ranges differ and the whole leaves'
    copies differ by a code step, as each device of JAX's mesh keeps its own
    copy (JAX reports model index 0's), and each trains on from its own:
    within ``INT8_COPY_ATOL``."""
    port = runs["port"]
    for a, b in zip(port[0::2], port[1::2]):
        assert a[case]["losses"] == b[case]["losses"]
        for x, y in zip(H.leaves(a[case]["theta"]), H.leaves(b[case]["theta"])):
            if case == "int8":
                np.testing.assert_allclose(x, y, rtol=0, atol=INT8_COPY_ATOL)
            else:
                np.testing.assert_array_equal(x, y)


def test_outer_steps_move_each_ranks_shards(runs):
    port = runs["port"]
    for rank in port:
        noloco, diloco = rank["noloco"], rank["diloco"]
        assert noloco["calls"]["outer"]["batch_isend_irecv"] == 4
        assert noloco["sent_bytes"]["p2p"] > 0 and "all_reduce" not in noloco["sent_bytes"]
        assert diloco["calls"]["outer"]["all_reduce"] == 4
    for case, kind in (("noloco", "p2p"), ("diloco", "all_reduce")):
        per_replica = port[0][case]["sent_bytes"][kind] + port[1][case]["sent_bytes"][kind]
        # a replica's ranks send its payload once, and each its copy of the whole leaves
        assert per_replica > 4 * H.delta_nbytes() * (2 if case == "noloco" else 1)
