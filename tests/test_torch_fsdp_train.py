"""The ``fsdp_hybrid`` plan through ``DistributedTrainer`` against JAX's.

TINY on two pods, each one replica whose weights are split ZeRO-3 style
over two data ranks: the port through the trainer API (``make_trainer(...,
plan=make_plan("fsdp_hybrid", 2, pod=2))``) on four ``gloo`` CPU ranks,
JAX's ``DistributedTrainer`` with ``make_plan("fsdp_hybrid", ...)`` on
``make_test_mesh(2, 1, pod=2)`` in one subprocess, both from JAX's initial
weights, 8 steps of m = 2 with a pairing pool of 2
(``tests/torch_dist_helpers.py``).  NoLoCo on the plain and the int8 wire
and DiLoCo, and one plain run with a model axis as well (pod 2 × data 2 ×
model 2: eight ranks, JAX on ``make_test_mesh(2, 2, pod=2)``): identical
partner tables, losses within 1e-5 relative at every step, final φ and θ
within ``CHURN_PHI_ATOL`` (the int8 wire by the existing int8 rule), and
the weight std and ``comm_bytes`` equal.  Each data rank's outer step is
one batched send/receive (NoLoCo) or one all-reduce (DiLoCo) with the rank
at its place in the other pod, carrying its shards.

A checkpoint written under ``fsdp_hybrid`` holds whole replicas: a run of
4 steps resumed to 8 equals the uninterrupted one bit for bit, and the
step-4 checkpoint resumes under ``gossip_dp`` (two ranks, one a replica)
and in JAX's ``DistributedProgram`` (its ``fsdp_hybrid`` mesh) onto the
same trajectory within the bounds above.
"""
import os
import shutil

import numpy as np
import pytest

import torch_dist_helpers as H

PODS, FSDP, MID = 2, 2, 4
LOSS_RTOL = 1e-5
# the weight std of two replicas after NoLoCo's symmetric pair update is
# a difference of nearly equal values (0 up to rounding on the plain
# wire, ~1e-5 on the int8 wire): held in absolute terms
WSTD_ATOL = 1e-8
INT8_WSTD_RTOL = 1e-3
# each data rank's copy of a norm leaf takes its own codes on the int8 wire
INT8_COPY_ATOL = 1e-2
CASES = [("noloco", {}), ("int8", {"codec": "int8"}), ("diloco", {"method": "diloco"})]
RUN = dict(data=PODS, fsdp=FSDP)
CKPT = [("full", dict(RUN, ckpt_dir="full", ckpt_every=MID)),
        ("half", dict(RUN, ckpt_dir="half", steps=MID)),
        ("resumed", dict(RUN, ckpt_dir="half", resume=True))]
STATE = ("theta", "phi", "delta", "mu", "nu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fsdp_train"))
    params = H.jax_params()
    kw = dict(data=FSDP, model=1, pod=PODS, plan="fsdp_hybrid", fast_compile=True)
    # the reference runs while the port's ranks do, in three subprocesses:
    # the straight runs without and with a model axis from the start, the
    # resume once the port has written its checkpoint
    jax = []
    for sub, cases in (("jax_runs", CASES), ("jax_tp", [("tp", {"model": 2})])):
        os.makedirs(os.path.join(root, sub))
        jax.append(H.start_jax_reference(os.path.join(root, sub), cases, params=params, **kw))
    port = H.spawn_port([(n, dict(c, **RUN)) for n, c in CASES] + CKPT, params, root,
                        data=PODS, fsdp=FSDP)
    name = f"step_{MID:08d}"
    for dst in ("for_jax", "for_gossip"):
        shutil.copytree(os.path.join(root, "half", name), os.path.join(root, dst, name))
    jax.append(H.start_jax_reference(root, [("from_port", {
        "ckpt_dir": os.path.join(root, "for_jax"), "resume": True})], resumed_only=True, **kw))
    tp = H.spawn_port([("tp", dict(RUN, model=2))], params, root, data=PODS, model=2,
                      fsdp=FSDP)
    gossip = H.spawn_port([("from_fsdp", {"ckpt_dir": "for_gossip", "resume": True,
                                          "data": PODS})], params, root, data=PODS)
    ref = {}
    for run in jax:
        ref.update(run.result())
    return {"root": root, "port": port, "tp": tp, "gossip": gossip, "jax": ref}


def _check(jax, ranks, case, per_replica, codec="none"):
    for rank in ranks:
        assert rank[case]["partners"] == [p.tolist() for p in jax["partners"]]
        assert rank[case]["pool"] == jax["pool"]
        assert rank[case]["comm_bytes"] == jax["summary"]["comm_bytes"]
        if codec == "int8":
            np.testing.assert_allclose(rank[case]["wstd"], jax["wstd"], rtol=INT8_WSTD_RTOL)
        else:
            np.testing.assert_allclose(rank[case]["wstd"], jax["wstd"], rtol=1e-5,
                                       atol=WSTD_ATOL)
    got = H.losses(ranks, case, per_replica)
    assert got.shape == jax["losses"].shape == (H.RUN["steps"], PODS)
    np.testing.assert_allclose(got, jax["losses"], rtol=LOSS_RTOL, atol=0)
    for key in ("phi", "theta"):
        H.assert_phi_close(H.rows(ranks, case, key, per_replica), jax[key], codec=codec,
                           atol=H.CHURN_PHI_ATOL)


@pytest.mark.parametrize("case", [n for n, _ in CASES])
def test_matches_the_reference(runs, case):
    _check(runs["jax"][case], runs["port"], case, FSDP, "int8" if case == "int8" else "none")


def test_matches_the_reference_with_a_model_axis(runs):
    _check(runs["jax"]["tp"], runs["tp"], "tp", FSDP * 2)


@pytest.mark.parametrize("case", [n for n, _ in CASES])
def test_data_ranks_of_a_pod_agree(runs, case):
    """A pod's data ranks report the same (pmean-ed) losses and hold the
    same whole replica once their shards are put together.  On the int8
    wire each rank codes its own fused buffer (its shards and its copy of
    the norms, the leaves held whole over the data axis), so the copies
    differ by a code step and each trains on from its own: within
    ``INT8_COPY_ATOL``, as the model ranks' copies in
    ``tests/test_torch_tp_train.py``."""
    port = runs["port"]
    for a, b in zip(port[0::2], port[1::2]):
        assert a[case]["losses"] == b[case]["losses"]
        for x, y in zip(H.leaves(a[case]["theta"]), H.leaves(b[case]["theta"])):
            if case == "int8":
                np.testing.assert_allclose(x, y, rtol=0, atol=INT8_COPY_ATOL)
            else:
                np.testing.assert_array_equal(x, y)


def test_each_rank_moves_its_own_shards(runs):
    """NoLoCo: one batched send/receive a round; DiLoCo: one all-reduce;
    no call across pods inside an inner step.  A pod's two data ranks
    together hand over its payload once, plus each one's copy of the
    leaves held whole over the data axis (the norms)."""
    port = runs["port"]
    for rank in port:
        noloco, diloco = rank["noloco"], rank["diloco"]
        assert noloco["calls"]["outer"]["batch_isend_irecv"] == 4
        assert diloco["calls"]["outer"]["all_reduce"] == 4
        assert "batch_isend_irecv" not in noloco["calls"]["inner"]
    payload = 4 * H.delta_nbytes()   # four rounds of Δ (fp32)
    for case, kind, per_round in (("noloco", "p2p", 2), ("diloco", "all_reduce", 1)):
        pod = port[0][case]["sent_bytes"][kind] + port[1][case]["sent_bytes"][kind]
        assert payload * per_round < pod < payload * per_round * 1.05


def test_resume_is_bit_identical(runs):
    for rank in runs["port"]:
        full, resumed = rank["full"], rank["resumed"]
        assert resumed["start_step"] == MID and rank["half"]["start_step"] == 0
        assert resumed["losses"] == full["losses"][MID:]
        for key in STATE:
            for a, b in zip(H.leaves(resumed[key]), H.leaves(full[key])):
                assert np.array_equal(a, b), key
        assert resumed["count"] == full["count"] and resumed["outer_step"] == full["outer_step"]


def test_checkpoint_holds_the_whole_replicas(runs):
    from repro_torch.checkpoint import ckpt

    tree = ckpt.restore(os.path.join(runs["root"], "full"), H.RUN["steps"])["program"]
    for got, want in zip(H.leaves(tree["theta"]),
                         H.leaves(H.rows(runs["port"], "full", "theta", FSDP))):
        assert got.shape == want.shape and got.shape[0] == PODS
        assert np.array_equal(got, want)


@pytest.mark.parametrize("who", ["jax", "gossip_dp"])
def test_checkpoint_resumes_under_another_plan(runs, who):
    full = runs["port"]
    if who == "jax":
        got = runs["jax"]["from_port"]
        assert got["start_step"] == MID
        losses, phi = got["losses"], got["phi"]
        partners = [p.tolist() for p in got["partners"]][MID // H.RUN["inner_steps"]:]
    else:
        ranks = runs["gossip"]
        assert ranks[0]["from_fsdp"]["start_step"] == MID
        losses, phi = H.losses(ranks, "from_fsdp"), H.rows(ranks, "from_fsdp", "phi")
        partners = ranks[0]["from_fsdp"]["partners"]
    np.testing.assert_allclose(losses, H.losses(full, "full", FSDP)[MID:], rtol=LOSS_RTOL,
                               atol=0)
    H.assert_phi_close(H.rows(full, "full", "phi", FSDP), phi, atol=H.CHURN_PHI_ATOL)
    assert partners == full[0]["full"]["partners"][MID // H.RUN["inner_steps"]:]
