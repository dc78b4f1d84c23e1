"""Elastic and asynchronous rounds on the port's replica group, on the CPU.

TINY on four replicas (``tests/torch_dist_helpers.py``): the port as four
spawned ``gloo`` CPU ranks, each running its own ``SimCluster`` from the
same plan; JAX's ``DistributedTrainer`` under ``SimCluster`` on
``make_test_mesh(4, 1)`` in one subprocess.  Both start from JAX's initial
weights; m = 2 and a pairing pool of 16, so every round's slot is its
index and the port's stacked ``GossipProgram`` (which pairs round k by
key k) pairs as the pool does.

* The elastic plan, 16 steps: drop [3] at round 1, rejoin [3] at round 3
  (warm-started from replica 0), straggle [1] for one round at round 4,
  partition [[0, 1], [2, 3]] at round 5, heal at round 6.
* The 2× straggler: replica 1 at rate 0.5 from round 0, under the
  ``momentum`` and the ``naive`` stale rule.
* Two all-absent rounds (every member straggles round 1; after a drop the
  three left straggle round 3), 10 steps: the pool's one ``all-absent``
  entry, nothing moved, every counter advanced.

For each: ``SimCluster.rounds`` (partner tables included) and the pool's
``stats()`` equal JAX's, every active replica's losses within 1e-4
relative, φ within 1e-5 (the elastic plan's within 2e-5, see
``CHURN_PHI_ATOL``), and the ranks equal the port's stacked program
under the same plan bit for bit.  A rejoin is one send from the source
to the rejoining rank and no other rank's call; a NoLoCo sync makes no
``all_reduce``, a rank that sits a round out none at all, and a rank
that sits a step out launches nothing.  A rate-1 world is the
synchronous run bit for bit.  Resumes after churn (step 5, replica 3
out) and mid-async (step 7, the straggler half a phase in) equal the
uninterrupted runs bit for bit, and the port resumes JAX's elastic
checkpoint of step 5 onto JAX's trajectory.
"""
import os
import shutil

import numpy as np
import pytest

import torch_dist_helpers as H

M, STEPS, POOL = 2, 16, 16
ELASTIC = [{"kind": "drop", "round": 1, "replicas": [3]},
           {"kind": "rejoin", "round": 3, "replicas": [3], "source": 0},
           {"kind": "straggle", "round": 4, "replicas": [1], "rounds": 1},
           {"kind": "partition", "round": 5, "groups": [[0, 1], [2, 3]]},
           {"kind": "heal", "round": 6}]
# every member misses round 1 and the three left after a drop miss round 3:
# two all-absent rounds
ABSENT = [{"kind": "straggle", "round": 1, "replicas": [0, 1, 2, 3], "rounds": 1},
          {"kind": "drop", "round": 2, "replicas": [2]},
          {"kind": "straggle", "round": 3, "replicas": [0, 1, 3], "rounds": 1}]
STRAGGLER = [{"kind": "rate", "round": 0, "replicas": [1], "rate": 0.5}]
RATE1 = [{"kind": "rate", "round": 0, "replicas": [1], "rate": 1.0}]
CHURN_MID, ASYNC_MID = 5, 7
RUN = {"inner_steps": M, "steps": STEPS, "pairing_pool": POOL}
E = {**RUN, "events": ELASTIC}
A = {**RUN, "events": STRAGGLER, "stale": "momentum"}
A_NAIVE = {**RUN, "events": STRAGGLER, "stale": "naive"}
ALL_ABSENT = {**RUN, "steps": 5 * M, "events": ABSENT}
JAX_CASES = [("elastic", E), ("async", A), ("async_naive", A_NAIVE), ("all_absent", ALL_ABSENT),
             ("elastic_half", {**E, "steps": CHURN_MID, "ckpt_dir": "jax_half"})]
PORT_CASES = [
    ("elastic", E), ("async", A), ("async_naive", A_NAIVE), ("all_absent", ALL_ABSENT),
    ("plain", RUN), ("rate1", {**RUN, "events": RATE1, "stale": "momentum"}),
    ("elastic_half", {**E, "steps": CHURN_MID, "ckpt_dir": "churn"}),
    ("elastic_resumed", {**E, "ckpt_dir": "churn", "resume": True}),
    ("async_half", {**A, "steps": ASYNC_MID, "ckpt_dir": "async"}),
    ("async_resumed", {**A, "ckpt_dir": "async", "resume": True}),
    ("from_jax", {**E, "ckpt_dir": "from_jax", "resume": True}),
]
STATE = ("theta", "phi", "delta", "mu", "nu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("elastic"))
    cases = [(n, dict(c, ckpt_dir=os.path.join(root, c["ckpt_dir"])) if "ckpt_dir" in c else c)
             for n, c in JAX_CASES]
    ref = H.jax_reference(root, cases)
    name = f"step_{CHURN_MID:08d}"
    shutil.copytree(os.path.join(root, "jax_half", name), os.path.join(root, "from_jax", name))
    ranks = H.spawn_port(PORT_CASES, ref["params"], root)
    return {"jax": ref, "port": ranks}


def assert_phi_close(got, want, case):
    """φ within PHI_ATOL; the runs through a drop within CHURN_PHI_ATOL (see
    ``tests/torch_dist_helpers.py``: up to 1.46e-5 measured, JAX's own
    threading spread on the elastic plan 6.9e-5)."""
    churn = case in ("elastic", "from_jax", "all_absent")
    H.assert_phi_close(got, want, atol=H.CHURN_PHI_ATOL if churn else H.PHI_ATOL)


def active_losses(losses: np.ndarray) -> np.ndarray:
    """Every active replica's loss, step by step (NaN marks a sat-out step)."""
    return losses[~np.isnan(losses)]


@pytest.mark.parametrize("case", ["elastic", "async", "async_naive", "all_absent"])
def test_rounds_pool_and_losses_match_the_reference(runs, case):
    jax, port = runs["jax"][case], runs["port"]
    for rank in port:
        assert rank[case]["rounds"] == jax["rounds"]
        assert rank[case]["pool"] == jax["pool"]
    got = H.losses(port, case)
    assert np.array_equal(np.isnan(got), np.isnan(jax["losses"]))
    np.testing.assert_allclose(active_losses(got), active_losses(jax["losses"]),
                               rtol=H.LOSS_RTOL, atol=0)
    assert_phi_close(H.rows(port, case, "phi"), jax["phi"], case)
    np.testing.assert_allclose(port[0][case]["wstd"], jax["wstd"], rtol=1e-3)


def test_the_plans_do_what_they_say(runs):
    rounds = runs["port"][0]["elastic"]["rounds"]
    assert [r["round"] for r in rounds] == list(range(STEPS // M))
    assert [r["active"] for r in rounds[1:3]] == [[0, 1, 2], [0, 1, 2]]
    assert rounds[3]["active"] == [0, 1, 2, 3] and rounds[4]["absent"] == [1]
    assert rounds[4]["partner"][1] == 1
    assert rounds[5]["partition"] == [[0, 1], [2, 3]] and rounds[6]["partition"] is None
    assert rounds[5]["partner"] == [1, 0, 3, 2]
    absent = runs["port"][0]["all_absent"]
    assert [r["absent"] for r in absent["rounds"]] == [[], [0, 1, 2, 3], [], [0, 1, 3], []]
    assert absent["rounds"][1]["partner"] == absent["rounds"][3]["partner"] == [0, 1, 2, 3]
    assert absent["pool"]["pool_size"] == 4   # the all-absent entry once, used twice
    ticks = runs["port"][0]["async"]["rounds"]
    assert any(1 not in r["due"] for r in ticks)
    assert any(1 in r["due"] and r["staleness"][1] == 1 for r in ticks)
    for case in ("async", "async_naive"):
        summary = runs["port"][0][case]["summary"]
        assert (summary["max_staleness"], summary["blocked_syncs"]) == (1, 0)
        assert summary == {k: runs["jax"][case]["summary"][k] for k in summary}


@pytest.mark.parametrize("case, events, stale", [("elastic", ELASTIC, "naive"),
                                                  ("async", STRAGGLER, "momentum"),
                                                  ("all_absent", ABSENT, "naive")])
def test_equals_the_stacked_program_under_the_same_plan(runs, case, events, stale):
    """Every active replica's loss and the final θ and φ bit for bit."""
    steps = {"all_absent": ALL_ABSENT["steps"]}.get(case, STEPS)
    stacked = H.stacked_run(runs["jax"]["params"], events, steps=steps, inner_steps=M,
                            stale=stale)
    got = H.losses(runs["port"], case)
    np.testing.assert_array_equal(got, stacked["losses"])
    assert stacked["rounds"] == runs["port"][0][case]["rounds"]
    final = stacked["state"]
    for key, tree in (("theta", final.theta), ("phi", final.outer.phi)):
        for a, b in zip(H.leaves(H.rows(runs["port"], case, key)),
                        H.leaves(tree)):
            assert np.array_equal(a, b), key


def test_rejoin_is_one_send_and_syncs_make_no_all_reduce(runs):
    """The warm start: rank 0 sends, rank 3 receives, in one call each, and
    the others make none.  Every sync: one send/receive on a rank paired
    with another, nothing on a rank paired with itself, no all-reduce."""
    for case in ("elastic", "async", "all_absent"):
        for r, rank in enumerate(runs["port"]):
            calls = rank[case]["calls"]
            if case == "elastic":
                want = {0: {"batch_isend_irecv": 1}, 3: {"batch_isend_irecv": 1}}.get(r, {})
                assert calls["warm"] == [want], (r, calls["warm"])
            assert sum(calls["inner"].values()) == 0, calls["inner"]
            paired = sum(rec["partner"][r] != r for rec in rank[case]["rounds"])
            assert calls["outer"] == ({"batch_isend_irecv": paired} if paired else {}), (
                r, calls["outer"])


def test_a_rank_that_sits_a_step_out_makes_no_step(runs):
    """A rank's AdamW count is the steps it took: the ones its loss is not
    NaN for (replica 3's count restarts at its warm start)."""
    for case in ("elastic", "async"):
        for r, rank in enumerate(runs["port"]):
            row = rank[case]
            took = int((~np.isnan(np.asarray(row["losses"]))).sum())
            since = 3 * M if case == "elastic" and r == 3 else 0
            assert row["count"] == [took - (since and took - (STEPS - since))], (case, r)
    assert int(np.isnan(H.losses(runs["port"], "async")[:, 1]).sum()) == STEPS // 2


def test_rate_one_world_is_the_synchronous_run(runs):
    rank_rows = runs["port"]
    np.testing.assert_array_equal(H.losses(rank_rows, "rate1"), H.losses(rank_rows, "plain"))
    for key in STATE:
        for a, b in zip(H.leaves(H.rows(rank_rows, "rate1", key)),
                        H.leaves(H.rows(rank_rows, "plain", key))):
            assert np.array_equal(a, b), key
    assert rank_rows[0]["rate1"]["summary"]["max_staleness"] == 0


@pytest.mark.parametrize("whole, resumed, mid", [("elastic", "elastic_resumed", CHURN_MID),
                                                 ("async", "async_resumed", ASYNC_MID)])
def test_resume_is_bit_identical(runs, whole, resumed, mid):
    for rank in runs["port"]:
        assert rank[resumed]["start_step"] == mid
        np.testing.assert_array_equal(rank[resumed]["losses"], rank[whole]["losses"][mid:])
        for key in STATE:
            for a, b in zip(H.leaves(rank[resumed][key]), H.leaves(rank[whole][key])):
                assert np.array_equal(a, b), key
        assert rank[resumed]["count"] == rank[whole]["count"]
        n = len(rank[resumed]["rounds"])
        assert n and rank[resumed]["rounds"] == rank[whole]["rounds"][-n:]


def test_resumes_the_reference_elastic_checkpoint(runs):
    jax, port = runs["jax"]["elastic"], runs["port"]
    assert all(r["from_jax"]["start_step"] == CHURN_MID for r in port)
    got = H.losses(port, "from_jax")
    want = jax["losses"][CHURN_MID:]
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(active_losses(got), active_losses(want), rtol=H.LOSS_RTOL, atol=0)
    assert_phi_close(H.rows(port, "from_jax", "phi"), jax["phi"], "from_jax")
    n = len(port[0]["from_jax"]["rounds"])
    assert port[0]["from_jax"]["rounds"] == jax["rounds"][-n:]
