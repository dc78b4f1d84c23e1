"""Streamed outer steps on the port's replica group, on the CPU.

TINY on four replicas (``tests/torch_dist_helpers.py``): the port as four
spawned ``gloo`` CPU ranks, JAX's ``DistributedTrainer`` on
``make_test_mesh(4, 1)`` in a subprocess;
m = 4 and a pairing pool of 16.  The port runs first, from JAX's initial
weights (drawn in the test's process); one JAX process then runs from the
same weights and resumes the port's checkpoint.  Each stream's φ′ pre-send is posted
without a wait and waited at the stream's next sync.

* One stream with the §3.2 overlap and four streams, 16 steps, healthy:
  the ``stream_sync`` events and pool stats equal JAX's, each stream's
  first sync blocks and the later ones consume, losses within 1e-4
  relative, φ within 1e-5.
* The streamed churn (``tests/test_streaming.py``'s plan on four
  replicas): 4 streams, replica 3 out over steps 9–16, 22 steps.  Round
  records, ``stream_sync`` events (``epoch_fallback`` included: at most
  one per stream per membership change), pool stats and losses equal
  JAX's, φ within ``CHURN_PHI_ATOL`` (2e-5, measured 1.55e-5).
* Four streams on the plain and the int8 wire equal the port's stacked
  ``GossipProgram`` bit for bit, the churn too.
* Bytes: a consuming sync sends exactly the byte model's
  ``blocking_bytes`` for the stream (Δ) and its pre-send the rest of the
  stream's ``payload_bytes`` (φ′); a blocking sync sends the stream's
  (Δ, φ) payload; a rank paired with itself sends nothing; no sync makes
  an ``all_reduce``.
* A run resumed mid-stream (step 11: replica 3 out, every stream's
  pre-send in flight) equals the uninterrupted run bit for bit, and JAX's
  ``DistributedTrainer`` resumes that checkpoint of the port onto the
  port's trajectory.
"""
import json
import os
import shutil

import numpy as np
import pytest

import torch_dist_helpers as H

M, STEPS, POOL, STREAMS = 4, 16, 16, 4
CHURN = [{"kind": "drop", "step": 9, "replicas": [3]},
         {"kind": "rejoin", "step": 17, "replicas": [3]}]
CHURN_STEPS, MID = 22, 11
RUN = {"inner_steps": M, "steps": STEPS, "pairing_pool": POOL}
S1 = {**RUN, "overlap": True, "log_jsonl": "s1.jsonl"}
S4 = {**RUN, "streams": STREAMS, "log_jsonl": "s4.jsonl"}
C = {**RUN, "streams": STREAMS, "steps": CHURN_STEPS, "events": CHURN, "log_jsonl": "c.jsonl"}
PORT_CASES = [
    ("s1", S1), ("s4", S4), ("s4_int8", {**S4, "codec": "int8", "log_jsonl": None}),
    ("churn", C), ("churn_half", {**C, "steps": MID, "ckpt_dir": "half", "log_jsonl": None}),
    ("churn_resumed", {**C, "ckpt_dir": "half", "resume": True, "log_jsonl": None}),
]
STATE = ("theta", "phi", "delta", "mu", "nu")


def jax_case(case: dict, root: str, prefix: str) -> dict:
    out = dict(case)
    if out.get("log_jsonl"):
        out["log_jsonl"] = os.path.join(root, prefix + out["log_jsonl"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port first, from JAX's initial weights drawn here; then one JAX
    process from the same weights, which also resumes the port's
    checkpoint."""
    root = str(tmp_path_factory.mktemp("stream"))
    params = H.jax_params()
    ranks = H.spawn_port(PORT_CASES, params, root)
    name = f"step_{MID:08d}"
    shutil.copytree(os.path.join(root, "half", name), os.path.join(root, "for_jax", name))
    cases = [(n, jax_case(c, root, "jax-")) for n, c in (("s1", S1), ("s4", S4), ("churn", C))]
    cases.append(("from_port", {**C, "log_jsonl": None, "resume": True,
                                "ckpt_dir": os.path.join(root, "for_jax")}))
    ref = H.jax_reference(root, cases, params=params)
    return {"root": root, "jax": ref, "port": ranks, "params": params}


def events(path, kind="stream_sync"):
    return [{k: v for k, v in e.items() if k != "run"}
            for e in map(json.loads, open(path)) if e["event"] == kind]


@pytest.mark.parametrize("case", ["s1", "s4", "churn"])
def test_events_pool_and_losses_match_the_reference(runs, case):
    root, jax, port = runs["root"], runs["jax"][case], runs["port"]
    log = PORT_CASES[[n for n, _ in PORT_CASES].index(case)][1]["log_jsonl"]
    got, want = events(os.path.join(root, log)), events(os.path.join(root, "jax-" + log))
    assert got == want and len(got) == port[0][case]["summary"]["outer_syncs"]
    for rank in port:
        assert rank[case]["pool"] == jax["pool"]
        assert rank[case]["rounds"] == jax["rounds"]
    got_l = H.losses(port, case)
    assert np.array_equal(np.isnan(got_l), np.isnan(jax["losses"]))
    np.testing.assert_allclose(got_l[~np.isnan(got_l)], jax["losses"][~np.isnan(got_l)],
                               rtol=H.LOSS_RTOL, atol=0)
    H.assert_phi_close(H.rows(port, case, "phi"), jax["phi"],
                       atol=H.CHURN_PHI_ATOL if case == "churn" else H.PHI_ATOL)


@pytest.mark.parametrize("case", ["s1", "s4", "s4_int8"])
def test_first_sync_of_each_stream_blocks_and_the_rest_consume(runs, case):
    syncs = [s["event"] for s in runs["port"][0][case]["calls"]["syncs"]]
    from repro_torch.core.outer import StreamSchedule

    streams = STREAMS if case != "s1" else 1
    schedule = StreamSchedule(M, streams)
    assert len(syncs) == sum(schedule.due(t) is not None for t in range(1, STEPS + 1))
    seen = set()
    for ev in syncs:
        assert ev["blocked"] == (ev["stream"] not in seen), ev
        assert not ev["epoch_fallback"]
        seen.add(ev["stream"])
    assert seen == set(range(streams))


def test_churn_falls_back_at_most_once_per_stream_per_change(runs):
    syncs = [s["event"] for s in runs["port"][0]["churn"]["calls"]["syncs"]]
    fallbacks = [ev for ev in syncs if ev["epoch_fallback"]]
    assert fallbacks
    per_stream = {}
    for ev in fallbacks:
        per_stream[ev["stream"]] = per_stream.get(ev["stream"], 0) + 1
    assert max(per_stream.values()) <= 2   # two membership changes: the drop, the rejoin


@pytest.mark.parametrize("case", ["s1", "s4", "s4_int8", "churn"])
def test_sync_and_presend_bytes_are_the_byte_model(runs, case):
    """Per rank and sync: the blocking exchange sends the stream's
    ``blocking_bytes`` (Δ when consuming, the (Δ, φ) payload when not) and
    the pre-send the stream's ``payload_bytes - blocking_bytes`` of a
    consuming sync (φ′), unless the table pairs the rank with itself."""
    for r, rank in enumerate(runs["port"]):
        row = rank[case]
        assert "all_reduce" not in row["calls"]["outer"] and not sum(row["calls"]["inner"].values())
        rounds = {rec["round"]: rec for rec in row["rounds"] or []}
        pre_bytes = {}
        for sync in row["calls"]["syncs"]:
            ev = sync["event"]
            partner = rounds[ev["sync_index"]]["partner"] if rounds else None
            paired = partner is None or partner[r] != r
            if ev["blocked"]:
                want_blocking = ev["payload_bytes"] if case != "s4_int8" else None
            else:
                want_blocking = ev["blocking_bytes"]
                pre_bytes.setdefault(ev["stream"], ev["payload_bytes"] - ev["blocking_bytes"])
            got_blocking = sync["sent"].get("p2p", 0)
            if not paired:
                assert got_blocking == 0
            elif want_blocking is not None:
                assert got_blocking == want_blocking, (r, ev, sync["sent"])
            pre_paired = sync["pre_partner"][r] != r
            got_pre = sync["sent"].get("presend", 0)
            if not pre_paired:
                assert got_pre == 0
            elif ev["stream"] in pre_bytes:
                assert got_pre == pre_bytes[ev["stream"]], (r, ev, sync["sent"])
        assert sorted(pre_bytes) == list(range(STREAMS if case != "s1" else 1))


@pytest.mark.parametrize("case, codec, events, steps", [
    ("s4", "none", None, STEPS), ("s4_int8", "int8", None, STEPS),
    ("churn", "none", CHURN, CHURN_STEPS)])
def test_equals_the_stacked_program(runs, case, codec, events, steps):
    stacked = H.stacked_run(runs["params"], events, steps=steps, inner_steps=M,
                            streams=STREAMS, codec=codec)
    np.testing.assert_array_equal(H.losses(runs["port"], case), stacked["losses"])
    final = stacked["state"]
    for key, tree in (("theta", final.theta), ("phi", final.outer.phi)):
        for a, b in zip(H.leaves(H.rows(runs["port"], case, key)), H.leaves(tree)):
            assert np.array_equal(a, b), key


def test_resume_mid_stream_is_bit_identical(runs):
    for rank in runs["port"]:
        whole, resumed = rank["churn"], rank["churn_resumed"]
        assert resumed["start_step"] == MID
        np.testing.assert_array_equal(resumed["losses"], whole["losses"][MID:])
        for key in STATE:
            for a, b in zip(H.leaves(resumed[key]), H.leaves(whole[key])):
                assert np.array_equal(a, b), key
        n = len(resumed["rounds"])
        assert n and resumed["rounds"] == whole["rounds"][-n:]
        syncs = [s["event"] for s in resumed["calls"]["syncs"]]
        assert syncs == [s["event"] for s in whole["calls"]["syncs"]][-len(syncs):]


def test_reference_resumes_the_port_mid_stream(runs):
    from repro_torch.checkpoint import ckpt

    tree = ckpt.restore(os.path.join(runs["root"], "half"), MID)["program"]
    assert {"phi_pre", "stream", "membership", "sim"} <= set(tree)
    assert tree["membership"]["mask"].tolist() == [True, True, True, False]
    jax = runs["jax"]["from_port"]
    assert jax["start_step"] == MID
    want = H.losses(runs["port"], "churn")[MID:]
    assert np.array_equal(np.isnan(jax["losses"]), np.isnan(want))
    np.testing.assert_allclose(jax["losses"][~np.isnan(want)], want[~np.isnan(want)],
                               rtol=H.LOSS_RTOL, atol=0)
    H.assert_phi_close(jax["phi"], H.rows(runs["port"], "churn", "phi"), atol=H.CHURN_PHI_ATOL)
