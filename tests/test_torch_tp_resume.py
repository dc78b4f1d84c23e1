"""Checkpoints of the replica group with a model axis, on the CPU.

``tests/test_train_engine.py::test_distributed_entry_resumes`` mirrored:
TINY at ``--data 4 --model 2`` (eight ``gloo`` CPU ranks) for 8 steps of
m = 4 with a checkpoint every 4, from the port's own initial weights.  Rank
0 writes the whole replicas (the JAX package's global arrays), gathered
from the shards.  A run of 4 steps resumed to 8 equals the uninterrupted
run bit for bit (losses, θ, φ, δ, both AdamW moments, the counters).  The
checkpoint of step 4 does not depend on the plan: JAX's
``DistributedTrainer`` on ``make_test_mesh(4, 2)`` resumes it onto the
port's trajectory, and so does the port at ``--model 1`` (four ranks), each
with the partner tables of the straight run, losses within 1e-5 relative
and φ within ``CHURN_PHI_ATOL``.
"""
import os
import shutil

import numpy as np
import pytest

import torch_dist_helpers as H

DATA, MODEL, STEPS, M, MID = 4, 2, 8, 4, 4
RUN = dict(data=DATA, model=MODEL, inner_steps=M, steps=STEPS)
CASES = [
    ("full", dict(RUN, ckpt_dir="full", ckpt_every=MID)),
    ("half", dict(RUN, ckpt_dir="half", steps=MID)),
    ("resumed", dict(RUN, ckpt_dir="half", resume=True)),
]
STATE = ("theta", "phi", "delta", "mu", "nu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_ckpt"))
    ranks = H.spawn_port(CASES, None, root, data=DATA, model=MODEL)
    name = f"step_{MID:08d}"
    for dst in ("for_jax", "for_model1"):
        shutil.copytree(os.path.join(root, "half", name), os.path.join(root, dst, name))
    ref = H.jax_reference(root, [("from_port", {"ckpt_dir": os.path.join(root, "for_jax"),
                                                "resume": True, "inner_steps": M})],
                          resumed_only=True, data=DATA, model=MODEL)
    model1 = H.spawn_port([("from_tp", {"ckpt_dir": "for_model1", "resume": True,
                                        "inner_steps": M, "data": DATA})], None, root,
                          data=DATA, model=1)
    return {"root": root, "port": ranks, "jax": ref, "model1": model1}


def test_resume_is_bit_identical(runs):
    for rank in runs["port"]:
        full, resumed = rank["full"], rank["resumed"]
        assert resumed["start_step"] == MID and rank["half"]["start_step"] == 0
        assert resumed["losses"] == full["losses"][MID:]
        assert rank["half"]["losses"] == full["losses"][:MID]
        for key in STATE:
            for a, b in zip(H.leaves(resumed[key]), H.leaves(full[key])):
                assert np.array_equal(a, b), key
        assert resumed["count"] == full["count"] and resumed["outer_step"] == full["outer_step"]


def test_checkpoint_holds_the_whole_replicas(runs):
    from repro_torch.checkpoint import ckpt
    from repro_torch.comm import bytes_model
    from repro_torch.models.config import ModelConfig
    from repro_torch.tree import tree_leaves

    tree = ckpt.restore(os.path.join(runs["root"], "full"), STEPS)["program"]
    shapes = tree_leaves(bytes_model.abstract_params(ModelConfig(**H.TINY)))
    for got, want, shape in zip(H.leaves(tree["theta"]),
                                H.leaves(H.rows(runs["port"], "full", "theta", MODEL)),
                                shapes):
        assert got.shape == (DATA,) + tuple(shape.shape)
        assert np.array_equal(got, want)
    assert tree["opt"]["count"].tolist() == [STEPS] * DATA


@pytest.mark.parametrize("who", ["jax", "model1"])
def test_resumes_at_another_plan(runs, who):
    got = runs["jax"]["from_port"] if who == "jax" else None
    full = runs["port"]
    if who == "jax":
        assert got["start_step"] == MID
        losses, phi = got["losses"], got["phi"]
        partners = [p.tolist() for p in got["partners"]][MID // M:]   # JAX lists every round
    else:
        ranks = runs["model1"]
        assert ranks[0]["from_tp"]["start_step"] == MID
        losses = H.losses(ranks, "from_tp")
        phi = H.rows(ranks, "from_tp", "phi")
        partners = ranks[0]["from_tp"]["partners"]
    np.testing.assert_allclose(losses, H.losses(full, "full", MODEL)[MID:], rtol=1e-5, atol=0)
    H.assert_phi_close(H.rows(full, "full", "phi", MODEL), phi, atol=H.CHURN_PHI_ATOL)
    assert partners == full[0]["full"]["partners"][MID // M:]
