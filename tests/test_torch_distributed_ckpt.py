"""Checkpoints of the port's replica group, on the CPU.

TINY on four ``gloo`` CPU ranks from the port's own initial weights, 8 steps
of m = 2 (``tests/torch_dist_helpers.py``).  Rank 0 writes JAX's
``DistributedProgram`` checkpoint tree, every replica's rows gathered.  A
run of 4 steps resumed to 8 equals the uninterrupted run of 8 bit for bit
(losses, θ, φ, δ, both AdamW moments and the counters); the port's stacked
``GossipProgram`` loads the distributed checkpoint with the same values;
and JAX's ``DistributedTrainer`` resumes the port's checkpoint of step 4
onto the port's trajectory (losses within 1e-4 relative, φ within 1e-5).
"""
import os
import shutil

import numpy as np
import pytest

import torch_dist_helpers as H

CASES = [
    ("full", {"ckpt_dir": "full", "ckpt_every": H.MID}),
    ("half", {"ckpt_dir": "half", "steps": H.MID}),
    ("resumed", {"ckpt_dir": "half", "resume": True}),
]
STATE = ("theta", "phi", "delta", "mu", "nu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    ranks = H.spawn_port(CASES, None, root)
    name = f"step_{H.MID:08d}"
    shutil.copytree(os.path.join(root, "half", name), os.path.join(root, "for_jax", name))
    ref = H.jax_reference(root, [("from_port", {"ckpt_dir": os.path.join(root, "for_jax"),
                                                "resume": True})], resumed_only=True)
    return {"root": root, "port": ranks, "jax": ref}


def test_resume_is_bit_identical(runs):
    for rank in runs["port"]:
        full, resumed = rank["full"], rank["resumed"]
        assert resumed["start_step"] == H.MID and rank["half"]["start_step"] == 0
        assert resumed["losses"] == full["losses"][H.MID:]
        assert rank["half"]["losses"] == full["losses"][:H.MID]
        for key in STATE:
            for a, b in zip(H.leaves(resumed[key]), H.leaves(full[key])):
                assert np.array_equal(a, b), key
        assert resumed["count"] == full["count"] and resumed["outer_step"] == full["outer_step"]


def test_writes_the_reference_layout(runs):
    from repro_torch.checkpoint import ckpt

    tree = ckpt.restore(os.path.join(runs["root"], "full"), H.RUN["steps"])["program"]
    assert sorted(tree) == ["delta", "inner_step", "opt", "outer_step", "phi", "theta"]
    assert sorted(tree["opt"]) == ["count", "mu", "nu"]
    assert tree["outer_step"].dtype == np.int32 and tree["outer_step"].tolist() == [4] * H.WORLD
    assert tree["opt"]["count"].tolist() == [H.RUN["steps"]] * H.WORLD
    assert int(tree["inner_step"]) == H.RUN["steps"]
    for got, want in zip(H.leaves(tree["phi"]), H.leaves(H.rows(runs["port"], "full", "phi"))):
        assert np.array_equal(got, want)


def tree_numpy(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().numpy(), tree)


def test_stacked_program_loads_the_distributed_checkpoint(runs):
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import OuterConfig, TrainerConfig
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import adapters

    cfg = ModelConfig(**H.TINY)
    tcfg = TrainerConfig(outer=OuterConfig(method="noloco", inner_steps=H.RUN["inner_steps"]),
                         inner=AdamWConfig(lr=H.RUN["lr"], weight_decay=0.0))
    program = adapters.GossipProgram(cfg, tcfg, replicas=H.WORLD, device="cpu")
    tree = ckpt.restore(os.path.join(runs["root"], "full"), H.RUN["steps"])["program"]
    state = program.load_state_pytree(None, tree)
    assert state.inner_step == H.RUN["steps"] and state.outer.step == 4
    assert state.opt.count.tolist() == [H.RUN["steps"]] * H.WORLD
    for key, got in (("theta", state.theta), ("phi", state.outer.phi),
                     ("delta", state.outer.delta), ("mu", state.opt.mu), ("nu", state.opt.nu)):
        for a, b in zip(H.leaves(tree_numpy(got)), H.leaves(H.rows(runs["port"], "full", key))):
            assert np.array_equal(a, b), key


def test_reference_resumes_the_port_checkpoint(runs):
    jax = runs["jax"]["from_port"]
    assert jax["start_step"] == H.MID
    np.testing.assert_allclose(jax["losses"], H.losses(runs["port"], "full")[H.MID:],
                               rtol=H.LOSS_RTOL, atol=0)
    H.assert_phi_close(H.rows(runs["port"], "full", "phi"), jax["phi"])
    assert [p.tolist() for p in jax["partners"]] == runs["port"][0]["full"]["partners"]
