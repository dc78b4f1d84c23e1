"""The port's replica group (``repro_torch.launch.train_distributed``) against
JAX's ``DistributedTrainer`` and the port's stacked program, on the CPU.

TINY (``tests/test_multidevice.py``'s config) on four replicas: the port as
four spawned ``gloo`` CPU ranks, JAX on ``make_test_mesh(4, 1)`` over four
forced host devices in one subprocess.  Both start from JAX's initial
weights and run 8 steps of m = 2 with a pairing pool of 2, so rounds 2 and
3 reuse the pool's slots.  NoLoCo on the plain wire with the random and the
hypercube schedule: identical partner tables and pool stats, per-replica
losses within 1e-4 relative, final φ within 1e-5.  The NoLoCo outer step
makes one batched send/receive and no ``all_reduce``; the inner steps make
no cross-rank call.  The port's ranks equal its stacked ``GossipProgram``
bit for bit while the rounds stay below the pool size (the stacked program
pairs round k by ``partner_table(k)``, the pool by slot ``k % 2``).  And the
port resumes JAX's checkpoint of step 4 onto JAX's trajectory.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import torch_dist_helpers as H

CASES = [
    ("noloco", {}),
    ("hypercube", {"schedule": "hypercube"}),
    ("from_jax", {"ckpt_dir": "from_jax", "resume": True}),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist"))
    jax_dir = os.path.join(root, "jax_ckpt")
    ref = H.jax_reference(root, [("noloco", {"ckpt_dir": jax_dir, "ckpt_every": H.MID}),
                                 ("hypercube", {"schedule": "hypercube"})])
    name = f"step_{H.MID:08d}"
    shutil.copytree(os.path.join(jax_dir, name), os.path.join(root, "from_jax", name))
    ranks = H.spawn_port(CASES, ref["params"], root)
    return {"jax": ref, "port": ranks}


@pytest.mark.parametrize("case", ["noloco", "hypercube"])
def test_partners_and_pool_match_the_reference(runs, case):
    jax, port = runs["jax"][case], runs["port"]
    want = [p.tolist() for p in jax["partners"]]
    assert len(want) == 4
    for rank in port:
        assert rank[case]["partners"] == want
        assert rank[case]["pool"] == jax["pool"]
    if case == "noloco":   # the pool cycles: rounds 2, 3 take slots 0, 1
        assert want[2:] == want[:2] and jax["pool"]["misses"] == 2 and jax["pool"]["hits"] == 2


@pytest.mark.parametrize("case", ["noloco", "hypercube"])
def test_losses_and_phi_match_the_reference(runs, case):
    jax = runs["jax"][case]
    np.testing.assert_allclose(H.losses(runs["port"], case), jax["losses"],
                               rtol=H.LOSS_RTOL, atol=0)
    H.assert_phi_close(H.rows(runs["port"], case, "phi"), jax["phi"])
    np.testing.assert_allclose(runs["port"][0][case]["wstd"], jax["wstd"], rtol=1e-3)


def test_noloco_outer_step_is_one_send_receive_and_no_all_reduce(runs):
    for rank in runs["port"]:
        calls = rank["noloco"]["calls"]
        assert calls["outer_steps"] == 4
        assert sum(calls["inner"].values()) == 0, calls["inner"]
        assert calls["outer"] == {"batch_isend_irecv": 4}, calls["outer"]
        # every byte handed to the sends is the byte model's (Δ, φ) payload
        assert rank["noloco"]["sent_bytes"] == {"p2p": rank["noloco"]["comm_bytes"]}
        assert rank["noloco"]["comm_bytes"] == 4 * rank["noloco"]["comm"]["payload_bytes"]


def test_resumes_the_reference_checkpoint(runs):
    jax, port = runs["jax"]["noloco"], runs["port"]
    assert all(r["from_jax"]["start_step"] == H.MID for r in port)
    np.testing.assert_allclose(H.losses(port, "from_jax"), jax["losses"][H.MID:],
                               rtol=H.LOSS_RTOL, atol=0)
    H.assert_phi_close(H.rows(port, "from_jax", "phi"), jax["phi"])


def test_equals_the_stacked_program_below_the_pool_size(runs):
    """The stacked program descending the mean of the replicas' losses (the
    distributed objective) equals the ranks bit for bit through the first
    two rounds (with the same partner tables)."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import OuterConfig, TrainerConfig
    from repro_torch.data import LoaderConfig, shard_iterator
    from repro_torch.models import convert
    from repro_torch.models import model as model_api
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import adapters

    threads = H.torch_threads_one()
    cfg = ModelConfig(**H.TINY)
    tcfg = TrainerConfig(outer=OuterConfig(method="noloco", alpha=0.5, beta=0.7,
                                           inner_steps=H.RUN["inner_steps"]),
                         inner=AdamWConfig(lr=H.RUN["lr"], weight_decay=0.0), comm=CommConfig())
    program = adapters.GossipProgram(cfg, tcfg, replicas=H.WORLD, device="cpu")
    params = convert.params_from_jax_numpy(runs["jax"]["params"], cfg)
    program.initial_params = lambda: params
    program.trainer.loss_fn = lambda p, b: model_api.stacked_loss(p, cfg, b) / H.WORLD
    loader = shard_iterator(LoaderConfig(vocab_size=cfg.vocab_size, seq_len=H.RUN["seq"],
                                         per_replica_batch=H.RUN["batch_per_replica"],
                                         replicas=H.WORLD))
    state = program.init_state(None)
    # the losses of the steps that only rounds 0 and 1 precede: 3 rounds of m
    steps = 3 * H.RUN["inner_steps"]
    got = H.losses(runs["port"], "noloco")
    try:
        for t in range(steps):
            state, metrics = program.inner_step(state, next(loader))
            assert np.array_equal((metrics["loss"] * H.WORLD).numpy(), got[t]), t
            state, _ = program.maybe_outer_step(state)
    finally:
        torch.set_num_threads(threads)
    tables = [p.tolist() for p in program.partners]
    assert tables[:2] == runs["port"][0]["noloco"]["partners"][:2]
