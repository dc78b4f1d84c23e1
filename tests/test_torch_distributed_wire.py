"""The port's replica group on the int8 wire, with DiLoCo and with the
FSDP baseline, against JAX's ``DistributedTrainer`` and the port's stacked
program, on the CPU.

TINY on four ``gloo`` CPU ranks against ``make_test_mesh(4, 1)``, 8 steps
of m = 2, a pairing pool of 2 (``tests/torch_dist_helpers.py``).  The int8
wire: identical partner tables, losses within 1e-4 relative, φ within
1e-4 but for at most 0.1% of its values, each within 2e-3 (a last-bit
difference may move a code of a chunk, and the next steps carry it on;
``tests/torch_dist_helpers.py``), one
batched send/receive a round carrying exactly the byte model's payload.
DiLoCo: losses within 1e-4, φ within 1e-5, one ``all_reduce`` of the fused
Δ a round, handing over Δ's bytes in its dtype (the byte model's ring
bytes are 2(w-1)/w of them), and no point-to-point call.  FSDP (``--method fsdp``, the
gradients all-reduced every step, no outer step): one ``all_reduce`` an
inner step, every rank's θ identical, and the trajectory of the port's
stacked FSDP program on the same objective within 1e-6.
"""
import numpy as np
import pytest
import torch

import torch_dist_helpers as H

CASES = [("int8", {"codec": "int8"}), ("diloco", {"method": "diloco"}),
         ("fsdp", {"method": "fsdp"})]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wire"))
    ref = H.jax_reference(root, CASES[:2])
    return {"jax": ref, "port": H.spawn_port(CASES, ref["params"], root)}


@pytest.mark.parametrize("case", ["int8", "diloco"])
def test_matches_the_reference(runs, case):
    jax, port = runs["jax"][case], runs["port"]
    for rank in port:
        assert rank[case]["partners"] == [p.tolist() for p in jax["partners"]]
        assert rank[case]["pool"] == jax["pool"]
    np.testing.assert_allclose(H.losses(port, case), jax["losses"], rtol=H.LOSS_RTOL, atol=0)
    H.assert_phi_close(H.rows(port, case, "phi"), jax["phi"], codec="int8" if case == "int8" else "none")


def test_int8_outer_step_moves_the_byte_model_payload(runs):
    for rank in runs["port"]:
        row = rank["int8"]
        assert row["calls"]["outer_steps"] == 4 and sum(row["calls"]["inner"].values()) == 0
        assert row["calls"]["outer"] == {"batch_isend_irecv": 4}
        assert row["comm"]["codec"] == "int8"
        assert row["sent_bytes"] == {"p2p": 4 * row["comm"]["payload_bytes"]}
        assert row["comm_bytes"] == 4 * row["comm"]["payload_bytes"]


def test_diloco_outer_step_is_an_all_reduce(runs):
    for rank in runs["port"]:
        calls = rank["diloco"]["calls"]
        assert calls["outer_steps"] == 4 and sum(calls["inner"].values()) == 0
        # TINY is fp32 throughout: the fused Δ is one buffer
        assert calls["outer"] == {"all_reduce": 4}, calls["outer"]
        # each sync hands over Δ's bytes in its own dtype, of which the byte
        # model's ring all-reduce sends 2(w-1)/w
        row = rank["diloco"]
        sent = row["sent_bytes"]["all_reduce"] // 4
        assert row["sent_bytes"] == {"all_reduce": 4 * sent}
        assert sent == H.delta_nbytes()
        assert row["comm"]["payload_bytes"] == round(sent * 2 * (H.WORLD - 1) / H.WORLD)
        assert row["comm_bytes"] == 4 * row["comm"]["payload_bytes"]


def test_fsdp_all_reduces_the_gradients_every_step(runs):
    port = runs["port"]
    for rank in port:
        calls = rank["fsdp"]["calls"]
        assert calls["outer_steps"] == 0
        assert calls["inner"] == {"all_reduce": H.RUN["steps"]}, calls["inner"]
    for leaf in H.leaves(H.rows(port, "fsdp", "theta")):
        assert all(np.array_equal(leaf[0], leaf[r]) for r in range(1, H.WORLD))


def test_fsdp_matches_the_stacked_baseline(runs):
    """The stacked program's FSDP baseline (``sync_grads``) on the same
    objective: the gradient mean is an all-reduce here and a mean over the
    replica axis there, so they agree to rounding."""
    from repro_torch.core import OuterConfig, TrainerConfig
    from repro_torch.data import LoaderConfig, shard_iterator
    from repro_torch.models import convert
    from repro_torch.models import model as model_api
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import adapters

    threads = H.torch_threads_one()
    cfg = ModelConfig(**H.TINY)
    tcfg = TrainerConfig(outer=OuterConfig(method="none", inner_steps=10**9),
                         inner=AdamWConfig(lr=H.RUN["lr"], weight_decay=0.0), sync_grads=True)
    program = adapters.GossipProgram(cfg, tcfg, replicas=H.WORLD, device="cpu")
    params = convert.params_from_jax_numpy(runs["jax"]["params"], cfg)
    program.initial_params = lambda: params
    program.trainer.loss_fn = lambda p, b: model_api.stacked_loss(p, cfg, b) / H.WORLD
    loader = shard_iterator(LoaderConfig(vocab_size=cfg.vocab_size, seq_len=H.RUN["seq"],
                                         per_replica_batch=H.RUN["batch_per_replica"],
                                         replicas=H.WORLD))
    state = program.init_state(None)
    got = H.losses(runs["port"], "fsdp")
    try:
        for t in range(H.RUN["steps"]):
            state, metrics = program.inner_step(state, next(loader))
            np.testing.assert_allclose(got[t], (metrics["loss"] * H.WORLD).numpy(), rtol=1e-6)
    finally:
        torch.set_num_threads(threads)
    for g, w in zip(H.leaves(H.rows(runs["port"], "fsdp", "theta")),
                    H.leaves(state.theta)):
        np.testing.assert_allclose(g, w.numpy() if hasattr(w, "numpy") else w, atol=1e-6)
