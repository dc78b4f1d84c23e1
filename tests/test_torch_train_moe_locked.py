"""The MoE family's training against the JAX package's, step-locked, on
the CPU: granite-moe-1b-a400m.reduced over ``test_torch_train.py``'s run
(20 steps, m 10, 4 replicas), each step of the port starting from the
reference's state, so that the free-running trajectories' routing flip
(``tests/test_torch_train_moe.py``) cannot hide a fault of any later step.
A file of its own so that a parallel run spreads it.

Tolerances: one step's per-replica losses from the same state within 1e-5
relative (fp32 sums in another order); the replicas' weight std after each
sync and the last step within 1e-3 relative, as the whole runs'; identical
partner tables.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pairing as jpairing
from repro_torch.comm import bytes_model, payload
from repro_torch.data import LoaderConfig, shard_iterator
from repro_torch.launch import train as train_cli
from test_torch_train import RUN, _configs
from test_torch_train_moe import KIND, _host_tree, _programs

LOCKED_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: these small CPU runs gain
    nothing from more, and in a parallel test run the other workers'
    multi-device JAX subprocesses need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method,codec", [("noloco", "none"), ("noloco", "int8")])
def test_step_locked_run_matches_jax(method, codec, monkeypatch):
    """Every step of the run from the reference's state (θ, AdamW, φ, δ and
    the step counters converted into the port before each step): the
    step's per-replica losses within 1e-5 relative, the same sync steps,
    the replicas' weight std after each sync and the last step within 1e-3
    relative, identical partner tables and bytes a sync.  The int8 wire
    packs the experts and the fp32 routers and norms by dtype, as the
    reference does."""
    cfg, jprog, pprog, batches = _programs(method, codec, monkeypatch)
    b0 = next(shard_iterator(LoaderConfig(vocab_size=cfg.vocab_size, seq_len=RUN["seq_len"],
                                          per_replica_batch=RUN["per_replica_batch"],
                                          replicas=RUN["replicas"])))
    jst, pst = jprog.init_state(b0), pprog.init_state(b0)
    syncs = 0
    for step in range(1, RUN["steps"] + 1):
        b = next(batches)
        pst = pprog.load_state_pytree(pst, _host_tree(jprog, jst))
        jst, jm = jprog.inner_step(jst, {k: jnp.asarray(v) for k, v in b.items()},
                                   jax.random.PRNGKey(0))
        pst, pm = pprog.inner_step(pst, b)
        np.testing.assert_allclose(pm["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=LOCKED_RTOL, atol=0, err_msg=f"step {step}")
        jst, jsync = jprog.maybe_outer_step(jst)
        pst, psync = pprog.maybe_outer_step(pst)
        assert jsync == psync
        syncs += psync
        if psync or step == RUN["steps"]:
            np.testing.assert_allclose(pprog.weight_std(pst), jprog.weight_std(jst), rtol=1e-3,
                                       err_msg=f"step {step}")
    assert syncs == 2
    assert pprog.comm_cost().as_dict() == jprog.comm_cost().as_dict()
    if method == "noloco":
        assert len(pprog.partners) == 2
        for i, table in enumerate(pprog.partners):
            np.testing.assert_array_equal(table, jpairing.partner_table(i, 4, seed=0))


def test_router_leaves_stay_fp32_through_training():
    """A bf16 granite run on the CPU: the routers of θ, φ and δ stay fp32,
    the experts bf16, and the payload holds the fp32 leaves in a buffer of
    their own."""
    cfg = dataclasses.replace(_configs(KIND)[1], dtype="bfloat16")
    res = train_cli.run_training(cfg, method="noloco", device="cpu", replicas=2,
                                 per_replica_batch=1, seq_len=16, steps=2, inner_steps=1,
                                 eval_every=0)
    state = res["state"]
    for tree in (state.theta, state.outer.phi, state.outer.delta):
        block = tree["stack"]["scan"][0]["moe"]
        assert block["router"].dtype == torch.float32
        assert block["w_in"].dtype == torch.bfloat16
    tree = bytes_model.abstract_params(cfg)
    assert sorted(b.dtype for b in payload.make_spec((tree, tree)).buffers) == [
        "bfloat16", "float32"]
    assert all(np.isfinite(res["losses"]))
    assert state.opt.mu["stack"]["scan"][0]["moe"]["w_in"].dtype == torch.float32
