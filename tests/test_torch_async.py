"""The port's asynchronous rounds against the JAX package's, on the CPU.

* The 2× straggler of ``tests/test_async_clock.py`` (TINY, 8 replicas,
  m = 3, 24 steps, replica 1 at rate 0.5 from round 0) under the
  ``momentum`` stale rule, through both packages' ``run_elastic_training``
  from the JAX initial weights: ``max_staleness`` 1, ``blocked_syncs`` 0,
  identical fault history (every merged tick's due set, staleness and
  partner table), losses within 1e-4 relative.  One JAX run.
* A rate-1 world (``async_clock=True``, no rate events) is the
  synchronous run bit for bit, losses and final θ, under both stale rules.
* A port run resumed mid-async (the clock's credits, local steps, sync
  indices and merged-tick counter ride in ``sim.clock``) is bit-identical
  to the uninterrupted run.
"""
import jax
import numpy as np
import pytest
import torch

from repro.launch.train_elastic import run_elastic_training as jax_run_elastic
from repro.models import model as JM
from repro.models.common import values_of
from repro.models.config import ModelConfig as JModelConfig
from repro.sim import FaultPlan as JFaultPlan
from repro_torch.checkpoint import ckpt
from repro_torch.launch.train_elastic import run_elastic_training
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.sim import FaultPlan
from repro_torch.train import adapters
from repro_torch.tree import tree_leaves

TINY = dict(name="tiny-async", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=128, dtype="float32", remat=False)
KW = dict(replicas=4, per_replica_batch=2, seq_len=32, steps=12, inner_steps=3, inner_lr=3e-3,
          eval_every=0, seed=0, total_steps=12)
STRAGGLER = [{"kind": "rate", "round": 0, "replicas": [1], "rate": 0.5}]
SKW = {**KW, "replicas": 8, "steps": 24, "total_steps": 24, "stale": "momentum"}
MID = 13   # mid-phase: the straggler is one step into a phase it has not finished


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    """The port's TINY, starting from the JAX initial weights."""
    pcfg = ModelConfig(**TINY)
    params = jax.tree.map(np.asarray, values_of(JM.init_params(jax.random.PRNGKey(0),
                                                               JModelConfig(**TINY))))
    mp = pytest.MonkeyPatch()
    mp.setattr(adapters.GossipProgram, "initial_params",
               lambda self: convert.params_from_jax_numpy(params, pcfg))
    yield pcfg
    mp.undo()


@pytest.fixture(scope="module")
def straggler(cfg):
    return run_elastic_training(cfg, FaultPlan.build(STRAGGLER), device="cpu", **SKW)


def test_two_x_straggler_matches_the_reference(cfg, straggler):
    jres = jax_run_elastic(JModelConfig(**TINY), JFaultPlan.build(STRAGGLER), impl="jnp", **SKW)
    assert straggler["max_staleness"] == jres["max_staleness"] == 1
    assert straggler["blocked_syncs"] == jres["blocked_syncs"] == 0
    assert straggler["fault_history"] == jres["fault_history"]
    np.testing.assert_allclose(straggler["losses"], jres["losses"], rtol=1e-4, atol=0)
    np.testing.assert_allclose(straggler["final_weight_std"], jres["final_weight_std"], rtol=1e-3)
    ticks = straggler["rounds"]
    due = [1 in r["due"] for r in ticks]
    assert True in due and False in due and all(r["absent"] == [] for r in ticks)
    assert any(r["staleness"][1] == 1 and 1 in r["due"] for r in ticks)   # a discounted Δ
    for rec in ticks:   # each merged tick's table: an involution over the participants
        assert all(rec["partner"][rec["partner"][r]] == r for r in rec["active"])


@pytest.fixture(scope="module")
def synchronous(cfg):
    return run_elastic_training(cfg, FaultPlan(), device="cpu", **KW)


@pytest.mark.parametrize("stale", ["naive", "momentum"])
def test_rate_one_async_world_is_the_synchronous_run(cfg, synchronous, stale):
    res = run_elastic_training(cfg, FaultPlan(), device="cpu", async_clock=True, stale=stale, **KW)
    assert res["losses"] == synchronous["losses"]
    for a, b in zip(tree_leaves(res["state"].theta), tree_leaves(synchronous["state"].theta)):
        assert torch.equal(a, b)
    assert res["max_staleness"] == 0 and res["blocked_syncs"] == 0
    assert all(np.array_equal(a, b) for a, b in zip(res["partners"], synchronous["partners"]))
    assert len(res["partners"]) == KW["steps"] // KW["inner_steps"]


def test_resume_mid_async_is_bit_identical(cfg, straggler, tmp_path):
    d = str(tmp_path / "async")
    plan = FaultPlan.build(STRAGGLER)
    run_elastic_training(cfg, plan, device="cpu", ckpt_dir=d, **{**SKW, "steps": MID})
    clock = ckpt.restore(d, MID)["program"]["sim"]["clock"]
    assert clock["local_step"].tolist()[:3] == [MID, MID // 2, MID]
    assert float(clock["credit"][1]) == 0.5
    cont = run_elastic_training(cfg, plan, device="cpu", ckpt_dir=d, resume=True, **SKW)
    assert cont["start_step"] == MID
    assert cont["losses"] == straggler["losses"][MID:]
    n = len(cont["rounds"])
    assert n and cont["rounds"] == straggler["rounds"][-n:]
    for a, b in zip(tree_leaves(cont["state"].theta), tree_leaves(straggler["state"].theta)):
        assert torch.equal(a, b)
    assert cont["max_staleness"] == 1 and cont["blocked_syncs"] == 0
