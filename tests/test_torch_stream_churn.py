"""A streamed run through churn, the port against the JAX package, on the CPU.

``tests/test_streaming.py``'s churn plan (one run, no healthy twin): TINY
on 8 replicas, m 4, 4 streams with the φ-prefetch overlap; replica 3 drops
at step 9 and rejoins at step 17, warm-started.  The run is cut from the
reference's 28 steps to 22, which hold every fallback (steps 10–13 and
18–21) and one sync after them.  Both
packages' ``run_elastic_training`` from the JAX initial weights give the
same ``stream_sync`` events, ``epoch_fallback`` flags included (each
stream falls back at most once per membership change), the same round
history (partner tables, the dropped replica alone) and fault history,
and per-step losses within 1e-4 relative, the final weight std within
1e-3 relative.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.train_elastic import run_elastic_training as jax_run_elastic
from repro.models import model as JM
from repro.models.common import values_of
from repro.models.config import ModelConfig as JModelConfig
from repro.train.adapters import GossipProgram as JGossipProgram
from repro.sim import FaultPlan as JFaultPlan
from repro_torch.launch.train_elastic import run_elastic_training
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.sim import FaultPlan
from repro_torch.train import adapters

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=128, dtype="float32", remat=False)
EVENTS = [{"kind": "drop", "step": 9, "replicas": [3]},
          {"kind": "rejoin", "step": 17, "replicas": [3]}]
KW = dict(method="noloco", replicas=8, per_replica_batch=2, seq_len=32, steps=22, inner_steps=4,
          inner_lr=3e-3, eval_every=0, stream_count=4)
LOSS_RTOL, WSTD_RTOL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(path, kind):
    return [{k: v for k, v in e.items() if k != "run"}
            for e in map(json.loads, open(path)) if e["event"] == kind]


def _initial_params():
    """JAX's initial weights of TINY, drawn in one jitted call (the eager
    draw compiles every op of the initialiser on its own), for both
    packages: the JAX program's ``init_state`` stacks these."""
    init = jax.jit(lambda: values_of(JM.init_params(jax.random.PRNGKey(0), JModelConfig(**TINY))))
    return jax.tree.map(np.asarray, init())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("churn")
    cfg = ModelConfig(**TINY)
    params = _initial_params()
    mp = pytest.MonkeyPatch()
    mp.setattr(adapters.GossipProgram, "initial_params",
               lambda self: convert.params_from_jax_numpy(params, cfg))
    mp.setattr(JGossipProgram, "init_state", lambda self, batch: self.trainer.init(jax.tree.map(
        lambda v: jnp.broadcast_to(jnp.asarray(v)[None], (self.replicas,) + v.shape), params)))
    out = {"jax_log": str(root / "jax.jsonl"), "port_log": str(root / "port.jsonl")}
    out["jax"] = jax_run_elastic(JModelConfig(**TINY), JFaultPlan.build(EVENTS), impl="jnp",
                                 log_jsonl=out["jax_log"], **KW)
    out["port"] = run_elastic_training(cfg, FaultPlan.build(EVENTS), device="cpu",
                                       log_jsonl=out["port_log"], **KW)
    yield out
    mp.undo()


def test_streamed_churn_events_match_the_reference(runs):
    jev, pev = _events(runs["jax_log"], "stream_sync"), _events(runs["port_log"], "stream_sync")
    assert pev == jev and len(pev) == KW["steps"] - KW["inner_steps"] + 1
    fallbacks = [(e["step"], e["stream"]) for e in pev if e["epoch_fallback"]]
    epochs = [(0, 0)] + [(e["step"], e["epoch"]) for e in _events(runs["port_log"], "membership")]
    assert epochs == [(0, 0), (10, 1), (18, 2)]
    by_epoch: dict[int, list[int]] = {}
    for step, k in fallbacks:
        by_epoch.setdefault([ep for first, ep in epochs if step >= first][-1], []).append(k)
    assert 0 < len(fallbacks) <= 2 * 4 and 0 not in by_epoch
    assert all(len(v) == len(set(v)) for v in by_epoch.values())
    assert _events(runs["port_log"], "outer") == _events(runs["jax_log"], "outer")


def test_streamed_churn_rounds_and_losses_match_the_reference(runs):
    jres, pres = runs["jax"], runs["port"]
    assert pres["rounds"] == jres["rounds"] and len(pres["rounds"]) == len(pres["partners"])
    assert pres["fault_history"] == jres["fault_history"]
    assert pres["membership"] == jres["membership"] == {"epoch": 2, "active": list(range(8))}
    assert all(r["partner"][3] == 3 for r in pres["rounds"] if 3 not in r["active"])
    assert all(np.array_equal(p, r["partner"]) for p, r in zip(pres["partners"], pres["rounds"]))
    np.testing.assert_allclose(pres["losses"], jres["losses"], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(pres["final_weight_std"], jres["final_weight_std"], rtol=WSTD_RTOL)
    for k in ("comm_bytes", "blocking_bytes", "blocking_fraction", "stream_count"):
        assert pres[k] == jres[k], k
    assert np.isfinite(pres["losses"]).all() and pres["blocking_fraction"] < 1.0
