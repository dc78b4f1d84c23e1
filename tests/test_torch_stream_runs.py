"""Streamed training runs of the port against the JAX package's, on the CPU.

``tests/test_streaming.py``'s TINY and KW: 4 replicas, m 4, 4 streams with
the φ-prefetch overlap, 16 steps (syncs at every step from 4 on), both
packages from the JAX initial weights.  One JAX run, checkpointing every 6
steps, is shared by every case; a second resumes the port's checkpoint.

- The ``stream_sync`` events equal JAX's in every field, and so do the
  partner tables of every sync and of every φ′ pre-send; per-step losses
  within 1e-4 relative, the final weight std within 1e-3 relative
  (``tests/test_torch_train.py``'s run tolerances), the summary's bytes
  and ``blocking_fraction`` exact.
- One stream with the overlap is the plain run bit for bit.
- Mid-stream (step 6: streams 2 and 3 of the round pending, the prefetch
  in flight) the port's checkpoint resumes bit-identical to its
  uninterrupted run; JAX's checkpoint resumes in the port and the port's
  in JAX, each on JAX's trajectory; both checkpoints have one structure,
  and their ``stream`` subtrees' tables are equal.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core.noloco import GossipTrainer as JGossipTrainer
from repro.launch.train import run_training as jax_run_training
from repro.models import model as JM
from repro.models.common import values_of
from repro.models.config import ModelConfig as JModelConfig
from repro.train.adapters import GossipProgram as JGossipProgram
from repro_torch.core.noloco import GossipTrainer
from repro_torch.launch.train import run_training
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.train import adapters
from repro_torch.tree import tree_leaves

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=128, dtype="float32", remat=False)
KW = dict(method="noloco", replicas=4, per_replica_batch=2, seq_len=32, inner_lr=3e-3,
          inner_steps=4, eval_every=0, total_steps=16)
STREAMED = dict(KW, streams=4, overlap=True)
STEPS, MID = 16, 6
LOSS_RTOL, WSTD_RTOL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorder(mp, cls, log):
    """Record (stream, partner, partner_next) of every stream sync."""
    real = cls.outer_step_stream

    def spy(self, state, **kw):
        log.append((kw["stream"], np.asarray(kw["partner"]).tolist(),
                    None if kw.get("partner_next") is None
                    else np.asarray(kw["partner_next"]).tolist()))
        return real(self, state, **kw)

    mp.setattr(cls, "outer_step_stream", spy)


def _events(path, kind="stream_sync"):
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
    root = tmp_path_factory.mktemp("stream")
    cfg = ModelConfig(**TINY)
    params = _initial_params()
    mp = pytest.MonkeyPatch()
    mp.setattr(adapters.GossipProgram, "initial_params",
               lambda self: convert.params_from_jax_numpy(params, cfg))
    mp.setattr(JGossipProgram, "init_state", lambda self, batch: self.trainer.init(jax.tree.map(
        lambda v: jnp.broadcast_to(jnp.asarray(v)[None], (self.replicas,) + v.shape), params)))
    out = {"cfg": cfg, "root": root, "jax_dir": str(root / "jax"), "port_dir": str(root / "port"),
           "jax_tables": [], "port_tables": []}
    _recorder(mp, JGossipTrainer, out["jax_tables"])
    _recorder(mp, GossipTrainer, out["port_tables"])
    out["jax"] = jax_run_training(JModelConfig(**TINY), steps=STEPS, impl="jnp",
                                  log_jsonl=str(root / "jax.jsonl"), ckpt_dir=out["jax_dir"],
                                  ckpt_every=MID, **STREAMED)
    out["port"] = run_training(cfg, steps=STEPS, device="cpu", log_jsonl=str(root / "port.jsonl"),
                               **STREAMED)
    out["short"] = run_training(cfg, steps=MID, device="cpu", ckpt_dir=out["port_dir"], **STREAMED)
    out["cont"] = run_training(cfg, steps=STEPS, device="cpu", ckpt_dir=out["port_dir"],
                               resume=True, **STREAMED)
    yield out
    mp.undo()


def _mid_dir(src, dst):
    name = f"step_{MID:08d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return dst


def _close(port, jax_res):
    np.testing.assert_allclose(port["losses"], jax_res["losses"][-len(port["losses"]):],
                               rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(port["final_weight_std"], jax_res["final_weight_std"],
                               rtol=WSTD_RTOL)


def test_streamed_run_matches_the_reference(runs):
    jres, pres, root = runs["jax"], runs["port"], runs["root"]
    jev, pev = _events(root / "jax.jsonl"), _events(root / "port.jsonl")
    assert pev == jev and len(pev) == STEPS - KW["inner_steps"] + 1
    assert [e["stream"] for e in pev[:4]] == [0, 1, 2, 3] and all(e["blocked"] for e in pev[:4])
    assert not any(e["blocked"] or e["epoch_fallback"] for e in pev[4:])
    assert _events(root / "port.jsonl", "outer") == _events(root / "jax.jsonl", "outer")
    port_tables = runs["port_tables"][:len(pev)]
    assert port_tables == runs["jax_tables"][:len(pev)]
    assert [t[1] for t in port_tables] == [p.tolist() for p in pres["partners"]]
    _close(pres, jres)
    for k in ("comm_bytes", "blocking_bytes", "blocking_fraction", "stream_count", "outer_syncs"):
        assert pres[k] == jres[k], k
    assert pres["comm"] == jres["comm"]
    assert 0.0 < pres["blocking_fraction"] < 1.0 and pres["stream_count"] == 4


def test_one_stream_with_overlap_is_the_plain_run_bit_for_bit(runs):
    cfg = runs["cfg"]
    plain = run_training(cfg, steps=12, device="cpu", **KW)
    ov = run_training(cfg, steps=12, device="cpu", streams=1, overlap=True, **KW)
    assert ov["losses"] == plain["losses"]
    for a, b in zip(tree_leaves((ov["state"].theta, ov["state"].outer.phi, ov["state"].outer.delta)),
                    tree_leaves((plain["state"].theta, plain["state"].outer.phi,
                                 plain["state"].outer.delta))):
        assert torch.equal(a, b)
    assert ov["stream_count"] == 1 and 0.0 < ov["blocking_fraction"] < 1.0
    assert [p.tolist() for p in ov["partners"]] == [p.tolist() for p in plain["partners"]]


def test_port_resume_mid_stream_is_bit_identical(runs):
    full, cont = runs["port"], runs["cont"]
    tree = jckpt.restore(runs["port_dir"], MID)["program"]
    assert tree["stream"]["pre_epoch"].tolist() == [0, 0, 0, -1]   # stream 3 not pre-sent yet
    assert "phi_pre" in tree["stream"]
    assert cont["start_step"] == MID and cont["losses"] == full["losses"][MID:]
    for a, b in zip(tree_leaves((cont["state"].theta, cont["state"].outer.phi,
                                 cont["state"].outer.delta)),
                    tree_leaves((full["state"].theta, full["state"].outer.phi,
                                 full["state"].outer.delta))):
        assert torch.equal(a, b)


def test_jax_mid_stream_checkpoint_resumes_in_port(runs, tmp_path):
    d = _mid_dir(runs["jax_dir"], str(tmp_path / "jax6"))
    jtree, ptree = jckpt.restore(d, MID), jckpt.restore(runs["port_dir"], MID)
    assert jax.tree.structure(jtree) == jax.tree.structure(ptree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(ptree)):
        assert np.asarray(a).shape == np.asarray(b).shape
        assert np.asarray(a).dtype == np.asarray(b).dtype
    for k in ("pre_partner", "pre_epoch"):
        np.testing.assert_array_equal(jtree["program"]["stream"][k], ptree["program"]["stream"][k])
    log = tmp_path / "cont.jsonl"
    cont = run_training(runs["cfg"], steps=STEPS, device="cpu", ckpt_dir=d, resume=True,
                        log_jsonl=str(log), **STREAMED)
    assert cont["start_step"] == MID
    _close(cont, runs["jax"])
    assert _events(log) == [e for e in _events(runs["root"] / "jax.jsonl") if e["step"] > MID]


def test_port_mid_stream_checkpoint_resumes_in_jax(runs, tmp_path):
    d = _mid_dir(runs["port_dir"], str(tmp_path / "port6"))
    jcont = jax_run_training(JModelConfig(**TINY), steps=STEPS, impl="jnp", ckpt_dir=d,
                             resume=True, **STREAMED)
    assert jcont["start_step"] == MID
    np.testing.assert_allclose(jcont["losses"], runs["jax"]["losses"][MID:], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(jcont["final_weight_std"], runs["jax"]["final_weight_std"],
                               rtol=WSTD_RTOL)
