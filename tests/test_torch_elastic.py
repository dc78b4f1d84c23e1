"""The port's elastic runtime against the JAX package's, on the CPU.

One combined fault plan on TINY (``tests/test_elastic.py``'s config) at 8
replicas, 30 steps of m = 5 (six rounds): replicas 3 and 5 drop at round 1
and rejoin, warm-started, at round 4; a partition into two halves from
round 2 heals at round 5; replica 1 straggles for two rounds from round 2,
inside its island.  Both packages' ``run_elastic_training`` run it from the
JAX initial weights: identical round histories (active, absent, partner,
partition) and fault history, per-step losses within 1e-4 relative, weight
std within 1e-3 relative at every eval, the same final membership.

The checkpoint at step 15 holds a dropped pair, a partition and a straggle
debt of one round (``sim.straggle``).  The port resumes its own
checkpoint bit for bit against its uninterrupted run, resumes the JAX
checkpoint on the JAX trajectory, and JAX resumes the port's.  The
reference's ``test_partition_then_heal_recontracts`` fails since jax 0.9
on its thresholds; the port is held to the reference's trajectory, not to
them.  The warm-start surgery is held against the reference's on one
state, bit for bit.  Two JAX runs in all.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.launch.train import method_config as jmethod_config
from repro.launch.train_elastic import run_elastic_training as jax_run_elastic
from repro.models import model as JM
from repro.models.common import values_of
from repro.models.config import ModelConfig as JModelConfig
from repro.sim import FaultPlan as JFaultPlan
from repro.train.adapters import GossipProgram as JGossipProgram
from repro_torch.checkpoint import ckpt
from repro_torch.data import LoaderConfig, shard_iterator
from repro_torch.launch import train as train_cli
from repro_torch.launch.train_elastic import run_elastic_training
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.sim import FaultPlan, SimCluster
from repro_torch.train import adapters
from repro_torch.tree import tree_leaves

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=128, dtype="float32", remat=False)
EVENTS = [
    {"kind": "drop", "round": 1, "replicas": [3, 5]},
    {"kind": "partition", "round": 2, "groups": [[0, 1, 2, 3], [4, 5, 6, 7]]},
    {"kind": "straggle", "round": 2, "replicas": [1], "rounds": 2},
    {"kind": "rejoin", "round": 4, "replicas": [3, 5]},
    {"kind": "heal", "round": 5},
]
KW = dict(replicas=8, per_replica_batch=2, seq_len=32, steps=30, total_steps=30, inner_steps=5,
          inner_lr=3e-3, eval_every=5, seed=0)
MID = 15
LOSS_RTOL, WSTD_RTOL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side, so that in a parallel test
    run the other workers' JAX processes keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs from the JAX initial weights.  ``jax``: 30 steps,
    a checkpoint every 15; ``port``: 30 uninterrupted steps; ``short``: the
    port's first 15 steps of the same horizon, its checkpoint in
    ``port_dir``; ``cont``: the port resumed from it."""
    root = tmp_path_factory.mktemp("elastic")
    cfg = ModelConfig(**TINY)
    params = jax.tree.map(np.asarray, values_of(JM.init_params(jax.random.PRNGKey(0),
                                                               JModelConfig(**TINY))))
    mp = pytest.MonkeyPatch()
    mp.setattr(adapters.GossipProgram, "initial_params",
               lambda self: convert.params_from_jax_numpy(params, cfg))
    out = {"cfg": cfg, "jax_dir": str(root / "jax"), "port_dir": str(root / "port")}
    out["jax"] = jax_run_elastic(JModelConfig(**TINY), JFaultPlan.build(EVENTS), impl="jnp",
                                 ckpt_dir=out["jax_dir"], ckpt_every=MID, **KW)
    plan = FaultPlan.build(EVENTS)
    out["port"] = run_elastic_training(cfg, plan, device="cpu", **KW)
    out["short"] = run_elastic_training(cfg, plan, device="cpu", ckpt_dir=out["port_dir"],
                                        **{**KW, "steps": MID})
    out["cont"] = run_elastic_training(cfg, plan, device="cpu", ckpt_dir=out["port_dir"],
                                       resume=True, **KW)
    yield out
    mp.undo()


def _mid_dir(src, dst):
    """A directory holding only ``src``'s checkpoint at step MID."""
    name = f"step_{MID:08d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return dst


def _close(port_losses, jax_losses):
    assert len(port_losses) == len(jax_losses)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=LOSS_RTOL, atol=0)


def test_combined_plan_matches_the_reference(runs):
    jres, pres = runs["jax"], runs["port"]
    assert pres["rounds"] == jres["rounds"] and len(pres["rounds"]) == 6
    assert pres["fault_history"] == jres["fault_history"]
    assert pres["membership"] == jres["membership"] == {"epoch": 2, "active": list(range(8))}
    _close(pres["losses"], jres["losses"])
    assert [s for s, _ in pres["weight_stds"]] == [s for s, _ in jres["weight_stds"]]
    np.testing.assert_allclose([w for _, w in pres["weight_stds"]],
                               [w for _, w in jres["weight_stds"]], rtol=WSTD_RTOL)
    np.testing.assert_allclose([e for _, e in pres["evals"]], [e for _, e in jres["evals"]],
                               rtol=LOSS_RTOL)
    # the plan did what it says: the pair frozen out, islands, a sit-out
    by_round = {r["round"]: r for r in pres["rounds"]}
    for k in (1, 2, 3):
        assert by_round[k]["active"] == [0, 1, 2, 4, 6, 7]
        assert by_round[k]["partner"][3] == 3 and by_round[k]["partner"][5] == 5
    for k in (2, 3, 4):
        assert by_round[k]["partition"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert all((i < 4) == (p < 4) for i, p in enumerate(by_round[k]["partner"]))
    assert by_round[2]["absent"] == by_round[3]["absent"] == [1]
    assert by_round[2]["partner"][1] == 1 and by_round[4]["absent"] == []
    assert by_round[5]["partition"] is None and by_round[5]["active"] == list(range(8))
    assert len(pres["partners"]) == 6 and all(
        np.array_equal(a, r["partner"]) for a, r in zip(pres["partners"], pres["rounds"]))
    assert np.isfinite(pres["losses"]).all() and pres["losses"][-1] < pres["losses"][0]


def test_port_resume_mid_straggle_is_bit_identical(runs):
    full, short, cont = runs["port"], runs["short"], runs["cont"]
    assert {r["round"]: r["absent"] for r in short["rounds"]}[2] == [1]
    tree = ckpt.restore(runs["port_dir"], MID)["program"]
    assert tree["sim"]["straggle"].tolist() == [0, 1, 0, 0, 0, 0, 0, 0]   # one round still owed
    assert tree["membership"]["mask"].tolist() == [i not in (3, 5) for i in range(8)]
    assert tree["membership"]["partition"].tolist() == [0, 0, 0, 0, 1, 1, 1, 1]
    assert cont["start_step"] == MID
    assert cont["losses"] == full["losses"][MID:]
    assert cont["rounds"] == full["rounds"][3:]
    assert cont["rounds"][0]["absent"] == [1]
    for a, b in zip(tree_leaves(cont["state"].theta) + tree_leaves(cont["state"].outer.phi),
                    tree_leaves(full["state"].theta) + tree_leaves(full["state"].outer.phi)):
        assert torch.equal(a, b)
    assert cont["membership"] == full["membership"]


def test_jax_checkpoint_resumes_in_port(runs, tmp_path):
    """The reference's elastic checkpoint (dropped pair, partition, straggle
    debt) restores into the port, which continues on the JAX trajectory;
    both packages' checkpoints at step 15 have one structure and dtypes."""
    d = _mid_dir(runs["jax_dir"], str(tmp_path / "jax15"))
    jtree, ptree = jckpt.restore(d, MID), jckpt.restore(runs["port_dir"], MID)
    assert jax.tree.structure(jtree) == jax.tree.structure(ptree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(ptree)):
        assert np.asarray(a).shape == np.asarray(b).shape
        assert np.asarray(a).dtype == np.asarray(b).dtype
    for k in ("membership", "sim"):
        for a, b in zip(jax.tree.leaves(jtree["program"][k]), jax.tree.leaves(ptree["program"][k])):
            np.testing.assert_array_equal(a, b)
    cont = run_elastic_training(runs["cfg"], FaultPlan.build(EVENTS), device="cpu", ckpt_dir=d,
                                resume=True, **KW)
    assert cont["start_step"] == MID
    assert cont["rounds"] == runs["jax"]["rounds"][3:]
    _close(cont["losses"], runs["jax"]["losses"][MID:])
    np.testing.assert_allclose(cont["final_weight_std"], runs["jax"]["final_weight_std"],
                               rtol=WSTD_RTOL)
    assert cont["membership"] == runs["jax"]["membership"]


def test_port_checkpoint_resumes_in_jax(runs, tmp_path):
    d = _mid_dir(runs["port_dir"], str(tmp_path / "port15"))
    jcont = jax_run_elastic(JModelConfig(**TINY), JFaultPlan.build(EVENTS), impl="jnp",
                            ckpt_dir=d, resume=True, **KW)
    assert jcont["start_step"] == MID
    assert jcont["rounds"] == runs["jax"]["rounds"][3:]
    _close(jcont["losses"], runs["jax"]["losses"][MID:])
    np.testing.assert_allclose(jcont["final_weight_std"], runs["jax"]["final_weight_std"],
                               rtol=WSTD_RTOL)


@pytest.mark.parametrize("aliased", [True, False], ids=["after-sync", "mid-phase"])
def test_warm_start_surgery_matches_the_reference(runs, aliased):
    """The rejoin surgery on one state, in both packages: θ[r] = φ[r] =
    φ[src], δ[r] = 0, zero moments, count 0; every other row untouched.
    Right after a sync θ and φ are the same tensors in the port: the new θ
    and φ are one new tensor, and the old state is left as it was."""
    cfg = runs["cfg"]
    tcfg = train_cli.method_config("noloco", inner_lr=3e-3, total_steps=8, warmup=1,
                                   inner_steps=2)
    program = adapters.GossipProgram(cfg, tcfg, replicas=4, device="cpu")
    it = shard_iterator(LoaderConfig(vocab_size=cfg.vocab_size, seq_len=16, per_replica_batch=2,
                                     replicas=4))
    state = program.init_state(None)
    for _ in range(4 if aliased else 3):
        state, _ = program.inner_step(state, next(it))
        state, _ = program.maybe_outer_step(state)
    theta0, phi0 = tree_leaves(state.theta), tree_leaves(state.outer.phi)
    assert all(a is b for a, b in zip(theta0, phi0)) == aliased
    before = jax.tree.map(np.asarray, convert.train_state_to_numpy(state))
    new = program.warm_start(state, 2, 0)
    got = convert.train_state_to_numpy(new)
    jprog = JGossipProgram(JModelConfig(**TINY), jmethod_config(
        "noloco", inner_lr=3e-3, total_steps=8, warmup=1, inner_steps=2), replicas=4)
    jstate = jprog.load_state_pytree(None, jax.tree.map(jnp.asarray, before))
    want = jprog.state_pytree(jprog.warm_start(jstate, 2, 0))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    new_theta, new_phi = tree_leaves(new.theta), tree_leaves(new.outer.phi)
    for th, p, old_th, old_p in zip(new_theta, new_phi, theta0, phi0):
        assert torch.equal(th[2], old_p[0]) and torch.equal(p[2], old_p[0])
        assert (th is p) == aliased and th is not old_th
    for a, b in zip(theta0, jax.tree.leaves(before["theta"])):   # the old θ is untouched
        np.testing.assert_array_equal(a.numpy(), b)
    assert new.opt.count.tolist()[2] == 0 and not any(m[2].any() for m in tree_leaves(new.opt.mu))
    assert not any(d[2].any() for d in tree_leaves(new.outer.delta))


def test_frozen_replicas_keep_their_bits(runs):
    """A replica dropped at step 2 keeps θ, φ, δ, both moments and its step
    count bit for bit while the others train and sync around it."""
    cfg = runs["cfg"]
    tcfg = train_cli.method_config("noloco", inner_lr=3e-3, total_steps=8, warmup=1,
                                   inner_steps=2)
    program = adapters.GossipProgram(cfg, tcfg, replicas=4, device="cpu")
    sim = SimCluster(program, FaultPlan.build([{"kind": "drop", "step": 2, "replicas": [1]}]))
    it = shard_iterator(LoaderConfig(vocab_size=cfg.vocab_size, seq_len=16, per_replica_batch=2,
                                     replicas=4))
    state = sim.init_state(None)
    snap = None
    for t in range(7):
        state, metrics = sim.inner_step(state, next(it))
        assert metrics["loss"].shape == ((4,) if t < 2 else (3,))
        state, _ = sim.maybe_outer_step(state)
        if t == 2:
            snap = {k: [x[1].clone() for x in tree_leaves(v)] for k, v in (
                ("theta", state.theta), ("phi", state.outer.phi), ("delta", state.outer.delta),
                ("mu", state.opt.mu), ("nu", state.opt.nu))}
            count = int(state.opt.count[1])
    for k, v in (("theta", state.theta), ("phi", state.outer.phi), ("delta", state.outer.delta),
                 ("mu", state.opt.mu), ("nu", state.opt.nu)):
        for a, b in zip(snap[k], tree_leaves(v)):
            assert torch.equal(a, b[1])
    assert int(state.opt.count[1]) == count == 2
    assert not torch.equal(tree_leaves(state.theta)[0][0], snap["theta"][0])


def test_all_absent_round_still_advances_the_counter(runs):
    """Every member in straggle debt: the round happens with nobody
    exchanging (identity table, an all-False mask through the outer step),
    the outer counter advances, and θ, φ, δ come out as they went in."""
    cfg = runs["cfg"]
    tcfg = train_cli.method_config("noloco", inner_lr=3e-3, total_steps=8, warmup=1,
                                   inner_steps=2)
    program = adapters.GossipProgram(cfg, tcfg, replicas=4, device="cpu")
    sim = SimCluster(program, FaultPlan.build(
        [{"kind": "straggle", "round": 1, "replicas": [0, 1, 2, 3]}]))
    it = shard_iterator(LoaderConfig(vocab_size=cfg.vocab_size, seq_len=16, per_replica_batch=2,
                                     replicas=4))
    state = sim.init_state(None)
    for _ in range(3):
        state, _ = sim.inner_step(state, next(it))
        state, _ = sim.maybe_outer_step(state)
    state, _ = sim.inner_step(state, next(it))
    before = {k: [x.clone() for x in tree_leaves(v)] for k, v in (
        ("theta", state.theta), ("phi", state.outer.phi), ("delta", state.outer.delta))}
    state, synced = sim.maybe_outer_step(state)
    assert synced and state.outer.step == 2
    rec = sim.rounds()[-1]
    assert rec["round"] == 1 and rec["absent"] == [0, 1, 2, 3] and rec["partner"] == [0, 1, 2, 3]
    assert np.array_equal(program.partners[-1], np.arange(4))
    for k, v in (("theta", state.theta), ("phi", state.outer.phi), ("delta", state.outer.delta)):
        assert all(torch.equal(a, b) for a, b in zip(before[k], tree_leaves(v)))
    state, _ = sim.inner_step(state, next(it))
    state, _ = sim.inner_step(state, next(it))
    state, _ = sim.maybe_outer_step(state)
    assert sim.rounds()[-1]["absent"] == [] and state.outer.step == 3
