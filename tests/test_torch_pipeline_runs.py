"""The port's routed pipeline trained against the JAX package's, on the CPU.

``tests/test_train_engine.py``'s pipeline case: ``TINY`` in 2 stages × 4
replicas, NoLoCo with random routing, m 5, 12 steps through the training
loop (eval every 6), both packages from JAX's initial weights.  Three JAX
runs in all, each made once and shared:

- the trajectory, checkpointing every 6 steps: per-step losses within 1e-4
  relative, weight std within 1e-3 (``tests/test_torch_train.py``'s
  tolerances), every stage's partner table of every round identical, the
  same ``outer_syncs`` and ``comm_bytes``;
- JAX resuming the port's step-6 checkpoint, on JAX's trajectory; the
  port resumes JAX's on it too, and its own bit for bit against its
  uninterrupted run; both packages' checkpoints have one layout;
- ``tests/test_elastic.py``'s pipeline scenario (m 2, replica 2 dropped
  after the first round, 8 batches): routes identical (replica 2 routed to
  itself), every stage's pairings identical, losses within 1e-4, the
  dropped replica's rows bit-identical from the drop on.

Without a JAX run: the warm start from a ``method="none"`` checkpoint gives
JAX's ``outer`` subtree, and a full-membership elastic context changes
nothing, bit for bit.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import pairing as jpairing
from repro.core.elastic import ElasticContext as JElasticContext
from repro.core.outer import OuterConfig as JOuterConfig
from repro.data import LoaderConfig as JLoaderConfig
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import AdamWConfig as JAdamWConfig
from repro.pipeline import PipelineTrainer as JPipelineTrainer
from repro.train import LoopConfig as JLoopConfig
from repro.train import PipelineProgram as JPipelineProgram
from repro.train import make_loop as jmake_loop
from repro_torch.core.elastic import ElasticContext
from repro_torch.core.outer import OuterConfig
from repro_torch.data import LoaderConfig, shard_iterator
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.pipeline import PipelineTrainer
from repro_torch.train import LoopConfig, PipelineProgram, make_loop
from repro_torch.tree import tree_leaves

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=128, dtype="float32", remat=False)
R, STAGES, M, STEPS, MID = 4, 2, 5, 12, 6
LOADER = dict(vocab_size=TINY["vocab_size"], seq_len=32, per_replica_batch=2, replicas=R)
LOSS_RTOL, WSTD_RTOL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jtrainer(method="noloco", m=M, elastic=None):
    outer = None if method == "none" else JOuterConfig(method=method, inner_steps=m, seed=0)
    return JPipelineTrainer(JModelConfig(**TINY), num_stages=STAGES, replicas=R,
                            inner=JAdamWConfig(lr=3e-3, weight_decay=0.0), outer=outer,
                            seed=0, elastic=elastic)


def _trainer(method="noloco", m=M, elastic=None):
    outer = None if method == "none" else OuterConfig(method=method, inner_steps=m, seed=0)
    return PipelineTrainer(ModelConfig(**TINY), num_stages=STAGES, replicas=R,
                           inner=AdamWConfig(lr=3e-3, weight_decay=0.0), outer=outer,
                           device="cpu", seed=0, elastic=elastic)


def _jloop(tr, ckpt_dir, resume=False):
    return jmake_loop(JPipelineProgram(tr), JLoaderConfig(**LOADER),
                      JLoopConfig(steps=STEPS, eval_every=MID, ckpt_dir=ckpt_dir,
                                  ckpt_every=MID, resume=resume)).run()


def _loop(tr, ckpt_dir=None, resume=False, steps=STEPS):
    return make_loop(PipelineProgram(tr), LoaderConfig(**LOADER),
                     LoopConfig(steps=steps, eval_every=MID, ckpt_dir=ckpt_dir, ckpt_every=MID,
                                resume=resume)).run()


def _mid(src, dst):
    """A directory holding only ``src``'s checkpoint at step MID."""
    name = f"step_{MID:08d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return dst


def _recording(mp, name, log):
    fn = getattr(jpairing, name)

    def wrapped(step, *args, seed=0, **kw):
        table = fn(step, *args, seed=seed, **kw)
        log.append((int(step), int(seed), np.asarray(table).copy()))
        return table

    mp.setattr(jpairing, name, wrapped)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    mp = pytest.MonkeyPatch()
    jt = _jtrainer()
    init = jt.init(jax.random.PRNGKey(0))["params"]
    jax_init = [convert.stage_params_from_jax_numpy(
        jax.tree.map(lambda x: np.asarray(x[0]), p), ModelConfig(**TINY), s, STAGES)
        for s, p in enumerate(init)]
    mp.setattr(PipelineTrainer, "initial_params", lambda self: jax_init)
    out = {"dir": {k: str(root / k) for k in ("jax", "port", "port_cont", "from_jax",
                                               "jax_cont")}}
    tables = []
    _recording(mp, "partner_table", tables)
    out["jax"] = _jloop(jt, out["dir"]["jax"])
    out["jax_tables"] = list(tables)
    tr = _trainer()
    out["port"] = _loop(tr, out["dir"]["port"])
    out["port_tables"] = tr.partners
    out["port_cont"] = _loop(_trainer(), _mid(out["dir"]["port"], out["dir"]["port_cont"]),
                             resume=True)
    out["from_jax"] = _loop(_trainer(), _mid(out["dir"]["jax"], out["dir"]["from_jax"]),
                            resume=True)
    # the trainer's jitted step is reused: a second JAX run, not a second compile
    out["jax_cont"] = _jloop(jt, _mid(out["dir"]["port"], out["dir"]["jax_cont"]), resume=True)
    out["elastic"] = _elastic_runs(mp)
    yield out
    mp.undo()


def _close(port, jax_losses):
    assert len(port) == len(jax_losses)
    np.testing.assert_allclose(port, jax_losses, rtol=LOSS_RTOL, atol=0)


def test_trajectory_matches_jax(runs):
    jres, pres = runs["jax"], runs["port"]
    _close(pres["losses"], jres["losses"])
    assert pres["outer_syncs"] == jres["outer_syncs"] == 2
    assert pres["comm_bytes"] == jres["comm_bytes"] > 0
    np.testing.assert_allclose(pres["final_weight_std"], jres["final_weight_std"], rtol=WSTD_RTOL)
    assert [s for s, _ in pres["weight_stds"]] == [s for s, _ in jres["weight_stds"]] == [6, 12]
    np.testing.assert_allclose([w for _, w in pres["weight_stds"]],
                               [w for _, w in jres["weight_stds"]], rtol=WSTD_RTOL)
    np.testing.assert_allclose([e for _, e in pres["evals"]], [e for _, e in jres["evals"]],
                               rtol=LOSS_RTOL)
    assert pres["losses"][-1] < pres["losses"][0]
    # every stage draws its own pairing each round, and they are JAX's
    pt = _trainer()
    want = [(k, pt.stage_seed(s)) for k in range(2) for s in range(STAGES)]
    assert [(k, seed) for k, seed, _ in runs["jax_tables"]] == want
    got = [t for round_tables in runs["port_tables"] for t in round_tables]
    assert len(got) == len(runs["jax_tables"]) == 4
    for g, (_, _, w) in zip(got, runs["jax_tables"]):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[1]) or not np.array_equal(got[2], got[3])


def _state_leaves(state):
    return (tree_leaves(state["params"]) + [t for o in state["opt"] for t in
                                            tree_leaves(o.mu) + tree_leaves(o.nu) + [o.count]]
            + tree_leaves(state["outer"]["phi"]) + tree_leaves(state["outer"]["delta"]))


def test_port_resume_is_bit_identical(runs):
    full, cont = runs["port"], runs["port_cont"]
    assert cont["start_step"] == MID and cont["steps_run"] == STEPS - MID
    assert cont["losses"] == full["losses"][MID:]
    assert cont["state"]["outer"]["step"] == full["state"]["outer"]["step"] == 2
    for a, b in zip(_state_leaves(cont["state"]), _state_leaves(full["state"])):
        assert torch.equal(a, b)


def test_checkpoints_resume_across_packages(runs):
    jfull = runs["jax"]
    for name in ("from_jax", "jax_cont"):
        res = runs[name]
        assert res["start_step"] == MID
        _close(res["losses"], jfull["losses"][MID:])
        np.testing.assert_allclose(res["final_weight_std"], jfull["final_weight_std"],
                                   rtol=WSTD_RTOL)
        assert res["outer_syncs"] == 1
    # one layout: the same paths, shapes and dtypes in both packages' checkpoints
    def layout(tree, prefix=""):
        if isinstance(tree, dict):
            return {p: v for k in tree for p, v in layout(tree[k], f"{prefix}/{k}").items()}
        if isinstance(tree, (list, tuple)):
            return {p: v for i, t in enumerate(tree) for p, v in layout(t, f"{prefix}/{i}").items()}
        return {prefix: (tuple(np.shape(tree)), str(tree.dtype))}

    jtree = jckpt.restore(runs["dir"]["jax"], MID)
    ptree = jckpt.restore(runs["dir"]["port"], MID)
    assert layout(ptree) == layout(jtree)
    assert ptree["program"]["step"] == MID and ptree["program"]["outer"]["step"] == 1


def test_warm_start_from_none_checkpoint_matches_jax(runs, tmp_path):
    """Gossip resumed from a ``method="none"`` checkpoint: φ at the restored
    θ, δ zero, the outer counter step // m, as JAX's load gives it."""
    d = str(tmp_path / "none")
    _loop(_trainer("none"), ckpt_dir=d, steps=MID)
    tree = jckpt.restore(d, MID)["program"]
    assert "outer" not in tree
    prog = PipelineProgram(_trainer())
    new = prog.load_state_pytree(prog.init_state({}), tree)
    jprog = JPipelineProgram(_jtrainer())
    jnew = jprog.load_state_pytree(jprog.init_state({}), tree)
    assert new["outer"]["step"] == jnew["outer"]["step"] == MID // M
    for s in range(STAGES):
        for p, phi, delta, jphi, jdelta in zip(
                tree_leaves(new["params"][s]), tree_leaves(new["outer"]["phi"][s]),
                tree_leaves(new["outer"]["delta"][s]), jax.tree.leaves(jnew["outer"]["phi"][s]),
                jax.tree.leaves(jnew["outer"]["delta"][s])):
            assert torch.equal(phi, p) and phi.data_ptr() != p.data_ptr()
            np.testing.assert_array_equal(phi.numpy(), np.asarray(jphi))
            assert not delta.any() and not np.asarray(jdelta).any()
    # the next sync fires at the next multiple of m
    res = _loop(_trainer(), ckpt_dir=d, resume=True, steps=2 * M)
    assert res["start_step"] == MID and res["outer_syncs"] == 1


# ---------------------------------------------------------------------------
# Elastic: tests/test_elastic.py's pipeline scenario
# ---------------------------------------------------------------------------


def _elastic_batches(n=8):
    it = shard_iterator(LoaderConfig(**dict(LOADER, seq_len=16)))
    return [next(it) for _ in range(n)]


def _drive(tr, ctx, init_state, batches, drop_after=2, snapshot=None):
    """Train + outer on every batch, replica 2 dropped after ``drop_after``:
    the final state, the per-step routes and losses, and ``snapshot`` of the
    state at the drop."""
    state, routes, losses, at_drop = init_state, [], [], None
    for i, b in enumerate(batches):
        if i == drop_after and ctx is not None:
            ctx.set_membership(ctx.membership.drop([2]))
            at_drop = snapshot(state) if snapshot else None
        routes.append([np.asarray(r).copy() for r in tr.routes(state["step"])])
        state, loss = tr.train_step(state, b)
        losses.append(loss)
        state, _ = tr.maybe_outer_step(state)
    return state, routes, losses, at_drop


def _elastic_runs(mp):
    """The scenario in both packages (one JAX run) and the port's
    full-membership elastic run beside its fixed-world one."""
    import jax.numpy as jnp

    batches = _elastic_batches()
    tables = []
    _recording(mp, "elastic_partner_table", tables)
    jctx = JElasticContext(world=R)
    jt = _jtrainer(m=2, elastic=jctx)
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    jstate, jroutes, jlosses, _ = _drive(jt, jctx, jt.init(jax.random.PRNGKey(0)), jbatches)
    ctx = ElasticContext(world=R)
    tr = _trainer(m=2, elastic=ctx)
    # the dropped replica's rows at the drop, copied: AdamW updates the
    # moments in place
    state, routes, losses, snap = _drive(
        tr, ctx, tr.init(), batches, snapshot=lambda st: [t[2].clone() for t in _state_leaves(st)])
    out = {"jax": {"routes": jroutes, "losses": jlosses, "tables": list(tables),
                   "weight_std": jt.weight_std(jstate),
                   "eval": float(jt.eval_loss(jstate["params"], jbatches[0]))},
           "port": {"routes": routes, "losses": losses, "tables": tr.partners,
                    "weight_std": tr.weight_std(state),
                    "eval": float(tr.eval_loss(state["params"], batches[0])),
                    "rows_at_drop": snap, "final": state},
           "seeds": [tr.stage_seed(s) for s in range(STAGES)]}
    fixed, full = _trainer(m=2), _trainer(m=2, elastic=ElasticContext(world=R))
    out["fixed"] = _drive(fixed, None, fixed.init(), batches[:6])
    out["full"] = _drive(full, None, full.init(), batches[:6])
    return out


def test_elastic_drop_matches_jax(runs):
    e = runs["elastic"]
    jres, pres = e["jax"], e["port"]
    for got, want in zip(pres["routes"], jres["routes"]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for got in pres["routes"][2:]:
        assert got[0][2] == 2 and sorted(got[0][[0, 1, 3]].tolist()) == [0, 1, 3]
    # one round before the drop, three after; every stage its own draw
    jt = jres["tables"]
    assert [(k, seed) for k, seed, _ in jt] == [(k, s) for k in range(4) for s in e["seeds"]]
    got = [t for round_tables in pres["tables"] for t in round_tables]
    assert len(got) == len(jt) == 8
    for g, (k, _, w) in zip(got, jt):
        np.testing.assert_array_equal(g, w)
        if k > 0:
            assert g[2] == 2
    _close(pres["losses"], jres["losses"])
    np.testing.assert_allclose(pres["weight_std"], jres["weight_std"], rtol=WSTD_RTOL)
    np.testing.assert_allclose(pres["eval"], jres["eval"], rtol=LOSS_RTOL)
    # frozen from the drop on: parameters, both moments, count, φ and δ
    for before, after in zip(pres["rows_at_drop"], _state_leaves(pres["final"])):
        assert torch.equal(before, after[2])
    assert not torch.equal(pres["rows_at_drop"][0], tree_leaves(pres["final"]["params"])[0][0])


def test_full_membership_elastic_is_the_fixed_world_bit_for_bit(runs):
    fixed, full = runs["elastic"]["fixed"], runs["elastic"]["full"]
    assert fixed[2] == full[2]
    for a, b in zip(fixed[1], full[1]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(_state_leaves(fixed[0]), _state_leaves(full[0])):
        assert torch.equal(a, b)
