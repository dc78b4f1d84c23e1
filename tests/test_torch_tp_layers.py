"""The model axis's layers and families at tp 2 against JAX's sharded loss.

JAX runs ``build_loss_shard`` on ``make_test_mesh(2, 2)`` (two replicas of
two model ranks, four forced host devices, one subprocess), differentiated
outside its ``shard_map`` as ``build_train_step`` does, followed by one
clipped AdamW step.  The port runs the same on four ``gloo`` CPU ranks (one
spawn): each rank its shard of its replica (``plans.shard_tree``), the
backward from 1/tp of the loss and the whole leaves' gradients summed over
the model axis, AdamW clipping by the replica's whole norm.  Both start
from JAX's weights and the same batch.

Configs: TINY (``tests/test_multidevice.py``'s) with GQA 4/2 (kv >= tp:
each rank slices its kv head) and MQA 4/1 (kv < tp: K/V expanded by the
head map), and the ``reduced()`` mamba2-370m, recurrentgemma-9b and
granite-moe-1b-a400m.  Losses and every leaf's gradient within 1e-5 of
JAX's tp-2 run; for all but the MoE config also within 1e-6 normwise of the
port's own unsharded gradients.  The MoE config is held against JAX's tp
run only: at tp > 1 each model rank routes its half of the sequence with
its own capacity (``transformer._split_seq``, capacity ceil(t·k/e·factor)
over the local t), so the block computes another function than the
unsharded one.  That is the reference's definition: JAX's own tp-2 losses
on ``make_test_mesh(4, 2)`` are 5.8104 / 5.8387 / 6.1705 / 5.7751 against
its unsharded 5.8133 / 5.8333 / 6.1919 / 5.7989.  The clipped update is
held where the replica's gradient norm exceeds 1 (the batch's loss is
scaled so that it does).
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_dist_helpers as H

SCALE = 8.0   # the loss is scaled so that every config's gradient norm exceeds 1
B, S = 4, 16
CONFIGS = ["tiny_gqa", "tiny_mqa", "mamba2-370m", "recurrentgemma-9b", "granite-moe-1b-a400m"]
MOE = "granite-moe-1b-a400m"
JAX_RTOL = 1e-5
# AdamW's first step is lr·g/(|g| + eps) per element: where |g| is near eps
# a last-bit difference of the gradient moves the step by a share of lr.
# Measured: 1-3 values of a leaf beyond 1e-5 (at most 6.4e-5 of lr 1e-3,
# on leaves of 8,192-131,072 values), so the update is held within
# UPDATE_NEAR but for a share UPDATE_MOVED of the values, each within lr.
LR = 1e-3
UPDATE_NEAR = 1e-5
UPDATE_MOVED = 1e-3

JAX_SCRIPT = textwrap.dedent('''
    import pickle, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import registry
    from repro.launch.mesh import make_test_mesh
    from repro.models import model as M
    from repro.models.common import unzip
    from repro.models.config import ModelConfig
    from repro.optim import AdamWConfig, adamw_init, adamw_update
    from repro.parallel import compat, plans as PL, steps as ST

    spec = pickle.load(open(sys.argv[1], "rb"))
    mesh = make_test_mesh(2, 2)
    out = {}
    for name in spec["configs"]:
        if name.startswith("tiny"):
            cfg = ModelConfig(**spec["tiny"], num_kv_heads=2 if name == "tiny_gqa" else 1)
        else:
            cfg = registry.get_config(name).reduced(dtype="float32", remat=False)
        plan = PL.make_plan("gossip_dp", mesh, shape_kind="train")
        stacked = ST.stack_replicas(M.init_params(jax.random.PRNGKey(0), cfg), plan.replicas)
        vals, _ = unzip(stacked)
        rng = np.random.default_rng(7)
        batch = {k: jnp.asarray(rng.integers(0, cfg.vocab_size, (spec["B"], spec["S"]),
                                             dtype=np.int32)) for k in ("tokens", "labels")}
        pspecs = PL.param_pspecs(plan, mesh, stacked)
        loss_shard = ST.build_loss_shard(cfg, plan, mesh, pspecs, ST.batch_pspecs(plan, batch))
        inner = AdamWConfig(lr=spec["lr"], weight_decay=0.0)

        def total(theta):
            losses, mets = loss_shard(theta, batch)
            return jnp.sum(losses) * spec["scale"] / plan.replicas, (losses, mets)

        def run(theta):
            (_, (losses, mets)), grads = jax.value_and_grad(total, has_aux=True)(theta)
            opt = jax.vmap(adamw_init)(theta)
            new, _, gnorm = jax.vmap(lambda g, o, p: adamw_update(g, o, p, inner))(
                grads, opt, theta)
            return losses, mets, grads, new, gnorm

        with compat.set_mesh(mesh):
            losses, mets, grads, new, gnorm = jax.jit(run)(vals)
        host = lambda t: jax.tree.map(np.asarray, t)
        out[name] = {"params": host(jax.tree.map(lambda x: x[0], vals)), "batch": host(batch),
                     "losses": np.asarray(losses), "aux": np.asarray(mets["aux_loss"]),
                     "grads": host(grads), "new": host(new), "gnorm": np.asarray(gnorm)}
    pickle.dump(out, open(sys.argv[2], "wb"))
''')


def port_config(name):
    from repro_torch.configs import registry
    from repro_torch.models.config import ModelConfig

    if name.startswith("tiny"):
        return ModelConfig(**dict(H.TINY, num_kv_heads=2 if name == "tiny_gqa" else 1))
    return registry.get_config(name).reduced(dtype="float32", remat=False)


def rank_grads(group, ref) -> dict:
    """Each config on this rank: its replica's loss, the whole gradient
    (gathered from the shards) and the clipped AdamW step's whole θ."""
    from repro_torch.models import convert
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import plans, steps
    from repro_torch.tree import tree_map

    out = {}
    for name, want in ref.items():
        cfg = port_config(name)
        plan = plans.make_plan("gossip_dp", group.replicas, group.tp)
        theta = tree_map(lambda t: t[None].contiguous(), convert.shard_from_jax_numpy(
            want["params"], cfg, plan, group.model_index))
        r = group.replica
        rows = slice(r * B // 2, (r + 1) * B // 2)
        batch = {k: torch.from_numpy(np.asarray(v)[rows][None].astype(np.int64))
                 for k, v in want["batch"].items()}
        bundle = steps.build_train_step(cfg, plan, group, AdamWConfig(lr=LR, weight_decay=0.0))
        captured = {}
        real_update = steps.adamw_update

        def spy(grads, opt, params, inner, active=None, norm=None):
            captured["grads"], captured["norm"] = grads, norm
            return real_update(grads, opt, params, inner, active, norm)

        steps.adamw_update = spy
        # the test's loss scale rides on the step's objective
        real_loss = steps.model_api.stacked_loss
        steps.model_api.stacked_loss = lambda *a, **k: real_loss(*a, **k) * SCALE
        try:
            new, _, metrics = bundle.step_fn(theta, adamw_init(theta), batch)
        finally:
            steps.adamw_update = real_update
            steps.model_api.stacked_loss = real_loss
        gather = lambda t: steps.gather_shards(t, cfg, plan, group.model)
        out[name] = {"loss": float(metrics["loss"][0]) / SCALE,
                     "grads": tree_map(lambda x: x[0].numpy(), gather(captured["grads"])),
                     "new": tree_map(lambda x: x[0].numpy(), gather(new)),
                     "gnorm": float(metrics["grad_norm"][0])}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_layers"))
    spec, out = os.path.join(root, "spec.pkl"), os.path.join(root, "jax.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"tiny": {k: v for k, v in H.TINY.items() if k != "num_kv_heads"},
                     "configs": CONFIGS, "B": B, "S": S, "scale": SCALE, "lr": LR}, f)
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, spec, out], env=H.jax_env(4),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out, "rb") as f:
        ref = pickle.load(f)
    from repro_torch.launch import mesh

    ranks = mesh.spawn(rank_grads, 4, (ref,), backend="gloo", device="cpu", threads=1, tp=2)
    return {"jax": ref, "port": ranks}


def unsharded_grads(name, want):
    """The port's own gradient of each replica's loss, no model axis."""
    from repro_torch.models import convert
    from repro_torch.models import model as model_api
    from repro_torch.tree import tree_leaves, tree_map

    cfg = port_config(name)
    threads = H.torch_threads_one()
    try:
        full = convert.params_from_jax_numpy(want["params"], cfg)
        params = tree_map(lambda t: t[None].expand((2,) + t.shape).clone().requires_grad_(),
                          full)
        tokens = {k: torch.from_numpy(np.asarray(v).reshape(2, B // 2, S).astype(np.int64))
                  for k, v in want["batch"].items()}
        losses = model_api.stacked_loss(params, cfg, tokens)
        grads = torch.autograd.grad(losses.sum() * SCALE / 2, tree_leaves(params))
    finally:
        torch.set_num_threads(threads)
    return losses.detach().numpy(), [g.numpy() for g in grads]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_match_jax_tp(runs, name):
    jax, port = runs["jax"][name], runs["port"]
    for rank in range(4):
        r = rank // 2
        got = port[rank][name]
        if rank % 2 == 0 or name != MOE:
            # JAX reports model index 0's loss; an MoE rank adds its own aux loss
            np.testing.assert_allclose(got["loss"], jax["losses"][r], rtol=JAX_RTOL)
        for g, w in zip(H.leaves(got["grads"]), H.leaves(jax["grads"])):
            w = w[r]
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=JAX_RTOL * max(np.abs(w).max(), 1e-3))


@pytest.mark.parametrize("name", [c for c in CONFIGS if c != MOE])
def test_gradients_match_the_unsharded_port(runs, name):
    losses, grads = unsharded_grads(name, runs["jax"][name])
    port = runs["port"]
    for rank in (0, 2):
        r = rank // 2
        np.testing.assert_allclose(port[rank][name]["loss"], losses[r], rtol=1e-6)
        got = np.concatenate([g.reshape(-1) for g in H.leaves(port[rank][name]["grads"])])
        want = np.concatenate([g[r].reshape(-1) for g in grads])
        assert _rel(got, want) <= 1e-6, _rel(got, want)


@pytest.mark.parametrize("name", CONFIGS)
def test_clipped_update_matches_jax(runs, name):
    jax, port = runs["jax"][name], runs["port"]
    for rank in (0, 1, 2, 3):
        r = rank // 2
        assert jax["gnorm"][r] > 1.0
        np.testing.assert_allclose(port[rank][name]["gnorm"], jax["gnorm"][r], rtol=JAX_RTOL)
        got = np.concatenate([g.reshape(-1) for g in H.leaves(port[rank][name]["new"])])
        want = np.concatenate([w[r].reshape(-1) for w in H.leaves(jax["new"])])
        diff = np.abs(got - want)
        assert diff.max() <= LR, diff.max()
        assert (diff > UPDATE_NEAR).mean() <= UPDATE_MOVED, (diff > UPDATE_NEAR).sum()


def test_moe_at_tp2_is_not_the_unsharded_block(runs):
    """The reference's own definition: the tp-2 loss differs from the
    unsharded one, and the port follows the tp run."""
    losses, _ = unsharded_grads(MOE, runs["jax"][MOE])
    jax = runs["jax"][MOE]["losses"]
    assert np.abs(jax - losses).max() > 1e-4
