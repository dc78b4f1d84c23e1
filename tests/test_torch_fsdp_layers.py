"""Every family's loss and gradients under ``fsdp_hybrid`` against JAX's.

JAX runs ``build_loss_shard`` with ``make_plan("fsdp_hybrid", ...)`` on
``make_test_mesh(2, 2, pod=1)`` (one replica split over two data ranks ×
two model ranks, four forced host devices, one subprocess),
differentiated outside its ``shard_map`` as ``build_train_step`` does,
followed by one clipped AdamW step.  The port runs the same on four
``gloo`` CPU ranks (one spawn): each rank its (data, model) shard of the
replica (``plans.shard_tree``) and its data index's half of the batch, the
weights gathered over the data axis at use (``ShardCtx.gather_param``),
the backward from 1/(tp · fsdp) of the loss, the gradients of the leaves
held whole summed over the axis that holds them whole, AdamW clipping by
the replica's whole norm.  Both start from the port's initial weights and
the same batch, and run at the same time.

Configs: TINY (``tests/test_multidevice.py``'s dense model), and the
``reduced()`` mamba2-370m, recurrentgemma-9b, granite-moe-1b-a400m,
whisper-base (its ``enc_proj`` gathered on the frame width, stub
``encoder_embeds`` in the batch) and internvl2-76b (its ``projector``,
stub ``image_embeds``).  The loss, every leaf's gradient and the replica's
gradient norm within 1e-5 of JAX's; the clipped update as
``tests/test_torch_tp_layers.py`` holds it.  An MoE rank routes its own
rows and half of their sequence (capacity over its own tokens) and adds
its own auxiliary loss, so its loss is held on the ranks at model index 0,
whose loss JAX reports.
"""
import textwrap

import numpy as np
import pytest
import torch

import torch_dist_helpers as H

SCALE = 8.0   # the loss is scaled so that every config's gradient norm exceeds 1
B, S, FRAMES = 4, 16, 8
CONFIGS = ["tiny", "mamba2-370m", "recurrentgemma-9b", "granite-moe-1b-a400m", "whisper-base",
           "internvl2-76b"]
MOE = "granite-moe-1b-a400m"
JAX_PROCS = 3
JAX_RTOL = 1e-5
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
    from repro.models.common import Param, unzip
    from repro.models.config import ModelConfig
    from repro.optim import AdamWConfig, adamw_init, adamw_update
    from repro.parallel import compat, plans as PL, steps as ST

    spec = pickle.load(open(sys.argv[1], "rb"))
    mesh = make_test_mesh(2, 2, pod=1)
    out = {}
    for name in spec["configs"]:
        if name == "tiny":
            cfg = ModelConfig(**spec["tiny"])
        else:
            cfg = registry.get_config(name).reduced(dtype="float32", remat=False)
        plan = PL.make_plan("fsdp_hybrid", mesh, shape_kind="train")
        shapes = jax.eval_shape(lambda: M.init_params(jax.random.PRNGKey(0), cfg))
        params = jax.tree.map(lambda p, v: Param(jnp.asarray(v), p.logical), shapes,
                              spec["params"][name], is_leaf=lambda x: isinstance(x, Param))
        stacked = ST.stack_replicas(params, plan.replicas)
        vals, _ = unzip(stacked)
        batch = {k: jnp.asarray(v) for k, v in spec["batches"][name].items()}
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
            return losses, grads, new, gnorm

        with compat.set_mesh(mesh):
            losses, grads, new, gnorm = jax.jit(run)(vals)
        host = lambda t: jax.tree.map(np.asarray, t)
        out[name] = {"losses": np.asarray(losses), "grads": host(grads), "new": host(new),
                     "gnorm": np.asarray(gnorm)}
    pickle.dump(out, open(sys.argv[2], "wb"))
''')


def port_config(name):
    from repro_torch.configs import registry
    from repro_torch.models.config import ModelConfig

    if name == "tiny":
        return ModelConfig(**H.TINY)
    return registry.get_config(name).reduced(dtype="float32", remat=False)


def inputs(name):
    """The config's initial weights (the port's, numpy in JAX's layout) and
    its batch: tokens and labels (B, S), and the stub frontend's embeddings
    for whisper-base and internvl2-76b."""
    cfg = port_config(name)
    rng = np.random.default_rng(7)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
             for k in ("tokens", "labels")}
    key = {"audio": "encoder_embeds", "vision": "image_embeds"}.get(cfg.frontend)
    if key:
        batch[key] = rng.standard_normal((B, FRAMES, cfg.frontend_dim)).astype(np.float32)
    return H.port_params(cfg), batch


def rank_grads(group, given) -> dict:
    """Each config on this rank: the replica's loss, the whole gradient and
    the clipped AdamW step's whole θ (both gathered from the shards)."""
    from repro_torch.models import convert
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import plans, steps
    from repro_torch.tree import tree_map

    out = {}
    for name, (params, batch) in given.items():
        cfg = port_config(name)
        plan = plans.make_plan("fsdp_hybrid", group.fsdp, group.tp, pod=group.replicas)
        theta = tree_map(lambda t: t[None].contiguous(), convert.shard_from_jax_numpy(
            params, cfg, plan, group.model_index, data_index=group.data_index))
        batch = {k: torch.from_numpy(np.asarray(v)[None]) for k, v in batch.items()}
        batch = {k: v.long() if k in ("tokens", "labels") else v for k, v in batch.items()}
        bundle = steps.build_train_step(cfg, plan, group, AdamWConfig(lr=LR, weight_decay=0.0))
        captured = {}
        real_update = steps.adamw_update

        def spy(grads, opt, params, inner, active=None, norm=None):
            captured["grads"] = grads
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
        gather = lambda t: steps.gather_shards(t, cfg, plan, group.model, data=group.data)
        out[name] = {"loss": float(metrics["loss"][0]) / SCALE,
                     "grads": tree_map(lambda x: x[0].numpy(), gather(captured["grads"])),
                     "new": tree_map(lambda x: x[0].numpy(), gather(new)),
                     "gnorm": float(metrics["grad_norm"][0])}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch import mesh

    root = str(tmp_path_factory.mktemp("fsdp_layers"))
    given = {name: inputs(name) for name in CONFIGS}
    # the reference in JAX_PROCS subprocesses (its compiles dominate the
    # file), all running while the port's ranks do
    runs = []
    for i in range(JAX_PROCS):
        names = CONFIGS[i::JAX_PROCS]
        runs.append(H.start_script(JAX_SCRIPT, {
            "tiny": H.TINY, "configs": names, "scale": SCALE, "lr": LR,
            "params": {n: given[n][0] for n in names},
            "batches": {n: given[n][1] for n in names}}, root, 4, name=f"jax{i}",
            fast_compile=True))
    ranks = mesh.spawn(rank_grads, 4, (given,), backend="gloo", device="cpu", threads=1, tp=2,
                       fsdp=2)
    ref = {}
    for run in runs:
        ref.update(run.result())
    return {"jax": ref, "port": ranks}


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_match_jax(runs, name):
    jax, port = runs["jax"][name], runs["port"]
    for rank in range(4):
        got = port[rank][name]
        if rank % 2 == 0 or name != MOE:
            np.testing.assert_allclose(got["loss"], jax["losses"][0], rtol=JAX_RTOL)
        for g, w in zip(H.leaves(got["grads"]), H.leaves(jax["grads"])):
            w = w[0]
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=JAX_RTOL * max(np.abs(w).max(), 1e-3))


@pytest.mark.parametrize("name", CONFIGS)
def test_clipped_update_matches_jax(runs, name):
    """The replica's gradient norm (split leaves' squares summed over the
    axes that split them) within 1e-5, and the clipped update as the tp
    test holds it: AdamW's first step is lr·g/(|g| + eps) per element, so
    where |g| is near eps a last-bit difference moves a value by a share
    of lr."""
    jax, port = runs["jax"][name], runs["port"]
    assert jax["gnorm"][0] > 1.0
    for rank in range(4):
        np.testing.assert_allclose(port[rank][name]["gnorm"], jax["gnorm"][0], rtol=JAX_RTOL)
        got = np.concatenate([g.reshape(-1) for g in H.leaves(port[rank][name]["new"])])
        want = np.concatenate([w[0].reshape(-1) for w in H.leaves(jax["new"])])
        diff = np.abs(got - want)
        assert diff.max() <= LR, diff.max()
        assert (diff > UPDATE_NEAR).mean() <= UPDATE_MOVED, (diff > UPDATE_NEAR).sum()
