"""The ``fsdp_hybrid`` plan's layout, shards and ZeRO-3 gather, no training.

``plans.make_plan("fsdp_hybrid", data, model, pod=)`` reads the layout as
the reference's ``make_plan`` reads its ``(pod, data, model)`` mesh: the
replicas are the pods, the data axis splits the weights.  Ranks are laid
out in the mesh's device order (rank = (pod · data + d) · model + m), and
the replica group built by ``mesh.spawn(..., tp=, fsdp=)`` on eight
``gloo`` CPU ranks agrees: each rank's model and data subgroups, its
partner ranks across pods.  ``plans.shard_tree`` cuts the blocks the
reference's ``spec_for`` gives under ``fsdp_hybrid`` on
``make_test_mesh(2, 2, pod=2)`` for every arch of the registry
(``reduced()``): a leaf split on one dimension over ``model`` and on
another over ``data``; ``gather_tree`` puts them back bit for bit.
``ShardCtx.gather_param`` on those ranks: the tiled all-gather over the
data axis forward, the reduce-scatter of the cotangents backward, the
identity for a width that does not divide; the data-axis sum of the
gradients of whole leaves; the batch rows of each data index.  Item 9b's
rounds and the serving steps under ``fsdp_hybrid`` raise, naming item 9e.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import logical
from repro_torch.parallel import plans, steps
from repro_torch.tree import tree_leaves, tree_map

ARCHS = sorted(registry.ARCHS)
POD, DATA, MODEL = 2, 2, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small trees gain nothing from more, and in
    a parallel test run the other workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_plan_layout():
    plan = plans.make_plan("fsdp_hybrid", DATA, MODEL, pod=POD)
    assert (plan.name, plan.replicas, plan.fsdp, plan.tp, plan.world) == (
        "fsdp_hybrid", POD, DATA, MODEL, 8)
    layout = [(p, d, m) for p in range(POD) for d in range(DATA) for m in range(MODEL)]
    assert [(plan.replica_of(r), plan.data_index_of(r), plan.model_index_of(r))
            for r in range(8)] == layout
    # under gossip_dp every (pod, data) coordinate is a replica
    gossip = plans.make_plan("gossip_dp", DATA, MODEL, pod=POD)
    assert (gossip.replicas, gossip.fsdp, gossip.tp, gossip.world) == (4, 1, 2, 8)
    assert plans.make_plan("fsdp_hybrid", 4).replicas == 1
    with pytest.raises(ValueError, match="model axis"):
        plan.ctx()
    with pytest.raises(ValueError, match="data axis"):
        plans.make_plan("fsdp_hybrid", DATA, pod=POD).ctx()
    with pytest.raises(ValueError, match="unknown plan"):
        plans.make_plan("zero3", 2)


def _jax_dims(arch):
    """Per leaf, the (model, data) dimensions of the reference's spec under
    ``fsdp_hybrid`` for a stacked tree on a (pod 2, data 2, model 2) mesh
    (None: whole over that axis)."""
    import jax
    from repro.configs import registry as jreg
    from repro.models import model as JM
    from repro.models.common import Param
    from repro.parallel.plans import Plan as JPlan, spec_for

    jplan = JPlan(name="fsdp_hybrid", mesh_axes=("pod", "data", "model"), replica_axes=("pod",),
                  fsdp_axis="data", tp=MODEL, fsdp=DATA, replicas=POD)

    class _Mesh:   # spec_for reads the mesh only for "dp" axes
        axis_names = ("pod", "data", "model")
        devices = np.zeros((POD, DATA, MODEL))

    cfg = jreg.get_config(arch).reduced(dtype="float32", remat=False)
    tree = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
    specs = [tuple(spec_for(jplan, _Mesh(), ("replica",) + tuple(p.logical),
                            (POD,) + tuple(p.value.shape)))
             for p in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, Param))]
    at = lambda s, axis: s.index(axis) if axis in s else None
    return [(at(s, "model"), at(s, "data")) for s in specs]


@pytest.mark.parametrize("arch", ARCHS)
def test_shards_match_the_reference_specs_and_gather_back(arch):
    from repro_torch.models import model as model_api

    cfg = registry.get_config(arch).reduced(dtype="float32", remat=False)
    plan = plans.make_plan("fsdp_hybrid", DATA, MODEL, pod=POD)
    full = tree_map(lambda t: t[None], model_api.init_params(torch.Generator().manual_seed(0),
                                                             cfg))
    axes = logical.stacked(logical.logical_axes(cfg))
    dims = [(plans.shard_dim(a.names, x.shape, plan), plans.fsdp_dim(a.names, x.shape, plan))
            for x, a in zip(tree_leaves(full), tree_leaves(axes))]
    assert dims == _jax_dims(arch)
    assert any(m is not None and d is not None for m, d in dims)
    places = [(d, m) for d in range(DATA) for m in range(MODEL)]
    shards = [steps.shard_params(full, cfg, plan, m, data_index=d) for d, m in places]
    for (dim, ddim), x, *parts in zip(dims, tree_leaves(full), *map(tree_leaves, shards)):
        for (d, m), part in zip(places, parts):
            want = x
            if dim is not None:
                n = x.shape[dim] // MODEL
                want = want.narrow(dim, m * n, n)
            if ddim is not None:
                n = x.shape[ddim] // DATA
                want = want.narrow(ddim, d * n, n)
            assert torch.equal(part, want)
    back = plans.gather_tree(shards, axes, plan, full)
    for a, b in zip(tree_leaves(back), tree_leaves(full)):
        assert torch.equal(a, b)


def _data_axis(group):
    """This rank's place, its subgroups and the data axis's gather, its
    transpose and the whole leaves' sum, on inputs that depend on the rank."""
    from repro_torch.parallel import sharding

    plan = plans.make_plan("fsdp_hybrid", DATA, MODEL, pod=POD)
    ctx = plan.ctx(group.model, group.data)
    d = group.data_index
    out = {"place": (group.replica, group.data_index, group.model_index),
           "model_ranks": group.model.ranks, "data_ranks": group.data.ranks,
           "partners": [group.rank_of(p) for p in range(POD)]}
    w = (torch.arange(24, dtype=torch.float64).reshape(1, 3, 8) + 100 * group.rank
         ).requires_grad_()
    y = ctx.gather_param(w, -1, 8 * DATA)
    cot = torch.arange(y.numel(), dtype=y.dtype).view(y.shape) * (d + 1)
    (g,) = torch.autograd.grad((y * cot).sum(), w)
    out["gather"] = (w.detach().numpy(), y.detach().numpy(), cot.numpy(), g.numpy())
    out["whole"] = ctx.gather_param(w, -1, 7) is w   # a width that does not divide stays
    grads = sharding.psum_replicated([w.detach(), w.detach() * 2], [False, True], group.data)
    out["summed"] = [x.numpy() for x in grads]
    batch = {"tokens": torch.arange(8).reshape(1, 4, 2), "odd": torch.arange(6).reshape(1, 3, 2)}
    out["rows"] = {k: v.numpy() for k, v in steps.data_rows(batch, plan, d).items()}
    return out


def test_replica_group_and_gather_param():
    from repro_torch.launch import mesh

    ranks = mesh.spawn(_data_axis, 8, (), backend="gloo", device="cpu", threads=1, tp=MODEL,
                       fsdp=DATA)
    plan = plans.make_plan("fsdp_hybrid", DATA, MODEL, pod=POD)
    for r, out in enumerate(ranks):
        p, d, m = out["place"]
        assert (p, d, m) == (plan.replica_of(r), plan.data_index_of(r), plan.model_index_of(r))
        assert out["model_ranks"] == [(p * DATA + d) * MODEL + j for j in range(MODEL)]
        assert out["data_ranks"] == [(p * DATA + j) * MODEL + m for j in range(DATA)]
        assert out["partners"] == [(q * DATA + d) * MODEL + m for q in range(POD)]
        peers = [ranks[j] for j in out["data_ranks"]]
        ws = [q["gather"][0] for q in peers]
        w, y, _, g = out["gather"]
        # forward: the data ranks' blocks in data-index order
        np.testing.assert_array_equal(y, np.concatenate(ws, axis=-1))
        # backward: this rank's block of the sum of the data ranks' cotangents
        cot = sum(q["gather"][2] for q in peers)
        np.testing.assert_array_equal(g, cot[..., 8 * d:8 * (d + 1)])
        assert out["whole"]
        np.testing.assert_array_equal(out["summed"][0], sum(ws))
        np.testing.assert_array_equal(out["summed"][1], w * 2)
        np.testing.assert_array_equal(out["rows"]["tokens"],
                                      np.arange(8).reshape(1, 4, 2)[:, 2 * d:2 * d + 2])
        np.testing.assert_array_equal(out["rows"]["odd"], np.arange(6).reshape(1, 3, 2))


@pytest.mark.parametrize("flag", ["elastic", "streams", "overlap", "stale"])
def test_rounds_and_serving_under_fsdp_hybrid_name_item_9e(flag):
    from repro_torch.comm import CommConfig
    from repro_torch.core.elastic import ElasticContext
    from repro_torch.core.outer import OuterConfig
    from repro_torch.launch import mesh, train_distributed
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import AdamWConfig

    plan = plans.make_plan("fsdp_hybrid", DATA, pod=POD)
    group = mesh.ReplicaGroup(rank=0, world=plan.world, device=torch.device("cpu"),
                              backend="gloo", fsdp=DATA)
    cfg = ModelConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=256, dtype="float32", remat=False)
    kw = {"elastic": {"elastic": ElasticContext(world=POD)},
          "streams": {"comm_cfg": CommConfig(streams=2, overlap=True)},
          "overlap": {"comm_cfg": CommConfig(overlap=True)},
          "stale": {"outer_cfg": OuterConfig(stale="momentum")}}[flag]
    args = dict(dict(cfg=cfg, group=group, plan=plan, outer_cfg=OuterConfig(),
                     inner_cfg=AdamWConfig()), **kw)
    with pytest.raises(NotImplementedError, match="item 9e"):
        train_distributed.DistributedTrainer(**args)
    for build in (steps.build_prefill_step, steps.build_decode_step):
        with pytest.raises(NotImplementedError, match="item 9e"):
            build(cfg, plan, group)
