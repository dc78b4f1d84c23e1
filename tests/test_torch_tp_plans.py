"""The port's logical axes and shards against the reference's, no training.

``models.logical.logical_axes(cfg)`` equals JAX's ``unzip(init_params(...))
[1]`` leaf for leaf for every arch of the registry (``reduced()``, traced
abstractly by ``jax.eval_shape``).  ``plans.shard_tree`` cuts the shards
the reference's ``spec_for`` gives (each rank's block of every split
dimension, at tp 2 and 4), and ``gather_tree`` puts them back bit for bit;
the decode plan keeps the attention heads whole, as
``adjust_attn_specs_for_decode`` does.  ``ShardCtx``'s collectives on two
``gloo`` CPU ranks: each forward against its plain meaning and each
backward against the transpose the reference's ``shard_map`` takes.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import logical
from repro_torch.parallel import plans, steps
from repro_torch.tree import tree_leaves, tree_map

ARCHS = sorted(registry.ARCHS)


def _jax_logical(arch):
    import jax
    from repro.configs import registry as jreg
    from repro.models import model as JM
    from repro.models.common import Param

    cfg = jreg.get_config(arch).reduced(dtype="float32", remat=False)
    tree = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
    return jax.tree.map(lambda p: (tuple(p.logical), tuple(p.value.shape)), tree,
                        is_leaf=lambda x: isinstance(x, Param))


def _flat(tree):
    """(path, leaf) pairs of a nested dict/list tree, leaves as given."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        elif node is not None:
            out.append((path, node))

    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_match_the_reference(arch):
    from repro_torch.models import convert

    cfg = registry.get_config(arch).reduced(dtype="float32", remat=False)
    want = _flat(_jax_logical(arch))
    got = _flat(logical.logical_axes(cfg))
    shapes = _flat(convert.expected_shapes(cfg))
    assert [p for p, _ in got] == [p for p, _ in want] == [p for p, _ in shapes]
    for (path, ax), (_, (names, shape)), (_, s) in zip(got, want, shapes):
        assert ax.names == names, path
        assert tuple(s) == shape, path


def _jax_specs(arch, tp, decode=False):
    """Per leaf, the model-axis dimension of the reference's spec (None:
    replicated) for a stacked tree on a (2, tp) mesh."""
    from repro.parallel.plans import Plan as JPlan, adjust_attn_specs_for_decode, spec_for

    jplan = JPlan(name="gossip_dp", mesh_axes=("data", "model"), replica_axes=("data",),
                  tp=tp, replicas=2, kv_shard_seq=decode)

    class _Mesh:   # spec_for reads the mesh only for "dp" axes
        axis_names = ("data", "model")
        devices = np.zeros((2, tp))

    tree = _jax_logical(arch)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if node is None:
            return None
        names, shape = node
        return spec_for(jplan, _Mesh(), ("replica",) + names, (2,) + shape)

    specs = adjust_attn_specs_for_decode(jplan, walk(tree), None)
    return [None if "model" not in tuple(s) else tuple(s).index("model")
            for _, s in _flat(specs)]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-370m", "paper-small-125m",
                                  "qwen3-0.6b", "recurrentgemma-9b", "whisper-base"])
def test_shards_match_the_reference_specs_and_gather_back(arch, tp):
    from repro_torch.models import model as model_api

    cfg = registry.get_config(arch).reduced(dtype="float32", remat=False)
    full = tree_map(lambda t: t[None], model_api.init_params(torch.Generator().manual_seed(0),
                                                             cfg))
    for decode in (False, True):
        plan = plans.make_plan("gossip_dp", 1, tp, shape_kind="decode" if decode else "train")
        want = _jax_specs(arch, tp, decode)
        axes = logical.stacked(plans.adjust_attn_specs_for_decode(plan, logical.logical_axes(cfg)))
        dims = [plans.shard_dim(a.names, x.shape, plan)
                for x, a in zip(tree_leaves(full), tree_leaves(axes))]
        assert dims == want
        shards = [steps.shard_params(full, cfg, plan, i) for i in range(tp)]
        for dim, x, *parts in zip(dims, tree_leaves(full), *map(tree_leaves, shards)):
            for i, part in enumerate(parts):
                if dim is None:
                    assert part is x
                else:
                    n = x.shape[dim] // tp
                    assert torch.equal(part, x.narrow(dim, i * n, n))
        back = plans.gather_tree(shards, axes, plan, full)
        for a, b in zip(tree_leaves(back), tree_leaves(full)):
            assert torch.equal(a, b)


def test_plans():
    plan = plans.make_plan("gossip_dp", 4, 2)
    assert (plan.replicas, plan.tp, plan.world, plan.kv_shard_seq) == (4, 2, 8, False)
    assert [plan.replica_of(r) for r in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert [plan.model_index_of(r) for r in range(8)] == [0, 1] * 4
    assert plans.make_plan("gossip_dp", 1, 2, shape_kind="decode").kv_shard_seq
    assert not plans.make_plan("gossip_dp", 1, 2, shape_kind="decode",
                               has_global_attention=False).kv_shard_seq
    assert not plans.make_plan("gossip_dp", 2, 1, shape_kind="decode").kv_shard_seq
    with pytest.raises(ValueError, match="model axis"):
        plan.ctx()
    plan = plans.make_plan("fsdp_hybrid", 4, 2)
    assert (plan.replicas, plan.fsdp, plan.tp, plan.world) == (1, 4, 2, 8)
    assert [(plan.data_index_of(r), plan.model_index_of(r)) for r in range(8)] == [
        (d, m) for d in range(4) for m in range(2)]


def _collectives(group):
    """Each collective's forward and backward on this rank, on inputs that
    depend on the rank."""
    from repro_torch.parallel import sharding

    plan = plans.make_plan("gossip_dp", 1, 2)
    ctx = plan.ctx(group.model)
    i = group.model_index
    out = {}
    x = (torch.arange(24, dtype=torch.float64).reshape(2, 3, 4) + 100 * i).requires_grad_()
    w = torch.arange(24, dtype=torch.float64).reshape(2, 3, 4) * (i + 1)
    for name, fn in (("psum", lambda t: ctx.psum_model(t)),
                     ("all_gather", lambda t: ctx.all_gather_model(t, axis=1)),
                     ("reduce_scatter", lambda t: ctx.reduce_scatter_model(t, axis=0)),
                     ("all_to_all", lambda t: ctx.all_to_all_model(t, 0, 2))):
        y = fn(x)
        cot = torch.ones_like(y) * (i + 1) + torch.arange(y.numel(), dtype=y.dtype).view(y.shape)
        (g,) = torch.autograd.grad((y * cot).sum(), x)
        out[name] = (y.detach().numpy(), cot.numpy(), g.numpy())
    out["pmax"] = ctx.pmax_model(w).numpy()
    grads = sharding.psum_replicated([w, w * 2], [False, True], group.model)
    out["replicated"] = [g.numpy() for g in grads]
    out["x"] = x.detach().numpy()
    return out


def test_collectives_and_their_transposes():
    from repro_torch.launch import mesh

    r0, r1 = mesh.spawn(_collectives, 2, (), backend="gloo", device="cpu", threads=1, tp=2)
    xs = [r0["x"], r1["x"]]
    cots = lambda name: [r0[name][1], r1[name][1]]
    # psum: the sum; its transpose sums the cotangents
    for r in (r0, r1):
        np.testing.assert_array_equal(r["psum"][0], xs[0] + xs[1])
        np.testing.assert_array_equal(r["psum"][2], sum(cots("psum")))
    # all_gather along 1; transpose: reduce-scatter of the cotangents
    for i, r in enumerate((r0, r1)):
        np.testing.assert_array_equal(r["all_gather"][0], np.concatenate(xs, axis=1))
        np.testing.assert_array_equal(r["all_gather"][2],
                                      sum(cots("all_gather"))[:, 3 * i:3 * i + 3])
    # reduce_scatter along 0; transpose: all-gather of the cotangents
    for i, r in enumerate((r0, r1)):
        np.testing.assert_array_equal(r["reduce_scatter"][0], (xs[0] + xs[1])[i:i + 1])
        np.testing.assert_array_equal(r["reduce_scatter"][2],
                                      np.concatenate(cots("reduce_scatter"), axis=0))
    # all_to_all (split 0, concat 2); transpose: the inverse all_to_all
    for i, r in enumerate((r0, r1)):
        np.testing.assert_array_equal(r["all_to_all"][0],
                                      np.concatenate([x[i:i + 1] for x in xs], axis=2))
        c = cots("all_to_all")
        np.testing.assert_array_equal(r["all_to_all"][2],
                                      np.concatenate([cc[:, :, 4 * i:4 * i + 4] for cc in c],
                                                     axis=0))
    np.testing.assert_array_equal(r0["pmax"], r1["pmax"])
    np.testing.assert_array_equal(r0["pmax"], np.maximum(r0["pmax"], r1["pmax"]))
    w0 = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    for r in (r0, r1):   # the whole leaf summed over the axis, the split one untouched
        np.testing.assert_array_equal(r["replicated"][0], w0 * 3)
    np.testing.assert_array_equal(r1["replicated"][1], w0 * 4)
