"""The port's routed pipeline against the JAX package's, on the CPU: the
cheap cases (no JAX training run).

- Routes equal JAX's integer for integer: random routing over steps 0–40
  for 4 and 8 replicas in 2 and 4 stages, fixed routing, and the elastic
  route with replica 2 dropped.
- Stage trees: JAX's leaf paths, shapes and dtypes for paper-small-125m at
  full width in 2 and 4 stages (abstract on both sides: nothing is
  allocated), ``TINY`` and recurrentgemma-9b's ``reduced()`` in 2 stages
  (each stage's single block an RG-LRU one); ``PipelineProgram.comm_cost``
  equal to JAX's.
- One loss and its gradients, port against JAX within 1e-5, from JAX's
  initial weights with the last stage's replicas made distinct: identity
  routes, ``[2, 3, 0, 1]`` and the cycle ``[1, 2, 3, 0]``, ``weights`` None, all ones and replica 2 at
  zero, on ``TINY`` and recurrentgemma-9b's ``reduced()`` in fp32 (its
  scan through the port's plain version).
- The port's own invariants (``tests/test_pipeline_routing.py``'s cases,
  ``tests/test_train_engine.py``'s pipeline ones), the CLI.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.elastic import ElasticContext as JElasticContext
from repro.models.common import values_of
from repro.models.config import ModelConfig as JModelConfig
from repro.pipeline import PipelineTrainer as JPipelineTrainer
from repro.pipeline.runner import init_stage_params as jinit_stage_params
from repro.comm import CommConfig as JCommConfig
from repro.core.outer import OuterConfig as JOuterConfig
from repro.train.adapters import PipelineProgram as JPipelineProgram
from repro_torch.comm import CommConfig, bytes_model
from repro_torch.configs import registry
from repro_torch.core.elastic import ElasticContext
from repro_torch.core.outer import OuterConfig
from repro_torch.data import LoaderConfig, shard_iterator
from repro_torch.launch import train_pipeline
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.pipeline import PipelineTrainer, split_stages
from repro_torch.pipeline.runner import init_stage_params
from repro_torch.train import LoopConfig, PipelineProgram, make_loop
from repro_torch.tree import tree_leaves, tree_map

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=128, dtype="float32", remat=False)
# tests/test_pipeline_routing.py's CFG
CFG = dict(num_layers=2, d_model=48, num_heads=4, num_kv_heads=4, d_ff=96, vocab_size=64,
           dtype="float32", remat=False)
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side, so that in a parallel test
    run the other workers' JAX processes keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name, **kw):
    if name == "tiny":
        return JModelConfig(**TINY), ModelConfig(**TINY)
    return jregistry.get_config(name).reduced(**kw), registry.get_config(name).reduced(**kw)


def _paths(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of dicts and lists whose leaves
    carry ``shape`` and ``dtype`` (arrays, tensors, abstract leaves)."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _paths(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree) for p, v in _paths(t, f"{prefix}/{i}").items()}
    if tree is None:
        return {}
    return {prefix: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


def _batch(cfg, replicas=4, seq=16, start=0):
    return next(shard_iterator(LoaderConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                            per_replica_batch=2, replicas=replicas),
                               start_step=start))


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("replicas,stages", [(4, 2), (4, 4), (8, 2), (8, 4)])
def test_random_routes_equal_jax(replicas, stages):
    cfg = dict(TINY, num_layers=4)
    jt = JPipelineTrainer(JModelConfig(**cfg), num_stages=stages, replicas=replicas, seed=3)
    pt = PipelineTrainer(ModelConfig(**cfg), num_stages=stages, replicas=replicas, seed=3,
                         device="cpu")
    seen = set()
    for step in range(41):
        want = [np.asarray(r) for r in jt.routes(step)]
        got = pt.routes(step)
        assert len(got) == stages - 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert sorted(g.tolist()) == list(range(replicas))
        seen.add(tuple(got[0].tolist()))
    assert len(seen) > 3


def test_fixed_and_elastic_routes_equal_jax():
    jfix = JPipelineTrainer(JModelConfig(**TINY), num_stages=2, replicas=4, routing="fixed")
    pfix = PipelineTrainer(ModelConfig(**TINY), num_stages=2, replicas=4, routing="fixed",
                           device="cpu")
    for step in (0, 7):
        np.testing.assert_array_equal(pfix.routes(step)[0], np.asarray(jfix.routes(step)[0]))
        np.testing.assert_array_equal(pfix.routes(step)[0], np.arange(4))
    jctx, pctx = JElasticContext(world=4), ElasticContext(world=4)
    jctx.set_membership(jctx.membership.drop([2]))
    pctx.set_membership(pctx.membership.drop([2]))
    jt = JPipelineTrainer(JModelConfig(**TINY), num_stages=2, replicas=4, elastic=jctx)
    pt = PipelineTrainer(ModelConfig(**TINY), num_stages=2, replicas=4, elastic=pctx,
                         device="cpu")
    for step in range(41):
        got, want = pt.routes(step)[0], np.asarray(jt.routes(step)[0])
        np.testing.assert_array_equal(got, want)
        assert got[2] == 2 and sorted(got[[0, 1, 3]].tolist()) == [0, 1, 3]


# ---------------------------------------------------------------------------
# Stage trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stages,leaves", [(2, [11, 13]), (4, [11, 10, 10, 13])])
def test_full_width_stage_trees_equal_jax(stages, leaves):
    """paper-small-125m at full width, abstract on both sides."""
    jcfg = jregistry.get_config("paper-small-125m")
    cfg = registry.get_config("paper-small-125m")
    total = 0
    for s in range(stages):
        want = jax.eval_shape(lambda s=s: values_of(
            jinit_stage_params(jax.random.PRNGKey(0), jcfg, s, stages)))
        got = bytes_model.abstract_stage_params(cfg, s, stages)
        assert _paths(got) == _paths(want)
        assert len(tree_leaves(got)) == leaves[s]
        total += sum(int(np.prod(x.shape)) for x in tree_leaves(got))
    assert total == 281_581_056
    if stages == 2:
        sizes = [sum(int(np.prod(x.shape)) for x in tree_leaves(
            bytes_model.abstract_stage_params(cfg, s, 2))) for s in range(2)]
        assert sizes == [140_789_760, 140_791_296]
    else:
        for s in (1, 2):
            assert set(bytes_model.abstract_stage_params(cfg, s, 4)) == {"stack"}


@pytest.mark.parametrize("codec,payload", [("none", 1_126_477_824), ("int8", 567_561_816)])
@pytest.mark.parametrize("stages", [2, 4])
def test_full_width_comm_cost_equals_jax(stages, codec, payload):
    jt = JPipelineTrainer(jregistry.get_config("paper-small-125m"), num_stages=stages,
                          replicas=4, outer=JOuterConfig(method="noloco", inner_steps=5),
                          comm=JCommConfig(codec=codec))
    pt = PipelineTrainer(registry.get_config("paper-small-125m"), num_stages=stages,
                         replicas=4, outer=OuterConfig(method="noloco", inner_steps=5),
                         comm=CommConfig(codec=codec), device="cpu")
    want = JPipelineProgram(jt).comm_cost()
    got = PipelineProgram(pt).comm_cost()
    assert got.payload_bytes == want.payload_bytes == payload
    assert got.raw_bytes == want.raw_bytes == 1_126_477_824
    assert (got.messages, got.blocking_bytes) == (want.messages, want.blocking_bytes)


@pytest.mark.parametrize("name", ["tiny", "recurrentgemma-9b"])
def test_stage_trees_equal_jax(name):
    jcfg, cfg = _configs(name)
    for s in range(2):
        want = jax.jit(lambda s=s: values_of(
            jinit_stage_params(jax.random.PRNGKey(0), jcfg, s, 2)))()
        got = init_stage_params(torch.Generator().manual_seed(0), cfg, s, 2)
        assert _paths(got) == _paths(want)
        # and the converter takes JAX's stage tree as it is
        conv = convert.stage_params_from_jax_numpy(jax.tree.map(np.asarray, want), cfg, s, 2)
        assert _paths(conv) == _paths(got)
    if name != "tiny":
        for scfg in split_stages(cfg, 2):
            assert scfg.num_layers == 1 and scfg.layer_types == ("rglru",)
        assert "mixer" in init_stage_params(torch.Generator().manual_seed(0), cfg, 1, 2)[
            "stack"]["rem"][0]
    with pytest.raises(ValueError, match="divide"):
        split_stages(cfg, 3)


# ---------------------------------------------------------------------------
# One loss and its gradients against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["tiny", "recurrentgemma-9b"])
def grad_case(request):
    """JAX's initial state of 4 replicas in 2 stages with the last stage's
    replicas made distinct, its value_and_grad jitted with and without
    weights, and the same state in the port."""
    jcfg, cfg = _configs(request.param, dtype="float32", remat=False)
    jt = JPipelineTrainer(jcfg, num_stages=2, replicas=4)
    state = jt.init(jax.random.PRNGKey(0))
    state["params"][1] = jax.tree.map(
        lambda v: v * (1.0 + 0.05 * jnp.arange(4).reshape((4,) + (1,) * (v.ndim - 1))),
        state["params"][1])
    tree = jax.tree.map(np.asarray, JPipelineProgram(jt).state_pytree(state))
    pstate = convert.pipeline_state_from_jax_numpy(tree, cfg, 2)
    pt = PipelineTrainer(cfg, num_stages=2, replicas=4, device="cpu")
    plain = jax.jit(jax.value_and_grad(lambda ps, b, r: jt.loss(ps, b, r)))
    weighted = jax.jit(jax.value_and_grad(lambda ps, b, r, w: jt.loss(ps, b, r, w)))
    return dict(jt=jt, jparams=state["params"], pt=pt, pparams=pstate["params"], cfg=cfg,
                plain=plain, weighted=weighted)


@pytest.mark.parametrize("weights", [None, "ones", "drop2"])
# [2, 3, 0, 1] is its own inverse; the cycle [1, 2, 3, 0] tells a route from
# its inverse
@pytest.mark.parametrize("route", [[0, 1, 2, 3], [2, 3, 0, 1], [1, 2, 3, 0]])
def test_loss_and_gradients_equal_jax(grad_case, route, weights):
    c = grad_case
    batch = _batch(c["cfg"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    w = None if weights is None else np.array([1, 1, 0 if weights == "drop2" else 1, 1],
                                              dtype=np.float32)
    if w is None:
        jl, jg = c["plain"](c["jparams"], jbatch, [jnp.asarray(route)])
    else:
        jl, jg = c["weighted"](c["jparams"], jbatch, [jnp.asarray(route)], jnp.asarray(w))
    params = [tree_map(lambda p: p.detach().requires_grad_(), ps) for ps in c["pparams"]]
    loss = c["pt"].loss(params, batch, [np.asarray(route)],
                        None if w is None else torch.from_numpy(w))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=GRAD_TOL)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for g, want in zip(grads, jleaves):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * max(float(np.abs(want).max()), 1e-30))


def test_gradients_follow_forward_route():
    """Swapping the route permutes which stage-1 replica accumulates each
    microbatch's gradient (``tests/test_pipeline_routing.py``'s case)."""
    cfg = ModelConfig(**CFG)
    pt = PipelineTrainer(cfg, num_stages=2, replicas=2, device="cpu")
    params = pt.init()["params"]
    scale = torch.tensor([1.0, 1.05])
    params[1] = tree_map(lambda v: v * scale.reshape((2,) + (1,) * (v.dim() - 1)), params[1])
    batch = _batch(cfg, replicas=2, seq=24)
    swap = np.array([1, 0])

    def grads(ps, route):
        ps = [tree_map(lambda p: p.detach().requires_grad_(), s) for s in ps]
        g = torch.autograd.grad(pt.loss(ps, batch, [route]), tree_leaves(ps[1]))
        return g

    g_id = grads(params, np.arange(2))
    params_sw = [params[0], tree_map(lambda v: v[torch.from_numpy(swap)], params[1])]
    g_sw = grads(params_sw, swap)
    for a, b in zip(g_id, g_sw):
        torch.testing.assert_close(a, b[torch.from_numpy(swap)], atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# The port's own invariants
# ---------------------------------------------------------------------------


def _batches(cfg, n, replicas=4, seq=24, start=0):
    it = shard_iterator(LoaderConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                     per_replica_batch=2, replicas=replicas), start_step=start)
    return [next(it) for _ in range(n)]


def test_fixed_routing_equals_independent_runs():
    """Fixed routing and no outer step: replica 0 depends on its own data
    alone."""
    cfg = ModelConfig(**CFG)
    runs = []
    for change in (False, True):
        tr = PipelineTrainer(cfg, num_stages=2, replicas=2, routing="fixed", device="cpu")
        st = tr.init()
        for b in _batches(cfg, 3, replicas=2):
            if change:
                b = {k: np.stack([v[0], np.roll(v[1], 3, axis=-1)]) for k, v in b.items()}
            st, _ = tr.train_step(st, b)
        runs.append(tree_leaves(st["params"][0])[0])
    torch.testing.assert_close(runs[0][0], runs[1][0], atol=1e-6, rtol=0)
    assert (runs[0][1] - runs[1][1]).abs().max() > 1e-6


def test_random_routing_trains():
    cfg = ModelConfig(**CFG)
    tr = PipelineTrainer(cfg, num_stages=2, replicas=4, device="cpu")
    st, losses = tr.init(), []
    for b in _batches(cfg, 25):
        st, loss = tr.train_step(st, b)
        losses.append(loss)
    assert losses[-1] < 0.8 * losses[0]


def test_routing_invisible_when_replicas_identical():
    cfg = ModelConfig(**CFG)
    tr = PipelineTrainer(cfg, num_stages=2, replicas=4, device="cpu")
    params = tr.init()["params"]
    batch = _batches(cfg, 1)[0]
    fixed = float(tr.loss(params, batch, [np.arange(4)]))
    routed = float(tr.loss(params, batch, [np.array([2, 3, 0, 1])]))
    assert abs(fixed - routed) < 1e-5


def test_outer_step_resets_fast_weights_and_fires_once():
    cfg = ModelConfig(**TINY)
    tr = PipelineTrainer(cfg, num_stages=2, replicas=4, inner=AdamWConfig(lr=3e-3, weight_decay=0.0),
                         outer=OuterConfig(method="noloco", inner_steps=2), device="cpu")
    state = tr.init()
    for b in _batches(cfg, 2, seq=16):
        state, _ = tr.train_step(state, b)
    state, synced = tr.maybe_outer_step(state)
    assert synced and state["outer"]["step"] == 1
    for s in range(2):
        for a, b in zip(tree_leaves(state["params"][s]), tree_leaves(state["outer"]["phi"][s])):
            assert torch.equal(a, b)
    assert len(tr.partners) == 1 and len(tr.partners[0]) == 2
    _, synced = tr.maybe_outer_step(state)
    assert not synced


def _loop(method, steps, codec="none"):
    cfg = ModelConfig(**TINY)
    outer = None if method == "none" else OuterConfig(method=method, inner_steps=5, seed=0)
    tr = PipelineTrainer(cfg, num_stages=2, replicas=4,
                         inner=AdamWConfig(lr=3e-3, weight_decay=0.0), outer=outer,
                         comm=CommConfig(codec=codec), device="cpu")
    lcfg = LoaderConfig(vocab_size=cfg.vocab_size, seq_len=32, per_replica_batch=2, replicas=4)
    return make_loop(PipelineProgram(tr), lcfg, LoopConfig(steps=steps)).run()


def test_noloco_reduces_weight_std_vs_none():
    none = _loop("none", 20)
    noloco = _loop("noloco", 20)
    assert noloco["outer_syncs"] == 4 and noloco["comm_bytes"] > 0 and none["comm_bytes"] == 0
    assert noloco["final_weight_std"] < 0.7 * none["final_weight_std"]
    assert noloco["losses"][-1] < noloco["losses"][0]
    assert none["membership_epoch"] is None


@pytest.mark.parametrize("method,codec", [("diloco", "none"), ("noloco", "int8")])
def test_diloco_and_int8_wire_train(method, codec):
    res = _loop(method, 10, codec=codec)
    assert res["outer_syncs"] == 2
    assert np.isfinite(res["losses"]).all() and res["losses"][-1] < res["losses"][0]
    cost = res["comm"]
    assert res["comm_bytes"] == 2 * cost["payload_bytes"] and cost["codec"] == (
        "none" if method == "diloco" else codec)


def test_cli_on_the_cpu(capsys):
    summary = train_pipeline.main(["--device", "cpu", "--reduced", "--stages", "2",
                                   "--steps", "4", "--inner-steps", "2", "--seq", "16",
                                   "--eval-every", "0"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == summary
    assert set(last) == {"arch", "stages", "replicas", "method", "routing", "final_loss",
                         "final_weight_std", "outer_syncs", "comm_bytes", "tokens_per_s",
                         "wall_s", "device"}
    assert last["device"] == "cpu" and last["outer_syncs"] == 2 and last["comm_bytes"] > 0
    with pytest.raises(SystemExit, match="must divide into --stages=3"):
        train_pipeline.main(["--device", "cpu", "--reduced", "--stages", "3"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_pipeline.main(["--reduced", "--steps", "1"])
