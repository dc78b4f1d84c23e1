"""The port's training slice against the JAX package's, on the CPU.

Both packages get the same inputs: the same synthetic batches (checked
``array_equal``), the same partner tables (checked identical), and the
same weights or training state, converted from the JAX tree with
``repro_torch.models.convert``.  The JAX side runs on its jnp twins
(``impl="jnp"``), the port on its plain versions.  Tolerances: fp32 atol
1e-5 for one loss and its gradients, 1e-6 for one optimizer or outer step
(sums in another order), and for whole runs per-step losses within 1e-4
relative and the final weight std within 1e-3 relative.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JCommConfig
from repro.configs import registry as jax_registry
from repro.core import outer as jouter
from repro.core import pairing as jpairing
from repro.data import LoaderConfig as JLoaderConfig
from repro.data import eval_batches as jeval_batches
from repro.data import shard_iterator as jshard_iterator
from repro.kernels import ops as jops
from repro.kernels.dispatch import KernelConfig, dispatch
from repro.launch.train import run_training as jax_run_training
from repro.models import model as JM
from repro.models.common import values_of
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import AdamWState as JAdamWState
from repro.optim import adamw_update as jadamw_update
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.parallel.sharding import ShardCtx
from repro_torch.comm import bytes_model
from repro_torch.configs import registry
from repro_torch.core import outer, pairing
from repro_torch.data import LoaderConfig, eval_batches, shard_iterator
from repro_torch.launch import train as train_cli
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, AdamWState, adamw_update, warmup_cosine
from repro_torch.train import adapters
from repro_torch.tree import tree_leaves, tree_map

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=128, dtype="float32", remat=False)          # tests/test_gossip_training.py
QUICKSTART = dict(name="quickstart-lm", num_layers=2, d_model=96, num_heads=4,
                  num_kv_heads=2, d_ff=192, vocab_size=256, dtype="float32",
                  remat=False)                                     # examples/quickstart.py


# the recurrent families' and the MoE family's smoke configs;
# recurrentgemma-9b at 3 layers (rglru, local, rglru) so that both mixers
# and the local attention run
REDUCED = {"paper-small-125m.reduced": ("paper-small-125m", {}),
           "mamba2-370m.reduced": ("mamba2-370m", {}),
           "recurrentgemma-9b.reduced3": ("recurrentgemma-9b", {"num_layers": 3}),
           "granite-moe-1b-a400m.reduced": ("granite-moe-1b-a400m", {})}


def _configs(kind):
    if kind in REDUCED:
        arch, kw = REDUCED[kind]
        kw = dict(kw, dtype="float32", remat=False)
        return jax_registry.get_config(arch).reduced(**kw), registry.get_config(arch).reduced(**kw)
    kw = TINY if kind == "tiny" else QUICKSTART
    return JModelConfig(**kw), ModelConfig(**kw)


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, values_of(JM.init_params(jax.random.PRNGKey(seed), jcfg)))


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,replicas,batch,seq,start", [(0, 4, 2, 32, 0), (3, 3, 1, 17, 5)])
def test_batches_array_equal(seed, replicas, batch, seq, start):
    kw = dict(vocab_size=300, seq_len=seq, per_replica_batch=batch, replicas=replicas, seed=seed)
    jit, pit = jshard_iterator(JLoaderConfig(**kw), start_step=start), shard_iterator(
        LoaderConfig(**kw), start_step=start)
    for _ in range(3):
        a, b = next(jit), next(pit)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(jeval_batches(JLoaderConfig(**kw), 2), eval_batches(LoaderConfig(**kw), 2)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def test_warmup_cosine_step_for_step():
    steps = np.arange(0, 130)
    want = np.asarray(jwarmup_cosine(3e-3, 120, warmup_steps=12)(jnp.asarray(steps)))
    got = warmup_cosine(3e-3, 120, warmup_steps=12)(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_adamw_step_for_step(grad_scale):
    """Three stacked AdamW steps (JAX vmaps the update over replicas):
    per-replica clipping, fp32 moments, schedule by the step counter."""
    rng = np.random.default_rng(1)
    r = 3
    params = {"a": rng.normal(size=(r, 5, 4)).astype(np.float32),
              "b": [rng.normal(size=(r, 7)).astype(np.float32)]}
    sched = dict(peak=1e-2, total_steps=10, warmup_steps=2)
    jcfg = JAdamWConfig(lr=jwarmup_cosine(**sched))
    pcfg = AdamWConfig(lr=warmup_cosine(**sched))
    jp, jst = jax.tree.map(jnp.asarray, params), None
    jst = JAdamWState(mu=jax.tree.map(jnp.zeros_like, jp), nu=jax.tree.map(jnp.zeros_like, jp),
                      count=jnp.zeros((r,), jnp.int32))
    pp = tree_map(torch.from_numpy, params)
    pst = AdamWState(mu=tree_map(torch.zeros_like, pp), nu=tree_map(torch.zeros_like, pp),
                     count=torch.zeros(r, dtype=torch.int32))
    update = jax.vmap(lambda g, o, p: jadamw_update(g, o, p, jcfg))
    for step in range(3):
        grads = tree_map(lambda x: (grad_scale * rng.normal(size=x.shape)).astype(np.float32),
                         params)
        jp, jst, jnorm = update(jax.tree.map(jnp.asarray, grads), jst, jp)
        pp, pst, pnorm = adamw_update(tree_map(torch.from_numpy, grads), pst, pp, pcfg)
        np.testing.assert_allclose(pnorm.numpy(), np.asarray(jnorm), rtol=1e-6)
        for got, want in zip(tree_leaves(pp) + tree_leaves(pst.mu) + tree_leaves(pst.nu),
                             jax.tree.leaves(jp) + jax.tree.leaves(jst.mu) + jax.tree.leaves(jst.nu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert pst.count.tolist() == [3] * r


# ---------------------------------------------------------------------------
# Model loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["tiny", "quickstart", "paper-small-125m.reduced",
                                  "mamba2-370m.reduced", "recurrentgemma-9b.reduced3"])
def test_loss_and_grads_match_jax(kind):
    jcfg, cfg = _configs(kind)
    params = _jax_params(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 41)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jb, ShardCtx.local()), has_aux=True
    )(jax.tree.map(jnp.asarray, params))
    tp = tree_map(lambda t: t.requires_grad_(), convert.params_from_jax_numpy(params, cfg))
    loss, aux = M.loss_fn(tp, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 and aux["aux_loss"].item() == 0.0
    for t, w in zip(tree_leaves(tp), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_stacked_loss_is_per_replica():
    """The stacked forward's replica r is loss_fn on replica r's weights and
    batch: R folds into the batch without mixing replicas."""
    jcfg, cfg = _configs("tiny")
    reps = [convert.params_from_jax_numpy(_jax_params(jcfg, seed), cfg) for seed in (0, 1, 2)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *reps)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 128, size=(3, 2, 17)))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    losses = M.stacked_loss(stacked, cfg, batch)
    for r, p in enumerate(reps):
        one, _ = M.loss_fn(p, cfg, {k: v[r] for k, v in batch.items()})
        torch.testing.assert_close(losses[r], one, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["mamba2-370m.reduced", "recurrentgemma-9b.reduced3"])
def test_stacked_recurrent_loss_is_per_replica(kind):
    """The recurrent mixers fold the replicas into one scan over R·B rows,
    each row with its replica's rates: replica r of the stacked loss and of
    its gradients is loss_fn on replica r's weights and batch alone."""
    jcfg, cfg = _configs(kind)
    reps = [convert.params_from_jax_numpy(_jax_params(jcfg, seed), cfg) for seed in (0, 1, 2)]
    stacked = tree_map(lambda *xs: torch.stack(xs).requires_grad_(), *reps)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, size=(3, 2, 25)))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    losses = M.stacked_loss(stacked, cfg, batch)
    losses.sum().backward()
    for r, p in enumerate(reps):
        p = tree_map(lambda t: t.requires_grad_(), p)
        one, _ = M.loss_fn(p, cfg, {k: v[r] for k, v in batch.items()})
        one.backward()
        torch.testing.assert_close(losses[r], one, atol=1e-6, rtol=0)
        for s_leaf, leaf in zip(tree_leaves(stacked), tree_leaves(p)):
            torch.testing.assert_close(s_leaf.grad[r], leaf.grad, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# Outer step
# ---------------------------------------------------------------------------


def _jax_state(jcfg, replicas, seed=0):
    """A mid-training-like JAX state: θ, φ, δ differ per replica."""
    rng = np.random.default_rng(seed)
    one = _jax_params(jcfg)
    noise = lambda x, s: (x[None] + s * rng.normal(size=(replicas,) + x.shape)).astype(x.dtype)
    return {
        "theta": jax.tree.map(lambda x: noise(x, 0.05), one),
        "opt": {"mu": jax.tree.map(lambda x: noise(x, 1e-3), one),
                "nu": jax.tree.map(lambda x: np.abs(noise(x, 1e-3)), one),
                "count": np.full((replicas,), 7, np.int32)},
        "outer": {"phi": jax.tree.map(lambda x: noise(x, 0.05), one),
                  "delta": jax.tree.map(lambda x: noise(0 * x, 0.01), one),
                  "step": np.int32(3)},
        "inner_step": np.int32(21),
    }


@pytest.mark.parametrize("method", ["noloco", "diloco", "none"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "active-mask"])
def test_outer_step_stacked_matches_jax(method, masked):
    jcfg, cfg = _configs("tiny")
    world = 5
    state = _jax_state(jcfg, world)
    ocfg = dict(method=method, alpha=0.5 if method != "diloco" else 0.3, beta=0.7, seed=2)
    active = np.array([True, False, True, True, True]) if masked else None
    partner = jpairing.partner_table(state["outer"]["step"], world, seed=2)
    jst = jouter.OuterState(phi=jax.tree.map(jnp.asarray, state["outer"]["phi"]),
                            delta=jax.tree.map(jnp.asarray, state["outer"]["delta"]),
                            step=jnp.int32(3))
    jnew, jtheta = jouter.outer_step_stacked(
        jst, jax.tree.map(jnp.asarray, state["theta"]), jouter.OuterConfig(**ocfg),
        partner=jnp.asarray(partner) if method == "noloco" else None,
        active=None if active is None else jnp.asarray(active),
        comm_cfg=JCommConfig())
    ps = convert.train_state_from_jax_numpy(state, cfg)
    pnew, ptheta = outer.outer_step_stacked(
        ps.outer, ps.theta, outer.OuterConfig(**ocfg), active=active)  # pairing from step
    assert pnew.step == 4
    for got, want in zip(tree_leaves(ptheta) + tree_leaves(pnew.phi) + tree_leaves(pnew.delta),
                         jax.tree.leaves(jtheta) + jax.tree.leaves(jnew.phi)
                         + jax.tree.leaves(jnew.delta)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("codec", ["int8", "fp16", "bf16"])
def test_outer_step_with_codec_matches_jax(codec):
    """One NoLoCo outer step over a lossy wire on the same state."""
    jcfg, cfg = _configs("tiny")
    world = 4
    state = _jax_state(jcfg, world)
    ocfg = dict(method="noloco", alpha=0.5, beta=0.7, seed=2)
    partner = jpairing.partner_table(state["outer"]["step"], world, seed=2)
    jst = jouter.OuterState(phi=jax.tree.map(jnp.asarray, state["outer"]["phi"]),
                            delta=jax.tree.map(jnp.asarray, state["outer"]["delta"]),
                            step=jnp.int32(3))
    jnew, jtheta = jax.jit(lambda s, t: jouter.outer_step_stacked(
        s, t, jouter.OuterConfig(**ocfg), partner=jnp.asarray(partner),
        comm_cfg=JCommConfig(codec=codec, chunk=256)))(
            jst, jax.tree.map(jnp.asarray, state["theta"]))
    ps = convert.train_state_from_jax_numpy(state, cfg)
    pnew, ptheta = outer.outer_step_stacked(ps.outer, ps.theta, outer.OuterConfig(**ocfg),
                                            comm_cfg=train_cli.CommConfig(codec=codec, chunk=256))
    for got, want in zip(tree_leaves(ptheta) + tree_leaves(pnew.delta),
                         jax.tree.leaves(jtheta) + jax.tree.leaves(jnew.delta)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_train_state_conversion_round_trip():
    jcfg, cfg = _configs("tiny")
    state = _jax_state(jcfg, 3)
    ps = convert.train_state_from_jax_numpy(state, cfg)
    assert ps.outer.step == 3 and ps.inner_step == 21 and ps.opt.count.tolist() == [7] * 3
    for got, want in zip(tree_leaves(ps.opt.nu), jax.tree.leaves(state["opt"]["nu"])):
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="shape"):
        convert.train_state_from_jax_numpy(_jax_state(jcfg, 3) | {"theta": state["outer"]["phi"]
                                                                   | {"embed": {"table": np.zeros((3, 1, 64))}}}, cfg)


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------

RUN = dict(replicas=4, per_replica_batch=2, seq_len=32, steps=20, inner_lr=3e-3,
           inner_steps=10, eval_every=10, eval_batches=1)


def _events(path):
    return [json.loads(line) for line in open(path)]


def _nan_safe_jnp_ssd_intra(x, dt, a, b_mat, c_mat):
    """The JAX twin ``ref.jnp_ssd_chunk_intra`` with L masked before the
    exponential instead of after it: the same values, but a masked entry's
    exp(cums_i − cums_j), which overflows once a chunk's decay passes e^88,
    no longer meets a zero cotangent (0·inf = NaN in the vjp)."""
    q = x.shape[2]
    xf, dtf, bf, cf = (t.astype(jnp.float32) for t in (x, dt, b_mat, c_mat))
    cums = jnp.cumsum(dtf * a[None, None, None, :], axis=2)
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]
    tri = jnp.tril(jnp.ones((q, q), bool))[None, None, :, :, None]
    l_kern = jnp.exp(jnp.where(tri, diff, -jnp.inf))
    xdt = xf * dtf[..., None]
    y = jnp.einsum("bcij,bcijh,bcjhp->bcihp", jnp.einsum("bcin,bcjn->bcij", cf, bf), l_kern, xdt)
    states = jnp.einsum("bcjn,bcjh,bcjhp->bchnp", bf, jnp.exp(cums[:, :, -1:, :] - cums), xdt)
    return y.astype(x.dtype), states


@functools.lru_cache(maxsize=None)
def _nan_safe_ssd_intra_op(impl, interpret):
    """``repro.kernels.ops._ssd_intra_op`` on its jnp path (the forward is
    the JAX twin as it is) with the vjp of :func:`_nan_safe_jnp_ssd_intra`."""
    fwd_impl = dispatch("ssd_chunk", KernelConfig("jnp"))

    @jax.custom_vjp
    def op(*args):
        return fwd_impl(*args)

    op.defvjp(lambda *args: (fwd_impl(*args), args),
              lambda res, g: jax.vjp(_nan_safe_jnp_ssd_intra, *res)[1](g))
    return op


@pytest.mark.parametrize("method", ["noloco", "diloco", "fsdp", "none"])
def test_run_training_matches_jax(method, tmp_path, monkeypatch):
    """run_training from the JAX initial weights: same losses, weight std,
    comm bytes and telemetry.  The recurrent families' NoLoCo runs are
    ``tests/test_torch_train_families.py``'s (a file of its own, so that a
    parallel run puts them on another worker)."""
    check_run_training(method, "tiny", tmp_path, monkeypatch)


def check_run_training(method, kind, tmp_path, monkeypatch, held=None):
    """The comparison of :func:`test_run_training_matches_jax` for ``kind``
    (see ``tests/test_torch_train_families.py`` for mamba2-370m's and
    ``tests/test_torch_train_moe.py`` for granite's, which pass ``held``,
    the steps whose losses and evals are held).  Returns (port's,
    reference's) summaries."""
    jcfg, cfg = _configs(kind)
    params = _jax_params(jcfg)
    monkeypatch.setattr(adapters.GossipProgram, "initial_params",
                        lambda self: convert.params_from_jax_numpy(params, cfg))
    if kind == "mamba2-370m.reduced":
        monkeypatch.setattr(jops, "_ssd_intra_op", _nan_safe_ssd_intra_op)
    jlog, plog = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    want = jax_run_training(jcfg, method=method, impl="jnp", log_jsonl=str(jlog), **RUN)
    got = train_cli.run_training(cfg, method=method, device="cpu", log_jsonl=str(plog), **RUN)
    evals_upto = RUN["steps"] if held is None else held
    if held is None:
        held = RUN["inner_steps"] if kind == "mamba2-370m.reduced" else RUN["steps"]
    assert np.isfinite(got["losses"]).all() and len(got["losses"]) == RUN["steps"]
    np.testing.assert_allclose(got["losses"][:held], want["losses"][:held], rtol=1e-4, atol=0)
    np.testing.assert_allclose(got["final_weight_std"], want["final_weight_std"], rtol=1e-3,
                               atol=1e-9)
    assert [t for t, _ in got["evals"]] == [t for t, _ in want["evals"]]
    np.testing.assert_allclose([e for t, e in got["evals"] if t <= evals_upto],
                               [e for t, e in want["evals"] if t <= evals_upto], rtol=1e-4)
    for key in ("comm_bytes", "blocking_bytes", "blocking_fraction", "outer_syncs",
                "stream_count", "membership_epoch", "steps_run"):
        assert got[key] == want[key], key
    assert got["comm"] == want["comm"]
    jev, pev = _events(jlog), _events(plog)
    assert [e["event"] for e in pev] == [e["event"] for e in jev]
    assert set(pev[-1]) == set(jev[-1])
    if method == "noloco":
        assert len(got["partners"]) == 2
        for i, table in enumerate(got["partners"]):
            np.testing.assert_array_equal(table, jpairing.partner_table(i, 4, seed=0))
    return got, want


def test_comm_cost_matches_jax_at_full_width():
    """The byte model on paper-small-125m in bf16, which nothing allocates."""
    from repro.comm import bytes_model as jbytes

    for method, overlap in (("noloco", False), ("noloco", True), ("diloco", False)):
        jcfg = dataclasses.replace(jax_registry.get_config("paper-small-125m"))
        jtree = jax.eval_shape(lambda: values_of(JM.init_params(jax.random.PRNGKey(0), jcfg)))
        want = jbytes.outer_step_cost(jtree, JCommConfig(overlap=overlap), method=method, world=4)
        got = bytes_model.outer_step_cost(
            bytes_model.abstract_params(registry.get_config("paper-small-125m")),
            train_cli.CommConfig(overlap=overlap), method=method, world=4)
        assert got.as_dict() == want.as_dict()


def test_cli_on_cpu(capsys, tmp_path):
    out = tmp_path / "res.json"
    summary = train_cli.main(["--device", "cpu", "--reduced", "--steps", "4", "--inner-steps", "2",
                              "--seq", "16", "--batch", "1", "--replicas", "3",
                              "--eval-every", "0", "--out", str(out)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert summary["device"] == "cpu" and summary["arch"] == "paper-small-125m"
    assert np.isfinite(summary["final_train_loss"]) and summary["final_weight_std"] > 0
    assert len(json.loads(out.read_text())["partners"]) == 2


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch):
    assert train_cli.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.run_training(ModelConfig(**TINY), steps=1)


@pytest.mark.parametrize("kwargs,syncs", [
    (dict(streams=2, overlap=True), 3), (dict(overlap=True), 2),
], ids=["streams", "overlap"])
def test_unported_options_raise(kwargs, syncs):
    """The two options that raised until streaming outer steps were ported:
    a short run on the CPU now trains through them (m 2, 4 steps: two
    streams sync at steps 2, 3 and 4; one stream at 2 and 4), and what the
    reference refuses raises its ``ValueError``: DiLoCo with streams, and
    the asynchronous replica clock with streams or the overlap."""
    from repro_torch.launch.train_elastic import run_elastic_training
    from repro_torch.sim import FaultPlan

    small = dict(steps=4, inner_steps=2, replicas=2, per_replica_batch=1, seq_len=8,
                 eval_every=0, device="cpu")
    res = train_cli.run_training(ModelConfig(**TINY), **small, **kwargs)
    assert res["outer_syncs"] == syncs and all(np.isfinite(res["losses"]))
    assert res["stream_count"] == kwargs.get("streams", 1) and res["blocking_fraction"] < 1.0
    with pytest.raises(ValueError, match="noloco-only"):
        train_cli.run_training(ModelConfig(**TINY), method="diloco", streams=2, overlap=True,
                               **small)
    with pytest.raises(ValueError, match="asynchronous replica clock does not compose"):
        run_elastic_training(ModelConfig(**TINY), FaultPlan(), async_clock=True,
                             stream_count=kwargs.get("streams", 1), overlap=True, **small)


@pytest.mark.parametrize("kwargs", [dict(codec="int8"), dict(ckpt_dir="ck")], ids=["int8", "ckpt"])
def test_ported_options_run(kwargs, tmp_path):
    """The two options that raised until the int8 codec and the checkpoint
    writer were ported: a short run on the CPU now trains through them."""
    if "ckpt_dir" in kwargs:
        kwargs = dict(ckpt_dir=str(tmp_path / kwargs["ckpt_dir"]))
    res = train_cli.run_training(ModelConfig(**TINY), steps=2, inner_steps=1, replicas=2,
                                 per_replica_batch=1, seq_len=8, eval_every=0, device="cpu",
                                 **kwargs)
    assert res["outer_syncs"] == 2 and all(np.isfinite(res["losses"]))
    if "codec" in kwargs:
        assert res["comm"]["codec"] == "int8" and res["comm_bytes"] == 2 * res["comm"]["payload_bytes"]
    else:
        assert os.listdir(kwargs["ckpt_dir"]) == ["step_00000002"]


@pytest.mark.parametrize("codec", ["int8", "fp16", "bf16"])
def test_run_training_with_codec_matches_jax(codec, monkeypatch):
    """NoLoCo over a lossy wire from the JAX initial weights, in the run of
    ``test_run_training_matches_jax``: same losses, weight std, partner
    tables and comm bytes.

    The int8 wire couples every value of a chunk through its min and max,
    so it amplifies the few weights where the two packages' AdamW steps
    already differ (13 weights by more than 1e-5 after 4 steps without a
    codec): over other run lengths the final weight std has differed by up
    to 1.7e-3 relative (15 steps, m 5), the losses never by more than
    2.1e-5.  On the same inputs the exchange itself is bit-exact
    (``tests/test_torch_codecs.py``) and one outer step agrees within 1e-6
    (``test_outer_step_with_codec_matches_jax``)."""
    jcfg, cfg = _configs("tiny")
    params = _jax_params(jcfg)
    monkeypatch.setattr(adapters.GossipProgram, "initial_params",
                        lambda self: convert.params_from_jax_numpy(params, cfg))
    want = jax_run_training(jcfg, method="noloco", impl="jnp", codec=codec, **RUN)
    got = train_cli.run_training(cfg, method="noloco", device="cpu", codec=codec, **RUN)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4, atol=0)
    np.testing.assert_allclose(got["final_weight_std"], want["final_weight_std"], rtol=1e-3)
    assert got["comm_bytes"] == want["comm_bytes"] and got["comm"] == want["comm"]
    assert len(got["partners"]) == 2
    for i, table in enumerate(got["partners"]):
        np.testing.assert_array_equal(table, jpairing.partner_table(i, 4, seed=0))
