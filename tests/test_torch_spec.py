"""Speculative decoding, depth-truncated drafts and the replica router of
the port against the JAX package's, on the CPU, on the "global", "rglru"
and "ssd" configs of ``tests/test_serve_fast.py``.

Weights come from the JAX initialiser and are converted with
``repro_torch.models.convert``.  Each config's JAX runs (the plain engine
and ``SpecServeEngine`` with a self, a divergent and a truncated draft) are
made once, by a module-scoped fixture, on the load of
``tests/test_serve_fast.py``'s speculative tests: three requests, the
second sampled at temperature 0.7.  The port must give JAX's tokens, the
port's plain engine's tokens (``tests/test_serve_fast.py`` holds JAX's
speculative tokens to JAX's plain engine) and JAX's acceptance telemetry
exactly: ``spec_rounds``, ``accept_rate`` and every request's stats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models.common import values_of
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serve import ReplicaRouter as JaxRouter
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxEngine
from repro.serve import SpecServeEngine as JaxSpec
from repro.serve import truncate_layers as jax_truncate
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.serve import (
    ReplicaRouter,
    Request,
    ServeConfig,
    ServeEngine,
    SpecServeEngine,
    truncate_layers,
)
from repro_torch.tree import tree_leaves

KW = {
    "global": dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                   vocab_size=128, qk_norm=True, dtype="float32", remat=False),
    "rglru": dict(arch_type="hybrid", num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
                  d_ff=128, vocab_size=128, attn_pattern=("rglru", "rglru", "local"),
                  sliding_window=6, lru_width=64, dtype="float32", remat=False),
    "ssd": dict(arch_type="ssm", num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=0,
                vocab_size=128, attn_pattern=("ssd",), ssm_state_dim=16, ssm_head_dim=32,
                ssm_chunk=4, use_rope=False, dtype="float32", remat=False),
}
SCFG = dict(max_slots=2, num_pages=24, page_size=4, max_new_cap=8, prefill_chunk=4)
SPEC_K = 3
DRAFTS = ["self", "divergent", "truncated"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one intra-op thread, leaving the cores to JAX."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(cls, vocab):
    rng = np.random.default_rng(9)
    return [cls(rid=rid, prompt=rng.integers(0, vocab, size=(pl,)).tolist(), max_new=gl,
                temperature=temp)
            for rid, (pl, gl, temp) in enumerate([(3, 6, 0.0), (8, 5, 0.7), (5, 7, 0.0)])]


def _trees(kind, seed):
    jcfg = JaxModelConfig(**KW[kind])
    return jax.tree.map(np.asarray, values_of(JM.init_params(jax.random.PRNGKey(seed), jcfg)))


def _draft(name, target, divergent, cfg, trunc):
    """(draft params, draft cfg) of each draft kind in either package."""
    if name == "self":
        return target, cfg
    if name == "divergent":
        return divergent, cfg
    return trunc(target, cfg, 1)


def _run(engine, requests):
    done = engine.run(requests)
    return {f.rid: (f.tokens, f.stats) for f in done}


@pytest.fixture(scope="module")
def jax_runs():
    """Per config: the JAX weights (target seed 2, divergent draft seed 7)
    and JAX's speculative runs on them, made on first use."""
    cache: dict = {}

    def get(kind):
        if kind not in cache:
            jcfg = JaxModelConfig(**KW[kind])
            trees = {"target": _trees(kind, 2), "divergent": _trees(kind, 7)}
            jp = {k: jax.tree.map(jnp.asarray, v) for k, v in trees.items()}
            scfg = JaxServeConfig(**SCFG)
            runs = {}
            for name in DRAFTS:
                dp, dc = _draft(name, jp["target"], jp["divergent"], jcfg, jax_truncate)
                eng = JaxSpec(jp["target"], jcfg, scfg, dp, dc, spec_k=SPEC_K)
                runs[name] = _run(eng, _load(JaxRequest, jcfg.vocab_size))
                runs[name]["engine"] = (eng.spec_rounds, eng.accept_rate, eng.spec_prop_total)
            cache[kind] = (trees, runs)
        return cache[kind]

    return get


@pytest.mark.parametrize("draft", DRAFTS)
@pytest.mark.parametrize("kind", list(KW))
def test_spec_tokens_and_stats_match_jax(kind, draft, jax_runs):
    trees, runs = jax_runs(kind)
    cfg = ModelConfig(**KW[kind])
    target = convert.params_from_jax_numpy(trees["target"], cfg)
    divergent = convert.params_from_jax_numpy(trees["divergent"], cfg)
    dp, dc = _draft(draft, target, divergent, cfg, truncate_layers)
    engine = SpecServeEngine(target, cfg, ServeConfig(**SCFG), dp, dc, spec_k=SPEC_K)
    got = _run(engine, _load(Request, cfg.vocab_size))
    engine.alloc.check_leaks()
    want = runs[draft]
    plain = _run(ServeEngine(target, cfg, ServeConfig(**SCFG)), _load(Request, cfg.vocab_size))
    for rid in range(3):
        assert got[rid][0] == want[rid][0], f"rid {rid}: tokens differ from JAX's"
        assert got[rid][0] == plain[rid][0], f"rid {rid}: not the target-only tokens"
        assert got[rid][1] == want[rid][1], f"rid {rid}: stats"
    assert (engine.spec_rounds, engine.accept_rate, engine.spec_prop_total) == want["engine"]
    if draft == "self":
        assert engine.accept_rate == 1.0


@pytest.mark.parametrize("kind,keep", [("global", 1), ("global", 2), ("rglru", 1),
                                       ("rglru", 2), ("ssd", 1)])
def test_truncate_layers_of_converted_tree_equals_converted_jax_truncation(kind, keep):
    tree = _trees(kind, 0)
    jcfg, cfg = JaxModelConfig(**KW[kind]), ModelConfig(**KW[kind])
    jdraft, jdcfg = jax_truncate(jax.tree.map(jnp.asarray, tree), jcfg, keep)
    dparams, dcfg = truncate_layers(convert.params_from_jax_numpy(tree, cfg), cfg, keep)
    assert dcfg.num_layers == jdcfg.num_layers == keep
    want = convert.params_from_jax_numpy(jax.tree.map(np.asarray, jdraft), dcfg)
    got, exp = tree_leaves(dparams), tree_leaves(want)
    assert len(got) == len(exp) > 0
    for g, w in zip(got, exp):
        assert g.shape == w.shape and torch.equal(g, w)


def _router_requests(cls, vocab):
    rng = np.random.default_rng(1)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=(pl,)).tolist(), max_new=gl,
                temperature=t)
            for i, (pl, gl, t) in enumerate([(3, 5, 0.0), (9, 2, 0.0), (4, 6, 0.7), (2, 3, 0.0),
                                             (7, 4, 0.0)])]


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
def test_router_matches_jax(policy):
    """Two engines on two different seed weights: each request lands where
    JAX's router puts it and gets the tokens of that engine."""
    jcfg, cfg = JaxModelConfig(**KW["global"]), ModelConfig(**KW["global"])
    trees = [_trees("global", 2), _trees("global", 5)]
    jr = JaxRouter([JaxEngine(jax.tree.map(jnp.asarray, t), jcfg, JaxServeConfig(**SCFG))
                    for t in trees], policy=policy)
    want = {f.rid: (i, f.tokens) for i, f in jr.run(_router_requests(JaxRequest, cfg.vocab_size))}
    router = ReplicaRouter([ServeEngine(convert.params_from_jax_numpy(t, cfg), cfg,
                                        ServeConfig(**SCFG)) for t in trees], policy=policy)
    got = {f.rid: (i, f.tokens) for i, f in router.run(_router_requests(Request, cfg.vocab_size))}
    assert got == want
    assert router.routed == jr.routed
    if policy == "round_robin":
        assert router.routed == [3, 2]
    for eng in router.engines:
        eng.alloc.check_leaks()
