"""Serving the MoE family: the port's paged steps and engine against the
JAX package's on the CPU, on granite-moe-1b-a400m's and
qwen3-moe-235b-a22b's ``reduced()`` configs in fp32.

An MoE block's capacity is shared by the rows routed together: a slot's
prefill chunk with the pad rows of a ragged last chunk, a decode step's R
rows with the idle slots'.  So the port must route exactly those rows
together, and a request's tokens may depend on its batch (the engines'
batched == solo guarantee does not hold for MoE).  Tolerances: logits of
the active slots within 1e-3 (fp32 sums in another order, as
``tests/test_torch_serve.py``); greedy engine tokens identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import model as JM
from repro.models.attention import PagedView as JaxView
from repro.models.common import values_of
from repro.parallel.sharding import ShardCtx
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxEngine
from repro_torch.configs import registry
from repro_torch.launch import serve as serve_cli
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.attention import PagedView
from repro_torch.serve import Request, ServeConfig, ServeEngine

CTX = ShardCtx.local()
ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]
LOGIT_ATOL = 1e-3
# more requests than slots (slots churn), prompts that end in a ragged
# chunk of 4, budgets that finish at different steps
MIX = [(3, 6), (11, 4), (5, 8), (9, 5), (14, 3), (2, 7), (7, 6)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: these small CPU runs gain
    nothing from more, and in a parallel test run the other workers'
    multi-device JAX subprocesses need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch):
    return (jax_registry.get_config(arch).reduced(dtype="float32", remat=False),
            registry.get_config(arch).reduced(dtype="float32", remat=False))


def _jax_numpy_params(jcfg, seed):
    return jax.tree.map(np.asarray, values_of(JM.init_params(jax.random.PRNGKey(seed), jcfg)))


def _requests(vocab, cls=Request, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=[int(t) for t in rng.integers(0, vocab, size=(pl,))], max_new=gl)
            for i, (pl, gl) in enumerate(MIX)]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_logits_match_jax(arch):
    """One prefill chunk of three slots (slot 0 ragged, slot 2 idle), then
    six decode steps with slot 2 idle: all rows of a call routed together,
    in both packages."""
    jcfg, cfg = _configs(arch)
    tree = _jax_numpy_params(jcfg, seed=1)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = convert.params_from_jax_numpy(tree, cfg)
    num_pages, page_size, chunk = 12, 4, 8
    rng = np.random.default_rng(0)
    tables = np.full((3, num_pages), num_pages, np.int32)
    tables[0, :4] = [5, 0, 9, 2]
    tables[1, :4] = [1, 7, 3, 11]
    active = np.array([True, True, False])
    lengths = np.array([7, 8, 0], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, size=(3, chunk)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, size=(6, 3, 1)).astype(np.int32)
    jcaches = JM.init_paged_cache_tree(jcfg, 3, num_pages, page_size)
    caches = M.init_paged_cache_tree(cfg, 3, num_pages, page_size)

    def views(pos):
        return (JaxView(jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(active)),
                PagedView(torch.from_numpy(tables), torch.from_numpy(pos), torch.from_numpy(active)))

    jv, tv = views(np.zeros(3, np.int32))
    want, jcaches = JM.paged_prefill_chunk(
        jparams, jcfg, jnp.asarray(tokens), jcaches, jv, CTX, lengths=jnp.asarray(lengths))
    got, caches = M.paged_prefill_chunk(
        params, cfg, torch.from_numpy(tokens), caches, tv, lengths=torch.from_numpy(lengths))
    errs = [np.abs(got.numpy()[active] - np.asarray(want)[active]).max()]
    pos = lengths.copy()
    for toks in steps:
        jv, tv = views(pos)
        want, jcaches = JM.paged_decode_step(jparams, jcfg, jnp.asarray(toks), jcaches, jv, CTX)
        got, caches = M.paged_decode_step(params, cfg, torch.from_numpy(toks), caches, tv)
        errs.append(np.abs(got.numpy()[active] - np.asarray(want)[active]).max())
        pos = pos + active
    assert max(errs) <= LOGIT_ATOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_jax(arch):
    """Seven requests through three slots, chunks of 4: the port's engine
    gives the JAX engine's greedy tokens, request for request."""
    jcfg, cfg = _configs(arch)
    tree = _jax_numpy_params(jcfg, seed=2)
    kw = dict(max_slots=3, num_pages=40, page_size=4, max_new_cap=8, prefill_chunk=4)
    jax_done = JaxEngine(jax.tree.map(jnp.asarray, tree), jcfg, JaxServeConfig(**kw)).run(
        _requests(cfg.vocab_size, JaxRequest))
    engine = ServeEngine(convert.params_from_jax_numpy(tree, cfg), cfg, ServeConfig(**kw))
    done = engine.run(_requests(cfg.vocab_size))
    want = {f.rid: f.tokens for f in jax_done}
    assert sorted(f.rid for f in done) == list(range(len(MIX)))
    for f in done:
        assert len(f.tokens) == MIX[f.rid][1]
        assert f.tokens == want[f.rid], f"rid {f.rid}"
    engine.alloc.check_leaks()


def test_serve_cli_runs_moe_on_cpu(capsys):
    summary = serve_cli.main(["--device", "cpu", "--arch", "granite-moe-1b-a400m",
                              "--requests", "3", "--max-batch", "2", "--pages", "24",
                              "--page-size", "8", "--prompt-lens", "5,40", "--gen-lens", "3,6",
                              "--prefill-chunk", "16"])
    assert summary["arch"] == "granite-moe-1b-a400m" and summary["requests"] == 3
    assert summary["gen_tokens"] == 3 + 6 + 3 and summary["device"] == "cpu"
