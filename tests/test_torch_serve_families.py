"""Serving the recurrent families through the port against the JAX package,
on the CPU: the "rglru" (RG-LRU + local attention) and "ssd" (Mamba-2)
configs of ``tests/test_serve.py`` and the ``reduced()`` configs of
recurrentgemma-9b and mamba2-370m.

Weights come from the JAX initialiser and are converted with
``repro_torch.models.convert``, so both packages compute the same function.
Chunked-prefill and decode logits agree with JAX's whole-sequence logits
within 1e-3 in fp32 (matmuls and scans sum in another order); greedy
engine tokens agree exactly, and within the port a request served in a
churning batch gets the tokens it gets alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import model as JM
from repro.models import transformer as jtfm
from repro.models.common import values_of
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.layers import apply_norm as japply_norm
from repro.models.layers import logits_sharded as jlogits
from repro.parallel.sharding import ShardCtx
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxEngine
from repro_torch.configs import registry
from repro_torch.launch import serve as serve_cli
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.attention import PagedView
from repro_torch.models.config import ModelConfig
from repro_torch.serve import Request, ServeConfig, ServeEngine

CTX = ShardCtx.local()
LOGIT_ATOL = 1e-3
# the "rglru" and "ssd" configs of tests/test_serve.py
TEST_KW = {
    "rglru": dict(arch_type="hybrid", num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
                  d_ff=128, vocab_size=128, attn_pattern=("rglru", "rglru", "local"),
                  sliding_window=6, lru_width=64, dtype="float32", remat=False),
    "ssd": dict(arch_type="ssm", num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=0,
                vocab_size=128, attn_pattern=("ssd",), ssm_state_dim=16, ssm_head_dim=32,
                ssm_chunk=4, use_rope=False, dtype="float32", remat=False),
}
NAMES = ["rglru", "ssd", "recurrentgemma-9b", "mamba2-370m"]
FP32_NAMES = {"scale", "bias", "dt_bias", "a_log", "d_skip", "norm_scale", "lam"}


def _configs(name, dtype="float32"):
    if name in TEST_KW:
        kw = dict(TEST_KW[name], dtype=dtype)
        return JaxModelConfig(**kw), ModelConfig(**kw)
    return (jax_registry.get_config(name).reduced(dtype=dtype, remat=False),
            registry.get_config(name).reduced(dtype=dtype, remat=False))


def _jax_numpy_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, values_of(JM.init_params(jax.random.PRNGKey(seed), jcfg)))


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def _shapes(tree):
    return {p: tuple(t.shape) for p, t in _named_leaves(tree)}


def _expected(tree, path=""):
    """{path: shape} of a tree of shape tuples, as ``_shapes`` gives it."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _expected(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, e in enumerate(tree) for k, v in _expected(e, f"{path}/{i}").items()}
    return {} if tree is None else {path: tuple(tree)}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_convert_round_trips_and_keeps_fp32_leaves(name):
    jcfg, cfg = _configs(name)
    tree = _jax_numpy_params(jcfg)
    params = convert.params_from_jax_numpy(tree, cfg, "cpu", torch.float32)
    got, want = dict(_named_leaves(params)), dict(_named_leaves(tree))
    assert list(got) == list(want)
    for path in want:
        np.testing.assert_array_equal(got[path].numpy(), want[path], err_msg=path)
    # a bf16 model keeps the norms, rates, skips and Λ in fp32, as JAX does
    jcfg16, cfg16 = _configs(name, "bfloat16")
    tree16 = _jax_numpy_params(jcfg16)
    params16 = convert.params_from_jax_numpy(tree16, cfg16)
    for path, t in _named_leaves(params16):
        want_dtype = torch.float32 if path.rsplit("/", 1)[-1] in FP32_NAMES else torch.bfloat16
        assert t.dtype == want_dtype, path
        assert str(dict(_named_leaves(tree16))[path].dtype) == str(want_dtype)[6:], path
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(lambda x: x, tree)
        mixer = bad["stack"]["scan"][0]["mixer"]
        mixer["conv"] = np.zeros((2, 2), np.float32)
        convert.params_from_jax_numpy(bad, cfg)


@pytest.mark.parametrize("name", NAMES)
def test_init_params_matches_jax_structure(name):
    jcfg, cfg = _configs(name, "bfloat16")
    jax_tree = jax.eval_shape(lambda: values_of(JM.init_params(jax.random.PRNGKey(0), jcfg)))
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    assert _shapes(params) == _shapes(jax_tree)
    assert _expected(convert.expected_shapes(cfg)) == _shapes(jax_tree)
    for (path, t), (_, j) in zip(_named_leaves(params), _named_leaves(jax_tree), strict=True):
        assert str(t.dtype)[6:] == str(j.dtype), path


# ---------------------------------------------------------------------------
# logits: chunked prefill and decode against JAX's whole-sequence forward
# ---------------------------------------------------------------------------


def _jax_full_logits(jparams, jcfg, toks):
    x, _ = JM.embed_input(jparams, jcfg, {"tokens": toks}, CTX)
    x, _, _ = jtfm.apply_stack(jparams["stack"], jcfg, x, CTX, positions=jnp.arange(toks.shape[1]))
    return np.asarray(jlogits(jparams["embed"], jcfg, japply_norm(jparams["final_norm"], x), CTX))


@pytest.mark.parametrize("name", NAMES)
def test_chunked_prefill_and_decode_logits_match_jax_full_forward(name):
    """One slot: a ragged prompt in chunks (the local window, 6 or 64, is
    crossed), then greedy-free decode steps on given tokens."""
    jcfg, cfg = _configs(name)
    tree = _jax_numpy_params(jcfg, seed=1)
    params = convert.params_from_jax_numpy(tree, cfg)
    small = name in TEST_KW
    prompt_len, chunk, steps, page_size = (19, 8, 5, 4) if small else (75, 32, 4, 16)
    rng = np.random.default_rng(2)
    seq = rng.integers(0, cfg.vocab_size, size=prompt_len + steps).astype(np.int32)
    full = _jax_full_logits(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(seq[None]))[0]

    pages = -(-len(seq) // page_size)
    caches = M.init_paged_cache_tree(cfg, 1, pages, page_size)
    table = torch.arange(pages, dtype=torch.int32)[None]
    active = torch.ones(1, dtype=torch.bool)
    errs = []
    for cur in range(0, prompt_len, chunk):
        n = min(chunk, prompt_len - cur)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :n] = seq[cur:cur + n]
        view = PagedView(table, torch.tensor([cur], dtype=torch.int32), active)
        logits, _ = M.paged_prefill_chunk(params, cfg, torch.from_numpy(toks), caches, view,
                                          lengths=torch.tensor([n], dtype=torch.int32))
        errs.append(np.abs(logits[0, 0].numpy() - full[cur + n - 1]).max())
    for i in range(steps - 1):
        pos = prompt_len + i
        view = PagedView(table, torch.tensor([pos], dtype=torch.int32), active)
        logits, _ = M.paged_decode_step(params, cfg, torch.tensor([[int(seq[pos])]]), caches, view)
        errs.append(np.abs(logits[0, 0].numpy() - full[pos]).max())
    assert max(errs) <= LOGIT_ATOL, errs


# ---------------------------------------------------------------------------
# the engine: tokens against JAX's engine, batched against solo
# ---------------------------------------------------------------------------

# (prompt length, budget): prompts of 1 to 4 chunks of 4
MIX = [(3, 6), (11, 4), (5, 8), (9, 5), (14, 3)]


def _requests(vocab, cls=Request, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=[int(t) for t in rng.integers(0, vocab, size=(pl,))], max_new=gl)
            for i, (pl, gl) in enumerate(MIX)]


@pytest.mark.parametrize("name", NAMES)
def test_engine_greedy_tokens_match_jax(name):
    jcfg, cfg = _configs(name)
    tree = _jax_numpy_params(jcfg, seed=2)
    kw = dict(max_slots=2, num_pages=24, page_size=4, max_new_cap=8, prefill_chunk=4)
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


@pytest.mark.parametrize("name", NAMES)
def test_batched_equals_solo_with_prefill_between_decode_steps(name):
    """A budget of one chunk per tick makes the long prompts' chunks
    alternate with decode steps of the other slot, which advance every
    slot's recurrent rows: the prompt's carried state must not live there."""
    _, cfg = _configs(name)
    params = M.init_params(torch.Generator().manual_seed(3), cfg)
    scfg = ServeConfig(max_slots=2, num_pages=24, page_size=4, max_new_cap=8,
                       prefill_chunk=4, prefill_budget=4)
    requests = _requests(cfg.vocab_size, seed=1)
    engine = ServeEngine(params, cfg, scfg)
    interleaved = []
    step = engine.step

    def traced_step():
        decoding = any(s is not None and s["phase"] == "decode" for s in engine._slots)
        prefilling = any(s is not None and s["phase"] == "prefill" and s["cursor"] > 0
                         for s in engine._slots)
        interleaved.append(decoding and prefilling)
        return step()

    engine.step = traced_step
    batched = {f.rid: f.tokens for f in engine.run([dataclasses.replace(r) for r in requests])}
    assert any(interleaved)   # some prompt was mid-prefill while another slot decoded
    for r in requests:
        [solo] = ServeEngine(params, cfg, scfg).run([dataclasses.replace(r)])
        assert solo.tokens == batched[r.rid], f"rid {r.rid}"


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_serve_cli_runs_on_cpu(arch, capsys):
    summary = serve_cli.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                              "--max-batch", "2", "--pages", "24", "--page-size", "8",
                              "--prompt-lens", "5,40", "--gen-lens", "3,6",
                              "--prefill-chunk", "16", "--verify"])
    assert summary["arch"] == arch and summary["requests"] == 3
    assert summary["gen_tokens"] == 3 + 6 + 3 and summary["parity"] is True
    assert summary["device"] == "cpu"
