"""The dense KV cache in the port against the JAX package, on the CPU: the
four cache kinds of ``tests/test_decode_consistency.py`` (global attention
with qk-norm, a local window of 6, RG-LRU with local attention, SSD).

Weights come from the JAX initialiser and are converted; tokens come from a
numpy seed.  The JAX side runs jitted at XLA's lowest optimisation level,
the port its plain versions.  Each decode step's logits are held against
the reference's within 1e-4 (fp32, sums in another order) and against the
port's own full forward within 2e-3, the reference test's tolerance
(prefill's flash op and decode's blockwise attention sum in other orders,
and so do the chunked and the stepwise recurrences).  The port's
``blockwise_attention`` is held against the reference's within 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import model as JM
from repro.models.common import values_of
from repro.models.config import ModelConfig as JModelConfig
from repro.parallel.sharding import ShardCtx
from repro_torch.models import attention
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm, logits_sharded
from repro_torch.tree import tree_map

CTX = ShardCtx.local()
# tests/test_decode_consistency.py's CFGS
CFGS = {
    "global": dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                   vocab_size=128, qk_norm=True, dtype="float32", remat=False),
    "local": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, d_ff=128,
                  vocab_size=128, attn_pattern=("local",), sliding_window=6,
                  dtype="float32", remat=False),
    "rglru": dict(arch_type="hybrid", num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
                  d_ff=128, vocab_size=128, attn_pattern=("rglru", "rglru", "local"),
                  sliding_window=6, lru_width=64, dtype="float32", remat=False),
    "ssd": dict(arch_type="ssm", num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                d_ff=0, vocab_size=128, attn_pattern=("ssd",), ssm_state_dim=16,
                ssm_head_dim=32, ssm_chunk=4, use_rope=False, dtype="float32", remat=False),
}
JAX_ATOL, SELF_ATOL = 1e-4, 2e-3
_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0,
                                                    "xla_llvm_disable_expensive_passes": True})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side (see tests/test_torch_archs.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_tree(kind):
    """The JAX initialiser's weights as numpy, made once per kind."""
    init = _jit(lambda key: values_of(JM.init_params(key, JModelConfig(**CFGS[kind]))))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def _setup(kind):
    jcfg, cfg = JModelConfig(**CFGS[kind]), ModelConfig(**CFGS[kind])
    tree = _jax_tree(kind)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), convert.params_from_jax_numpy(tree, cfg)


def _full_logits(params, cfg, toks):
    """The port's own forward without a cache (the training path, one
    replica), logits (B, S, V)."""
    stacked = tree_map(lambda t: t[None], params)
    x, _ = M.embed_input(stacked, cfg, {"tokens": toks[None]})
    x, _, _ = tfm.apply_stack(stacked["stack"], cfg, x, positions=torch.arange(toks.shape[1]))
    x = apply_norm(stacked["final_norm"], x)
    return logits_sharded(stacked["embed"], cfg, x)[0]


def _decode_both(kind, n_prompt, n_total, length, seed):
    """Prefill n_prompt tokens and decode the rest on both sides; returns
    the per-step logits (port, JAX) and the port's full-forward logits."""
    jcfg, cfg, jp, tp = _setup(kind)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n_total)).astype(np.int32)
    jcache = values_of(JM.init_cache_tree(jcfg, 1, length))
    _, jcache = _jit(lambda p, b, c: JM.prefill(p, jcfg, b, c, CTX))(
        jp, {"tokens": jnp.asarray(toks[:, :n_prompt])}, jcache)
    jdecode = _jit(lambda p, t, i, c: JM.decode_step(p, jcfg, t, i, c, CTX))
    got, want = [], []
    with torch.no_grad():
        full = _full_logits(tp, cfg, torch.from_numpy(toks))
        cache = M.init_cache_tree(cfg, 1, length)
        _, cache = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :n_prompt])}, cache)
        for i in range(n_prompt, n_total):
            tok = toks[:, i:i + 1]
            jlog, jcache = jdecode(jp, jnp.asarray(tok), jnp.asarray(i), jcache)
            logits, cache = M.decode_step(tp, cfg, torch.from_numpy(tok), i, cache)
            got.append(logits[:, 0].numpy())
            want.append(np.asarray(jlog[:, 0]))
    return got, want, full.numpy(), cache


@pytest.mark.parametrize("kind", list(CFGS))
def test_decode_matches_jax_and_the_full_forward(kind):
    got, want, full, _ = _decode_both(kind, 6, 12, 16, seed=3)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=JAX_ATOL, rtol=0, err_msg=f"{kind} step {i}")
        np.testing.assert_allclose(g, full[:, 6 + i], atol=SELF_ATOL, rtol=0,
                                   err_msg=f"{kind} step {i} vs the full forward")


def test_local_ring_buffer_wraps_past_its_window():
    """Prefill 4 tokens, then decode 16 through a ring of 6 slots: every step
    against JAX, and the last against the full forward."""
    got, want, full, cache = _decode_both("local", 4, 20, 20, seed=4)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=JAX_ATOL, rtol=0, err_msg=f"step {i}")
    np.testing.assert_allclose(got[-1], full[:, 19], atol=SELF_ATOL, rtol=0)
    ring = cache["scan"][0][0]
    assert ring.k.shape[2] == 6 and ring.index.tolist() == [20, 20]


def test_local_prefill_longer_than_the_window_fills_the_ring_in_slot_order():
    """A prompt of 9 through a ring of 6: the ring keeps positions 3..8, each
    at slot pos % 6, as the reference rolls them."""
    jcfg, cfg, jp, tp = _setup("local")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 9)).astype(np.int32)
    jcache = values_of(JM.init_cache_tree(jcfg, 1, 16))
    _, jcache = _jit(lambda p, b, c: JM.prefill(p, jcfg, b, c, CTX))(
        jp, {"tokens": jnp.asarray(toks)}, jcache)
    with torch.no_grad():
        cache = M.init_cache_tree(cfg, 1, 16)
        _, cache = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, cache)
    jring = jcache["scan"][0][0]
    ring = cache["scan"][0][0]
    np.testing.assert_allclose(ring.k.numpy(), np.asarray(jring.k), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ring.v.numpy(), np.asarray(jring.v), atol=1e-5, rtol=0)
    assert ring.index.tolist() == np.asarray(jring.index).tolist() == [9, 9]


@pytest.mark.parametrize("mode,window", [("causal", 0), ("local", 5), ("full", 0)])
def test_blockwise_attention_matches_jax(mode, window):
    """Across two KV blocks, with sentinel (negative) kv positions, a query
    that sees no live key, and expanded heads."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 3, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 21, 4, 16)).astype(np.float32)
    v = rng.normal(size=(2, 21, 4, 16)).astype(np.float32)
    qpos = np.array([0, 9, 20], np.int32)
    kvpos = np.arange(21, dtype=np.int32)
    kvpos[[0, 4, 13]] = -(10**9)
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v, qpos, kvpos)), mode=mode,
                                     window=window, block_kv=8)
    got = attention.blockwise_attention(*map(torch.from_numpy, (q, k, v, qpos, kvpos)),
                                        mode=mode, window=window, block_kv=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_decode_index_is_one_scalar_for_the_batch():
    cfg = ModelConfig(**CFGS["global"])
    tp = M.init_params(torch.Generator().manual_seed(0), cfg)
    cache = M.init_cache_tree(cfg, 2, 8)
    with pytest.raises(ValueError, match="one scalar"):
        M.decode_step(tp, cfg, torch.zeros((2, 1), dtype=torch.int32), torch.tensor([0, 1]),
                      cache)
