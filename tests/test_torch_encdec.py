"""The encoder-decoder family in the port against the JAX package, on the CPU:
whisper-base's ``reduced()`` config and the enc-dec config of
``tests/test_decode_consistency.py``.

Weights come from the JAX initialiser and are converted; inputs (tokens,
stub frame embeddings) come from a numpy seed.  The JAX side runs its jnp
twins, jitted at XLA's lowest optimisation level (one quick compile per
function is quicker here than eager dispatch), the port its plain
versions.  Tolerances (fp32, sums in another
order): the encoder output within 1e-5; the loss within 1e-5 relative and
each gradient leaf within 1e-4 of its largest magnitude (normwise); the
prefill hidden state and every decode step's logits within 1e-4 absolute,
and the greedy tokens identical.  The flash op's plain version in ``full``
mode with Sq != Sk (cross-attention's shape) is held against the
reference's ``jnp_flash_attention``, forward within 1e-5 and its vjp
within 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.models.common import values_of
from repro.models.config import ModelConfig as JModelConfig
from repro.parallel.sharding import ShardCtx
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map

CTX = ShardCtx.local()
# tests/test_decode_consistency.py::test_encdec_cross_cache_built_at_prefill
SMALL = dict(arch_type="encdec", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=128, is_encoder_decoder=True, num_encoder_layers=2,
             encoder_seq=8, use_rope=False, norm_type="layernorm", frontend="audio",
             frontend_dim=64, frontend_tokens=8, dtype="float32", remat=False)
CONFIGS = ["whisper-base", "small"]
LOSS_RTOL, GRAD_NORM_RTOL, LOGIT_ATOL = 1e-5, 1e-4, 1e-4
_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0,
                                                    "xla_llvm_disable_expensive_passes": True})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side (see tests/test_torch_archs.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name, **kw):
    if name == "small":
        return JModelConfig(**SMALL, **kw), ModelConfig(**SMALL, **kw)
    kw = dict(dtype="float32", remat=False, **kw)
    return (jax_registry.get_config(name).reduced(**kw),
            registry.get_config(name).reduced(**kw))


@functools.lru_cache(maxsize=None)
def _jax_tree(jcfg, seed=0):
    """The JAX initialiser's weights as numpy, made once per config and seed."""
    init = _jit(lambda key: values_of(JM.init_params(key, jcfg)))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def _params(jcfg, cfg, seed=0):
    tree = _jax_tree(jcfg, seed)
    return jax.tree.map(jnp.asarray, tree), convert.params_from_jax_numpy(tree, cfg)


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    enc = rng.normal(size=(b, cfg.encoder_seq, cfg.frontend_dim)).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "encoder_embeds": enc}


def _normwise(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


def test_whisper_reduced_has_an_encoder_projection():
    """reduced() narrows d_model to 256 but the frames to 128, so enc_proj
    exists there, as in the reference; at full width it does not."""
    _, cfg = _configs("whisper-base")
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    assert params["enc_proj"].shape == (128, 256)
    assert "enc_proj" not in convert.expected_shapes(registry.get_config("whisper-base"))


@pytest.mark.parametrize("name", CONFIGS)
def test_encode_matches_jax(name):
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg, cfg)
    enc = _batch(cfg, 2, 4)["encoder_embeds"]
    want = _jit(lambda p, e: JM.encode(p, jcfg, e, CTX))(jp, jnp.asarray(enc))
    got = M.encode(tp, cfg, torch.from_numpy(enc))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_loss_and_grads_match_jax():
    jcfg, cfg = _configs("whisper-base")
    jp, tp = _params(jcfg, cfg)
    batch = _batch(cfg, 2, 12)
    (jloss, _), jgrads = _jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b, CTX), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tree_map(lambda t: t.requires_grad_(), tp)
    loss, parts = M.loss_fn(tp, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert parts["aux_loss"].item() == 0.0
    for t, w in zip(tree_leaves(tp), jax.tree.leaves(jgrads), strict=True):
        assert t.grad.shape == w.shape
        assert _normwise(t.grad.numpy(), w) <= GRAD_NORM_RTOL


def test_stacked_loss_matches_vmap():
    """Two replicas with their own weights and batches in one forward, the
    reference's loss vmapped over the replica axis."""
    jcfg, cfg = _configs("whisper-base")
    tree = _jax_tree(jcfg)
    rng = np.random.default_rng(1)   # replica 1: the same weights, each scaled apart
    stacked = jax.tree.map(
        lambda x: np.stack([x, x * rng.uniform(0.9, 1.1, x.shape).astype(x.dtype)]), tree)
    batches = [_batch(cfg, 2, 12, seed=s) for s in (0, 1)]
    batch = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    want = _jit(jax.vmap(lambda p, b: JM.loss_fn(p, jcfg, b, CTX)[0]))(
        jax.tree.map(jnp.asarray, stacked), {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.train_state_from_jax_numpy(
        {"theta": stacked, "opt": {"mu": stacked, "nu": stacked,
                                   "count": np.zeros((2,), np.int32)},
         "outer": {"phi": stacked, "delta": stacked, "step": 0}, "inner_step": 0}, cfg).theta
    got = M.stacked_loss(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=LOSS_RTOL, atol=0)


def test_token_batches_without_frames_are_refused():
    """The token loader makes no encoder_embeds, as the reference's does not;
    the loss says what it needs instead of failing on a missing key."""
    _, cfg = _configs("small")
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1, 4).items() if k != "encoder_embeds"}
    with pytest.raises(ValueError, match="encoder_embeds"):
        M.loss_fn(params, cfg, batch)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_greedy_decode_match_jax(name):
    """Prefill's last hidden state and every greedy decode step's logits
    against the reference's, each side feeding back its own argmax; the
    cross caches are built at prefill and only read afterwards."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg, cfg)
    batch = _batch(cfg, 2, 5, seed=3)
    prompt = {"tokens": batch["tokens"], "encoder_embeds": batch["encoder_embeds"]}
    jcache = values_of(JM.init_cache_tree(jcfg, 2, 16))
    jprefill = _jit(lambda p, b, c: JM.prefill(p, jcfg, b, c, CTX))
    jdecode = _jit(lambda p, t, i, c: JM.decode_step(p, jcfg, t, i, c, CTX))
    jh, jcache = jprefill(jp, {k: jnp.asarray(v) for k, v in prompt.items()}, jcache)
    with torch.no_grad():
        cache = M.init_cache_tree(cfg, 2, 16)
        h, cache = M.prefill(tp, cfg, {k: torch.from_numpy(v) for k, v in prompt.items()}, cache)
        assert h.shape == (2, 1, cfg.d_model)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=LOGIT_ATOL, rtol=0)
        cross = cache["scan"][0][1]
        enc_k = cross.k.clone()
        jtok = ttok = batch["labels"][:, -1:]
        jtoks, ttoks = [], []
        for i in range(5, 13):
            jlog, jcache = jdecode(jp, jnp.asarray(jtok), jnp.asarray(i), jcache)
            logits, cache = M.decode_step(tp, cfg, torch.from_numpy(np.asarray(ttok)), i, cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
            jtok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1))[:, None].astype(np.int32)
            ttok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32).numpy()
            jtoks.append(jtok)
            ttoks.append(ttok)
        assert np.array_equal(np.concatenate(jtoks, 1), np.concatenate(ttoks, 1))
        assert torch.equal(cache["scan"][0][1].k, enc_k)
        assert cache["scan"][0][0].index.tolist() == [13] * cfg.num_layers


@pytest.mark.parametrize("sq,sk,h,kv", [(1, 37, 4, 2), (5, 37, 4, 4), (9, 130, 8, 1)])
def test_plain_flash_full_mode_with_more_keys_than_queries(sq, sk, h, kv):
    """Cross-attention's shape: every query sees all Sk keys.  The port's
    plain flash op and its autograd against the reference's jnp twin and
    its vjp."""
    rng = np.random.default_rng(sq + sk)
    q = rng.normal(size=(2, sq, h, 16)).astype(np.float32)
    k = rng.normal(size=(2, sk, kv, 16)).astype(np.float32)
    v = rng.normal(size=(2, sk, kv, 16)).astype(np.float32)
    do = rng.normal(size=q.shape).astype(np.float32)
    want, want_grads = _jit(lambda a, b, c, g: (
        lambda out, vjp: (out, vjp(g)))(*jax.vjp(
            lambda *x: jref.jnp_flash_attention(*x, mode="full"), a, b, c)))(
        *map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, mode="full")
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for t, w in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_remat_changes_nothing_on_the_cpu():
    """The encoder and the decoder under torch.utils.checkpoint give the
    same loss and gradients as without it."""
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(_configs("small")[1], remat=remat)
        params = tree_map(lambda t: t.requires_grad_(),
                          M.init_params(torch.Generator().manual_seed(0), cfg))
        loss, _ = M.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                          for k, v in _batch(cfg, 2, 6).items()})
        loss.backward()
        results.append((loss.item(), [t.grad.clone() for t in tree_leaves(params)]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
