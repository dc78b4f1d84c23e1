"""The vision-frontend family in the port against the JAX package, on the
CPU: internvl2-76b's ``reduced()`` config (2 layers, d_model 256, 16 stub
patch embeddings of width 128 in front of the text).

Weights come from the JAX initialiser and are converted; tokens and patch
embeddings come from a numpy seed.  The JAX side runs jitted at XLA's
lowest optimisation level (one quick compile per function), the port its
plain versions.  Tolerances (fp32, sums in another order): the loss within
1e-5 relative and each gradient leaf within 1e-4 of its largest magnitude;
the prefill hidden state and every greedy decode step's logits within 1e-4
absolute, the greedy tokens identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import model as JM
from repro.models.common import values_of
from repro.parallel.sharding import ShardCtx
from repro_torch.configs import registry
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map

CTX = ShardCtx.local()
LOSS_RTOL, GRAD_NORM_RTOL, LOGIT_ATOL = 1e-5, 1e-4, 1e-4
_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0,
                                                    "xla_llvm_disable_expensive_passes": True})
JCFG = jax_registry.get_config("internvl2-76b").reduced(dtype="float32", remat=False)
CFG = registry.get_config("internvl2-76b").reduced(dtype="float32", remat=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side (see tests/test_torch_archs.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _tree():
    init = _jit(lambda key: values_of(JM.init_params(key, JCFG)))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def _params():
    tree = _tree()
    return jax.tree.map(jnp.asarray, tree), convert.params_from_jax_numpy(tree, CFG)


def _batch(b, s, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab_size, size=(b, s + 1)).astype(np.int32)
    img = rng.normal(size=(b, CFG.frontend_tokens, CFG.frontend_dim)).astype(np.float32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "image_embeds": img}
    if mask:
        out["loss_mask"] = rng.random((b, s)) < 0.6
    return out


def _normwise(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


def test_projector_and_untied_embedding():
    params = M.init_params(torch.Generator().manual_seed(0), CFG)
    assert params["projector"].shape == (CFG.frontend_dim, CFG.d_model)
    assert params["embed"]["unembed"].shape == (CFG.d_model, CFG.vocab_size)
    assert "encoder" not in params


@pytest.mark.parametrize("mask", [False, True], ids=["no-mask", "loss-mask"])
def test_loss_and_grads_match_jax(mask):
    """Labels are padded with zeros in front of the text and the loss mask
    with False, so the image rows predict nothing; RoPE positions run over
    image and text."""
    jp, tp = _params()
    batch = _batch(2, 12, mask=mask)
    (jloss, _), jgrads = _jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, JCFG, b, CTX), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tree_map(lambda t: t.requires_grad_(), tp)
    loss, _ = M.loss_fn(tp, CFG, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    for t, w in zip(tree_leaves(tp), jax.tree.leaves(jgrads), strict=True):
        assert t.grad.shape == w.shape
        assert _normwise(t.grad.numpy(), w) <= GRAD_NORM_RTOL
    assert tp["projector"].grad.abs().max() > 0


def test_text_only_batch_is_the_decoder_alone():
    """Without image_embeds the reference runs the text alone, and so does
    the port: the loss equals the one of a batch of the same tokens."""
    params = M.init_params(torch.Generator().manual_seed(0), CFG)
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, 8).items() if k != "image_embeds"}
    loss, _ = M.loss_fn(params, CFG, batch)
    x, mask_extra = M.embed_input(params, CFG, batch)
    assert mask_extra is None and x.shape == (2, 8, CFG.d_model)
    assert torch.isfinite(loss)


def test_prefill_and_greedy_decode_match_jax():
    """Dense prefill of the image embeddings and a 6-token prompt, then 8
    greedy steps on each side, from index 16 + 6."""
    jp, tp = _params()
    batch = _batch(2, 6, seed=3)
    prompt = {"tokens": batch["tokens"], "image_embeds": batch["image_embeds"]}
    n = CFG.frontend_tokens + 6
    jcache = values_of(JM.init_cache_tree(JCFG, 2, 32))
    jh, jcache = _jit(lambda p, b, c: JM.prefill(p, JCFG, b, c, CTX))(
        jp, {k: jnp.asarray(v) for k, v in prompt.items()}, jcache)
    jdecode = _jit(lambda p, t, i, c: JM.decode_step(p, JCFG, t, i, c, CTX))
    with torch.no_grad():
        cache = M.init_cache_tree(CFG, 2, 32)
        h, cache = M.prefill(tp, CFG, {k: torch.from_numpy(v) for k, v in prompt.items()}, cache)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=LOGIT_ATOL, rtol=0)
        jtok = ttok = batch["labels"][:, -1:]
        jtoks, ttoks = [], []
        for i in range(n, n + 8):
            jlog, jcache = jdecode(jp, jnp.asarray(jtok), jnp.asarray(i), jcache)
            logits, cache = M.decode_step(tp, CFG, torch.from_numpy(np.asarray(ttok)), i, cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
            jtok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1))[:, None].astype(np.int32)
            ttok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32).numpy()
            jtoks.append(jtok)
            ttoks.append(ttok)
    assert np.array_equal(np.concatenate(jtoks, 1), np.concatenate(ttoks, 1))


def test_paged_serving_refuses_a_vision_model():
    with pytest.raises(ValueError, match="paged serving supports decoder-only token models"):
        M.init_paged_cache_tree(CFG, 2, 8, 4)
