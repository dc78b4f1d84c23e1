"""The port's layers (``repro_torch.models.layers``) against the JAX
package's (``repro.models.layers``) on the same numpy inputs, fp32, atol
1e-5 (XLA and ATen reduce in different orders)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models.config import ModelConfig as JaxConfig
from repro.parallel.sharding import ShardCtx
from repro_torch.models import layers as tl
from repro_torch.models.config import ModelConfig

CTX = ShardCtx.local()
ATOL = 1e-5
CFG = dict(d_model=32, d_ff=48, vocab_size=40, dtype="float32")


def _rng(seed):
    return np.random.default_rng(seed)


def _check(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _both(tree):
    """The same numpy tree as JAX and as torch leaves."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norm(norm_type):
    rng = _rng(0)
    p = {"scale": rng.normal(size=32).astype(np.float32)}
    if norm_type == "layernorm":
        p["bias"] = rng.normal(size=32).astype(np.float32)
    x = (3 * rng.normal(size=(2, 5, 32)) + 1).astype(np.float32)
    pj, pt = _both(p)
    _check(tl.apply_norm(pt, torch.from_numpy(x)), jl.apply_norm(pj, jnp.asarray(x)))
    cfg = ModelConfig(norm_type=norm_type, **CFG)
    init = tl.init_norm(cfg, 32)
    want = jl.init_norm(JaxConfig(norm_type=norm_type, **CFG), 32)
    assert sorted(init) == sorted(want)
    for k in init:
        _check(init[k], want[k].value)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = _rng(1)
    x = rng.normal(size=(3, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(3, 7)).astype(np.int32)
    _check(tl.rope_freqs(16, theta), jl.rope_freqs(16, theta))
    _check(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_sinusoidal_positions():
    _check(tl.sinusoidal_positions(50, 24), jl.sinusoidal_positions(50, 24))


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp(variant):
    rng = _rng(2)
    d, f = CFG["d_model"], CFG["d_ff"]
    p = {"w_in": rng.normal(size=(d, f)) / np.sqrt(d), "w_out": rng.normal(size=(f, d)) / np.sqrt(f)}
    if variant in ("swiglu", "geglu"):
        p["w_gate"] = rng.normal(size=(d, f)) / np.sqrt(d)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 6, d)).astype(np.float32)
    pj, pt = _both(p)
    jcfg = JaxConfig(mlp_variant=variant, **CFG)
    cfg = ModelConfig(mlp_variant=variant, **CFG)
    _check(tl.apply_mlp(pt, cfg, torch.from_numpy(x)), jl.apply_mlp(pj, jcfg, jnp.asarray(x), CTX))
    init = tl.init_mlp(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in init.items()} == {k: v.shape for k, v in p.items()}


@pytest.mark.parametrize("tie,softcap", [(True, None), (False, None), (True, 5.0)])
def test_embed_and_logits(tie, softcap):
    rng = _rng(3)
    d, v = CFG["d_model"], CFG["vocab_size"]
    p = {"table": rng.normal(size=(v, d)).astype(np.float32)}
    if not tie:
        p["unembed"] = rng.normal(size=(d, v)).astype(np.float32)
    jcfg = JaxConfig(tie_embeddings=tie, logit_softcap=softcap, **CFG)
    cfg = ModelConfig(tie_embeddings=tie, logit_softcap=softcap, **CFG)
    pj, pt = _both(p)
    toks = rng.integers(0, v, size=(2, 9)).astype(np.int32)
    emb = tl.embed_tokens(pt, cfg, torch.from_numpy(toks))
    _check(emb, jl.embed_tokens(pj, jcfg, jnp.asarray(toks), CTX))
    x = rng.normal(size=(2, 9, d)).astype(np.float32)
    logits = tl.logits_sharded(pt, cfg, torch.from_numpy(x))
    assert logits.dtype == torch.float32
    _check(logits, jl.logits_sharded(pj, jcfg, jnp.asarray(x), CTX))
    init = tl.init_embedding(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(t.shape) for k, t in init.items()} == {k: a.shape for k, a in p.items()}


def test_logits_cast_to_fp32_after_the_product():
    """bf16 weights: the product is taken in bf16 and only then cast, as in
    the JAX package, so bf16 logits carry bf16 rounding."""
    cfg = dataclasses.replace(ModelConfig(**CFG), dtype="bfloat16")
    rng = _rng(4)
    table = torch.from_numpy(rng.normal(size=(40, 32)).astype(np.float32)).bfloat16()
    x = torch.from_numpy(rng.normal(size=(1, 3, 32)).astype(np.float32)).bfloat16()
    got = tl.logits_sharded({"table": table}, cfg, x)
    assert got.dtype == torch.float32
    assert torch.equal(got, (x @ table.T).float())


def test_cross_entropy():
    rng = _rng(5)
    logits = (3 * rng.normal(size=(2, 7, 40))).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, 7)).astype(np.int32)
    mask = (rng.random(size=(2, 7)) > 0.3).astype(np.float32)
    jcfg, cfg = JaxConfig(**CFG), ModelConfig(**CFG)
    for m in (None, mask):
        s, n = tl.cross_entropy_parts(
            torch.from_numpy(logits), torch.from_numpy(labels), cfg,
            None if m is None else torch.from_numpy(m))
        sj, nj = jl.cross_entropy_parts(
            jnp.asarray(logits), jnp.asarray(labels), jcfg, CTX,
            None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(s.item(), float(sj), rtol=1e-6)
        assert n.item() == float(nj)
