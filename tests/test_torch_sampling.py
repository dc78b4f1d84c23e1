"""The port's sampling noise and sampled tokens against the JAX package's,
on the CPU.

Token i of request rid draws ``jax.random.gumbel(fold_in(fold_in(
PRNGKey(17), rid), i), (V,), float32)`` in the JAX engine.  The port derives
the keys with its numpy threefry (``repro_torch.core.pairing``) and draws
the bits in torch integer ops (``random_bits_torch``): the bits and the
uniforms are held bit for bit.  The Gumbel values are held within 2 ulp of
max(|g|, 1): torch's and XLA's ``log`` each differ by at most 1 ulp, and
near g = 0 the outer log of a value near 1 turns that into an absolute, not
a relative, error.  Then the port's engine must give the JAX engine's
tokens at temperature 0.7 on the same weights; where a token differs, the
test prints the margin between the top two noisy logits of that draw.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models.common import values_of
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxEngine
from repro_torch.core import pairing
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve import engine as engine_mod

CPU = torch.device("cpu")
TINY = np.finfo(np.float32).tiny
VOCABS = [151_936, 128]   # qwen3-0.6b's vocabulary and the test configs'
RIDS_INDICES = [(rid, i) for rid in range(6) for i in range(6)]


def _jax_key(rid, index):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(17), rid), index)


def _port_keys():
    return np.stack([engine_mod._sample_key(rid, i) for rid, i in RIDS_INDICES])


def _jax_batch(fn):
    keys = jnp.stack([_jax_key(rid, i) for rid, i in RIDS_INDICES])
    return np.asarray(jax.jit(jax.vmap(fn))(keys))


def test_sample_keys_are_jax_keys():
    want = np.stack([np.asarray(jax.random.key_data(_jax_key(rid, i))) for rid, i in RIDS_INDICES])
    np.testing.assert_array_equal(_port_keys(), want)


@pytest.mark.parametrize("vocab", VOCABS)
def test_random_bits_torch_equal_numpy_and_jax(vocab):
    keys = _port_keys()
    got = pairing.random_bits_torch(torch.from_numpy(keys.astype(np.int64)), vocab, CPU)
    assert got.dtype == torch.int64 and got.shape == (len(keys), vocab)
    got = got.numpy()
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF
    got = got.astype(np.uint32)
    np.testing.assert_array_equal(got, np.stack([pairing.random_bits(k, vocab) for k in keys]))
    np.testing.assert_array_equal(got, _jax_batch(lambda k: jax.random.bits(k, (vocab,), jnp.uint32)))


@pytest.mark.parametrize("vocab", VOCABS)
def test_uniform_is_bit_identical_to_jax(vocab):
    got = engine_mod._uniform(_port_keys(), vocab, CPU).numpy()
    want = _jax_batch(lambda k: jax.random.uniform(k, (vocab,), jnp.float32, minval=TINY, maxval=1.0))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vocab", VOCABS)
def test_gumbel_within_two_ulp_of_jax(vocab):
    keys = _port_keys()
    got = engine_mod._gumbel(keys, vocab, CPU).numpy().astype(np.float64)
    want = _jax_batch(lambda k: jax.random.gumbel(k, (vocab,), jnp.float32))
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32)).astype(np.float64)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 2 * ulp).all(), np.abs(got - want).max()
    # each of the two logs alone is within 1 ulp of XLA's
    u = engine_mod._uniform(keys, vocab, CPU)
    inner_t, inner_j = -torch.log(u).numpy(), np.asarray(-jnp.log(jnp.asarray(u.numpy())))
    assert (np.abs(inner_t.astype(np.float64) - inner_j) <= np.spacing(inner_j)).all()


# ---------------------------------------------------------------------------
# the engine: sampled tokens against the JAX engine's
# ---------------------------------------------------------------------------

# the "global" and "rglru" configs and the mix of tests/test_serve.py, and the
# "ssd" config of tests/test_torch_serve_families.py
CFG_KW = {
    "global": dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                   vocab_size=128, qk_norm=True, dtype="float32", remat=False),
    "rglru": dict(arch_type="hybrid", num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
                  d_ff=128, vocab_size=128, attn_pattern=("rglru", "rglru", "local"),
                  sliding_window=6, lru_width=64, dtype="float32", remat=False),
    "ssd": dict(arch_type="ssm", num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=0,
                vocab_size=128, attn_pattern=("ssd",), ssm_state_dim=16, ssm_head_dim=32,
                ssm_chunk=4, use_rope=False, dtype="float32", remat=False),
}
MIX = [(3, 6, 0.0), (7, 4, 0.0), (5, 8, 0.7), (2, 5, 0.0)]
HOT = [(pl, gl, 0.7) for pl, gl, _ in MIX]


def _requests(cls, vocab, mix):
    rng = np.random.default_rng(0)
    return [cls(rid=rid, prompt=[int(t) for t in rng.integers(0, vocab, size=(pl,))],
                max_new=gl, temperature=temp)
            for rid, (pl, gl, temp) in enumerate(mix)]


@pytest.mark.parametrize("mix", [MIX, HOT], ids=["mix", "all-sampled"])
@pytest.mark.parametrize("kind", ["global", "rglru", "ssd"])
def test_engine_sampled_tokens_match_jax(kind, mix, monkeypatch):
    jcfg, cfg = JaxModelConfig(**CFG_KW[kind]), ModelConfig(**CFG_KW[kind])
    tree = jax.tree.map(np.asarray, values_of(JM.init_params(jax.random.PRNGKey(2), jcfg)))
    kw = dict(max_slots=2, num_pages=24, page_size=4, max_new_cap=8)
    jax_done = JaxEngine(jax.tree.map(jnp.asarray, tree), jcfg, JaxServeConfig(**kw)).run(
        _requests(JaxRequest, cfg.vocab_size, mix))
    want = {f.rid: f.tokens for f in jax_done}

    margins = {}   # (rid, index) -> top-1 minus top-2 of the port's noisy logits
    perturb = engine_mod._perturb

    def recording(logits, draws):
        noisy = perturb(logits, draws)
        for row, d in enumerate(draws):
            if d is not None:
                top = torch.topk(noisy[row], 2).values
                margins[(d[1], d[2])] = float(top[0] - top[1])
        return noisy

    monkeypatch.setattr(engine_mod, "_perturb", recording)
    params = convert.params_from_jax_numpy(tree, cfg)
    done = {f.rid: f.tokens for f in ServeEngine(params, cfg, ServeConfig(**kw)).run(
        _requests(Request, cfg.vocab_size, mix))}
    assert sorted(done) == sorted(want)
    for rid, tokens in done.items():
        if tokens != want[rid]:
            i = next(i for i, (a, b) in enumerate(zip(tokens, want[rid])) if a != b)
            pytest.fail(f"{kind} rid {rid}: token {i} is {tokens[i]}, JAX's {want[rid][i]}; "
                        f"margin of the port's top two noisy logits {margins.get((rid, i))!r}")
    monkeypatch.undo()
    greedy = {f.rid: f.tokens for f in ServeEngine(params, cfg, ServeConfig(**kw)).run(
        [dataclasses.replace(r, temperature=0.0) for r in _requests(Request, cfg.vocab_size, mix)])}
    assert any(greedy[rid] != done[rid] for rid in done)   # the hot requests really sampled
