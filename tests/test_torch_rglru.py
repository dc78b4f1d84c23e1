"""The port's RG-LRU (RecurrentGemma) pieces against the JAX package's, on
the CPU: the plain scan, the decode step and the three branches of the
block.

Inputs are made with numpy from a seed and handed to both packages, which
compute in fp32.  Tolerances: the scan atol and rtol 1e-5, as the JAX
package's own sweep (the port's scan is sequential, the JAX twin an
associative scan: they differ by rounding order only); the decode step
1e-6 (one product and one sum); the block 1e-4 (matmuls of width 64 in
another order).  The scan's backward is held to the vjp of the JAX twin
within atol and rtol 1e-5 too: the port's reverse scan and the transpose of
JAX's associative scan sum dh_t = g_t + a_{t+1}·dh_{t+1} in other orders,
and da_t = dh_t·h_{t−1} carries the forward's rounding differences.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dispatch import KernelConfig
from repro.kernels.rglru_scan import pallas_rglru_scan
from repro.models import rglru as jrglru
from repro.models.common import values_of
from repro.models.config import ModelConfig as JaxModelConfig
from repro.parallel.sharding import ShardCtx
from repro_torch.kernels import ops, ref
from repro_torch.models import rglru
from repro_torch.models.config import ModelConfig

CTX = ShardCtx.local()
# (batch, seq, width): tests/test_kernels.py's sweep, and the lengths at
# which the CUDA scan changes its launch (up to 32 steps loaded whole, 33 on
# the ring)
SHAPES = [(2, 64, 32), (1, 300, 128), (2, 257, 130), (2, 1, 40), (1, 8, 33), (2, 24, 40),
          (1, 32, 65), (2, 33, 40)]
# the "rglru" config of tests/test_serve.py
RGLRU_KW = dict(arch_type="hybrid", num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
                d_ff=128, vocab_size=128, attn_pattern=("rglru", "rglru", "local"),
                sliding_window=6, lru_width=64, dtype="float32", remat=False)


def _ab(shape, seed):
    """a in (0.45, 0.95), b normal · 0.3, fp32 numpy."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.normal(size=shape))) * 0.5 + 0.45
    b = rng.normal(size=shape) * 0.3
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_rglru_scan_matches_jax_twin(shape):
    a, b = _ab(shape, 0)
    h = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    want = jref.jnp_rglru_scan(jnp.asarray(a), jnp.asarray(b))
    assert h.dtype == torch.float32 and h.shape == shape
    np.testing.assert_allclose(h.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # and it is the serial recurrence, step for step in fp32
    state = np.zeros((shape[0], shape[2]), np.float32)
    for t in range(shape[1]):
        state = a[:, t] * state + b[:, t]
        np.testing.assert_array_equal(h[:, t].numpy(), state)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_rglru_scan_matches_pallas_interpret(shape):
    a, b = _ab(shape, 1)
    h = ref.torch_rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    want = pallas_rglru_scan(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _vjp_inputs(shape, seed):
    a, b = _ab(shape, seed)
    g = (np.random.default_rng(seed + 100).normal(size=shape)).astype(np.float32)
    return a, b, g


@pytest.mark.parametrize("shape", [(2, 64, 32), (1, 300, 128), (2, 33, 40)],
                         ids=lambda s: "-".join(map(str, s)))
def test_rglru_scan_bwd_matches_jax_vjp(shape):
    """The plain backward against jax.vjp of the JAX twin (what the JAX
    package's custom vjp computes)."""
    a, b, g = _vjp_inputs(shape, 3)
    da, db = ref.torch_rglru_scan_bwd(*map(torch.from_numpy, (a, b, g)))
    _, vjp = jax.vjp(jref.jnp_rglru_scan, jnp.asarray(a), jnp.asarray(b))
    wda, wdb = vjp(jnp.asarray(g))
    assert da.dtype == db.dtype == torch.float32 and da.shape == db.shape == shape
    np.testing.assert_allclose(da.numpy(), np.asarray(wda), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(wdb), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 64, 32), (1, 8, 33)], ids=lambda s: "-".join(map(str, s)))
def test_rglru_scan_op_gradients_match_jax(shape):
    """ops.rglru_scan under autograd against jax.vjp of the JAX package's op
    (jnp impl, whose custom vjp is the twin's)."""
    a, b, g = _vjp_inputs(shape, 4)
    ta, tb = (torch.from_numpy(v).requires_grad_() for v in (a, b))
    ops.rglru_scan(ta, tb).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda x, y: jops.rglru_scan(x, y, config=KernelConfig("jnp")),
                     jnp.asarray(a), jnp.asarray(b))
    wda, wdb = vjp(jnp.asarray(g))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(wda), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(wdb), atol=1e-5, rtol=1e-5)


def test_rglru_scan_bwd_is_the_reverse_scan():
    """The plain backward is the recurrence the kernel runs, step for step
    in fp32: dh_t = g_t + a_{t+1}·dh_{t+1}, da_t = dh_t·h_{t−1}, db_t = dh_t."""
    a, b, g = _vjp_inputs((2, 40, 24), 5)
    h = ref.torch_rglru_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    da, db = ref.torch_rglru_scan_bwd(*map(torch.from_numpy, (a, b, g)))
    dh = np.zeros((2, 24), np.float32)
    a_next = np.zeros((2, 24), np.float32)
    for t in reversed(range(40)):
        dh = g[:, t] + a_next * dh
        np.testing.assert_array_equal(db[:, t].numpy(), dh)
        prev = h[:, t - 1] if t else np.zeros_like(dh)
        np.testing.assert_array_equal(da[:, t].numpy(), dh * prev)
        a_next = a[:, t]


def test_rglru_decode_matches_jax():
    rng = np.random.default_rng(2)
    h, b = (rng.normal(size=(2, 3, 48))).astype(np.float32)
    a = (1.0 / (1.0 + np.exp(-rng.normal(size=(3, 48))))).astype(np.float32)
    got = ops.rglru_decode(*map(torch.from_numpy, (h, a, b)))
    want = jops.rglru_decode(*map(jnp.asarray, (h, a, b)), config=KernelConfig("jnp"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    # one decode step is one step of the scan from h
    scan = ops.rglru_scan(torch.from_numpy(a)[:, None],
                          torch.from_numpy(b + a * h)[:, None])
    np.testing.assert_array_equal(scan[:, 0].numpy(), (b + a * h).astype(np.float32))
    np.testing.assert_allclose(got.numpy(), scan[:, 0].numpy(), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the block's three branches against JAX's, on the same weights
# ---------------------------------------------------------------------------


def _block(seed=0):
    jcfg, cfg = JaxModelConfig(**RGLRU_KW), ModelConfig(**RGLRU_KW)
    jp = jax.tree.map(np.asarray, values_of(jrglru.init_rglru(jax.random.PRNGKey(seed), jcfg)))
    return jcfg, cfg, jp, {k: torch.from_numpy(v.copy()) for k, v in jp.items()}


def _cache(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    w = rglru.lru_width(cfg)
    return (rng.normal(size=(batch, 3, w)) * 0.5).astype(np.float32), \
        (rng.normal(size=(batch, w)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("branch", ["no-cache", "prefill-from-cache", "chunked", "decode"])
def test_apply_rglru_branches_match_jax(branch):
    jcfg, cfg, jp, p = _block()
    rng = np.random.default_rng(7)
    s = 1 if branch == "decode" else 11
    x = rng.normal(size=(3, s, cfg.d_model)).astype(np.float32)
    cache = None if branch == "no-cache" else _cache(cfg, 3, 8)
    lengths = np.array([11, 6, 0], np.int32) if branch == "chunked" else None
    jcache = None if cache is None else jrglru.RGLRUCache(*map(jnp.asarray, cache))
    tcache = None if cache is None else rglru.RGLRUCache(*map(torch.from_numpy, cache))
    jkw = {} if lengths is None else {"chunk_lengths": jnp.asarray(lengths)}
    tkw = {} if lengths is None else {"chunk_lengths": torch.from_numpy(lengths)}
    wy, wc = jrglru.apply_rglru(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x), CTX,
                                cache=jcache, **jkw)
    y, c = rglru.apply_rglru(p, cfg, torch.from_numpy(x), cache=tcache, **tkw)
    assert y.shape == x.shape and y.dtype == torch.float32
    for i in range(3):
        n = s if lengths is None else lengths[i]
        np.testing.assert_allclose(y[i, :n].numpy(), np.asarray(wy)[i, :n], atol=1e-4, rtol=1e-4)
    if cache is None:
        assert c is None and wc is None
        return
    np.testing.assert_allclose(c.conv.numpy(), np.asarray(wc.conv), atol=1e-6, rtol=0)
    np.testing.assert_allclose(c.h.numpy(), np.asarray(wc.h), atol=1e-5, rtol=1e-5)
    if lengths is not None:   # a row with no valid token keeps its state and tail
        np.testing.assert_array_equal(c.h[2].numpy(), cache[1][2])
        np.testing.assert_array_equal(c.conv[2].numpy(), cache[0][2])


def test_init_rglru_keeps_lambda_in_fp32():
    cfg = ModelConfig(**{**RGLRU_KW, "dtype": "bfloat16"})
    p = rglru.init_rglru(torch.Generator().manual_seed(0), cfg)
    assert {k for k, v in p.items() if v.dtype == torch.float32} == {"lam"}
    a = torch.sigmoid(p["lam"])
    assert a.min() >= 0.9 * 0.999 and a.max() <= 0.999 * 1.0001
    assert torch.equal(p["conv"][-1].float(), torch.ones(rglru.lru_width(cfg)))
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(1)).bfloat16()
    y, _ = rglru.apply_rglru(p, cfg, x)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


def test_apply_rglru_speculative_verify_raises():
    """The speculative verify branch (``chunk_exact``) against JAX's: the
    output, the per-token trajectory (h (B, S, W), conv tails (B, S, 3, W)),
    and the cache passed in left unwritten."""
    jcfg, cfg, jp, p = _block()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, cfg.d_model)).astype(np.float32)
    cache = _cache(cfg, 2, 6)
    lengths = np.array([4, 2], np.int32)
    wy, wc = jrglru.apply_rglru(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x), CTX,
                                cache=jrglru.RGLRUCache(*map(jnp.asarray, cache)),
                                chunk_lengths=jnp.asarray(lengths), chunk_exact=True)
    tcache = rglru.RGLRUCache(*map(torch.from_numpy, cache))
    y, c = rglru.apply_rglru(p, cfg, torch.from_numpy(x), cache=tcache,
                             chunk_lengths=torch.from_numpy(lengths), chunk_exact=True)
    assert c is not tcache and c.h.shape == (2, 4, rglru.lru_width(cfg))
    assert c.conv.shape == (2, 4, 3, rglru.lru_width(cfg))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(c.h.numpy(), np.asarray(wc.h), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(c.conv.numpy(), np.asarray(wc.conv), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tcache.conv.numpy(), cache[0])
    np.testing.assert_array_equal(tcache.h.numpy(), cache[1])

