"""The port's SSD (Mamba-2) pieces against the JAX package's, on the CPU:
the plain intra-chunk form, the chunked op against the token-by-token
oracle, the decode step, and the three branches of the block.

Inputs are made with numpy from a seed and handed to both packages, which
compute in fp32.  Tolerances: the intra-chunk form 1e-5 (the same
arithmetic, summed in another order); the chunked op against the oracle
atol 2e-4 and rtol 1e-3, as the JAX package's own test; the decode step
1e-6 (elementwise products and one N-term sum); the block 1e-4 (matmuls of
width 64 in another order).  The intra-chunk backward against the vjp of
the JAX twin: atol 1e-5 and rtol 1e-5, and the chunked op's gradients
against jax.vjp of the JAX op 1e-5 / 1e-4 (the same arithmetic summed in
another order; through the inter-chunk recurrence the gradients of dt and
a are sums of up to S·P terms).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dispatch import KernelConfig
from repro.kernels.ssd_scan import ssd_chunk_kernel
from repro.models import ssd as jssd
from repro.models.common import values_of
from repro.models.config import ModelConfig as JaxModelConfig
from repro.parallel.sharding import ShardCtx
from repro_torch.kernels import ops, ref
from repro_torch.models import ssd
from repro_torch.models.config import ModelConfig

CTX = ShardCtx.local()
# (batch, seq, heads, head_dim, state, chunk): tests/test_kernels.py's sweep
SHAPES = [(1, 64, 2, 16, 8, 32), (2, 96, 2, 16, 8, 32), (1, 130, 1, 8, 4, 64)]
# the "ssd" config of tests/test_serve.py
SSD_KW = dict(arch_type="ssm", num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=0,
              vocab_size=128, attn_pattern=("ssd",), ssm_state_dim=16, ssm_head_dim=32,
              ssm_chunk=4, use_rope=False, dtype="float32", remat=False)


def _inputs(shape, seed):
    """x, dt (softplus · 0.1), a (negative), B, C as fp32 numpy arrays."""
    b, s, h, p, n, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)) * 0.5
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))) * 0.1
    a = -np.exp(rng.normal(size=(h,)) * 0.3)
    bm = rng.normal(size=(b, s, n)) * 0.5
    cm = rng.normal(size=(b, s, n)) * 0.5
    return [v.astype(np.float32) for v in (x, dt, a, bm, cm)]


def _chunked(shape, seed):
    """The inputs cut into chunks of q = min(chunk, S), the tail padded with
    zeros (dt 0), as the ops lay them out for the kernel."""
    x, dt, a, bm, cm = _inputs(shape, seed)
    b, s, h, p, n, chunk = shape
    q = min(chunk, s)
    nc = math.ceil(s / q)
    pad = [(0, 0), (0, nc * q - s)]
    x = np.pad(x, pad + [(0, 0), (0, 0)]).reshape(b, nc, q, h, p)
    dt = np.pad(dt, pad + [(0, 0)]).reshape(b, nc, q, h)
    bm = np.pad(bm, pad + [(0, 0)]).reshape(b, nc, q, n)
    cm = np.pad(cm, pad + [(0, 0)]).reshape(b, nc, q, n)
    return x, dt, a, bm, cm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_ssd_chunk_intra_matches_jax_twin(shape):
    args = _chunked(shape, 0)
    y, st = ref.torch_ssd_chunk_intra(*_t(*args))
    wy, wst = jref.jnp_ssd_chunk_intra(*map(jnp.asarray, args))
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    assert st.shape == (shape[0], args[0].shape[1], shape[2], shape[4], shape[3])
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(wst), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_ssd_chunk_intra_matches_pallas_interpret(shape):
    args = _chunked(shape, 1)
    y, st = ref.torch_ssd_chunk_intra(*_t(*args))
    wy, wst = ssd_chunk_kernel(*map(jnp.asarray, args), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(wst), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("initial", [False, True], ids=["zero-state", "initial-state"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_ssd_chunk_matches_reference(shape, initial):
    x, dt, a, bm, cm = _inputs(shape, 2)
    b, _, h, p, n, chunk = shape
    s0 = (np.random.default_rng(3).normal(size=(b, h, p, n)) * 0.3).astype(np.float32) if initial else None
    y, final = ops.ssd_chunk(*_t(x, dt, a, bm, cm), chunk=chunk,
                             initial_state=None if s0 is None else torch.from_numpy(s0))
    wy, wf = jref.reference_ssd(*map(jnp.asarray, (x, dt, a, bm, cm)),
                                initial_state=None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(final.numpy(), np.asarray(wf), atol=2e-4, rtol=1e-3)
    # the port's token-by-token oracle is the JAX one
    oy, of = ref.torch_reference_ssd(*_t(x, dt, a, bm, cm),
                                     initial_state=None if s0 is None else torch.from_numpy(s0))
    np.testing.assert_allclose(oy.numpy(), np.asarray(wy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(of.numpy(), np.asarray(wf), atol=1e-5, rtol=1e-5)


def _cotangents(args, seed):
    """dy and dstates for the chunked inputs, as the intra op's outputs."""
    x, dt, a, bm, cm = args
    b, nc, q, h, p = x.shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=x.shape).astype(np.float32),
            rng.normal(size=(b, nc, h, bm.shape[-1], p)).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_ssd_chunk_intra_bwd_matches_jax_vjp(shape):
    """The plain backward against jax.vjp of the JAX twin, the JAX
    package's custom vjp; the last shape has a ragged tail (130 = 2·64 + 2,
    the pad rows with dt 0)."""
    args = _chunked(shape, 5)
    dy, dst = _cotangents(args, 6)
    got = ref.torch_ssd_chunk_intra_bwd(*_t(*args, dy, dst))
    _, vjp = jax.vjp(jref.jnp_ssd_chunk_intra, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dy), jnp.asarray(dst)))
    for g, w, arg in zip(got, want, args):
        assert g.shape == arg.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES[:2] + [(1, 37, 2, 16, 8, 16)],
                         ids=lambda s: "-".join(map(str, s)))
def test_ssd_chunk_op_gradients_match_jax(shape):
    """ops.ssd_chunk under autograd (the intra op's backward and the
    inter-chunk recurrence) against jax.vjp of the JAX op on its jnp path;
    37 is a ragged tail of 5 rows in the last chunk of 16."""
    x, dt, a, bm, cm = _inputs(shape, 7)
    rng = np.random.default_rng(8)
    gy = rng.normal(size=x.shape).astype(np.float32)
    gf = rng.normal(size=(shape[0], shape[2], shape[3], shape[4])).astype(np.float32)
    ins = [torch.from_numpy(v).requires_grad_() for v in (x, dt, a, bm, cm)]
    y, final = ops.ssd_chunk(*ins, chunk=shape[5])
    torch.autograd.backward((y, final), (torch.from_numpy(gy), torch.from_numpy(gf)))
    _, vjp = jax.vjp(lambda *v: jops.ssd_chunk(*v, chunk=shape[5], config=KernelConfig("jnp")),
                     *map(jnp.asarray, (x, dt, a, bm, cm)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gf)))
    for t, w in zip(ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4)


def test_ssd_chunk_rates_per_row_are_each_rows_own():
    """a (B, H): every row runs with its own rates, forward and backward,
    as if it ran alone with a (H,); the gradient of a is per row."""
    x, dt, a, bm, cm = _inputs((3, 40, 2, 8, 4, 16), 9)
    rates = (a[None] * np.array([[1.0], [0.5], [2.0]], np.float32)).astype(np.float32)
    ins = [torch.from_numpy(v).requires_grad_() for v in (x, dt, rates, bm, cm)]
    y, final = ops.ssd_chunk(*ins, chunk=16)
    (y.square().sum() + final.sum()).backward()
    for r in range(3):
        one = [torch.from_numpy(v[r:r + 1]).requires_grad_() for v in (x, dt)] + [
            torch.from_numpy(rates[r]).requires_grad_()] + [
            torch.from_numpy(v[r:r + 1]).requires_grad_() for v in (bm, cm)]
        yr, fr = ops.ssd_chunk(*one, chunk=16)
        (yr.square().sum() + fr.sum()).backward()
        torch.testing.assert_close(y[r:r + 1], yr, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(ins[2].grad[r], one[2].grad, atol=1e-5, rtol=1e-5)
        for full, solo in zip((ins[0], ins[1], ins[3], ins[4]), (one[0], one[1], one[3], one[4])):
            torch.testing.assert_close(full.grad[r:r + 1], solo.grad, atol=1e-5, rtol=1e-5)


def test_ssd_chunk_intra_bwd_has_no_nan_where_masked_exponentials_overflow():
    """At Q 128 with |dt·a| ~ 1 a step the masked entries' exp(cums_i −
    cums_j) overflow fp32; the plain version masks before the exponential,
    so its backward stays finite (the JAX twin's vjp gives NaN there) and
    equals an fp64 evaluation."""
    rng = np.random.default_rng(10)
    b, nc, q, h, p, n = 1, 1, 128, 2, 8, 8
    x = rng.normal(size=(b, nc, q, h, p))
    dt = np.full((b, nc, q, h), 0.5)
    a = np.array([-4.0, -16.0])
    bm, cm = rng.normal(size=(2, b, nc, q, n))
    dy, dst = rng.normal(size=(b, nc, q, h, p)), rng.normal(size=(b, nc, h, n, p))
    f32 = [torch.from_numpy(v.astype(np.float32)) for v in (x, dt, a, bm, cm, dy, dst)]
    got = ref.torch_ssd_chunk_intra_bwd(*f32)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    f64 = [torch.from_numpy(v).double() for v in (x, dt, a, bm, cm)]
    for t in f64:
        t.requires_grad_()
    cums = torch.cumsum(f64[1] * f64[2], dim=2)
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]
    tri = torch.ones((q, q), dtype=torch.bool).tril()[None, None, :, :, None]
    l_kern = torch.exp(torch.where(tri, diff, torch.full_like(diff, -np.inf)))
    xdt = f64[0] * f64[1][..., None]
    y = torch.einsum("bcij,bcijh,bcjhp->bcihp", torch.einsum("bcin,bcjn->bcij", f64[4], f64[3]),
                     l_kern, xdt)
    st = torch.einsum("bcjn,bcjh,bcjhp->bchnp", f64[3], torch.exp(cums[:, :, -1:] - cums), xdt)
    want = torch.autograd.grad((y, st), f64, (torch.from_numpy(dy), torch.from_numpy(dst)))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.double(), w, atol=1e-4, rtol=1e-4)


def test_ssd_chunk_pad_rows_with_zero_dt_leave_the_state_unchanged():
    """Ragged serving chunks mask dt to exactly 0 past the valid tokens: the
    final state is then the state after the valid tokens alone."""
    x, dt, a, bm, cm = _inputs((2, 24, 2, 16, 8, 16), 4)
    masked = dt.copy()
    masked[:, 13:] = 0.0
    _, full = ops.ssd_chunk(*_t(x, masked, a, bm, cm), chunk=16)
    _, short = ops.ssd_chunk(*_t(x[:, :13], dt[:, :13], a, bm[:, :13], cm[:, :13]), chunk=16)
    torch.testing.assert_close(full, short, atol=1e-6, rtol=1e-6)


def test_ssd_decode_matches_jax():
    r, h, p, n = 3, 2, 8, 4
    rng = np.random.default_rng(5)
    state = (rng.normal(size=(r, h, p, n)) * 0.3).astype(np.float32)
    dt1 = (np.log1p(np.exp(rng.normal(size=(r, h)))) * 0.1).astype(np.float32)
    a = (-np.exp(rng.normal(size=(h,)) * 0.3)).astype(np.float32)
    b1, c1 = (rng.normal(size=(2, r, n)) * 0.5).astype(np.float32)
    x1 = (rng.normal(size=(r, h, p)) * 0.5).astype(np.float32)
    st, y = ops.ssd_decode(*_t(state, dt1, a, b1, c1, x1))
    wst, wy = jops.ssd_decode(*map(jnp.asarray, (state, dt1, a, b1, c1, x1)),
                              config=KernelConfig("jnp"))
    assert st.shape == (r, h, p, n) and y.shape == (r, h, p)
    np.testing.assert_allclose(st.numpy(), np.asarray(wst), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-6, rtol=1e-6)
    # one decode step is one token of the chunked op
    yc, fc = ops.ssd_chunk(*_t(x1[:, None], dt1[:, None], a, b1[:, None], c1[:, None]),
                           chunk=4, initial_state=torch.from_numpy(state))
    torch.testing.assert_close(fc, st, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(yc[:, 0], y, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# the block's three branches against JAX's, on the same weights
# ---------------------------------------------------------------------------


def _block(seed=0):
    jcfg, cfg = JaxModelConfig(**SSD_KW), ModelConfig(**SSD_KW)
    jp = jax.tree.map(np.asarray, values_of(jssd.init_ssd(jax.random.PRNGKey(seed), jcfg)))
    p = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    return jcfg, cfg, jp, p


def _cache(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    conv = (rng.normal(size=(batch, cfg.ssm_conv_width - 1, ssd.d_inner(cfg))) * 0.5)
    state = rng.normal(size=(batch, ssd.num_heads_ssm(cfg), cfg.ssm_head_dim,
                             cfg.ssm_state_dim)) * 0.3
    return conv.astype(np.float32), state.astype(np.float32)


def _branch(jcfg, cfg, jp, p, x, cache=None, lengths=None):
    jcache = tcache = None
    if cache is not None:
        jcache = jssd.SSDCache(conv=jnp.asarray(cache[0]), state=jnp.asarray(cache[1]))
        tcache = ssd.SSDCache(*_t(*cache))
    wy, wc = jssd.apply_ssd(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x), CTX, cache=jcache,
                            **({} if lengths is None else {"chunk_lengths": jnp.asarray(lengths)}))
    y, c = ssd.apply_ssd(p, cfg, torch.from_numpy(x), cache=tcache,
                         **({} if lengths is None else {"chunk_lengths": torch.from_numpy(lengths)}))
    return (y, c), (wy, wc)


@pytest.mark.parametrize("branch", ["no-cache", "prefill-from-cache", "chunked", "decode"])
def test_apply_ssd_branches_match_jax(branch):
    jcfg, cfg, jp, p = _block()
    rng = np.random.default_rng(7)
    s = 1 if branch == "decode" else 11
    x = (rng.normal(size=(3, s, cfg.d_model))).astype(np.float32)
    cache = None if branch == "no-cache" else _cache(cfg, 3, 8)
    lengths = np.array([11, 6, 0], np.int32) if branch == "chunked" else None
    (y, c), (wy, wc) = _branch(jcfg, cfg, jp, p, x, cache, lengths)
    assert y.shape == x.shape and y.dtype == torch.float32
    rows = np.ones(3, bool) if lengths is None else lengths > 0
    for i in np.flatnonzero(rows):
        n = s if lengths is None else lengths[i]
        np.testing.assert_allclose(y[i, :n].numpy(), np.asarray(wy)[i, :n], atol=1e-4, rtol=1e-4)
    if cache is None:
        assert c is None and wc is None
        return
    np.testing.assert_allclose(c.conv.numpy(), np.asarray(wc.conv), atol=1e-6, rtol=0)
    np.testing.assert_allclose(c.state.numpy(), np.asarray(wc.state), atol=1e-4, rtol=1e-4)
    if lengths is not None:   # a row with no valid token keeps its state and tail
        np.testing.assert_array_equal(c.state[2].numpy(), cache[1][2])
        np.testing.assert_array_equal(c.conv[2].numpy(), cache[0][2])


def test_apply_ssd_keeps_its_rates_in_fp32():
    cfg = ModelConfig(**{**SSD_KW, "dtype": "bfloat16"})
    p = ssd.init_ssd(torch.Generator().manual_seed(0), cfg)
    fp32 = {k for k, v in p.items() if v.dtype == torch.float32}
    assert fp32 == {"dt_bias", "a_log", "d_skip", "norm_scale"}
    assert all(v.dtype == torch.bfloat16 for k, v in p.items() if k not in fp32)
    step = torch.nn.functional.softplus(p["dt_bias"])
    assert step.min() >= 1e-3 * 0.999 and step.max() <= 1e-1 * 1.001
    assert (-torch.exp(p["a_log"])).max() <= -1.0 and (-torch.exp(p["a_log"])).min() >= -16.0
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(1)).bfloat16()
    y, _ = ssd.apply_ssd(p, cfg, x)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


def test_apply_ssd_speculative_verify_raises():
    """The speculative verify branch (``chunk_exact``) against JAX's: the
    output, the per-token trajectory (state (B, S, H, P, N), conv tails
    (B, S, K−1, d_inner)), and the cache passed in left unwritten."""
    jcfg, cfg, jp, p = _block()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, cfg.d_model)).astype(np.float32)
    cache = _cache(cfg, 2, 6)
    lengths = np.array([4, 2], np.int32)
    wy, wc = jssd.apply_ssd(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x), CTX,
                            cache=jssd.SSDCache(*map(jnp.asarray, cache)),
                            chunk_lengths=jnp.asarray(lengths), chunk_exact=True)
    tcache = ssd.SSDCache(*_t(*cache))
    y, c = ssd.apply_ssd(p, cfg, torch.from_numpy(x), cache=tcache,
                         chunk_lengths=torch.from_numpy(lengths), chunk_exact=True)
    assert c is not tcache and c.state.shape == (2, 4) + cache[1].shape[1:]
    assert c.conv.shape == (2, 4) + cache[0].shape[1:]
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(c.state.numpy(), np.asarray(wc.state), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(c.conv.numpy(), np.asarray(wc.conv), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tcache.conv.numpy(), cache[0])
    np.testing.assert_array_equal(tcache.state.numpy(), cache[1])
