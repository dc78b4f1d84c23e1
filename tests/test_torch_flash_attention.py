"""The port's flash attention against the JAX package's, on the CPU.

The same numpy inputs go through ``repro.kernels.ref.jnp_flash_attention``
(the jnp twin the JAX package trains with off the TPU) and through the
port's op, whose CPU path is the plain version ``ref.torch_flash_attention``
differentiated by autograd.  The port's hand-written backward has a plain
version of its own, ``ref.torch_flash_attention_bwd``, which recomputes the
softmax from the forward's log-sum-exp; it is held against ``jax.vjp`` of
the twin here and against the CUDA kernel on the card
(``tests/test_torch_cuda_kernels.py``).  Tolerance: fp32 atol 1e-5 (the two
sum in different orders and in different blocks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

ATOL = 1e-5

# (B, S, H, KV, D, mode, window): GQA, MQA, ragged heads (6/4), S not a
# multiple of the twin's block, D 48 (the paper model's head_dim) and 64;
# then the edges of the card's tensor-core kernels: D 128 and 256, S no
# multiple of their 64-row and 64-key tiles, MQA, a window wider than a tile.
CASES = [
    (2, 37, 4, 2, 48, "causal", 0),
    (1, 40, 4, 1, 64, "causal", 0),
    (2, 29, 6, 4, 48, "causal", 0),
    (1, 33, 4, 2, 64, "local", 5),
    (2, 21, 4, 4, 48, "full", 0),
    (1, 45, 6, 4, 64, "local", 9),
    (1, 70, 2, 1, 128, "causal", 0),
    (1, 65, 2, 2, 256, "full", 0),
    (1, 100, 4, 1, 48, "causal", 0),
    (1, 150, 4, 2, 64, "local", 80),
]
IDS = ["-".join(map(str, c)) for c in CASES]


def _inputs(case, seed=0):
    b, s, h, kv, d, _, _ = case
    rng = np.random.default_rng(seed + s)
    shapes = [(b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)]
    return [rng.normal(size=sh).astype(np.float32) for sh in shapes]


def _jax_fwd_vjp(case, q, k, v, g):
    mode, window = case[5], case[6]
    fn = lambda q, k, v: jref.jnp_flash_attention(q, k, v, mode=mode, window=window, block_kv=16)
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_jax(case):
    q, k, v, _ = _inputs(case)
    mode, window = case[5], case[6]
    want = np.asarray(jref.jnp_flash_attention(q, k, v, mode=mode, window=window, block_kv=16))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), mode=mode, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_grads_match_jax_vjp(case):
    q, k, v, g = _inputs(case, seed=1)
    _, want = _jax_fwd_vjp(case, q, k, v, g)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ops.flash_attention(*leaves, mode=case[5], window=case[6]).backward(torch.from_numpy(g))
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_from_lse_matches_jax_vjp(case):
    q, k, v, g = _inputs(case, seed=2)
    out, want = _jax_fwd_vjp(case, q, k, v, g)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = ref.torch_flash_attention_fwd(tq, tk, tv, mode=case[5], window=case[6])
    np.testing.assert_allclose(o.numpy(), out, atol=ATOL, rtol=0)
    assert lse.shape == (case[0], case[2], case[1]) and lse.dtype == torch.float32
    got = ref.torch_flash_attention_bwd(tq, tk, tv, o, lse, tg, mode=case[5], window=case[6])
    for t, w in zip(got, want):
        np.testing.assert_allclose(t.numpy(), w, atol=ATOL, rtol=0)


def test_lse_is_the_row_log_normaliser():
    """lse = log Σ_j exp(q·k_j·scale) over the keys each row sees."""
    q, k, v, _ = _inputs(CASES[0])
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _, lse = ref.torch_flash_attention_fwd(tq, tk, tv)
    b, s, h, d = q.shape
    kx = tk.repeat_interleave(h // k.shape[2], dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", tq, kx) / np.sqrt(d)
    scores = scores.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1), atol=1e-5, rtol=0)


def test_bad_mode_raises():
    q, k, v, _ = _inputs(CASES[0])
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(*map(torch.from_numpy, (q, k, v)), mode="local", window=0)
    with pytest.raises(ValueError, match="mode"):
        ops.flash_attention(*map(torch.from_numpy, (q, k, v)), mode="sliding")
