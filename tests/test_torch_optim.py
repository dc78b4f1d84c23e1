"""The port's ``clip_by_global_norm``, ``constant`` and ``linear_warmup``
against the JAX package's ``repro.optim`` on the same numpy inputs (the
counterpart of ``tests/test_optim.py::test_clip_by_global_norm``).

The port's trees carry a leading replica axis R and clip each replica by
its own norm, as the JAX package's functions under ``jax.vmap`` over that
axis; so the reference here is ``jax.vmap(clip_by_global_norm)``.
Tolerances: the norms within 1e-6 relative (fp32 sums of squares in
another order); fp32 leaves within 1e-6 relative (the scale differs by at
most an ulp or two); bf16 leaves within one bf16 ulp (2^-8 relative), since
a scale an ulp apart can round the cast the other way.  A zero tree stays
exactly zero, and a tree below ``max_norm`` passes through unchanged.  The
schedules are exact: the same fp32 operations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro_torch import optim

R = 3
SHAPES = {"w": (R, 4, 5), "b": (R, 7), "e": (R, 2, 3, 2)}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _to_torch(tree, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in tree.items()}


def _to_jax(tree, dtype):
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return {k: jnp.asarray(v).astype(jd) for k, v in tree.items()}


def _norms(tree):
    return np.sqrt(sum((v.astype(np.float64) ** 2).reshape(R, -1).sum(1) for v in tree.values()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("where", ["below", "at", "above", "zero"])
def test_clip_by_global_norm_matches_jax(dtype, where):
    np_tree = _tree(7)
    if where == "zero":
        np_tree = {k: np.zeros_like(v) for k, v in np_tree.items()}
    # max_norm against each replica's own norm (of the tree cast to dtype)
    norms = _norms({k: torch.from_numpy(v).to(dtype).float().numpy() for k, v in np_tree.items()})
    max_norm = {"below": 2.0 * norms.max(), "at": float(norms[1]), "above": 0.25 * norms.min(),
                "zero": 1.0}[where]
    got, gnorm = optim.clip_by_global_norm(_to_torch(np_tree, dtype), max_norm)
    want, wnorm = jax.vmap(jax_optim.clip_by_global_norm, in_axes=(0, None))(
        _to_jax(np_tree, dtype), max_norm)
    assert gnorm.shape == (R,) and gnorm.dtype == torch.float32
    np.testing.assert_allclose(gnorm.numpy(), np.asarray(wnorm), rtol=1e-6)
    rtol = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8}[dtype]
    for k in SHAPES:
        assert got[k].dtype == dtype and got[k].shape == SHAPES[k]
        g = got[k].float().numpy()
        w = np.asarray(want[k].astype(jnp.float32))
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0)
        if where in ("below", "zero"):   # scale 1: the leaves pass through
            assert torch.equal(got[k], _to_torch(np_tree, dtype)[k])
    if where == "above":   # every replica clipped to max_norm
        np.testing.assert_allclose(optim.global_norm(got).numpy(), max_norm, rtol=rtol * 4)


@pytest.mark.parametrize("name, make", [
    ("constant", lambda m: m.constant(3e-4)),
    ("warmup", lambda m: m.linear_warmup(1e-3, 100)),
    ("warmup0", lambda m: m.linear_warmup(1e-3, 0)),
])
def test_schedules_match_jax(name, make):
    steps = np.array([0, 1, 37, 50, 99, 100, 101, 250], np.int32)   # 0, mid-warmup, past warmup
    port, ref = make(optim), make(jax_optim)
    got = port(torch.from_numpy(steps))
    assert got.dtype == torch.float32 and got.shape == steps.shape
    for i, s in enumerate(steps):
        assert got[i].item() == float(ref(jnp.asarray(s))), (name, s)
    if name == "warmup":
        assert got[0].item() == 0.0 and got[5].item() == np.float32(1e-3)
        assert got[3].item() == np.float32(np.float32(50 / 100) * np.float32(1e-3))
    if name == "warmup0":   # max(warmup_steps, 1): step 0 is 0, every later step the peak
        assert got[0].item() == 0.0 and bool((got[1:] == np.float32(1e-3)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_global_norm_rows_alone_in_parts(monkeypatch, dtype):
    """Each replica's norm is its slice reduced alone, so a row of the
    stacked tree equals the same replica held alone bit for bit; a slice
    longer than ``SLICE`` is squared in parts of at most ``SLICE``
    elements (the memory guard for recurrentgemma-9b's embedding row)."""
    from repro_torch.optim import adamw

    monkeypatch.setattr(adamw, "SLICE", 8)
    sizes = []
    square = torch.Tensor.square
    monkeypatch.setattr(torch.Tensor, "square", lambda t: sizes.append(t.numel()) or square(t))
    tree = _to_torch(_tree(3), dtype)
    stacked = optim.global_norm(tree)
    assert sizes and max(sizes) <= 8
    for r in range(R):
        alone = optim.global_norm({k: v[r:r + 1] for k, v in tree.items()})
        assert torch.equal(alone, stacked[r:r + 1])
    want = _norms({k: v.float().numpy() for k, v in tree.items()})
    np.testing.assert_allclose(stacked.numpy(), want, rtol=1e-6)
