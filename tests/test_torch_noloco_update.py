"""The port's fused NoLoCo outer update against the JAX package's, on the
CPU.  The plain version (``ref.torch_noloco_update``, which the CPU runs)
evaluates Eqs. 2–3 in the order of ``repro.kernels.ref.
reference_noloco_update``, so the two agree bit for bit in fp32 and bf16;
the CUDA kernel is held against the plain version on the card.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dispatch import KernelConfig
from repro_torch.kernels import ops, ref
from repro_torch.tree import tree_leaves

COEF = dict(alpha=0.5, beta=0.7, gamma=0.9186)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(4097,), (3, 64, 48)], ids=["flat", "stacked"])
def test_plain_matches_reference_bitwise(dtype, shape):
    rng = np.random.default_rng(sum(shape))
    args = [rng.normal(size=shape).astype(np.float32).astype(dtype) for _ in range(4)]
    want = jref.reference_noloco_update(*map(jnp.asarray, args), **COEF)
    got = ref.torch_noloco_update(*map(_to_torch, args), **COEF)
    for g, w in zip(got, want):
        assert g.dtype == _to_torch(args[0]).dtype
        np.testing.assert_array_equal(_to_numpy(g), np.asarray(w))


def test_pytree_op_matches_jax_ops():
    """``ops.noloco_update_pytree`` on a replica-stacked tree with fp32 and
    bf16 leaves, against the JAX package's op on its jnp path."""
    rng = np.random.default_rng(0)

    def tree(dt_w):
        return {"w": rng.normal(size=(4, 8, 6)).astype(dt_w),
                "norm": {"scale": rng.normal(size=(4, 6)).astype(np.float32)},
                "layers": [rng.normal(size=(4, 5)).astype(dt_w), None]}

    trees = [tree(ml_dtypes.bfloat16) for _ in range(4)]
    want_phi, want_delta = jops.noloco_update_pytree(
        *[jax.tree.map(jnp.asarray, t) for t in trees], **COEF, config=KernelConfig("jnp"))
    conv = [jax.tree.map(_to_torch, t) for t in trees]
    conv = [{"w": c["w"], "norm": c["norm"], "layers": list(c["layers"])} for c in conv]
    got_phi, got_delta = ops.noloco_update_pytree(*conv, **COEF)
    assert got_phi["layers"][1] is None
    for g, w in zip(tree_leaves(got_phi) + tree_leaves(got_delta),
                    jax.tree.leaves(want_phi) + jax.tree.leaves(want_delta)):
        np.testing.assert_array_equal(_to_numpy(g), np.asarray(w))
