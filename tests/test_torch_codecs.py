"""The port's wire codecs, payload packing, stacked exchange and byte model
against the JAX package's, on the CPU.

The JAX side runs jitted, as its training path does.  Tolerance: none — the
wire arrays are byte-identical, decoded buffers and exchanged trees equal
bit for bit, byte counts equal.  Buffers are fp32 and bf16 of ragged sizes
(not a multiple of the int8 chunk), made from numpy with a seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JCommConfig
from repro.comm import StackedGather as JStackedGather
from repro.comm import bytes_model as jbytes
from repro.comm import get_codec as jget_codec
from repro.comm import payload as jpayload
from repro.comm.exchange import wire_roundtrip as jwire_roundtrip
from repro.configs import registry as jax_registry
from repro.models import model as JM
from repro.models.common import values_of
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.comm import CommConfig, StackedGather, bytes_model, get_codec, pack, unpack
from repro_torch.comm.exchange import wire_roundtrip
from repro_torch.configs import registry
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves

CODECS = ["none", "fp16", "bf16", "int8"]
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=128, dtype="float32", remat=False)


def _buffer(n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 10.0 ** rng.uniform(-4, 2, size=n // 64 + 1).repeat(64)[:n])
    x = x.astype(np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(x.astype(ml_dtypes.bfloat16)), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)


@pytest.mark.parametrize("codec", ["fp16", "bf16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [5000, 2048, 37])
def test_wire_and_decode_match_jax(codec, dtype, n):
    jbuf, pbuf = _buffer(n, dtype, seed=n)
    jc, pc = jget_codec(JCommConfig(codec=codec)), get_codec(CommConfig(codec=codec))
    jwire = jax.jit(jc.encode)(jbuf)
    pwire = pc.encode(pbuf)
    assert str(pwire.dtype).removeprefix("torch.") == str(jwire.dtype)
    np.testing.assert_array_equal(_np(pwire), _jnp(jwire))
    assert pwire.numel() * pwire.element_size() == pc.wire_bytes(n, dtype) == jc.wire_bytes(n, dtype)
    jback = jax.jit(lambda w: jc.decode(w, jnp.dtype(dtype), n))(jwire)
    pback = pc.decode(pwire, dtype, n)
    assert pback.dtype == getattr(torch, dtype) and pback.shape == (n,)
    np.testing.assert_array_equal(_np(pback), _jnp(jback))


def test_batched_rows_are_coded_one_by_one():
    """A (R, N) buffer gives each row the wire of a 1-D encode of that row."""
    codec = get_codec("int8")
    rows = torch.stack([_buffer(3000, "float32", seed=s)[1] for s in range(3)])
    wire = codec.encode(rows)
    for r in range(3):
        assert torch.equal(wire[r], codec.encode(rows[r]))
    assert torch.equal(codec.decode(wire, torch.float32, 3000)[1],
                       codec.decode(wire[1], torch.float32, 3000))


def test_codec_passes_integers_and_narrow_floats_through():
    ints = torch.arange(10, dtype=torch.int32)
    for name in ("fp16", "bf16", "int8"):
        assert get_codec(name).encode(ints) is ints
    bf = torch.ones(4, dtype=torch.bfloat16)
    assert get_codec("fp16").encode(bf) is bf   # not wider than fp16: as JAX
    assert get_codec("fp16").wire_bytes(4, "bfloat16") == 8


def test_encode_with_residual_matches_jax():
    jbuf, pbuf = _buffer(3000, "float32", seed=1)
    res = np.random.default_rng(2).normal(size=3000).astype(np.float32) * 1e-3
    jw, jr = jax.jit(jget_codec("int8").encode_with_residual)(jbuf, jnp.asarray(res))
    pw, pr = get_codec("int8").encode_with_residual(pbuf, torch.from_numpy(res))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))


def _tree(replicas=None, seed=0):
    """Mixed fp32/bf16 leaves in a nested dict/list, optionally stacked."""
    rng = np.random.default_rng(seed)
    lead = () if replicas is None else (replicas,)
    shapes = {"b": {"w": (7, 9), "bias": (5,)}, "a": [(33,), (2, 3, 4)], "z": (1000,)}
    dtypes = {"b": {"w": "bfloat16", "bias": "float32"}, "a": ["float32", "bfloat16"],
              "z": "bfloat16"}

    def make(shape, dt):
        x = rng.normal(size=lead + shape).astype(np.float32)
        return x.astype(ml_dtypes.bfloat16) if dt == "bfloat16" else x

    return jax.tree.map(make, shapes, dtypes, is_leaf=lambda s: isinstance(s, tuple))


def _to_torch(tree):
    return jax.tree.map(
        lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16 if x.dtype == ml_dtypes.bfloat16 else torch.float32), tree)


def test_pack_matches_jax_order_and_round_trips():
    jt = _tree()
    jbufs, jspec = jpayload.pack(jax.tree.map(jnp.asarray, jt))
    pbufs, pspec = pack(_to_torch(jt))
    assert [b.dtype for b in pspec.buffers] == [b.dtype for b in jspec.buffers]
    assert [b.size for b in pspec.buffers] == [b.size for b in jspec.buffers]
    for p, j in zip(pbufs, jbufs):
        np.testing.assert_array_equal(_np(p), _jnp(j))
    back = unpack(pbufs, pspec)
    for got, want in zip(tree_leaves(back), jax.tree.leaves(jt)):
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("codec", CODECS)
def test_stacked_exchange_matches_jitted_jax(codec):
    """StackedGather.exchange (gather, then each replica's payload through
    the wire) equals the JAX package's jitted exchange; wire_roundtrip on
    one replica equals JAX's."""
    jt = _tree(replicas=4, seed=3)
    partner = np.array([2, 3, 0, 1])
    jcfg = JCommConfig(codec=codec, chunk=256)
    want = jax.jit(lambda t: JStackedGather(jnp.asarray(partner), jcfg).exchange(t))(
        jax.tree.map(jnp.asarray, jt))
    got = StackedGather(torch.from_numpy(partner), CommConfig(codec=codec, chunk=256)).exchange(
        _to_torch(jt))
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(_np(g), _jnp(w))
    one = jax.tree.map(lambda x: x[1], jt)
    want1 = jax.jit(lambda t: jwire_roundtrip(t, jcfg))(jax.tree.map(jnp.asarray, one))
    got1 = wire_roundtrip(_to_torch(one), CommConfig(codec=codec, chunk=256))
    for g, w in zip(tree_leaves(got1), jax.tree.leaves(want1)):
        np.testing.assert_array_equal(_np(g), _jnp(w))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("width", ["tiny", "full"])
def test_byte_model_matches_jax(codec, width):
    """paper-small-125m at its published width (bf16, nothing allocated) and
    the TINY training config (fp32), noloco with and without overlap and
    diloco: int8 at full width is 369,417,816 B per sync."""
    if width == "full":
        jcfg = jax_registry.get_config("paper-small-125m")
        cfg = registry.get_config("paper-small-125m")
    else:
        jcfg, cfg = JModelConfig(**TINY), ModelConfig(**TINY)
    jtree = jax.eval_shape(lambda: values_of(JM.init_params(jax.random.PRNGKey(0), jcfg)))
    ptree = bytes_model.abstract_params(cfg)
    for method, overlap in (("noloco", False), ("noloco", True), ("diloco", False)):
        want = jbytes.outer_step_cost(jtree, JCommConfig(codec=codec, overlap=overlap),
                                      method=method, world=4)
        got = bytes_model.outer_step_cost(ptree, CommConfig(codec=codec, overlap=overlap),
                                          method=method, world=4)
        assert got.as_dict() == want.as_dict()
    if width == "full" and codec == "int8":
        for dtype in ("bfloat16", "float32"):   # one fused buffer per dtype either way
            tree = bytes_model.abstract_params(dataclasses.replace(cfg, dtype=dtype))
            cost = bytes_model.outer_step_cost(tree, CommConfig(codec="int8"), world=4)
            assert cost.payload_bytes == 369_417_816
