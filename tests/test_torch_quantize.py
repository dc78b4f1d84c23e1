"""The port's int8 codec pair (plain versions, what the CPU runs) against the
JAX package's, bit for bit.

The reference is what the JAX training path runs: ``ref.jnp_int8_quantize``
/ ``_dequantize`` under ``jax.jit`` (XLA folds ``/ 255`` into a product with
f32(1/255) and fuses the dequantize into one multiply-add) and the Pallas
kernels in interpret mode, which give the same bits.  Tolerance: none —
q, scale, lo and the dequantized values must be identical.  Inputs come
from numpy with a seed: chunks whose magnitudes span 1e-30 to 1e4, offsets
of their own size, constant chunks (scale 1), ragged chunk counts (NC not
a multiple of the Pallas kernels' 8 rows), CHUNK 1024 and a small odd one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.quantize import pallas_int8_dequantize, pallas_int8_quantize
from repro_torch.kernels import ops, quantize, ref

CASES = [(13, 1024), (8, 1024), (21, 7)]


def _chunks(nc, chunk, seed=0):
    """(NC, CHUNK) fp32 rows of magnitudes 1e-30 .. 1e4, two constant."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-30, 4, size=(nc, 1))
    x = (rng.normal(size=(nc, chunk)) + 4 * rng.normal(size=(nc, 1))) * mag
    x[1] = 3.25
    x[-1] = -0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("nc,chunk", CASES)
def test_quantize_matches_jitted_reference_and_pallas(nc, chunk):
    x = _chunks(nc, chunk, seed=nc)
    want = [np.asarray(a) for a in jax.jit(jref.jnp_int8_quantize)(x)]
    pallas = [np.asarray(a) for a in pallas_int8_quantize(jnp.asarray(x), interpret=True)]
    q, scale, lo = ref.torch_int8_quantize(torch.from_numpy(x), chunk)   # one chunk per row
    got = [q.reshape(nc, chunk).numpy(), scale.reshape(nc).numpy(), lo.reshape(nc).numpy()]
    for g, w, p in zip(got, want, pallas):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(p, w)
    assert got[1][1] == 1.0   # constant chunk: safe scale


@pytest.mark.parametrize("nc,chunk", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_dequantize_matches_jitted_reference_and_pallas(nc, chunk, dtype):
    q, scale, lo = (np.array(a) for a in jax.jit(jref.jnp_int8_quantize)(_chunks(nc, chunk)))
    want = np.asarray(jax.jit(jref.jnp_int8_dequantize)(q, scale, lo))
    pallas = np.asarray(pallas_int8_dequantize(*map(jnp.asarray, (q, scale, lo)), interpret=True))
    np.testing.assert_array_equal(pallas, want)
    got = ref.torch_int8_dequantize(torch.from_numpy(q)[None], torch.from_numpy(scale)[None],
                                    torch.from_numpy(lo)[None], nc * chunk, dtype)
    want_t = torch.from_numpy(np.array(want)).reshape(1, -1).to(dtype)   # the codec's final cast
    assert got.dtype == dtype and torch.equal(got, want_t)


def test_dequantize_is_one_rounding():
    """q·scale + lo rounded twice in fp32 differs from the reference in most
    values; the plain version's single rounding in none."""
    q, scale, lo = (np.array(a) for a in jax.jit(jref.jnp_int8_quantize)(_chunks(64, 1024, 3)))
    want = np.asarray(jax.jit(jref.jnp_int8_dequantize)(q, scale, lo))
    twice = q.astype(np.float32) * scale[:, None] + lo[:, None]
    assert (twice != want).mean() > 0.3
    got = ref.torch_int8_dequantize(*(torch.from_numpy(a)[None] for a in (q, scale, lo)),
                                    q.size, torch.float32)
    np.testing.assert_array_equal(got.reshape(q.shape).numpy(), want)


@pytest.mark.parametrize("n,chunk", [(5000, 1024), (3 * 1024, 1024), (50, 7), (3, 1024)])
def test_rows_pad_like_the_codec(n, chunk):
    """Each row of (R, N) is edge-padded to whole chunks of its own, as the
    JAX codec pads each replica's buffer before its (NC, CHUNK) call."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(3, n)) * 10.0 ** rng.uniform(-3, 3, size=(3, 1))).astype(np.float32)
    q, scale, lo = ref.torch_int8_quantize(torch.from_numpy(x), chunk)
    nc = -(-n // chunk)
    for r in range(3):
        padded = np.pad(x[r], (0, nc * chunk - n), mode="edge").reshape(nc, chunk)
        wq, ws, wl = (np.asarray(a) for a in jax.jit(jref.jnp_int8_quantize)(padded))
        np.testing.assert_array_equal(q[r].numpy(), wq)
        np.testing.assert_array_equal(scale[r].numpy(), ws)
        np.testing.assert_array_equal(lo[r].numpy(), wl)
        back = ref.torch_int8_dequantize(q[r:r + 1], scale[r:r + 1], lo[r:r + 1], n, torch.float32)
        want = np.asarray(jax.jit(jref.jnp_int8_dequantize)(wq, ws, wl)).reshape(-1)[:n]
        np.testing.assert_array_equal(back[0].numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,chunk", [(8 * 1024 + 17, 1024), (8 * 1024 + 3, 1024), (1000, 1024),
                                     (4100, 256), (6144, 2048), (4096, 512)])
def test_rows_match_the_jitted_reference_where_the_kernels_split(n, chunk, dtype):
    """The shapes on which the CUDA quantize divides its chunks between its
    16-byte and scalar kernels (ragged tails, rows that start misaligned,
    n < chunk, CHUNK 256 and 2048): the plain version on bf16 or fp32 rows
    equals the jitted JAX reference on the same values read as fp32."""
    rng = np.random.default_rng(n + chunk)
    x = torch.from_numpy((rng.normal(size=(3, n)) * 10.0 ** rng.uniform(-3, 3, size=(3, 1)))
                         .astype(np.float32)).to(dtype)
    q, scale, lo = ref.torch_int8_quantize(x, chunk)
    nc = -(-n // chunk)
    for r in range(3):
        padded = np.pad(x[r].float().numpy(), (0, nc * chunk - n), mode="edge").reshape(nc, chunk)
        wq, ws, wl = (np.asarray(a) for a in jax.jit(jref.jnp_int8_quantize)(padded))
        np.testing.assert_array_equal(q[r].numpy(), wq)
        np.testing.assert_array_equal(scale[r].numpy(), ws)
        np.testing.assert_array_equal(lo[r].numpy(), wl)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Launched(Exception):
    pass


def test_non_cpu_tensors_never_reach_the_plain_versions(monkeypatch):
    def plain_called(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    def launched():
        raise _Launched

    monkeypatch.setattr(ref, "torch_int8_quantize", plain_called)
    monkeypatch.setattr(ref, "torch_int8_dequantize", plain_called)
    monkeypatch.setattr(quantize, "library", launched)
    before = (quantize.int8_quantize.launches, quantize.int8_dequantize.launches)
    x = torch.randn(2, 40)
    with pytest.raises(_Launched):   # a CUDA tensor goes to the kernel
        ops.int8_quantize(x.as_subclass(_FakeCuda), 16)
    with pytest.raises(ValueError, match="CUDA tensor"):   # any other device raises
        ops.int8_quantize(x.to("meta"), 16)
    q = torch.zeros((2, 3, 16), dtype=torch.uint8)
    s = torch.ones((2, 3))
    with pytest.raises(_Launched):
        ops.int8_dequantize(q.as_subclass(_FakeCuda), s.as_subclass(_FakeCuda),
                            s.as_subclass(_FakeCuda), 40, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.int8_dequantize(q.to("meta"), s.to("meta"), s.to("meta"), 40, torch.float32)
    assert (quantize.int8_quantize.launches, quantize.int8_dequantize.launches) == before


def test_nan_poisons_its_chunk_as_in_the_reference():
    """A NaN makes its chunk's min, max and every decoded value NaN (the
    reference's reductions propagate it); other chunks are untouched."""
    x = _chunks(4, 1024, seed=9)
    x[2, 17] = np.nan
    jq, js, jl = jax.jit(jref.jnp_int8_quantize)(x)
    want = np.asarray(jax.jit(jref.jnp_int8_dequantize)(jq, js, jl))
    q, scale, lo = ref.torch_int8_quantize(torch.from_numpy(x).reshape(1, -1), 1024)
    got = ref.torch_int8_dequantize(q, scale, lo, x.size, torch.float32).reshape(4, 1024)
    assert np.isnan(lo[0, 2].item()) and np.isnan(got[2].numpy()).all()
    np.testing.assert_array_equal(got.numpy(), want)   # NaN == NaN here
    np.testing.assert_array_equal(q[0, [0, 1, 3]].numpy(), np.asarray(jq)[[0, 1, 3]])
