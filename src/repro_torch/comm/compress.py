"""Wire codecs for packed gossip payloads and the CommConfig that selects
them (the port of ``repro/comm/compress.py``).

Each codec maps a packed buffer (:mod:`repro_torch.comm.payload`) to ONE
wire array, so compression never adds messages:

  * ``none``  — identity.
  * ``fp16`` / ``bf16`` — cast floating buffers wider than the target to it;
    anything else (a bf16 buffer under ``fp16``, integers) passes through.
  * ``int8``  — per-chunk affine quantization: every ``chunk`` values map to
    uint8 with an fp32 (scale, min) pair; the wire is the codes, then the
    scales, then the minima as little-endian fp32 bytes, one uint8 array.
    The arithmetic is the dispatched kernel op (:func:`repro_torch.kernels.
    ops.int8_quantize`: the CUDA kernel on the card, its plain version on
    the CPU); the byte layout is the JAX package's.

Unlike the JAX codecs, which take one 1-D buffer, these take a buffer with
leading axes (a replica axis: (R, N)) and code every row on its own, exactly
as the JAX package's ``vmap`` over replicas does, in one kernel launch.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops as kernel_ops

__all__ = [
    "CODECS", "CommConfig", "Codec", "NoneCodec", "CastCodec", "Int8Codec", "get_codec",
    "itemsize",
]

CODECS = ("none", "fp16", "bf16", "int8")


def as_dtype(dtype: str | torch.dtype) -> torch.dtype:
    """A torch dtype from its name ("float32") or itself."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def itemsize(dtype: str | torch.dtype) -> int:
    """Bytes per element of a dtype given by name ("float32") or torch."""
    return torch.empty((), dtype=as_dtype(dtype)).element_size()


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """How the outer-step payload travels: codec × fusing × overlap.

    ``codec``:   "none" | "fp16" | "bf16" | "int8" — wire compression.
    ``fuse``:    pack the tree into one buffer per dtype (message count 1–2)
                 instead of one message per leaf.
    ``overlap``: pre-send φ′ for the NEXT pairing during the inner phase
                 (paper §3.2) so only Δ blocks the outer step.
    ``streams``: shard the outer payload into this many parameter-group
                 streams synced on staggered round offsets.
    ``chunk``:   int8 quantization group size (fp32 scale+min per chunk).
    ``error_feedback``: reserved for LoCo-style residual accumulation; no
                 trainer path carries the residuals, so it raises.
    """

    codec: str = "none"
    fuse: bool = True
    overlap: bool = False
    streams: int = 1
    chunk: int = 1024
    error_feedback: bool = False

    def validate(self) -> None:
        if self.codec not in CODECS:
            raise ValueError(f"unknown codec {self.codec!r}; options: {sorted(CODECS)}")
        if self.codec == "int8" and self.chunk < 2:
            raise ValueError("int8 chunk size must be >= 2")
        if self.streams < 1:
            raise ValueError(f"streams must be >= 1, got {self.streams}")
        if self.error_feedback and self.codec in ("none",):
            raise ValueError("error feedback only applies to lossy codecs")
        if self.error_feedback:
            raise NotImplementedError(
                "error_feedback=True: no trainer path accumulates the "
                "LoCo-style (arXiv 2407.04480) quantization residuals yet, "
                "so the flag would silently drop them; leave it False"
            )


class Codec:
    """encode(buffer) -> one wire array; decode(wire, dtype, size) -> buffer.
    Buffers are (..., N): every leading index is coded on its own."""

    name = "abstract"

    def encode(self, buf: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, wire: torch.Tensor, dtype, size: int) -> torch.Tensor:
        raise NotImplementedError

    def wire_bytes(self, size: int, dtype) -> int:
        """Exact bytes on the wire for a buffer of ``size`` elements."""
        raise NotImplementedError

    def encode_with_residual(self, buf: torch.Tensor,
                             residual: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Error-feedback encode: fold the accumulated residual into the
        buffer before coding it, and return the new residual (what this
        round's wire failed to carry)."""
        corrected = buf + residual.to(buf.dtype)
        wire = self.encode(corrected)
        decoded = self.decode(wire, corrected.dtype, corrected.shape[-1])
        return wire, (corrected - decoded).to(residual.dtype)


class NoneCodec(Codec):
    name = "none"

    def encode(self, buf):
        return buf

    def decode(self, wire, dtype, size):
        return wire

    def wire_bytes(self, size, dtype):
        return size * itemsize(dtype)


class CastCodec(Codec):
    """Cast floating buffers to a 2-byte dtype; pass everything else through."""

    def __init__(self, target: str):
        self.name = {"float16": "fp16", "bfloat16": "bf16"}[target]
        self._target = as_dtype(target)

    def _applies(self, dtype) -> bool:
        dtype = as_dtype(dtype)
        return dtype.is_floating_point and itemsize(dtype) > itemsize(self._target)

    def encode(self, buf):
        return buf.to(self._target) if self._applies(buf.dtype) else buf

    def decode(self, wire, dtype, size):
        return wire.to(as_dtype(dtype))

    def wire_bytes(self, size, dtype):
        return size * (itemsize(self._target) if self._applies(dtype) else itemsize(dtype))


class Int8Codec(Codec):
    """Per-chunk affine uint8 quantization with fp32 (scale, min) metadata.

    Wire of one (N,) buffer with NC = ⌈N / chunk⌉: the NC·chunk codes (the
    last chunk padded with the buffer's last value, so padding never widens
    its range), then the NC scales and the NC minima as little-endian fp32
    bytes: NC·(chunk + 8) bytes."""

    name = "int8"
    _META_BYTES_PER_CHUNK = 8  # fp32 scale + fp32 min

    def __init__(self, chunk: int = 1024):
        self.chunk = int(chunk)

    def _nchunks(self, size: int) -> int:
        return -(-size // self.chunk)

    def encode(self, buf):
        if not buf.dtype.is_floating_point:
            return buf
        lead, n = buf.shape[:-1], buf.shape[-1]
        q, scale, lo = kernel_ops.int8_quantize(buf.reshape(-1, n), self.chunk)
        rows = q.shape[0]
        meta = torch.cat([scale, lo], dim=1).view(torch.uint8)   # (R, 8·NC), native = little-endian
        return torch.cat([q.reshape(rows, -1), meta], dim=1).reshape(*lead, -1)

    def decode(self, wire, dtype, size):
        dtype = as_dtype(dtype)
        if not dtype.is_floating_point:
            return wire
        nc = self._nchunks(size)
        lead = wire.shape[:-1]
        w = wire.reshape(-1, wire.shape[-1])
        q = w[:, :nc * self.chunk].reshape(w.shape[0], nc, self.chunk)   # a view: no copy
        meta = w[:, nc * self.chunk:].contiguous().view(torch.float32)   # (R, 2·NC)
        x = kernel_ops.int8_dequantize(q, meta[:, :nc].contiguous(), meta[:, nc:].contiguous(),
                                       size, dtype)
        return x.reshape(*lead, size)

    def wire_bytes(self, size, dtype):
        if not as_dtype(dtype).is_floating_point:
            return size * itemsize(dtype)
        nc = self._nchunks(size)
        return nc * self.chunk + nc * self._META_BYTES_PER_CHUNK


def get_codec(cfg: CommConfig | str) -> Codec:
    """Codec instance for a :class:`CommConfig` (or bare codec name)."""
    if isinstance(cfg, str):
        cfg = CommConfig(codec=cfg)
    cfg.validate()
    if cfg.codec == "none":
        return NoneCodec()
    if cfg.codec == "fp16":
        return CastCodec("float16")
    if cfg.codec == "bf16":
        return CastCodec("bfloat16")
    return Int8Codec(chunk=cfg.chunk)
