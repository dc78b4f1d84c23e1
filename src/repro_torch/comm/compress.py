"""Wire codecs for packed gossip payloads and the CommConfig that selects
them.

The port of ``repro/comm/compress.py`` for the default wire: ``CommConfig``
(with its validation) and the identity codec ``none``.  The lossy codecs
(``fp16``, ``bf16`` and the int8 per-chunk affine codec with its two kernels)
come with the next slice of the port and raise until then.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["CODECS", "CommConfig", "Codec", "NoneCodec", "get_codec", "itemsize"]

CODECS = ("none", "fp16", "bf16", "int8")


def itemsize(dtype: str | torch.dtype) -> int:
    """Bytes per element of a dtype given by name ("float32") or torch."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


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
    """encode(buffer) -> one wire array; decode(wire, dtype, size) -> buffer."""

    name = "abstract"

    def encode(self, buf: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, wire: torch.Tensor, dtype, size: int) -> torch.Tensor:
        raise NotImplementedError

    def wire_bytes(self, size: int, dtype) -> int:
        """Exact bytes on the wire for a buffer of ``size`` elements."""
        raise NotImplementedError


class NoneCodec(Codec):
    name = "none"

    def encode(self, buf):
        return buf

    def decode(self, wire, dtype, size):
        return wire

    def wire_bytes(self, size, dtype):
        return size * itemsize(dtype)


def get_codec(cfg: CommConfig | str) -> Codec:
    """Codec instance for a :class:`CommConfig` (or bare codec name)."""
    if isinstance(cfg, str):
        cfg = CommConfig(codec=cfg)
    cfg.validate()
    if cfg.codec == "none":
        return NoneCodec()
    raise NotImplementedError(
        f"codec {cfg.codec!r} is not ported yet: the lossy codecs and the int8 "
        "kernels are the next slice of the port (ROADMAP Queue 1 item 6)"
    )
