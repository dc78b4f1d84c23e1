"""Gossip communication for the NoLoCo outer step (the port's slice of
``repro/comm``): :class:`CommConfig` and the four wire codecs, the payload
layout with pack/unpack, the exact byte model, and the stacked
communicator."""

from repro_torch.comm import bytes_model, compress, exchange, payload
from repro_torch.comm.compress import (
    CODECS, CastCodec, Codec, CommConfig, Int8Codec, NoneCodec, get_codec,
)
from repro_torch.comm.exchange import Communicator, StackedGather, exchange_gossip, wire_roundtrip
from repro_torch.comm.payload import (
    BufferSpec, LeafShape, LeafSlot, PayloadSpec, make_spec, pack, unpack,
)

__all__ = [
    "CODECS", "Codec", "CommConfig", "NoneCodec", "CastCodec", "Int8Codec", "get_codec",
    "Communicator", "StackedGather", "exchange_gossip", "wire_roundtrip",
    "BufferSpec", "LeafShape", "LeafSlot", "PayloadSpec", "make_spec", "pack", "unpack",
    "bytes_model", "compress", "exchange", "payload",
]
