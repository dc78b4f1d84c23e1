"""Gossip communication for the NoLoCo outer step (the port's slice of
``repro/comm``): :class:`CommConfig` and the four wire codecs, the payload
layout with pack/unpack and the stream partition, the exact byte model
(per stream), the stacked communicator with the φ-prefetch, and the
replica group's pairwise exchange and all-reduce."""

from repro_torch.comm import bytes_model, compress, exchange, payload
from repro_torch.comm.compress import (
    CODECS, CastCodec, Codec, CommConfig, Int8Codec, NoneCodec, get_codec,
)
from repro_torch.comm.exchange import (
    AllReduce, Communicator, ShardedPermute, StackedGather, exchange_gossip, presend,
    wire_roundtrip,
)
from repro_torch.comm.payload import (
    BufferSpec, LeafShape, LeafSlot, PayloadSpec, StreamPartition, make_spec, pack,
    stream_partition, unpack, unpack_onto,
)

__all__ = [
    "CODECS", "Codec", "CommConfig", "NoneCodec", "CastCodec", "Int8Codec", "get_codec",
    "AllReduce", "Communicator", "ShardedPermute", "StackedGather", "exchange_gossip", "presend", "wire_roundtrip",
    "BufferSpec", "LeafShape", "LeafSlot", "PayloadSpec", "StreamPartition", "make_spec",
    "pack", "stream_partition", "unpack", "unpack_onto",
    "bytes_model", "compress", "exchange", "payload",
]
