"""Gossip communication for the NoLoCo outer step (the port's slice of
``repro/comm``): :class:`CommConfig` and the identity codec, the payload
layout, the exact byte model, and the stacked communicator."""

from repro_torch.comm import bytes_model, compress, exchange, payload
from repro_torch.comm.compress import CODECS, Codec, CommConfig, NoneCodec, get_codec
from repro_torch.comm.exchange import Communicator, StackedGather, exchange_gossip
from repro_torch.comm.payload import BufferSpec, LeafShape, LeafSlot, PayloadSpec, make_spec

__all__ = [
    "CODECS", "Codec", "CommConfig", "NoneCodec", "get_codec",
    "Communicator", "StackedGather", "exchange_gossip",
    "BufferSpec", "LeafShape", "LeafSlot", "PayloadSpec", "make_spec",
    "bytes_model", "compress", "exchange", "payload",
]
