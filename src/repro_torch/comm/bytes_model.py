"""Exact bytes on the wire and message counts for one outer step.

The port of ``repro/comm/bytes_model.py`` for one stream (the default,
``streams=1``, with or without the φ-prefetch overlap).  The numbers are the
paper's communication figures: they feed the training loop's ``comm_bytes``
/ ``blocking_bytes`` accounting, and they equal the JAX package's for the
same tree and :class:`CommConfig`.  The per-stream schedule of streaming
outer steps comes with the streaming runtime and raises until then.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.comm import payload as payload_lib
from repro_torch.comm.compress import CommConfig, get_codec

PyTree = Any

__all__ = ["CommCost", "StreamCost", "spec_cost", "outer_step_cost", "abstract_params"]


@dataclasses.dataclass(frozen=True)
class StreamCost:
    """One stream's share of the outer-cycle exchange (one sync event)."""

    stream: int
    payload_bytes: int
    blocking_bytes: int
    overlapped_bytes: int
    messages: int
    blocking_messages: int


@dataclasses.dataclass(frozen=True)
class CommCost:
    """Per-replica communication cost of one outer step (one direction):
    everything a replica sends (``payload_bytes``/``messages``), the part its
    sync point waits for (``blocking_*``), and the uncompressed fused baseline
    ``raw_bytes``."""

    method: str
    codec: str
    fuse: bool
    overlap: bool
    payload_bytes: int
    messages: int
    blocking_bytes: int
    blocking_messages: int
    raw_bytes: int
    stream_count: int = 1
    overlapped_bytes: int = 0
    per_stream: tuple[StreamCost, ...] = ()

    @property
    def compression_ratio(self) -> float:
        return self.raw_bytes / max(self.payload_bytes, 1)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["per_stream"] = list(d["per_stream"])
        d["compression_ratio"] = self.compression_ratio
        return d


def spec_cost(spec: payload_lib.PayloadSpec, cfg: CommConfig) -> tuple[int, int]:
    """(wire_bytes, messages) to send one packed payload under ``cfg``: one
    wire array, so one message, per buffer."""
    codec = get_codec(cfg)
    return sum(codec.wire_bytes(b.size, b.dtype) for b in spec.buffers), len(spec.buffers)


def outer_step_cost(
    param_tree: PyTree, cfg: CommConfig, *, method: str = "noloco", world: int = 2
) -> CommCost:
    """Cost of one outer step for a replica holding ``param_tree``.

    NoLoCo exchanges the (Δ, φ) payload with ONE partner; with ``overlap``
    φ′ is pre-sent during the inner phase so only Δ blocks.  DiLoCo
    ring-all-reduces Δ over ``world`` replicas, uncompressed: each replica
    sends ``2·(world−1)/world`` of the payload in ``2·(world−1)`` messages
    per buffer.  ``method="none"`` costs nothing."""
    cfg.validate()
    if method == "none":
        return CommCost(method, cfg.codec, cfg.fuse, cfg.overlap, 0, 0, 0, 0, 0)
    delta_spec = payload_lib.make_spec(param_tree, fuse=cfg.fuse)
    if method == "diloco":
        if cfg.streams > 1:
            raise ValueError("streams > 1 is a noloco-only feature (gossip pairing)")
        steps = 2 * (world - 1)
        raw = int(round(delta_spec.nbytes * steps / world))
        msgs = steps * len(delta_spec.buffers)
        return CommCost(method, "none", cfg.fuse, cfg.overlap, raw, msgs, raw, msgs, raw)
    if method != "noloco":
        raise ValueError(f"unknown outer method: {method}")
    if cfg.streams > 1:
        raise NotImplementedError(
            "the per-stream schedule of streaming outer steps is not ported yet "
            "(ROADMAP Queue 1 item 10)"
        )
    if cfg.overlap:
        delta_bytes, delta_msgs = spec_cost(delta_spec, cfg)
        stream = StreamCost(0, 2 * delta_bytes, delta_bytes, delta_bytes,
                            2 * delta_msgs, delta_msgs)
    else:
        pair_bytes, pair_msgs = spec_cost(
            payload_lib.make_spec((param_tree, param_tree), fuse=cfg.fuse), cfg
        )
        stream = StreamCost(0, pair_bytes, pair_bytes, 0, pair_msgs, pair_msgs)
    raw = payload_lib.make_spec((param_tree, param_tree), fuse=cfg.fuse).nbytes
    return CommCost(
        method, cfg.codec, cfg.fuse, cfg.overlap,
        stream.payload_bytes, stream.messages, stream.blocking_bytes,
        stream.blocking_messages, raw, stream_count=1,
        overlapped_bytes=stream.payload_bytes - stream.blocking_bytes,
        per_stream=(stream,),
    )


def abstract_params(cfg) -> PyTree:
    """:class:`~repro_torch.comm.payload.LeafShape` tree of one replica's
    parameters for a model config (nothing allocated): norm scales and
    biases fp32, every other weight in ``cfg.dtype``, as ``init_params``
    makes them."""
    from repro_torch.models import convert

    def leaf(path, shape):
        dt = "float32" if path in convert.FP32_LEAVES else cfg.dtype
        return payload_lib.LeafShape(tuple(shape), dt)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return None if tree is None else leaf(name, tree)

    return walk(convert.expected_shapes(cfg))
