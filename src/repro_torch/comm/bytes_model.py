"""Exact bytes on the wire and message counts for one outer step.

The port of ``repro/comm/bytes_model.py``.  The numbers are the paper's
communication figures: they feed the training loop's ``comm_bytes`` /
``blocking_bytes`` accounting, and they equal the JAX package's for the
same tree and :class:`CommConfig`, the per-stream schedule of streaming
outer steps included (one :class:`StreamCost` per stream sync, each costed
over that stream's own buffers, so the int8 wire's chunk rounding falls
where the runtime's does).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.comm import payload as payload_lib
from repro_torch.comm.compress import CommConfig, get_codec
from repro_torch.tree import tree_leaves

PyTree = Any

__all__ = ["CommCost", "StreamCost", "spec_cost", "outer_step_cost", "abstract_params",
           "abstract_stage_params"]


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
    """Per-replica communication cost of one full outer cycle (every stream
    synced once; with ``streams=1`` one outer step), one direction:
    everything a replica sends (``payload_bytes``/``messages``, the
    overlapped φ′ pre-send included), the part its sync points wait for
    (``blocking_*``), their difference ``overlapped_bytes``, the schedule
    ``per_stream``, and the uncompressed fused baseline ``raw_bytes``."""

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
    """Cost of one outer cycle for a replica holding ``param_tree``.

    NoLoCo exchanges the (Δ, φ) payload with ONE partner per sync; with
    ``streams=S`` the payload is sharded into S streams (:func:`~repro_torch.
    comm.payload.stream_partition`), each synced at its own round offset.
    A stream without the overlap blocks on its (Δ_k, φ_k) pair, one fused
    payload; with ``overlap`` its φ′_k is pre-sent during the inner phase
    as a payload of its own (costed like Δ_k's: the same leaves), and only
    Δ_k blocks.  DiLoCo ring-all-reduces Δ over ``world`` replicas,
    uncompressed: each replica sends ``2·(world−1)/world`` of the payload in
    ``2·(world−1)`` messages per buffer (no streams).  ``method="none"``
    costs nothing."""
    cfg.validate()
    if method == "none":
        return CommCost(method, cfg.codec, cfg.fuse, cfg.overlap, 0, 0, 0, 0, 0)
    if method == "diloco":
        if cfg.streams > 1:
            raise ValueError("streams > 1 is a noloco-only feature (gossip pairing)")
        delta_spec = payload_lib.make_spec(param_tree, fuse=cfg.fuse)
        steps = 2 * (world - 1)
        raw = int(round(delta_spec.nbytes * steps / world))
        msgs = steps * len(delta_spec.buffers)
        return CommCost(method, "none", cfg.fuse, cfg.overlap, raw, msgs, raw, msgs, raw)
    if method != "noloco":
        raise ValueError(f"unknown outer method: {method}")
    leaves = tree_leaves(param_tree)
    part = payload_lib.stream_partition(param_tree, cfg.streams, fuse=cfg.fuse)
    per_stream: list[StreamCost] = []
    for k in range(cfg.streams):
        sub = [leaves[i] for i in part.leaf_indices(k)]
        if cfg.overlap:
            delta_bytes, delta_msgs = spec_cost(payload_lib.make_spec(sub, fuse=cfg.fuse), cfg)
            per_stream.append(StreamCost(k, 2 * delta_bytes, delta_bytes, delta_bytes,
                                         2 * delta_msgs, delta_msgs))
        else:
            pair_bytes, pair_msgs = spec_cost(payload_lib.make_spec((sub, sub), fuse=cfg.fuse), cfg)
            per_stream.append(StreamCost(k, pair_bytes, pair_bytes, 0, pair_msgs, pair_msgs))
    payload_bytes = sum(s.payload_bytes for s in per_stream)
    blocking_bytes = sum(s.blocking_bytes for s in per_stream)
    raw = payload_lib.make_spec((param_tree, param_tree), fuse=cfg.fuse).nbytes
    return CommCost(
        method, cfg.codec, cfg.fuse, cfg.overlap, payload_bytes,
        sum(s.messages for s in per_stream), blocking_bytes,
        sum(s.blocking_messages for s in per_stream), raw, stream_count=cfg.streams,
        overlapped_bytes=payload_bytes - blocking_bytes, per_stream=tuple(per_stream),
    )


def _abstract(shapes: PyTree, cfg) -> PyTree:
    """The :class:`~repro_torch.comm.payload.LeafShape` tree of a shape
    tree: norm scales and biases fp32, every other weight in ``cfg.dtype``."""
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

    return walk(shapes)


def abstract_params(cfg) -> PyTree:
    """:class:`~repro_torch.comm.payload.LeafShape` tree of one replica's
    parameters for a model config (nothing allocated), dtypes as
    ``init_params`` makes them."""
    from repro_torch.models import convert

    return _abstract(convert.expected_shapes(cfg), cfg)


def abstract_stage_params(cfg, stage: int, num_stages: int) -> PyTree:
    """:class:`~repro_torch.comm.payload.LeafShape` tree of one replica's
    parameters of a routed-pipeline stage (``pipeline.runner.
    init_stage_params``), nothing allocated."""
    from repro_torch.models import convert

    return _abstract(convert.stage_shapes(cfg, stage, num_stages), cfg)
