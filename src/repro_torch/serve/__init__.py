"""Serving: continuous batching over a paged KV cache, speculative decoding
with a second replica or a depth-truncated draft, routing over several
promoted replicas, and promotion of a training checkpoint's replica to the
served model."""

from repro_torch.serve.engine import (
    EngineState,
    FinishedRequest,
    Request,
    ServeConfig,
    ServeEngine,
)
from repro_torch.serve.paged import BlockAllocator, Lease
from repro_torch.serve.promote import promote, resolve_replica, truncate_layers
from repro_torch.serve.router import ReplicaRouter
from repro_torch.serve.spec import SpecServeEngine

__all__ = [
    "BlockAllocator",
    "EngineState",
    "FinishedRequest",
    "Lease",
    "ReplicaRouter",
    "Request",
    "ServeConfig",
    "ServeEngine",
    "SpecServeEngine",
    "promote",
    "resolve_replica",
    "truncate_layers",
]
