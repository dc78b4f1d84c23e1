"""Serving: continuous batching over a paged KV cache, and promotion of a
training checkpoint's replica to the served model."""

from repro_torch.serve.engine import FinishedRequest, Request, ServeConfig, ServeEngine
from repro_torch.serve.paged import BlockAllocator, Lease
from repro_torch.serve.promote import promote, resolve_replica

__all__ = [
    "BlockAllocator",
    "FinishedRequest",
    "Lease",
    "Request",
    "ServeConfig",
    "ServeEngine",
    "promote",
    "resolve_replica",
]
