"""Serving: continuous batching over a paged KV cache."""

from repro_torch.serve.engine import FinishedRequest, Request, ServeConfig, ServeEngine
from repro_torch.serve.paged import BlockAllocator, Lease

__all__ = [
    "BlockAllocator",
    "FinishedRequest",
    "Lease",
    "Request",
    "ServeConfig",
    "ServeEngine",
]
