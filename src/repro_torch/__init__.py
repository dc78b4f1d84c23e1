"""PyTorch and CUDA port of the NoLoCo reproduction (JAX reference in ``repro``).

Covers two paths so far.  Serving: a continuous-batching engine over a paged
KV cache.  Training: the stacked NoLoCo / DiLoCo / FSDP simulation, with
gossip pairings identical to the JAX package's.  On the card their attention
and the NoLoCo outer update run through hand-written CUDA kernels; on the
CPU through the kernels' plain PyTorch versions.
"""
