"""PyTorch and CUDA port of the NoLoCo reproduction (JAX reference in ``repro``).

Covers the serving path so far: a continuous-batching engine over a paged KV
cache whose attention runs through hand-written CUDA kernels on the card and
through their plain PyTorch versions on the CPU.
"""
