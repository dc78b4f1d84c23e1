"""Checkpoints in the JAX package's on-disk format (the port of
``repro/checkpoint``), read and written without ``msgpack`` or
``ml_dtypes``."""

from repro_torch.checkpoint.ckpt import latest_step, restore, save

__all__ = ["save", "restore", "latest_step"]
