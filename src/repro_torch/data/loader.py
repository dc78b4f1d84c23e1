"""Shard-aware loader gluing the synthetic corpus (or a token memmap) to
the trainer: deterministic, resumable (keyed by step), no coordination
between replicas.

The port's copy of ``repro/data/loader.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.data.synthetic import SyntheticLM

__all__ = ["LoaderConfig", "shard_iterator", "eval_batches", "TokenFileSource"]


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    vocab_size: int = 512
    seq_len: int = 128
    per_replica_batch: int = 4
    replicas: int = 4
    seed: int = 0


class TokenFileSource:
    """Memmap-backed pretokenized corpus (one flat int32 file)."""

    def __init__(self, path: str):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")

    def slice(self, start: int, n: int) -> np.ndarray:
        start = start % max(len(self.tokens) - n, 1)
        return np.asarray(self.tokens[start: start + n])


def shard_iterator(
    cfg: LoaderConfig, *, source: TokenFileSource | None = None, start_step: int = 0
) -> Iterator[dict]:
    """Infinite iterator of stacked numpy batches {tokens, labels}: (R, B, S)
    int32.  Replica r's data at step t is a pure function of (seed, r, t):
    starting at step t reproduces the exact stream.  With a ``source`` the
    rows are windows of the file; the seed offsets its cursor in steps, so
    differently seeded streams (the +777 eval convention) read other
    windows."""
    lm = None if source is not None else SyntheticLM(cfg.vocab_size, seed=cfg.seed)
    row = cfg.seq_len + 1
    need = cfg.per_replica_batch * row
    t = start_step
    while True:
        toks = np.empty((cfg.replicas, cfg.per_replica_batch, row), np.int32)
        for r in range(cfg.replicas):
            if source is not None:
                flat = source.slice(((t + cfg.seed) * cfg.replicas + r) * need, need)
            else:
                flat = lm.sample_tokens(r * 1_000_003 + t, need)
            toks[r] = flat.reshape(cfg.per_replica_batch, row)
        yield {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
        t += 1


def eval_batches(
    cfg: LoaderConfig, n: int, *, source: TokenFileSource | None = None
) -> list[dict]:
    """A fixed held-out eval set: the first ``n`` batches of the stream keyed
    by ``cfg.seed`` (callers pass a seed offset, conventionally +777, so the
    eval stream is disjoint from training)."""
    it = shard_iterator(cfg, source=source)
    return [next(it) for _ in range(n)]
