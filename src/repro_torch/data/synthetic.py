"""Deterministic synthetic corpus with LEARNABLE structure.

The port's copy of ``repro/data/synthetic.py`` (numpy only, so the batches
are the JAX package's bit for bit): a token stream from a random-but-fixed
first-order Markov chain with Zipfian marginals plus periodic copy motifs.
A model that learns picks up the bigram transitions (fast loss drop) and
the copy motif (longer-range signal).

Everything is keyed by (seed, shard, position): any worker can materialize
any shard independently, as each NoLoCo replica owns its own data shard.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLM"]


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int = 512
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    motif_period: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # Zipfian stationary distribution over a random permutation of tokens
        ranks = rng.permutation(v) + 1
        base = 1.0 / ranks ** self.zipf_a
        base /= base.sum()
        # sparse-ish Markov transitions: each token prefers ~8 successors
        k = min(8, v)
        self._succ = rng.integers(0, v, size=(v, k))
        self._succ_p = rng.dirichlet(np.ones(k) * 0.5, size=v)
        self._base = base
        self._motif = rng.integers(0, v, size=self.motif_len)

    def sample_tokens(self, shard: int, length: int) -> np.ndarray:
        """Deterministic token stream for ``shard``."""
        rng = np.random.default_rng((self.seed + 1) * 1_000_003 + shard)
        out = np.empty(length, dtype=np.int32)
        tok = int(rng.choice(self.vocab_size, p=self._base))
        for i in range(length):
            if (i % self.motif_period) < self.motif_len:
                tok = int(self._motif[i % self.motif_period])
            else:
                j = int(rng.choice(self._succ.shape[1], p=self._succ_p[tok]))
                tok = int(self._succ[tok, j])
            out[i] = tok
        return out
