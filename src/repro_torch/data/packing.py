"""Sequence packing: concatenate variable-length documents into fixed
(seq_len+1) training rows with an EOS separator and a loss mask that blanks
the first token after each boundary (no cross-document prediction).

The port's copy of ``repro/data/packing.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pack_documents"]


def pack_documents(
    docs: list[np.ndarray], seq_len: int, eos_id: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy-pack documents into rows of seq_len+1 tokens.

    Returns (tokens (N, S), labels (N, S), loss_mask (N, S)): a label is
    masked where its input token is an EOS or follows one."""
    stream: list[int] = []
    for d in docs:
        stream.extend(int(x) for x in d)
        stream.append(eos_id)
    row = seq_len + 1
    n = len(stream) // row
    if n == 0:
        raise ValueError("not enough tokens to fill one packed row")
    arr = np.asarray(stream[: n * row], dtype=np.int32).reshape(n, row)
    tokens, labels = arr[:, :-1], arr[:, 1:]
    mask = np.ones_like(labels, dtype=bool)
    mask[:, 1:] &= tokens[:, 1:] != eos_id
    mask &= tokens != eos_id
    return tokens, labels, mask
