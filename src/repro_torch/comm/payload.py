"""Payload layout: where each leaf of a tree sits in one packed buffer per
dtype.

The port of the part of ``repro/comm/payload.py`` that the byte model needs:
``make_spec`` builds a static :class:`PayloadSpec` from leaf shapes and
dtypes (tensors or :class:`LeafShape` stand-ins, so a full-width model is
costed without allocating it).  Packing and unpacking values, and the
stream partition of streaming outer steps, come with the lossy codecs and
the streaming runtime.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.comm.compress import itemsize
from repro_torch.tree import tree_leaves

PyTree = Any

__all__ = ["LeafShape", "LeafSlot", "BufferSpec", "PayloadSpec", "make_spec"]


@dataclasses.dataclass(frozen=True)
class LeafShape:
    """Shape and dtype name of a leaf that is not allocated."""

    shape: tuple[int, ...]
    dtype: str


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one leaf lives inside its packed buffer."""

    index: int                    # leaf position in flatten order
    shape: tuple[int, ...]
    offset: int                   # element offset into the buffer
    size: int                     # number of elements


@dataclasses.dataclass(frozen=True)
class BufferSpec:
    """One packed 1-D buffer: a dtype and the leaf slots it carries."""

    dtype: str
    size: int
    slots: tuple[LeafSlot, ...]

    @property
    def nbytes(self) -> int:
        return self.size * itemsize(self.dtype)


@dataclasses.dataclass(frozen=True)
class PayloadSpec:
    """Static description of a packed tree."""

    buffers: tuple[BufferSpec, ...]
    num_leaves: int

    @property
    def nbytes(self) -> int:
        """Raw (uncompressed) payload bytes."""
        return sum(b.nbytes for b in self.buffers)

    @property
    def num_elements(self) -> int:
        return sum(b.size for b in self.buffers)


def _dtype_name(leaf) -> str:
    dt = leaf.dtype
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else str(dt)


def make_spec(tree: PyTree, *, fuse: bool = True) -> PayloadSpec:
    """The packing layout of ``tree``: ``fuse=True`` groups leaves by dtype
    (one buffer per dtype, in order of first appearance); ``fuse=False``
    gives every leaf its own buffer."""
    leaves = tree_leaves(tree)
    slots_of: dict[str, list[LeafSlot]] = {}
    buffers: list[BufferSpec] = []
    for i, leaf in enumerate(leaves):
        shape = tuple(leaf.shape)
        size = math.prod(shape)
        dt = _dtype_name(leaf)
        if not fuse:
            buffers.append(BufferSpec(dt, size, (LeafSlot(i, shape, 0, size),)))
            continue
        slots = slots_of.setdefault(dt, [])
        offset = slots[-1].offset + slots[-1].size if slots else 0
        slots.append(LeafSlot(i, shape, offset, size))
    if fuse:
        buffers = [
            BufferSpec(dt, slots[-1].offset + slots[-1].size, tuple(slots))
            for dt, slots in slots_of.items()
        ]
    return PayloadSpec(buffers=tuple(buffers), num_leaves=len(leaves))
