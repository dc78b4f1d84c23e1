"""Payload layout: where each leaf of a tree sits in one packed buffer per
dtype.

The port of ``repro/comm/payload.py`` for one stream: ``make_spec`` builds
a static :class:`PayloadSpec` from leaf shapes and dtypes (tensors or
:class:`LeafShape` stand-ins, so a full-width model is costed without
allocating it); :func:`pack` and :func:`unpack` move values in and out of
the packed buffers.  Leaves and buffers follow the JAX package's order
(dict keys sorted, buffers in order of first appearance), so the int8
codec's chunk boundaries fall where the JAX package puts them.  The stream
partition of streaming outer steps comes with the streaming runtime
(ROADMAP Queue 1 item 10b).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.comm.compress import itemsize
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["LeafShape", "LeafSlot", "BufferSpec", "PayloadSpec", "make_spec", "pack", "unpack"]


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
    # the tree's structure with each leaf replaced by its flatten index
    treedef: Any = dataclasses.field(default=None, compare=False, repr=False)

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
    index = iter(range(len(leaves)))
    treedef = tree_map(lambda _: next(index), tree)
    return PayloadSpec(buffers=tuple(buffers), num_leaves=len(leaves), treedef=treedef)


def pack(tree: PyTree, *, fuse: bool = True, lead: int = 0) -> tuple[list[torch.Tensor], PayloadSpec]:
    """Flatten ``tree`` into its packed buffers.  The first ``lead`` axes of
    every leaf are batch axes (the replica axis of the stacked simulation):
    the layout is that of one entry, and each buffer comes out as
    ``batch + (size,)``.  Returns (buffers, spec)."""
    leaves = tree_leaves(tree)
    spec = make_spec(
        tree_map(lambda x: LeafShape(tuple(x.shape[lead:]), _dtype_name(x)), tree), fuse=fuse
    )
    batch = tuple(leaves[0].shape[:lead]) if leaves else ()
    buffers = []
    for bspec in spec.buffers:
        parts = [leaves[s.index].reshape(*batch, -1) for s in bspec.slots]
        buffers.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1))
    return buffers, spec


def unpack(buffers: list[torch.Tensor], spec: PayloadSpec) -> PyTree:
    """Inverse of :func:`pack`: the tree, each leaf a view into its buffer
    with the buffer's batch axes in front."""
    leaves: list = [None] * spec.num_leaves
    for buf, bspec in zip(buffers, spec.buffers):
        batch = tuple(buf.shape[:-1])
        for s in bspec.slots:
            leaves[s.index] = buf[..., s.offset:s.offset + s.size].reshape(*batch, *s.shape)
    return tree_map(lambda i: leaves[i], spec.treedef)
