"""Payload layout: where each leaf of a tree sits in one packed buffer per
dtype.

The port of ``repro/comm/payload.py`` for one stream: ``make_spec`` builds
a static :class:`PayloadSpec` from leaf shapes and dtypes (tensors or
:class:`LeafShape` stand-ins, so a full-width model is costed without
allocating it); :func:`pack` and :func:`unpack` move values in and out of
the packed buffers.  Leaves and buffers follow the JAX package's order
(dict keys sorted, buffers in order of first appearance), so the int8
codec's chunk boundaries fall where the JAX package puts them.

:func:`stream_partition` shards the payload into ``stream_count``
contiguous parameter-group streams (Streaming DiLoCo): leaves go to streams
in flatten order by the reference's integer midpoint rule over their
element counts, and streams may be empty.  Each stream's
:class:`PayloadSpec` is built over the full leaf list with global leaf
indices, so ``pack(tree, spec=part.specs[k])`` packs just that stream's
leaves and :func:`unpack_onto` writes them back into a base tree, leaving
the other streams' leaves as they were.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.comm.compress import itemsize
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = [
    "LeafShape", "LeafSlot", "BufferSpec", "PayloadSpec", "StreamPartition", "make_spec",
    "stream_partition", "pack", "unpack", "unpack_onto",
]


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


def _spec_for_indices(leaves: list, treedef, idxs, *, fuse: bool) -> PayloadSpec:
    """Packing layout of the leaves ``idxs`` (global flatten indices) of a
    tree whose leaves are ``leaves``: ``fuse=True`` groups them by dtype
    (one buffer per dtype, in order of first appearance); ``fuse=False``
    gives every leaf its own buffer."""
    slots_of: dict[str, list[LeafSlot]] = {}
    buffers: list[BufferSpec] = []
    for i in idxs:
        shape = tuple(leaves[i].shape)
        size = math.prod(shape)
        dt = _dtype_name(leaves[i])
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
    return PayloadSpec(buffers=tuple(buffers), num_leaves=len(leaves), treedef=treedef)


def _index_tree(tree: PyTree) -> PyTree:
    """``tree``'s structure with each leaf replaced by its flatten index."""
    return tree_unflatten(tree, range(len(tree_leaves(tree))))


def make_spec(tree: PyTree, *, fuse: bool = True) -> PayloadSpec:
    """The packing layout of ``tree``: ``fuse=True`` groups leaves by dtype
    (one buffer per dtype, in order of first appearance); ``fuse=False``
    gives every leaf its own buffer."""
    leaves = tree_leaves(tree)
    return _spec_for_indices(leaves, _index_tree(tree), range(len(leaves)), fuse=fuse)


@dataclasses.dataclass(frozen=True)
class StreamPartition:
    """A deterministic shard of one payload into contiguous leaf streams.

    ``leaf_stream[i]`` is the stream of global leaf ``i`` (non-decreasing in
    flatten order); ``specs[k]`` packs stream ``k``'s leaves and is built
    over the full leaf list, so global leaf indices flow straight into
    :func:`pack` and :func:`unpack_onto`.  Streams may be empty."""

    num_leaves: int
    stream_count: int
    leaf_stream: tuple[int, ...]
    specs: tuple[PayloadSpec, ...]

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.specs)

    def leaf_indices(self, stream: int) -> tuple[int, ...]:
        """Global leaf indices of ``stream``, in flatten order."""
        return tuple(i for i, k in enumerate(self.leaf_stream) if k == stream)


def stream_partition(tree: PyTree, stream_count: int, *, fuse: bool = True) -> StreamPartition:
    """Shard ``tree``'s payload (tensors or :class:`LeafShape` stand-ins)
    into ``stream_count`` contiguous leaf streams: leaf ``i`` spanning
    elements ``[a, a+n)`` of the flattened payload goes to stream
    ``⌊(2a + n)·S / (2·total)⌋`` (the midpoint rule in integers), at most
    ``S − 1``.  With ``stream_count=1`` the one spec is ``make_spec(tree,
    fuse=fuse)``."""
    if stream_count < 1:
        raise ValueError(f"stream_count must be >= 1, got {stream_count}")
    leaves = tree_leaves(tree)
    sizes = [math.prod(tuple(leaf.shape)) for leaf in leaves]
    total = sum(sizes)
    leaf_stream: list[int] = []
    acc = 0
    for size in sizes:
        k = ((2 * acc + size) * stream_count) // (2 * total) if total else 0
        leaf_stream.append(min(k, stream_count - 1))
        acc += size
    treedef = _index_tree(tree)
    specs = tuple(
        _spec_for_indices(leaves, treedef, [i for i, k in enumerate(leaf_stream) if k == s],
                          fuse=fuse)
        for s in range(stream_count)
    )
    return StreamPartition(num_leaves=len(leaves), stream_count=stream_count,
                           leaf_stream=tuple(leaf_stream), specs=specs)


def pack(tree: PyTree, *, fuse: bool = True, lead: int = 0,
         spec: PayloadSpec | None = None) -> tuple[list[torch.Tensor], PayloadSpec]:
    """Flatten ``tree`` into its packed buffers.  The first ``lead`` axes of
    every leaf are batch axes (the replica axis of the stacked simulation):
    the layout is that of one entry, and each buffer comes out as
    ``batch + (size,)``.  ``spec`` (e.g. a stream's, over the whole tree)
    packs only the leaves it covers.  Returns (buffers, spec)."""
    leaves = tree_leaves(tree)
    if spec is None:
        spec = make_spec(
            tree_map(lambda x: LeafShape(tuple(x.shape[lead:]), _dtype_name(x)), tree), fuse=fuse
        )
    batch = tuple(leaves[0].shape[:lead]) if leaves else ()
    buffers = []
    for bspec in spec.buffers:
        parts = [leaves[s.index].reshape(*batch, -1) for s in bspec.slots]
        buffers.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1))
    return buffers, spec


def _write(leaves: list, buffers: list[torch.Tensor], spec: PayloadSpec) -> None:
    for buf, bspec in zip(buffers, spec.buffers):
        batch = tuple(buf.shape[:-1])
        for s in bspec.slots:
            leaves[s.index] = buf[..., s.offset:s.offset + s.size].reshape(batch + tuple(s.shape))


def unpack(buffers: list[torch.Tensor], spec: PayloadSpec) -> PyTree:
    """Inverse of :func:`pack`: the tree, each leaf a view into its buffer
    with the buffer's batch axes in front."""
    leaves: list = [None] * spec.num_leaves
    _write(leaves, buffers, spec)
    return tree_map(lambda i: leaves[i], spec.treedef)


def unpack_onto(buffers: list[torch.Tensor], spec: PayloadSpec, base: PyTree) -> PyTree:
    """Partial unpack: the leaves ``spec`` covers, from ``buffers``, written
    into a tree of ``base``'s structure; every other leaf is ``base``'s own.
    The inverse of ``pack(tree, spec=partition.specs[k])``."""
    leaves = tree_leaves(base)
    if len(leaves) != spec.num_leaves:
        raise ValueError(
            f"base has {len(leaves)} leaves but spec covers a tree of {spec.num_leaves}"
        )
    _write(leaves, buffers, spec)
    return tree_unflatten(base, leaves)
