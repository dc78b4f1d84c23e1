"""Checkpoints of replica-stacked training state, in the JAX package's
on-disk format (the port of ``repro/checkpoint/ckpt.py``).

One directory per step, ``step_XXXXXXXX/`` with

    manifest.msgpack — the tree: dicts, ``{"__seq__": "list"|"tuple",
                       "items": [...]}``, ``{"__none__": true}`` and leaves
                       ``{"__leaf__": i, "dtype": name, "shape": [...]}``
    arrays.msgpack   — a list of ``{"dtype", "shape", "data"}``, ``data``
                       the leaf's row-major bytes (bfloat16 as its raw bits)

so a checkpoint written by either package restores in the other.  The
MessagePack coding is the port's own (:mod:`repro_torch.checkpoint.
msgpack_subset`); bfloat16 is read with ``torch.frombuffer``, so neither
``msgpack`` nor ``ml_dtypes`` is needed.  Leaves may be numpy arrays or
tensors on any device; :func:`restore` returns numpy arrays, except
bfloat16 leaves, which come back as CPU tensors (numpy has no bfloat16 of
its own).  A leaf larger than MessagePack's bin limit (2³² − 1 bytes)
raises, as ``msgpack.packb`` does for the JAX package.
"""

from __future__ import annotations

import mmap
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_subset as mp

__all__ = ["save", "restore", "latest_step"]

_SENTINEL = "__leaf__"
_STEP = re.compile(r"step_(\d+)")


def _host(leaf) -> tuple[str, tuple[int, ...], memoryview]:
    """(dtype name, shape, row-major bytes) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous().reshape(-1)
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(leaf.shape), memoryview(t.view(torch.int16).numpy().view(np.uint8))
        shape, arr = tuple(leaf.shape), t.numpy()
    else:
        arr = np.asarray(leaf)
        shape, arr = tuple(arr.shape), np.ascontiguousarray(arr).reshape(-1)
    return str(arr.dtype), shape, memoryview(arr.view(np.uint8))


def _encode_tree(tree: Any, leaves: list) -> Any:
    if isinstance(tree, dict):
        return {str(k): _encode_tree(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {"__seq__": type(tree).__name__, "items": [_encode_tree(v, leaves) for v in tree]}
    if tree is None:
        return {"__none__": True}
    idx = len(leaves)
    leaves.append(tree)
    shape = tree.shape if hasattr(tree, "shape") else np.shape(tree)
    return {_SENTINEL: idx, "dtype": _dtype_name(tree), "shape": [int(d) for d in shape]}


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _decode_tree(node: Any, leaves: list):
    if isinstance(node, dict):
        if _SENTINEL in node:
            return leaves[node[_SENTINEL]]
        if node.get("__none__"):
            return None
        if "__seq__" in node:
            items = [_decode_tree(v, leaves) for v in node["items"]]
            return tuple(items) if node["__seq__"] == "tuple" else items
        return {k: _decode_tree(v, leaves) for k, v in node.items()}
    raise ValueError(f"bad manifest node: {node!r}")


def _steps(path: str) -> list[tuple[int, str]]:
    return sorted((int(m.group(1)), n) for n in os.listdir(path)
                  for m in [_STEP.fullmatch(n)] if m)


def save(path: str, step: int, tree: Any, *, keep: int | None = None) -> str:
    """Write ``tree`` as step ``step`` under ``path``; returns its directory.

    The write is atomic: both files go into ``step_XXXXXXXX.tmp``, which is
    renamed into place once they are complete, so a run killed mid-save
    never leaves a half-written checkpoint for ``--resume`` (leftover
    ``.tmp`` directories of any step are swept first).  Re-saving a step
    replaces it.  ``keep`` retains only the newest ``keep`` step
    directories, this one included; other entries under ``path`` are never
    touched.  ``arrays.msgpack`` is streamed to the file leaf by leaf."""
    d = os.path.join(path, f"step_{step:08d}")
    tmp = d + ".tmp"
    if os.path.isdir(path):
        for name in os.listdir(path):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(path, name), ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    leaves: list = []
    manifest = _encode_tree(tree, leaves)
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(mp.packb(manifest))
    with open(os.path.join(tmp, "arrays.msgpack"), "wb") as f:
        f.write(mp.array_header(len(leaves)))
        for i, leaf in enumerate(leaves):
            dtype, shape, data = _host(leaf)
            if data.nbytes > mp.BIN_MAX:
                raise ValueError(
                    f"checkpoint leaf {i} ({dtype}, shape {list(shape)}) holds {data.nbytes:,} "
                    f"bytes, over MessagePack's bin limit of {mp.BIN_MAX:,} bytes that the "
                    "checkpoint format stores each leaf in"
                )
            mp.pack_to({"dtype": dtype, "shape": list(shape), "data": data}, f.write)
    shutil.rmtree(d, ignore_errors=True)
    os.rename(tmp, d)
    if keep is not None and keep > 0:
        for _, name in _steps(path)[:-keep]:
            shutil.rmtree(os.path.join(path, name), ignore_errors=True)
    return d


def _leaf(blob: dict):
    dtype, shape, data = blob["dtype"], tuple(blob["shape"]), blob["data"]
    if dtype == "bfloat16":
        if data.nbytes == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(data, dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)


def restore(path: str, step: int | None = None) -> Any:
    """The tree saved as ``step`` (default: the latest) under ``path``.
    Leaves are views of a private copy-on-write mapping of the file (numpy
    arrays; CPU tensors for bfloat16)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        manifest = mp.unpackb(f.read())
    with open(os.path.join(d, "arrays.msgpack"), "rb") as f:
        # copy-on-write mapping: nothing is read until a leaf is used, and
        # the views stay valid after the file is closed or pruned
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    blobs = mp.unpackb(data)
    return _decode_tree(manifest, [_leaf(b) for b in blobs])


def latest_step(path: str) -> int | None:
    """The newest step saved under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = _steps(path)
    return steps[-1][0] if steps else None
