"""Nested dict / list parameter trees: map and flatten.

The port keeps parameters, optimizer moments and outer state as plain trees
of dicts, lists and tuples with tensor leaves (``None`` is an empty
subtree), laid out like the JAX package's value trees.  Leaves are visited
in JAX's flatten order: dict keys sorted, sequences in order.
"""

from __future__ import annotations

from typing import Any, Callable

PyTree = Any

__all__ = ["tree_map", "tree_leaves", "tree_unflatten"]


def tree_map(fn: Callable[..., Any], tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), visited in the order of
    :func:`tree_leaves`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    """The leaves in JAX's flatten order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_unflatten(like: PyTree, leaves: list) -> PyTree:
    """``leaves`` (in flatten order) in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
