"""Nested dict/list/tuple helpers for parameter trees (the JAX package's
pytrees of params and optimizer state)."""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *items) for items in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves in a fixed order (dict insertion order, then sequence order)."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_unflatten(tree: Any, leaves: list) -> Any:
    """Rebuild ``tree``'s structure from ``leaves`` (as tree_leaves orders them)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
