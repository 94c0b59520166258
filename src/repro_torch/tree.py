"""Nested dicts, tuples and lists of tensors (the port's pytrees).

The reference walks its parameter, optimiser and checkpoint trees with
``jax.tree``; the port's trees have the same nesting (dicts, tuples,
lists; anything else is a leaf), walked by these helpers.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_leaves", "leaves_like", "unflatten_like",
           "paths_and_leaves"]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``, given the subtree of each of
    ``rest`` at the same place (a whole subtree where ``rest`` is deeper
    than ``tree``, as adafactor's per-leaf state is)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def leaves_like(structure, tree) -> list:
    """The subtrees of ``tree`` at the leaves of ``structure``, in order."""
    out: list = []
    tree_map(lambda _, t: out.append(t), structure, tree)
    return out


def unflatten_like(structure, values) -> Any:
    """``structure``'s nesting with its leaves replaced by ``values``."""
    it = iter(values)
    return tree_map(lambda _: next(it), structure)


def paths_and_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(key, leaf)`` pairs; a key is the dict keys and sequence indexes
    down to the leaf joined by ``/``, as the reference's checkpoint names
    its leaves (``jax.tree_util`` key paths)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += paths_and_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    return out
