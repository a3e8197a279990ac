"""Parameter trees: nested dicts and lists of tensors (the port's stand-in
for JAX pytrees).  ``leaves`` flattens in ``jax.tree`` order (dict keys
sorted, lists in order), so a checkpoint's ``arr_<i>.npy`` and an
optimizer's moments line up leaf for leaf with the reference's."""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list[Any]:
    """The leaves of a tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf, the tree's shape kept (tuples become
    lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def unflatten(tree, flat: list):
    """A tree of ``tree``'s shape whose leaves are ``flat``, in ``leaves``
    order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}           # the template's key order
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree has")
    return out
