"""Trees of parameters: nested dicts and lists with tensor (or ParamDef)
leaves and ``None`` for an absent subtree.

Dict keys are walked in sorted order, as JAX walks its pytrees, so leaf
order (and the order of any sum over leaves) matches the reference.  A
leaf's path is the string the reference's ``common.tree.path_str`` gives
it: dict keys and list indices joined by ``/`` (``model/units/0/conv1/w``);
a ``None`` subtree has no leaves and so no path, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``, in ``tree_leaves``
    order; ``None`` subtrees stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], f"{prefix}/{k}" if prefix
                                 else str(k)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, t, f"{prefix}/{i}" if prefix
                                        else str(i))
                          for i, t in enumerate(tree))
    return fn(prefix, tree)


def flatten_paths(tree) -> dict:
    """tree -> {path: leaf}."""
    out = {}
    map_with_path(out.__setitem__, tree)
    return out
