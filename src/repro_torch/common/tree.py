"""Trees of parameters: nested dicts and lists with tensor (or ParamDef)
leaves and ``None`` for an absent subtree.

Dict keys are walked in sorted order, as JAX walks its pytrees, so leaf
order (and the order of any sum over leaves) matches the reference.  A
leaf's path is the string the reference's ``common.tree.path_str`` gives
it: dict keys and list indices joined by ``/`` (``model/units/0/conv1/w``);
a ``None`` subtree has no leaves and so no path, as in JAX.

NeuLite trains only a subtree of the parameters each round (active block,
boundary layers, output module).  The mask helpers build boolean trees
from path predicates and select or merge subtrees by them, as the
reference's do: the masked optimizer, the sparse aggregation and the
memory model use them.
"""
from __future__ import annotations

from typing import Any, Callable, List


def path_str(path) -> str:
    """A key path (dict keys and list indices, in order) -> its
    ``'a/b/0/c'`` string."""
    return "/".join(str(k) for k in path)


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


def mask_from_predicate(tree, pred: Callable[[str], bool]):
    """Boolean tree: True where ``pred(path)``."""
    return map_with_path(lambda p, x: bool(pred(p)), tree)


def select(tree, mask, fill=None):
    """Leaves where ``mask`` is False replaced by ``fill`` (``None``: the
    leaf drops out of the tree)."""
    return tree_map(lambda x, m: x if m else fill, tree, mask)


def merge(base, update, mask):
    """``update`` where ``mask`` is True, ``base`` elsewhere."""
    return tree_map(lambda b, u, m: u if m else b, base, update, mask)


def where_mask(base, update, mask):
    """``merge`` by another name, as in the reference (whole leaves)."""
    return merge(base, update, mask)


def count_leaves(tree, mask=None) -> int:
    if mask is None:
        return len(tree_leaves(tree))
    return sum(1 for f in tree_leaves(mask) if f)


def leaf_nbytes(leaf) -> int:
    """Bytes of a tensor, numpy array or ``ParamDef`` leaf."""
    if hasattr(leaf, "element_size"):
        return leaf.numel() * leaf.element_size()
    if hasattr(leaf, "nbytes"):
        return int(leaf.nbytes)
    n = 1
    for d in leaf.shape:
        n *= d
    return n * leaf.dtype.itemsize


def masked_nbytes(tree, mask) -> int:
    return sum(leaf_nbytes(leaf) for leaf, m in zip(
        tree_leaves(tree), tree_leaves(mask), strict=True) if m)
