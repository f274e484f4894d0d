"""Params across the reference/port boundary, through numpy.

The reference keeps conv weights HWIO, (k, k, Cin, Cout); the port keeps
them OIHW, (Cout, Cin, k, k), as ``torch.nn.functional.conv2d`` takes them.
A leaf is such a weight by its place in the tree, not by its rank: it is
the ``"w"`` of a CNN conv (a dict under one of ``CONV_KEYS``: the stem's,
the surrogates' and VGG's ``"conv"``, a residual block's ``"conv1"``,
``"conv2"`` and ``"proj"``, a fire module's ``"squeeze"``, ``"e1"`` and
``"e3"``).  Every other leaf crosses unchanged, the transformer's stacked
4-D attention weights (``wq`` (L, d, H, Dh), ``wo`` (L, H, Dh, d))
included, as are MoE expert stacks (L, E, d, ff), MLA's (L, r, H, e)
and Mamba's ``conv_w`` (a plain leaf, not a conv's ``"w"``).  Both
directions copy values exactly.  ``from_reference`` takes a bfloat16
leaf of the reference (a numpy array of the ``bfloat16`` extension dtype)
by its bits (``reference_layout`` gives it back as a bfloat16 tensor), and
the float32 leaves of a bfloat16 model (Mamba's ``A_log``, ``D`` and
``dt_bias``, the MoE router) stay float32.  A stacked tree (the
async buffer's deltas: an entry axis in front of each leaf) crosses with
``lead=1``: a conv weight's last four axes are permuted, its leading ones
kept.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_map

# keys of the CNN's conv param dicts (``models/cnn.py``: stem, surrogate
# and VGG "conv", residual "conv1"/"conv2", 1x1 shortcut "proj", fire
# module "squeeze"/"e1"/"e3")
CONV_KEYS = ("conv", "conv1", "conv2", "proj", "squeeze", "e1", "e3")


def _map_with_conv(fn, tree, in_conv: bool = False):
    """``fn(leaf, is_conv_weight)`` over a dict/list tree, sorted keys."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: (fn(tree[k], True) if in_conv and k == "w"
                    else _map_with_conv(fn, tree[k], k in CONV_KEYS))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_conv(fn, t) for t in tree)
    return fn(tree, False)


def _perm(lead: int, to_port: bool):
    """The permutation of a conv weight under ``lead`` leading axes: HWIO
    -> OIHW (``to_port``) or back."""
    tail = (3, 2, 0, 1) if to_port else (2, 3, 1, 0)
    return (*range(lead), *(lead + a for a in tail))


def _from_numpy(a) -> torch.Tensor:
    """A copy of ``a`` as a tensor; a bfloat16 array (numpy's extension
    dtype, which torch does not take) through its raw 16 bits."""
    a = np.array(np.asarray(a), copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_reference(np_tree, device: DeviceLike = None, lead: int = 0):
    """A reference param tree (numpy arrays, anything ``np.asarray`` takes,
    or tensors in the reference's layout, such as ``load_checkpoint``
    gives) -> the port's tensors on ``device``; ``lead`` leading axes
    (such as a stack of entries) in front of every leaf."""
    dev = resolve_device(device)

    def leaf(a, conv):
        t = a.detach().clone() if torch.is_tensor(a) else _from_numpy(a)
        if conv:
            t = t.permute(_perm(lead, True)).contiguous()
        return t.to(dev)

    return _map_with_conv(leaf, np_tree)


def reference_permuted(tree, lead: int = 0):
    """The port's tree as views in the reference's layout, on their own
    device (meta tensors too)."""
    return _map_with_conv(
        lambda t, conv: t.permute(_perm(lead, False)) if conv else t, tree)


def reference_layout(tree, lead: int = 0):
    """The port's param tree -> CPU tensors in the reference's layout, of
    any dtype (bf16 too, which numpy cannot hold)."""
    return tree_map(lambda t: t.detach().cpu().contiguous(),
                    reference_permuted(tree, lead))


def to_reference(tree, lead: int = 0):
    """The port's param tree -> numpy arrays in the reference's layout."""
    return tree_map(lambda t: t.numpy().copy(), reference_layout(tree, lead))
