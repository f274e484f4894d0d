"""Params across the reference/port boundary, through numpy.

The reference keeps conv weights HWIO, (k, k, Cin, Cout); the port keeps
them OIHW, (Cout, Cin, k, k), as ``torch.nn.functional.conv2d`` takes them.
A leaf is such a weight by its place in the tree, not by its rank: it is
the ``"w"`` of a CNN conv (a dict under one of ``CONV_KEYS``).  Every other
leaf crosses unchanged, the transformer's stacked 4-D attention weights
(``wq`` (L, d, H, Dh), ``wo`` (L, H, Dh, d)) included.  Both directions
copy values exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device

# keys of the CNN's conv param dicts (``models/cnn.py``: stem and surrogate
# "conv", residual "conv1"/"conv2", 1x1 shortcut "proj")
CONV_KEYS = ("conv", "conv1", "conv2", "proj")


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


def from_reference(np_tree, device: DeviceLike = None):
    """A reference param tree (numpy arrays, or anything ``np.asarray``
    takes) -> the port's tensors on ``device``."""
    dev = resolve_device(device)

    def leaf(a, conv):
        t = torch.from_numpy(np.array(np.asarray(a), copy=True))
        if conv:
            t = t.permute(3, 2, 0, 1).contiguous()
        return t.to(dev)

    return _map_with_conv(leaf, np_tree)


def to_reference(tree):
    """The port's param tree -> numpy arrays in the reference's layout."""
    def leaf(t, conv):
        t = t.detach()
        if conv:
            t = t.permute(2, 3, 1, 0)
        return t.cpu().contiguous().numpy().copy()

    return _map_with_conv(leaf, tree)
