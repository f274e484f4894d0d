"""Params across the reference/port boundary, through numpy.

The reference keeps conv weights HWIO, (k, k, Cin, Cout); the port keeps
them OIHW, (Cout, Cin, k, k), as ``torch.nn.functional.conv2d`` takes them.
Every 4-D leaf is such a weight.  Other leaves (linear weights stay
(cin, cout), norms, biases) cross unchanged.  Both directions copy values
exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_map


def from_reference(np_tree, device: DeviceLike = None):
    """A reference param tree (numpy arrays, or anything ``np.asarray``
    takes) -> the port's tensors on ``device``."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        t = torch.from_numpy(np.array(a, copy=True))
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        return t.to(dev)

    return tree_map(leaf, np_tree)


def to_reference(tree):
    """The port's param tree -> numpy arrays in the reference's layout."""
    def leaf(t):
        t = t.detach()
        if t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        return t.cpu().contiguous().numpy().copy()

    return tree_map(leaf, tree)
