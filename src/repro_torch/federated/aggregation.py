"""Server-side aggregation, paper Eq. 1 (port of
``repro.federated.aggregation``).

Weighted FedAvg over the trainable subtree, one weighted sum per leaf over
a stacked client axis.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.common.tree import tree_leaves, tree_map


def stacked_weighted_average(tree, weights: Sequence[float]):
    """Eq. 1 over leaves with a leading (C,) client axis.  ``weights`` (true
    sample counts) are normalized to sum to one; a zero or non-finite sum
    raises."""
    w = np.asarray(weights, np.float64)
    total = w.sum()
    if not np.isfinite(total) or total <= 0:
        raise ValueError(
            f"aggregation needs a positive finite weight sum; "
            f"got sum({np.asarray(weights).tolist()}) = {total}")
    w = w / total
    w32 = torch.from_numpy(w.astype(np.float32))

    def avg(leaf):
        wd = w32.to(leaf.device)
        return torch.einsum("c...,c->...", leaf.float(), wd).to(leaf.dtype)

    return tree_map(avg, tree)


def weighted_average(trees: Sequence, weights: Sequence[float]):
    """FedAvg over a list of per-client trees (stack, then one sum)."""
    return stacked_weighted_average(
        tree_map(lambda *leaves: torch.stack(leaves), *trees), weights)


def tree_bytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(tree))
