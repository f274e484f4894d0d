"""Server-side aggregation, paper Eq. 1 (port of
``repro.federated.aggregation``).

Weighted FedAvg over the trainable subtree, one weighted sum per leaf over
a stacked client axis.  The buffered-async runtime folds FedBuff staleness
discounts (``staleness_discount``) into the same sum.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.common.device import to_device
from repro_torch.common.tree import tree_leaves, tree_map

STALENESS_SCHEDULES = ("constant", "polynomial")


def staleness_discount(staleness, schedule: str = "polynomial",
                       alpha: float = 0.5) -> np.ndarray:
    """FedBuff staleness discount d(s) per delta: ``constant`` d(s) = 1,
    ``polynomial`` d(s) = (1 + s)^-alpha.  ``staleness`` counts server
    updates between a client's pull and its delta's aggregation."""
    s = np.asarray(staleness, np.float64)
    if s.size and s.min() < 0:
        raise ValueError(f"staleness must be >= 0; got min {s.min()}")
    if schedule == "constant":
        return np.ones_like(s)
    if schedule == "polynomial":
        return (1.0 + s) ** (-float(alpha))
    raise ValueError(f"unknown staleness schedule {schedule!r}; "
                     f"choose from {STALENESS_SCHEDULES}")


def stacked_weighted_average(tree, weights: Sequence[float],
                             discounts: Optional[Sequence[float]] = None):
    """Eq. 1 over leaves with a leading (C,) client axis.  ``weights`` (true
    sample counts) are normalized to sum to one; a zero or non-finite sum
    raises.  Optional per-client ``discounts`` (staleness) multiply the
    normalized weights without renormalizing them."""
    w = np.asarray(weights, np.float64)
    total = w.sum()
    if not np.isfinite(total) or total <= 0:
        raise ValueError(
            f"aggregation needs a positive finite weight sum; "
            f"got sum({np.asarray(weights).tolist()}) = {total}")
    w = w / total
    if discounts is not None:
        w = w * np.asarray(discounts, np.float64)
    w32 = w.astype(np.float32)
    on = {}                 # the weights on each leaf's device, copied once

    def avg(leaf):
        if leaf.device not in on:
            on[leaf.device] = to_device(w32, leaf.device)
        return torch.einsum("c...,c->...", leaf.float(),
                            on[leaf.device]).to(leaf.dtype)

    return tree_map(avg, tree)


def buffered_flush_average(stacked_deltas, weights: Sequence[float],
                           staleness: Sequence[int], *,
                           schedule: str = "polynomial",
                           alpha: float = 0.5):
    """One buffered-async flush: Eq. 1 over a delta buffer whose entries
    each carry their own staleness.  Returns ``(update, discounts)``, the
    discounts being those folded into the update."""
    d = staleness_discount(staleness, schedule, alpha)
    w = list(weights)
    if len(d) != len(w):
        raise ValueError(f"{len(w)} weights for "
                         f"{len(d)} staleness entries")
    return stacked_weighted_average(stacked_deltas, w, discounts=d), d


def weighted_average(trees: Sequence, weights: Sequence[float]):
    """FedAvg over a list of per-client trees (stack, then one sum)."""
    return stacked_weighted_average(
        tree_map(lambda *leaves: torch.stack(leaves), *trees), weights)


def tree_bytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(tree))


def delta(new, old):
    return tree_map(lambda a, b: a - b, new, old)


def add(base, update, scale: float = 1.0):
    return tree_map(lambda b, u: b + scale * u.to(b.dtype), base, update)
