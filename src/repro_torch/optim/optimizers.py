"""Functional SGD with momentum (port of ``repro.optim.optimizers.sgd``).

The paper trains clients with SGD (weight decay 5e-4).  L2 is added to the
gradient before momentum, the momentum is kept in float32, and state exists
only for the trainable subtree NeuLite hands it (fresh for each client).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]      # (grads, state, params) -> (updates, state)


def sgd(lr, momentum: float = 0.9, weight_decay: float = 5e-4) -> Optimizer:
    """lr: float or schedule fn(step) -> float, ``step`` a 0-d int32
    tensor (the update's count, from 1)."""
    sched = lr if callable(lr) else (lambda _: lr)

    def init(params):
        mu = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params) if momentum else None)
        # a device counter, as the reference's: a captured step (CUDA graph)
        # counts on the card, and a vmapped one per cohort
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return {"mu": mu, "step": step}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)

        def decayed(g, p):
            return g.float() + weight_decay * p.float()

        # one leaf at a time, so that no tree of decayed gradients is held
        # beside the momentum (a stack of cohorts' trees is GBs)
        if momentum:
            mu = tree_map(lambda m, g, p: momentum * m + decayed(g, p),
                          state["mu"], grads, params)
            g = mu
        else:
            mu, g = None, tree_map(decayed, grads, params)
        updates = tree_map(lambda g, p: (-lr_t * g).to(p.dtype), g, params)
        return updates, {"mu": mu, "step": step}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
