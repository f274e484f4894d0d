"""Functional optimizers, SGD with momentum and AdamW (port of
``repro.optim.optimizers``).

The paper trains clients with SGD (weight decay 5e-4); the LLM launch
defaults to AdamW.  State is kept in float32 and exists only for the
trainable subtree NeuLite hands it (fresh for each client).  The update
counter ``step`` is a 0-d int32 tensor on the params' device, as the
reference's, so that a captured step (CUDA graph) counts on the card and
a vmapped one per cohort; schedules and the bias correction read it
there.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.common.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]      # (grads, state, params) -> (updates, state)


def _tree_zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _step0(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd(lr, momentum: float = 0.9, weight_decay: float = 5e-4,
        nesterov: bool = False) -> Optimizer:
    """lr: float or schedule fn(step) -> float, ``step`` a 0-d int32
    tensor (the update's count, from 1)."""
    sched = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"mu": _tree_zeros(params) if momentum else None,
                "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)

        def decayed(g, p):
            return g.float() + weight_decay * p.float()

        # one leaf at a time, so that no tree of decayed gradients is held
        # beside the momentum (a stack of cohorts' trees is GBs)
        if not momentum:
            mu, g = None, tree_map(decayed, grads, params)
        elif nesterov:
            mu = tree_map(lambda m, g, p: momentum * m + decayed(g, p),
                          state["mu"], grads, params)
            g = tree_map(lambda m, g, p: momentum * m + decayed(g, p),
                         mu, grads, params)
        else:
            mu = tree_map(lambda m, g, p: momentum * m + decayed(g, p),
                          state["mu"], grads, params)
            g = mu
        updates = tree_map(lambda g, p: (-lr_t * g).to(p.dtype), g, params)
        return updates, {"mu": mu, "step": step}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """AdamW with decoupled weight decay on every leaf; m and v in
    float32, the bias correction from the device counter."""
    sched = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"m": _tree_zeros(params), "v": _tree_zeros(params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        s = step.float()
        bc1 = 1 - b1 ** s
        bc2 = 1 - b2 ** s
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                     state["v"], grads)

        def upd(m, v, p):
            du = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
                + weight_decay * p.float()
            return (-lr_t * du).to(p.dtype)

        updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "step": step}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled by min(1, max_norm / (‖grads‖ + 1e-9)), the norm
    over every leaf in float32.  Returns (grads, the norm)."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in leaves))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gnorm
