"""Parameter-definition trees (port of ``repro.common.paramdef``).

A ``ParamDef`` describes one parameter leaf: shape, dtype and initializer.
Model builders return trees of them, from which ``init_params`` makes the
tensors and ``nbytes`` / ``nparams`` count without allocating.  The memory
model, and through it the fleet's feasibility draw, depends on ``nbytes``,
which gives the reference's byte counts exactly.

The port has its own init: a ``torch.Generator`` seeded by the caller.  It
does not reproduce ``jax.random``; parity tests start both sides from the
same params through ``repro_torch.bridge``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    dtype: torch.dtype = torch.float32
    init: str = "normal"          # normal | zeros | ones
    scale: Optional[float] = None  # stddev override (default fan-in)


def nbytes(tree) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize
               for d in tree_leaves(tree))


def nparams(tree) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(tree))


def _init_leaf(gen: torch.Generator, d: ParamDef) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype)
    if d.scale is not None:
        scale = d.scale
    else:
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(d.shape, generator=gen) * scale).to(d.dtype)


def init_params(seed: int, tree, device: DeviceLike = None):
    """Materialize a ParamDef tree on ``device``, drawing every leaf from one
    CPU generator seeded with ``seed`` (the same values on any device)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    return tree_map(lambda d: _init_leaf(gen, d).to(dev), tree)
