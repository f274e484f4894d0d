"""Parameter-definition trees (port of ``repro.common.paramdef``).

A ``ParamDef`` describes one parameter leaf: shape, dtype, its logical
sharding spec and initializer.  Model builders return trees of them, from
which ``init_params`` makes the tensors and ``nbytes`` / ``nparams`` count
without allocating.  ``spec`` names, per dim, the mesh axis that dim may
split over (``"model"``) or ``None``, as the reference's ``PartitionSpec``
does; ``launch.sharding.fit_spec`` fits it to a concrete mesh.  A conv
weight is OIHW here and HWIO in the reference, so its ``"model"`` sits on
axis 0 where the reference's sits on axis 3.  The memory
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
    spec: tuple = ()              # logical mesh axis per dim (trailing None
                                  # dims dropped), as the reference's
    init: str = "normal"          # normal | zeros | ones | embed
    scale: Optional[float] = None  # stddev override (default fan-in)

    def with_prefix(self, n: int) -> "ParamDef":
        """Prepend a stacked layer axis of size ``n`` (unsharded)."""
        return dataclasses.replace(self, shape=(n, *self.shape),
                                   spec=(None, *self.spec) if self.spec
                                   else ())

    def __getitem__(self, idx) -> "ParamDef":
        """Slice the leading (stacked) axis, as ``tensor[s:e]`` does, so
        ParamDef trees go through the same ``split_stage`` as params."""
        if isinstance(idx, slice):
            n = len(range(*idx.indices(self.shape[0])))
            return dataclasses.replace(self, shape=(n, *self.shape[1:]))
        raise TypeError("ParamDef only supports slice indexing")


def stack_defs(tree, n: int):
    """Stack every ParamDef in ``tree`` over a new leading axis of size
    ``n``."""
    return tree_map(lambda d: d.with_prefix(n), tree)


def shape_tree(tree):
    """ParamDef tree -> tree of ``meta`` tensors of the same shapes and
    dtypes (the reference's ``ShapeDtypeStruct`` tree; nothing is
    allocated)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), tree)


def spec_tree(tree):
    """ParamDef tree -> tree of the leaves' logical specs (tuples)."""
    return tree_map(lambda d: d.spec, tree)


def nbytes(tree) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize
               for d in tree_leaves(tree))


def nparams(tree) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(tree))


def _init_leaf(gen: torch.Generator, d: ParamDef) -> torch.Tensor:
    """One leaf, drawn on ``gen``'s device."""
    dev = gen.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=dev)
    if d.init == "embed":
        scale = d.scale if d.scale is not None else 0.02
    elif d.scale is not None:
        scale = d.scale
    else:
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(d.shape, generator=gen, device=dev)
            * scale).to(d.dtype)


def init_params(seed: int, tree, device: DeviceLike = None, *,
                draw_on_device: bool = False):
    """Materialize a ParamDef tree on ``device``, drawing every leaf from one
    CPU generator seeded with ``seed`` (the same values on any device).
    ``draw_on_device`` draws from a generator on ``device`` instead:
    seconds less per billion params on a card, other values than the CPU
    generator's (still the same for the same seed and device)."""
    dev = resolve_device(device)
    gen = torch.Generator(dev if draw_on_device else "cpu")
    gen.manual_seed(int(seed))
    return tree_map(lambda d: _init_leaf(gen, d).to(dev), tree)
