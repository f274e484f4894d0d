"""Sharding annotations that degrade gracefully outside a mesh (port of
``repro.common.sharding``).

``shard(x, *axes)`` is the reference's in-model annotation, and the
identity outside a mesh as there.  Inside a mesh the reference constrains
``x`` to the logical axes fitted to the mesh; ``shard_spec(shape, axes,
mesh)`` gives that fitted spec on a mesh (a ``launch.mesh.HostMesh``, or
anything with ``axis_names`` and a ``shape`` mapping): the axes the mesh
has.  The port returns the tensor unchanged everywhere: it splits a
leaf's storage where a runtime asks for it (``launch/sharding.py``'s
``shard``, a different function), never the compute of an annotated
activation.

``filter_spec(spec, mesh)`` drops axis names the mesh lacks.
"""
from __future__ import annotations

import os
from typing import Optional


def shard_spec(shape, axes, mesh) -> tuple:
    """The spec ``shard`` fits ``axes`` to on ``mesh`` for a tensor of
    ``shape``: under ``REPRO_SHARDING_POLICY=fsdp`` the logical batch axes
    ("pod", "data") widen to include "model"; an axis name the mesh lacks
    is dropped, and of a tuple the longest prefix whose size divides the
    dim is kept.  One entry per dim, as the reference's PartitionSpec."""
    if os.environ.get("REPRO_SHARDING_POLICY") == "fsdp":
        axes = tuple(
            ("pod", "data", "model")
            if isinstance(a, (tuple, list)) and set(a) == {"pod", "data"}
            else a
            for a in axes)
    names = set(mesh.axis_names)

    def keep(dim_size, a):
        if a is None:
            return None
        cand = tuple(x for x in (a if isinstance(a, (tuple, list)) else (a,))
                     if x in names)
        while cand:
            size = 1
            for n in cand:
                size *= mesh.shape[n]
            if dim_size % size == 0 and dim_size >= size:
                return cand if len(cand) > 1 else cand[0]
            cand = cand[:-1]
        return None

    return tuple(keep(d, a) for d, a in zip(shape, axes))


def shard(x, *axes):
    """``x`` unchanged (see the module's note)."""
    return x


def filter_spec(spec: tuple, mesh) -> tuple:
    """Drop axis names not present in ``mesh`` from a spec."""
    names = set(mesh.axis_names)

    def keep(a) -> Optional[object]:
        if a is None:
            return None
        if isinstance(a, (tuple, list)):
            kept = tuple(x for x in a if x in names)
            # one name stands alone, as a PartitionSpec normalizes it
            return kept[0] if len(kept) == 1 else (kept or None)
        return a if a in names else None

    return tuple(keep(a) for a in spec)
