"""Sharding policy: fit logical param specs onto a concrete mesh (port of
``repro.launch.sharding``).

A ``ParamDef``'s ``spec`` is written for the production mesh (a 16-way
model axis).  ``fit_spec`` adapts it to an actual mesh (anything with
``axis_names`` and a ``shape`` mapping axis -> size, such as
``launch.mesh.HostMesh``), by the reference's three rules:

  1. drop axis names the mesh doesn't have (e.g. "pod" on a single pod);
  2. drop an axis from a dim whose size it does not divide (or exceeds);
     of a tuple of axes, keep the first that divides;
  3. a dropped "model" axis leaves the leaf replicated over the model
     shards (no contraction-dim fallback, as in the reference).

A spec is a tuple, one entry per leading dim (a name, a tuple of names or
``None``), trailing ``None`` dims dropped: the reference's ``PartitionSpec``
as a tuple.

``tree_placements`` gives per leaf a ``Placement``: the dim sharded over
``"model"`` (or none); ``stacked_tree_placements`` the same under a
leading cohort axis, which splits over ``"data"``; ``shard`` / ``unshard``
cut a leaf to this rank's block and gather it back.  The port splits a
leaf's storage, not the compute that reads it: a rank gathers its
operands whole before a step (``federated.runtime.ShardedRuntime``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.common.tree import tree_leaves, tree_map

MODEL = "model"


def _names(entry) -> tuple:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def fit_spec(shape: tuple, spec: tuple, mesh) -> tuple:
    """The logical ``spec`` of a leaf of ``shape`` fitted to ``mesh``."""
    mesh_axes = set(mesh.axis_names)
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for dim, entry in enumerate(spec):
        names = tuple(n for n in _names(entry) if n in mesh_axes)
        if not names:
            out.append(None)
            continue
        size = math.prod(mesh.shape[n] for n in names)
        if shape[dim] % size == 0 and shape[dim] >= size:
            out.append(names if len(names) > 1 else names[0])
            continue
        # a partial subset (e.g. ("pod", "data") -> "data")
        for n in names:
            if shape[dim] % mesh.shape[n] == 0 and shape[dim] >= \
                    mesh.shape[n]:
                out.append(n)
                break
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def batch_spec(shape: tuple, mesh, policy: str = "tp") -> tuple:
    """Inputs/labels batch sharding: ``"tp"`` puts the batch over
    ("pod", "data"), ``"fsdp"`` over the largest dividing combination that
    includes "model"; ``()`` where no combination divides the batch."""
    if policy == "fsdp":
        candidates = [("pod", "data", "model"), ("data", "model"),
                      ("pod", "data"), ("data",)]
    else:
        candidates = [("pod", "data"), ("data",)]
    names = set(mesh.axis_names)
    for cand in candidates:
        axes = tuple(a for a in cand if a in names)
        if not axes:
            continue
        size = math.prod(mesh.shape[a] for a in axes)
        if shape and shape[0] % size == 0 and shape[0] >= size:
            return (axes if len(axes) > 1 else axes[0],)
    return ()


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf lives on a (data, model) mesh: ``model_dim``, the
    dim split over "model" (``None``: whole on every model rank), and for
    a leaf stacked on a leading cohort axis ``cohort_axis``, the mesh axis
    (or tuple of axes) that axis splits over (``None``: every cohort on
    every rank); ``cohort_dim`` is that axis's dim where it does not lead
    (a cache's batch behind its period axis).  A leaf object, not a
    subtree, so that trees of them keep every leaf."""
    model_dim: Optional[int]
    cohort_axis: Optional[str] = None
    cohort_dim: int = 0


def model_dim(fitted: tuple) -> Optional[int]:
    """The dim a fitted spec splits over "model", or ``None``."""
    for dim, entry in enumerate(fitted):
        if MODEL in _names(entry):
            return dim
    return None


def tree_placements(def_tree, mesh):
    """ParamDef tree -> ``Placement`` tree fitted to ``mesh`` (the
    counterpart of the reference's ``tree_shardings``)."""
    return tree_map(lambda d: Placement(model_dim(fit_spec(
        d.shape, d.spec, mesh))), def_tree)


def data_tree_placements(def_tree, mesh):
    """ParamDef tree -> ``Placement`` tree that also keeps the dim a
    leaf's fitted spec splits over the data axes ("pod" and "data"), in
    ``cohort_axis`` and ``cohort_dim``: a decode cache's batch, which each
    data rank holds its block of."""
    def fit(d):
        fitted = fit_spec(d.shape, d.spec, mesh)
        for dim, entry in enumerate(fitted):
            names = tuple(n for n in _names(entry) if n != MODEL)
            if names:
                return Placement(model_dim(fitted),
                                 names if len(names) > 1 else names[0], dim)
        return Placement(model_dim(fitted))
    return tree_map(fit, def_tree)


def stacked_tree_placements(def_tree, mesh, leading_axis: str = "data"):
    """ParamDef tree -> ``Placement`` tree for leaves stacked on a leading
    cohort axis (the counterpart of ``stacked_tree_shardings``): the
    cohort axis splits over ``leading_axis`` where the mesh has it with
    more than one rank, the param dims keep ``tree_placements``' dim,
    shifted past the cohort axis.  The caller pads the cohort axis to a
    multiple of the data size (``federated.runtime.pad_cohorts``)."""
    lead = (leading_axis if leading_axis in mesh.axis_names
            and mesh.shape[leading_axis] > 1 else None)

    def fit(d):
        dim = model_dim(fit_spec(d.shape, d.spec, mesh))
        return Placement(None if dim is None else dim + 1, lead)

    return tree_map(fit, def_tree)


def block(n: int, parts: int, index: int) -> Tuple[int, int]:
    """``[start, stop)`` of block ``index`` of ``n`` rows cut into
    ``parts`` equal contiguous blocks (``parts`` divides ``n``)."""
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} equal blocks")
    size = n // parts
    return index * size, (index + 1) * size


def axes_size(mesh, axes) -> int:
    """Ranks along ``axes`` (a name or a tuple of names)."""
    return math.prod(mesh.shape[a] for a in _names(axes))


def axes_index(mesh, axes) -> int:
    """This rank's place along ``axes``, the first name outermost."""
    index = 0
    for a in _names(axes):
        index = index * mesh.shape[a] + mesh.index(a)
    return index


def shard(x, dim: Optional[int], mesh, axis=MODEL):
    """This rank's block of ``x`` along ``dim`` over ``axis`` (a name or a
    tuple of names; ``x`` itself where ``dim`` is ``None``), a copy with
    storage of its own."""
    n = axes_size(mesh, axis)
    if dim is None or n == 1:
        return x
    start, stop = block(x.shape[dim], n, axes_index(mesh, axis))
    return x.narrow(dim, start, stop - start).clone()


def unshard(x, dim: Optional[int], mesh, axis: str = MODEL):
    """``shard``'s inverse: the whole leaf from every rank's block."""
    if dim is None or mesh.shape[axis] == 1:
        return x
    return mesh.all_gather(x, axis, dim)


def per_device_nbytes(tree, placements=None, mesh=None) -> int:
    """Bytes one rank holds for a tree of tensors held whole: a leaf that
    ``placements`` (a ``Placement`` tree) splits over "model" counts its
    local block, any other leaf whole, as the reference counts a sharded
    array's shard and a plain one whole.  Without ``placements`` every
    leaf counts as it is (a tree of shards: their own bytes)."""
    leaves = tree_leaves(tree)
    where = ([Placement(None)] * len(leaves) if placements is None
             else tree_leaves(placements))
    total = 0
    for leaf, p in zip(leaves, where, strict=True):
        n = leaf.numel() * leaf.element_size()
        if p.model_dim is not None and mesh is not None:
            n //= mesh.shape[MODEL]
        total += n
    return total
