"""State-release audit: a program must not leave its threaded state held
twice (the port's counterpart of ``repro.analysis.donation``).

The reference donates the threaded state of its programs (the optimizer
state of a step, the trainable tree of a round) and checks in the compiled
executable that each donated buffer aliases an output: a dropped donation
doubles the live bytes of that state.  Torch has no donation; what it
protects is that the old state is gone once the program has returned.  So
``audit_donation`` runs each spec once on a fresh copy of each argument in
``alias_argnums``, drops the caller's references and collects, and then
requires every input leaf of that state to be freed (its weak reference
dead) or its storage reused in place by an output.  A leaf still alive is
``donation.must-alias``, with the objects that hold it.  The prox term's
``global_ref`` is held by design and is not in ``alias_argnums``, as in
the reference.
"""
from __future__ import annotations

import contextlib
import gc
import types
import weakref
from typing import List

import torch

from repro_torch.common.tree import flatten_paths, tree_leaves, tree_map


def _holders(obj, skip, depth: int = 4) -> List[str]:
    """What holds ``obj``: up through the dicts, lists and tuples that
    refer to it (``depth`` levels) to their owners."""
    names, level, seen = [], [(obj, "")], set(skip)
    for _ in range(depth):
        up = []
        for o, via in level:
            for ref in gc.get_referrers(o):
                if id(ref) in seen or isinstance(ref, types.FrameType):
                    continue
                seen.add(id(ref))
                if isinstance(ref, (dict, list, tuple)):
                    up.append((ref, f"a {type(ref).__name__} in " + via
                               if via else f"a {type(ref).__name__}"))
                else:
                    names.append(f"{_describe(ref)}" + (f" ({via})"
                                                       if via else ""))
        level = up
        if names or not level:
            break
    modules = [n for n in names if n.startswith("module ")]
    return (modules or names)[:4] or ["a reference from outside Python"]


def _describe(obj) -> str:
    if isinstance(obj, types.ModuleType):
        return f"module {obj.__name__}"
    if isinstance(obj, types.FunctionType):
        return f"function {obj.__qualname__}"
    if isinstance(obj, types.CellType):
        return "a closure cell"
    return type(obj).__qualname__


def _weak_leaves(args, argnums):
    """(argnum, path, weak reference, data pointer) of every tensor leaf
    of the ``argnums`` arguments (no strong reference kept)."""
    return [(i, path, weakref.ref(leaf), leaf.data_ptr())
            for i in argnums
            for path, leaf in flatten_paths(args[i]).items()
            if isinstance(leaf, torch.Tensor)]


def audit_donation(spec, report, within=None) -> dict:
    """Run ``spec`` once on fresh copies of its ``alias_argnums`` (inside
    the context manager ``within``, such as the purity pass's dispatch
    mode, so that one run serves both) and check that none of their input
    leaves outlives the call."""
    if not spec.alias_argnums:
        return {}
    args = list(spec.args)
    for i in spec.alias_argnums:
        args[i] = tree_map(lambda x: x.detach().clone()
                           if isinstance(x, torch.Tensor) else x, args[i])
    refs = _weak_leaves(args, spec.alias_argnums)
    try:
        with within if within is not None else contextlib.nullcontext():
            out = spec.fn(*args)
    except Exception as e:
        report.add("donation.run-failure",
                   f"program failed to run: {type(e).__name__}: {e}",
                   program=spec.name)
        return {}
    del args
    reused = {t.data_ptr() for t in tree_leaves(out)
              if isinstance(t, torch.Tensor)}
    alive = [r for r in refs if r[2]() is not None and r[3] not in reused]
    if alive:            # freed by reference counting, unless in a cycle
        gc.collect()
    held = []
    for i, path, ref, _ in alive:
        leaf = ref()
        if leaf is None:
            continue
        held.append((i, path, _holders(leaf, {id(refs), id(alive),
                                              id(held)})))
        del leaf
    del out
    for i, path, holders in held[:8]:
        report.add(
            "donation.must-alias",
            f"argument {i} leaf '{path}' is still alive after the program "
            f"returned and its caller dropped it: the program holds its "
            f"threaded state twice (held by {'; '.join(holders)}).",
            program=spec.name)
    return {"program": spec.name, "alias_argnums": list(spec.alias_argnums),
            "leaves": len(refs), "held": len(held)}
