"""Collective audit: record every ``torch.distributed`` collective a round
issues and classify it by the mesh axes it crosses (port of
``repro.analysis.collectives``).

The reference walks compiled HLO for its collectives; a torch round issues
them from Python, so ``record_collectives`` patches ``torch.distributed``'s
``all_reduce``, ``all_gather``, ``all_gather_into_tensor``,
``reduce_scatter``, ``reduce_scatter_tensor``, ``all_to_all``,
``all_to_all_single``, ``broadcast``, ``send``, ``recv`` and ``barrier``
and records each call: its kind, its group's ranks, its bytes, the port's
frame that issued it and the phase of the round it came from (the
innermost runtime method on the stack: local training, the Eq. 1 seam, or
the rank-consensus gather).  A group crosses a mesh axis where two of its
ranks differ in that axis's coordinate (``crossed_axes``, over
``HostMesh``'s ``(data, model)`` grid).  The reference's rules
(``audit_collectives``):

  * nothing but all-reduce crosses "data" (``collectives.data-axis-gather``);
  * nothing crosses "data" in local training
    (``collectives.local-data-crossing``);
  * what the Eq. 1 seam sends over "data" is all-reduce only
    (``collectives.seam-non-allreduce``);
  * a round makes between 1 and ``n_agg_leaves + 2`` data-axis
    all-reduces (``collectives.eq1-allreduce-count``).

Model-axis all-gathers (``launch.sharding.unshard``: a step gathers its
model-sharded operands whole, and the port's seam returns the aggregate
whole, where the reference's GSPMD program keeps it sharded) stay inside a
model group and are legal anywhere.

The port has two collectives the reference lacks.  The (C_pad,) loss
vector is one more data-axis all-reduce, inside the ``+ 2``.  The
rank-consensus digest (``ShardedRuntime._check_same_round``) is an
all-gather over the whole world of 32 host bytes, through
``HostMesh.gather_host``, once a round before the first collective: every
rank compares every rank's cohorts, weights and step mask with rank 0's,
so that a rank whose host state drifted makes every rank refuse the round
instead of averaging the wrong clients (a broadcast would tell only the
drifted rank, and the others would wait in the round's all-reduce).  It
crosses "data" and is not an all-reduce, so it is counted under a check
of its own, ``collectives.host-consensus``, at most one a round; it is
known by the seam that issues it (``gather_host``), not by its file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import traceback
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.hostsync import port_frame

COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
               "all_to_all_single", "broadcast", "send", "recv", "barrier")
ALL_REDUCE = "all_reduce"

# The runtime methods that open each phase of a round (innermost wins).
PHASES = {"gather_host": "consensus",
          "_eq1_seam": "aggregation", "_exchange_deltas": "aggregation",
          "_train_cohorts": "local", "_train_sharded": "local"}


@dataclasses.dataclass
class CollectiveRecord:
    kind: str
    ranks: Tuple[int, ...]          # the group's global ranks
    nbytes: int
    location: str                   # the port's file:line
    phase: str                      # local | aggregation | consensus | other
    crossed_axes: Tuple[str, ...] = ()
    result_nbytes: int = 0          # its first argument's: the output list
                                    # or the tensor reduced in place

    def where(self) -> str:
        return f"{self.kind} over ranks {list(self.ranks)} ({self.location})"


def _nbytes(args, kwargs) -> int:
    total = 0
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        elif isinstance(a, (list, tuple)):
            total += sum(t.numel() * t.element_size() for t in a
                         if isinstance(t, torch.Tensor))
    return total


def _phase(stack) -> str:
    for frame in reversed(stack):
        if frame.name in PHASES:
            return PHASES[frame.name]
    return "other"


@contextlib.contextmanager
def record_collectives():
    """Patch ``torch.distributed``'s collectives; yields the list of
    ``CollectiveRecord`` of every call in the window.  Restored on exit."""
    records: List[CollectiveRecord] = []
    saved = {}

    def wrap(name, fn):
        def wrapped(*args, **kwargs):
            group = kwargs.get("group")
            if group is None and name not in ("send", "recv", "barrier"):
                group = next((a for a in args
                              if isinstance(a, dist.ProcessGroup)), None)
            ranks = tuple(dist.get_process_group_ranks(group)
                          if group is not None
                          else range(dist.get_world_size()))
            stack = traceback.extract_stack()[:-1]
            records.append(CollectiveRecord(
                kind=name, ranks=ranks, nbytes=_nbytes(args, kwargs),
                location=port_frame(stack), phase=_phase(stack),
                result_nbytes=_nbytes(args[:1], {})))
            return fn(*args, **kwargs)
        return wrapped

    for name in COLLECTIVES:
        if hasattr(dist, name):
            saved[name] = getattr(dist, name)
            setattr(dist, name, wrap(name, saved[name]))
    try:
        yield records
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def mesh_coords(mesh) -> Dict[int, dict]:
    """global rank -> {axis: coordinate} of a ``HostMesh``."""
    grid = np.asarray(mesh.device_mesh.mesh)
    names = list(mesh.axis_names)
    return {int(grid[idx]): dict(zip(names, idx))
            for idx in np.ndindex(*grid.shape)}


def crossed_axes(ranks: Sequence[int], coords: Dict[int, dict],
                 axis_names: Sequence[str]) -> Tuple[str, ...]:
    """The mesh axes along which the group's ranks differ."""
    return tuple(ax for ax in axis_names
                 if len({coords[r][ax] for r in ranks if r in coords}) > 1)


def classify(records: List[CollectiveRecord], coords: Dict[int, dict],
             axis_names: Sequence[str]) -> List[CollectiveRecord]:
    for r in records:
        r.crossed_axes = crossed_axes(r.ranks, coords, axis_names)
    return records


def audit_collectives(records: List[CollectiveRecord], report, *,
                      program: str, coords: Dict[int, dict],
                      axis_names: Sequence[str] = ("data", "model"),
                      data_axis: str = "data", kind: str = "round",
                      n_agg_leaves: int = 0, rounds: int = 1) -> dict:
    """The reference's rules over one program's (``kind``) or ``rounds``
    whole rounds' records.  A ``local`` program's records are all local
    training.  Returns a summary: counts by kind and crossed axes, the
    data-axis all-reduces a round, the consensus gathers a round, the
    bytes."""
    classify(records, coords, axis_names)
    data_size = len({c[data_axis] for c in coords.values()})
    summary = {"program": program, "n_collectives": len(records),
               "by_kind": {}, "bytes": sum(r.nbytes for r in records)}
    for r in records:
        key = f"{r.kind}[{','.join(r.crossed_axes) or 'intra'}]"
        summary["by_kind"][key] = summary["by_kind"].get(key, 0) + 1
    consensus = [r for r in records if r.phase == "consensus"]
    data_ops = [r for r in records
                if data_axis in r.crossed_axes and r.phase != "consensus"]
    for r in data_ops:
        phase = "local" if kind == "local" else r.phase
        if r.kind != ALL_REDUCE:
            report.add(
                "collectives.data-axis-gather",
                f"{r.kind} crosses the '{data_axis}' axis: cohort-sharded "
                f"values must only ever combine through the Eq. 1 "
                f"all-reduce; a {r.kind} here materializes per-cohort "
                f"locals on every data rank.", program=program,
                location=r.where())
            if phase == "aggregation":
                report.add(
                    "collectives.seam-non-allreduce",
                    f"the Eq. 1 seam sent a {r.kind} over '{data_axis}': "
                    f"the seam must be pure all-reduce.", program=program,
                    location=r.where())
        if phase == "local":
            report.add(
                "collectives.local-data-crossing",
                f"{r.kind} crosses the '{data_axis}' axis in local "
                f"training: local training must have no cross-cohort "
                f"communication (Alg. 1 lines 5-9); only the aggregation "
                f"seam may reduce over cohorts.", program=program,
                location=r.where())
    n = sum(r.kind == ALL_REDUCE for r in data_ops)
    summary["data_axis_all_reduces"] = n / max(rounds, 1)
    summary["consensus_gathers"] = len(consensus) / max(rounds, 1)
    if len(consensus) > rounds:
        report.add(
            "collectives.host-consensus",
            f"{len(consensus)} rank-consensus gathers in {rounds} round(s) "
            f"(at most one a round): "
            f"{[r.location for r in consensus]}", program=program)
    if kind in ("round", "aggregation") and data_size > 1 and n_agg_leaves:
        lo, hi = 1, n_agg_leaves + 2
        if not lo * rounds <= n <= hi * rounds:
            report.add(
                "collectives.eq1-allreduce-count",
                f"expected between {lo} and {hi} data-axis all-reduces a "
                f"round (one per aggregated leaf [{n_agg_leaves}] plus the "
                f"loss vector and the normalizer), found {n} in {rounds} "
                f"round(s). Fewer than 1 means the aggregation no longer "
                f"reduces over '{data_axis}'; more means a redundant "
                f"reduction crept in.", program=program,
                location=data_ops[0].where() if data_ops else None)
    return summary
