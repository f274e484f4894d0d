"""Roofline terms of a dry-run's per-rank program (port of
``repro.launch.roofline``), on an NVIDIA H100's constants
(``launch.mesh``):

    compute term    = FLOPs per rank / peak bf16 FLOP/s
    memory term     = HBM bytes per rank / HBM rate
    collective term = sum over the mesh axes of the collective bytes sent
                      over that axis / its link rate (NVLink inside a
                      host, the network across hosts: ``mesh.link_bw``)

The reference reads its FLOPs and bytes from XLA's ``cost_analysis`` and
its collectives from the partitioned HLO text: ``_shape_bytes``,
``_split_computations``, ``_trip_count`` and ``parse_collectives`` rebuild
how often a ``while`` body's collective runs from the loop's trip count.
The port has no HLO, so they have no counterpart here.  The dry-run runs
rank 0's program eagerly on fake tensors over a fake process group: every
loop trip runs, and ``analysis.collectives.record_collectives`` records
each collective as it is issued, so there is no multiplicity to rebuild.
``roofline_from_trace`` takes those records, with the dry-run's counted
FLOPs and bytes, in place of ``roofline_from_compiled``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.launch.mesh import (HBM_BW, NET_BW, PEAK_FLOPS_BF16,
                                     link_bw)

# the reference's collective kinds (HLO names) per torch.distributed call
KINDS = {"all_gather": "all-gather", "all_gather_into_tensor": "all-gather",
         "all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all": "all-to-all", "all_to_all_single": "all-to-all",
         "send": "collective-permute", "recv": "collective-permute"}
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    chips: int
    model_flops: float = 0.0       # 6·N_active·D global
    # collective bytes per rank by the mesh axes they cross, and the link
    # rate of each; empty: every byte at the network's rate
    collective_bytes_by_axis: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    link_bw_by_axis: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        if not self.collective_bytes_by_axis:
            return self.collective_bytes_per_chip / NET_BW
        return sum(b / self.link_bw_by_axis.get(ax, NET_BW)
                   for ax, b in self.collective_bytes_by_axis.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "collective_bytes_by_axis": dict(self.collective_bytes_by_axis),
            "link_bw_by_axis": dict(self.link_bw_by_axis),
        }


def collectives_summary(records) -> Dict[str, dict]:
    """Per-kind ``{count, bytes}`` of classified ``CollectiveRecord``s (the
    reference's dict: an all-gather's bytes are its result's, an
    all-reduce's its tensor's), ``total_bytes``, and ``by_axis``: the same
    per crossed-axes key (``"model"``, ``"pod,data"``; ``"intra"`` for a
    group of one rank) with that group's ``link_bw``."""
    out = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
    by_axis: Dict[str, dict] = {}
    for r in records:
        kind = KINDS.get(r.kind, r.kind)
        axis = ",".join(r.crossed_axes) or "intra"
        for slot in (out.setdefault(kind, {"count": 0, "bytes": 0}),
                     by_axis.setdefault(axis, {"link_bw": link_bw(r.ranks)})
                     .setdefault(kind, {"count": 0, "bytes": 0})):
            slot["count"] += 1
            slot["bytes"] += r.result_nbytes
    out["total_bytes"] = sum(v["bytes"] for k, v in out.items()
                             if isinstance(v, dict))
    out["by_axis"] = by_axis
    return out


def roofline_from_trace(trace, chips: int, model_flops: float = 0.0):
    """(Roofline, collectives dict) of a dry-run trace: ``trace.flops`` and
    ``trace.hbm_bytes`` counted per rank, ``trace.collectives`` the
    classified records of rank 0's collectives."""
    coll = collectives_summary(trace.collectives)
    by_axis = {ax: float(sum(v["bytes"] for k, v in kinds.items()
                             if k != "link_bw"))
               for ax, kinds in coll["by_axis"].items() if ax != "intra"}
    rates = {ax: coll["by_axis"][ax]["link_bw"] for ax in by_axis}
    return Roofline(flops_per_chip=float(trace.flops),
                    hbm_bytes_per_chip=float(trace.hbm_bytes),
                    collective_bytes_per_chip=float(sum(by_axis.values())),
                    chips=chips, model_flops=model_flops,
                    collective_bytes_by_axis=by_axis,
                    link_bw_by_axis=rates), coll
