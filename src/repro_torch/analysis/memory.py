"""Measured peak memory of one client's local training, and the gate of
the paper's block-wise memory claim (port of the stage-vs-full gate of
``repro.analysis.memory.audit_memory``).

The claim (the paper's Fig. 6: up to 50.4% less peak memory): every
NeuLite stage's local training peaks below full-model (FedAvg) training of
the same model on the same batches.  The reference checks it statically,
from XLA's ``memory_analysis()`` of each stage's program and of the
full-model program.  Eager PyTorch has no static peak, so the port
measures one: the CUDA caching allocator's ``max_memory_allocated`` over a
client's local training, from a resident set that mirrors the runtime's.
A stage holds the whole NeuLite tree (model, surrogates, projectors), as
the server does; the full step holds ``{"model": ...}`` only, as the
reference's ``full_reference_spec`` does.  Each step moves its batch to
the card, so the peak includes it.  The steps are eager
(``make_stage_step``, ``make_full_step``), not the captured steps the
runtimes use on the card: the claim is about a client's training, and a
captured step's private memory pool and static buffers belong to the
simulation, not to the client.

A measurement needs a CUDA device.  On any other it raises: it never
returns the analytic estimate (``core.memory``) in place of a measurement;
``audit_stage_peaks`` then reports that nothing was measured.

The reference's second claim, ~0.5x the trainable bytes a device at
``model_parallel=2``, is read here from what a ``ShardedRuntime`` rank held
in its last round (``held_trainable_bytes``) against the replicated
footprint (``trainable_ratio``), gated at <= 0.55 (``audit_trainable``).
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.core.progressive import make_full_step, make_stage_step
from repro_torch.federated.client import (run_local_training,
                                          run_local_training_full)


@dataclasses.dataclass(frozen=True)
class PeakMemory:
    resident_bytes: int    # allocated before the first step: the held tree
    peak_bytes: int        # the allocator's peak over the local training
    num_batches: int
    mean_loss: float


class _FixedBatches:
    """The given host batches as one epoch, every epoch (what
    ``run_local_training`` iterates)."""

    def __init__(self, batches: Sequence[dict]):
        self.batches = list(batches)
        self.num_samples = sum(len(b["labels"]) for b in self.batches)

    def epoch(self):
        return iter(self.batches)


def measure_local_training(adapter, params, batches: Sequence[dict],
                           optimizer, *, stage: Optional[int] = None,
                           hp: Optional[CurriculumHP] = None,
                           device: DeviceLike = None) -> PeakMemory:
    """One client's local training over ``batches`` (host batches, one
    step each) on the card: stage ``stage``'s step from the whole NeuLite
    tree ``params``, or with ``stage=None`` the full-model step from
    ``{"model": params["model"]}``.  It starts from an empty allocator
    cache; the held tree is moved to ``device`` (the current card by
    default); the bytes allocated then, and the peak over the steps, are
    returned.  Whatever else the caller keeps on the card counts in both:
    to measure a step alone, keep ``params`` on the host and nothing else
    on the card."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(
            f"measure_local_training reads the CUDA allocator's peak; "
            f"device {device} has none, and no estimate stands in for a "
            f"measurement")
    gc.collect()
    torch.cuda.empty_cache()
    held = params if stage is not None else {"model": params["model"]}
    held = tree_map(lambda p: p.to(device), held)
    data = _FixedBatches(batches)
    torch.cuda.synchronize(device)
    resident = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    if stage is None:
        out = run_local_training_full(make_full_step(adapter, optimizer),
                                      optimizer, held, data, 1, device)
    else:
        frozen, trainable = adapter.split_stage(held, stage)
        step = make_stage_step(adapter, optimizer, hp or CurriculumHP(),
                               stage)
        out = run_local_training(step, optimizer, trainable, frozen, data, 1,
                                 device=device)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    return PeakMemory(resident, peak, out.num_batches, float(out.mean_loss))


RATIO_LIMIT_DEFAULT = 0.55


def replicated_nbytes(tree) -> int:
    """Bytes of a tree of tensors held whole (unsharded)."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(tree))


def trainable_ratio(runtime, trainable) -> Optional[float]:
    """Bytes of the stage's trainable tree a rank of ``runtime`` held in
    its last round (``held_trainable_bytes``) over the replicated
    footprint of ``trainable``; None where the runtime holds no such
    count (not on a mesh, or before its first round)."""
    held = getattr(runtime, "held_trainable_bytes", None)
    full = replicated_nbytes(trainable)
    if held is None or full == 0:
        return None
    return held / full


def model_parallel_of(spec) -> int:
    """The size of a spec's model axis (1 off a mesh)."""
    if spec.mesh is None or spec.model_axis is None:
        return 1
    return dict(spec.mesh.shape).get(spec.model_axis, 1)


def audit_trainable(report, ratio: Optional[float], model_parallel: int, *,
                    program: str,
                    ratio_limit: float = RATIO_LIMIT_DEFAULT) -> None:
    """At ``model_parallel >= 2`` a rank holds at most ``ratio_limit`` of
    the replicated trainable bytes."""
    if model_parallel >= 2 and ratio is not None and ratio > ratio_limit:
        report.add(
            "memory.trainable-ratio",
            f"trainable bytes a rank holds are {ratio:.3f}x the replicated "
            f"footprint at model_parallel={model_parallel} (limit "
            f"{ratio_limit}): model-axis sharding regressed; check "
            f"fit_spec placements (launch.sharding).", program=program)


def audit_stage_peaks(report, adapter, params, batches: Sequence[dict],
                      optimizer, *, hp: Optional[CurriculumHP] = None,
                      device: DeviceLike = None,
                      program: str = "local-training") -> dict:
    """Every stage's measured peak against the full-model step's on the
    same host ``batches`` (``measure_local_training``), through
    ``audit_memory``; returns its table with each stage's ratio to the
    full step.  On a device with no allocator peak (the CPU) it measures
    nothing and says so as an ``info`` finding."""
    device = resolve_device(device)
    if device.type != "cuda":
        report.add("memory.unavailable",
                   f"{device} has no allocator peak: the stage-vs-full "
                   f"peak gate needs the card; nothing was measured.",
                   severity="info", program=program)
        return {}
    host = tree_map(lambda p: p.detach().cpu(), params)
    full = measure_local_training(adapter, host, batches, optimizer,
                                  device=device)
    peaks = {t: measure_local_training(adapter, host, batches, optimizer,
                                       stage=t, hp=hp,
                                       device=device).peak_bytes
             for t in range(adapter.plan.num_stages)}
    table, _ = audit_memory(peaks, full.peak_bytes, report=report,
                            program=program)
    for t, row in table["stages"].items():
        row["ratio_to_full"] = row["peak_bytes"] / full.peak_bytes
    return table


def audit_memory(stage_peaks: Mapping[int, int], full_peak: int, *,
                 report=None, program: str = "local-training"
                 ) -> Tuple[dict, Dict[int, str]]:
    """The reference's gate on measured peaks: every stage's peak bytes
    must be below the full-model step's.  Returns the table and, for each
    stage that fails, the reference's message (with ``report``, also a
    ``memory.stage-peak`` finding)."""
    table = {"reference": {"program": "full-model-step",
                           "peak_bytes": full_peak},
             "stages": {}}
    failures = {}
    for t, peak in sorted(stage_peaks.items()):
        below = peak < full_peak
        table["stages"][str(t)] = {"program": f"stage{t}/step",
                                   "peak_bytes": peak,
                                   "below_full": below}
        if not below:
            failures[t] = (
                f"stage {t} peak {peak:,} B >= full-model reference peak "
                f"{full_peak:,} B (full-model-step) — block-wise training "
                f"no longer saves memory; check that frozen params stay out "
                f"of grads/optimizer state (split_stage) and that the stage "
                f"program is not materializing the full tree.")
            if report is not None:
                report.add("memory.stage-peak", failures[t],
                           program=f"{program}/stage{t}")
    return table, failures
