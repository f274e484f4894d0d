"""Client-side local training (port of ``repro.federated.client``).

Per-step losses stay on the device: the loop enqueues steps without
blocking, and the round's loss summary is read by the server once, at round
end.  A captured step (``core.progressive.CapturedStep``) returns its own
buffers, so the trained tree a client hands back is a copy of them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.common.device import DeviceLike, resolve_device, to_device
from repro_torch.core.progressive import own_outputs
from repro_torch.data.loader import Batcher

DROPOUT_SCHEDULES = ("none", "constant", "ramp")


def dropout_prob(schedule: str, rate: float, round_idx: int) -> float:
    """Per-round client dropout probability: ``none``, ``constant`` (every
    round ``rate``) or ``ramp`` (rate/10 up to ``rate`` over 10 rounds)."""
    if schedule == "none" or rate <= 0:
        return 0.0
    if schedule == "constant":
        return float(rate)
    if schedule == "ramp":
        return float(rate) * min(1.0, (round_idx + 1) / 10.0)
    raise ValueError(f"unknown dropout schedule {schedule!r}; "
                     f"choose from {DROPOUT_SCHEDULES}")


def sample_fault_steps(rng, targets: Sequence[int],
                       prob: float) -> List[Optional[int]]:
    """With probability ``prob`` client i crashes uniformly at one of its
    ``targets[i]`` local steps (0 = before any step completes).  Returns
    completed-step counts; ``None`` marks survivors."""
    faults: List[Optional[int]] = []
    for target in targets:
        if prob > 0 and rng.random() < prob:
            faults.append(int(rng.integers(0, max(int(target), 1))))
        else:
            faults.append(None)
    return faults


@dataclasses.dataclass
class ClientResult:
    trainable: Any
    num_samples: int          # true sample count (no wraparound duplicates)
    mean_loss: Any            # 0-d device tensor; read at round end
    num_batches: int


def local_steps(step_fn: Callable, optimizer, trainable, frozen,
                batcher: Batcher, local_epochs: int, global_ref=None,
                device: DeviceLike = None) -> ClientResult:
    """``run_local_training`` without the copy of its trained tree: that
    tree may be the buffers of a captured step, which its next call
    rewrites (``own_outputs`` keeps it past that)."""
    device = resolve_device(device)
    opt_state = optimizer.init(trainable)
    gref = global_ref if global_ref is not None else trainable
    losses, nb = [], 0
    for _ in range(local_epochs):
        for batch in batcher.epoch():
            opt_state, trainable, metrics = step_fn(
                opt_state, trainable, frozen, to_device(batch, device), gref)
            losses.append(metrics["loss"])
            nb += 1
    return _result(trainable, batcher, losses, nb, device)


def run_local_training(step_fn: Callable, optimizer, trainable, frozen,
                       batcher: Batcher, local_epochs: int,
                       global_ref=None, device: DeviceLike = None
                       ) -> ClientResult:
    """Run E local epochs of ``step_fn`` (a stage step) on ``device``: the
    current CUDA card unless the caller passes ``device="cpu"``."""
    res = local_steps(step_fn, optimizer, trainable, frozen, batcher,
                      local_epochs, global_ref, device)
    res.trainable = own_outputs(step_fn, res.trainable)
    return res


def run_local_training_full(step_fn: Callable, optimizer, params,
                            batcher: Batcher, local_epochs: int,
                            device: DeviceLike = None) -> ClientResult:
    """Full-model local training (the FedAvg-style baselines): E local
    epochs of ``step_fn`` (a ``make_full_step`` step) on ``device``, the
    current CUDA card unless the caller passes ``device="cpu"``."""
    device = resolve_device(device)
    opt_state = optimizer.init(params)
    losses, nb = [], 0
    for _ in range(local_epochs):
        for batch in batcher.epoch():
            opt_state, params, metrics = step_fn(
                opt_state, params, to_device(batch, device))
            losses.append(metrics["loss"])
            nb += 1
    return _result(own_outputs(step_fn, params), batcher, losses, nb, device)


def _result(trainable, batcher: Batcher, losses, nb,
            device: torch.device) -> ClientResult:
    mean = (torch.stack(losses).mean() if losses
            else torch.zeros((), device=device))
    return ClientResult(trainable=trainable,
                        num_samples=int(batcher.num_samples),
                        mean_loss=mean, num_batches=nb)
