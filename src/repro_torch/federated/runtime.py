"""Client runtimes for one NeuLite FL round (port of the sequential part of
``repro.federated.runtime``).

One round (paper Alg. 1, lines 4-10) splits the stage-t params, runs E
local steps on each selected client with no cross-client communication,
then takes the Eq. 1 weighted average of the trainable subtree.
``SequentialRuntime`` runs the clients one after another, one stage step
per batch; the vectorized, sharded and async runtimes come with later parts
of the port.

Mid-round faults route through a ``RoundStack`` (``data.loader``): a
(C, E) step mask whose False steps are skipped, with Eq. 1 weights scaled
by the completed fraction.  A round whose total weight is 0 is lost: params
come back unchanged with a NaN loss.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.device import to_device
from repro_torch.common.tree import tree_map
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.core.progressive import Adapter, make_stage_step
from repro_torch.data.loader import (Batcher, RoundStack, stack_round,
                                     truncate_step_mask)
from repro_torch.federated import aggregation as agg
from repro_torch.federated.client import run_local_training


@dataclasses.dataclass
class RoundOutcome:
    """What the server needs back from one executed round."""
    params: Any                  # full param tree with stage t merged back
    trainable: Any               # aggregated trainable subtree (upload bytes)
    mean_loss: Any               # |D_c|-weighted mean local loss (device)
    cohort_losses: Any           # (C,) per-cohort mean local loss (device)
    num_batches: List[int]       # true local steps per cohort (sim time)
    num_samples: List[float]     # effective per-cohort sample counts
    n_uploads: Optional[int] = None   # cohorts that delivered an update


class ClientRuntime:
    """Owns the adapter/optimizer/hp triple, the device and the per-stage
    steps.  ``run_round`` is the server-facing entry; ``run_stacked`` runs
    a prepared ``RoundStack``."""

    name = "base"

    def __init__(self, adapter: Adapter, optimizer, hp: CurriculumHP,
                 device: torch.device):
        self.adapter = adapter
        self.optimizer = optimizer
        self.hp = hp
        self.device = device
        self._programs: Dict[int, Any] = {}

    def _run_stack(self, t: int, trainable, frozen, stack: RoundStack):
        raise NotImplementedError

    def run_stacked(self, params, t: int, stack: RoundStack):
        """One round on a prepared stack -> (new_trainable, metrics)."""
        if float(np.sum(stack.weights)) <= 0:
            raise ValueError("round has zero total aggregation weight")
        frozen, trainable = self.adapter.split_stage(params, t)
        return self._run_stack(t, trainable, frozen, stack)

    def _lost_round(self, params, t: int, num_batches, num_samples):
        _, trainable = self.adapter.split_stage(params, t)
        return RoundOutcome(
            params=params, trainable=trainable,
            mean_loss=torch.tensor(float("nan"), device=self.device),
            cohort_losses=torch.zeros(len(num_batches), device=self.device),
            num_batches=list(num_batches),
            num_samples=[float(n) for n in num_samples], n_uploads=0)

    def run_round(self, params, t: int, batchers: Sequence[Batcher],
                  cohorts: Sequence[int], local_epochs: int,
                  faults: Optional[Sequence[Optional[int]]] = None
                  ) -> RoundOutcome:
        """One FL round.  ``faults`` (one entry per cohort, ``None`` = no
        fault) truncates cohort i's steps to its first ``faults[i]`` and
        scales its Eq. 1 weight by the completed fraction."""
        stack = stack_round(batchers, cohorts, local_epochs=local_epochs)
        if faults is not None:
            stack = truncate_step_mask(stack, faults)
        if float(np.sum(stack.weights)) <= 0:        # all cohorts dropped
            return self._lost_round(params, t, stack.num_batches,
                                    stack.weights)
        new_trainable, metrics = self.run_stacked(params, t, stack)
        return RoundOutcome(
            params=self.adapter.merge_stage(params, new_trainable, t),
            trainable=new_trainable,
            mean_loss=metrics["mean_local_loss"],
            cohort_losses=metrics["cohort_losses"],
            num_batches=list(stack.num_batches),
            num_samples=[float(w) for w in stack.weights],
            n_uploads=int(np.count_nonzero(np.asarray(stack.weights) > 0)))


class SequentialRuntime(ClientRuntime):
    """Clients one by one, one stage step per batch; losses stay on the
    device until the server reads the round's aggregate."""

    name = "sequential"

    def _step(self, t: int):
        if t not in self._programs:
            self._programs[t] = make_stage_step(self.adapter, self.optimizer,
                                                self.hp, t)
        return self._programs[t]

    def _weighted_loss(self, losses, weights):
        cohort_losses = torch.stack(losses)
        w = np.asarray(weights, np.float32)
        w = torch.from_numpy(w / w.sum()).to(self.device)
        return (cohort_losses * w).sum(), cohort_losses

    def _run_stack(self, t, trainable, frozen, stack: RoundStack):
        step = self._step(t)
        results, losses = [], []
        for c in range(stack.num_cohorts):
            tr_c = trainable
            opt_state = self.optimizer.init(tr_c)
            cohort_losses = []
            for e in range(stack.max_steps):
                # honor arbitrary masks (mid-round dropout), not only the
                # True-prefix padding stack_round emits
                if not stack.step_mask[c, e]:
                    continue
                batch = to_device(tree_map(lambda x: x[c, e], stack.batches),
                                  self.device)
                opt_state, tr_c, metrics = step(opt_state, tr_c, frozen,
                                                batch, trainable)
                cohort_losses.append(metrics["loss"])
            results.append(tr_c)
            losses.append(torch.stack(cohort_losses).mean() if cohort_losses
                          else torch.zeros((), device=self.device))
        new_trainable = agg.weighted_average(results, stack.weights)
        mean_loss, cohort_losses = self._weighted_loss(losses, stack.weights)
        return new_trainable, {"mean_local_loss": mean_loss,
                               "cohort_losses": cohort_losses}

    def run_round(self, params, t, batchers, cohorts, local_epochs,
                  faults=None):
        """Iterate each client's own Batcher.  With ``faults`` the round
        goes through the stacked path, which honors truncated masks."""
        if faults is not None:
            return ClientRuntime.run_round(self, params, t, batchers,
                                           cohorts, local_epochs, faults)
        frozen, trainable = self.adapter.split_stage(params, t)
        step = self._step(t)
        results, losses, num_batches, num_samples = [], [], [], []
        for cid in cohorts:
            res = run_local_training(step, self.optimizer, trainable, frozen,
                                     batchers[cid], local_epochs,
                                     global_ref=trainable,
                                     device=self.device)
            results.append(res.trainable)
            losses.append(res.mean_loss)
            num_batches.append(res.num_batches)
            num_samples.append(res.num_samples)
        if float(np.sum(num_samples)) <= 0:
            return self._lost_round(params, t, num_batches, num_samples)
        new_trainable = agg.weighted_average(results, num_samples)
        mean_loss, cohort_losses = self._weighted_loss(losses, num_samples)
        return RoundOutcome(
            params=self.adapter.merge_stage(params, new_trainable, t),
            trainable=new_trainable, mean_loss=mean_loss,
            cohort_losses=cohort_losses, num_batches=num_batches,
            num_samples=num_samples)


RUNTIMES = {"sequential": SequentialRuntime}


def make_runtime(spec: str, adapter: Adapter, optimizer, hp: CurriculumHP,
                 device: torch.device) -> ClientRuntime:
    """Resolve a runtime name (``FLConfig.runtime``)."""
    try:
        cls = RUNTIMES[spec]
    except KeyError:
        raise ValueError(f"unknown runtime {spec!r}; the port has "
                         f"{sorted(RUNTIMES)}") from None
    return cls(adapter, optimizer, hp, device)
