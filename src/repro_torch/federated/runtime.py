"""Client runtimes for one NeuLite FL round (port of the sequential and
vectorized parts of ``repro.federated.runtime``).

One round (paper Alg. 1, lines 4-10) splits the stage-t params, runs E
local steps on each selected client with no cross-client communication,
then takes the Eq. 1 weighted average of the trainable subtree.

  SequentialRuntime  clients one after another, one stage step per batch:
                     on the card the step is captured once per batch shape
                     (``jit_stage_step``) and replayed.
  VectorizedRuntime  all cohorts at once: one local step of every cohort is
                     ``torch.func.vmap`` of ``grad_and_value`` of the stage
                     loss (the kernels launch once for all cohorts), on the
                     card captured once per (stage, C, batch shape) and
                     replayed E times; then the Eq. 1 sum over the cohort
                     axis (``eq1_aggregate``), eager.

The sharded and async runtimes come with later parts of the port.  A
runtime builds its stage program at the start of a round and drops it
(on the card its graphs and their memory) right after the round's last
local step, so that Eq. 1, the evaluation and the next round reuse the
graphs' memory as an eager round reuses its activations': every round
captures anew.  A captured step reads the frozen prefix and
``global_ref`` in place rather than copying them.

Mid-round faults route through a ``RoundStack`` (``data.loader``): a
(C, E) step mask whose False steps are skipped, with Eq. 1 weights scaled
by the completed fraction.  A round whose total weight is 0 is lost: params
come back unchanged with a NaN loss.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.common.device import to_device
from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.core.progressive import (Adapter, CapturedStep,
                                          donation_supported, jit_stage_step,
                                          make_stage_loss, own_outputs)
from repro_torch.data.loader import (Batcher, RoundStack, stack_round,
                                     truncate_step_mask)
from repro_torch.federated import aggregation as agg
from repro_torch.federated.client import local_steps
from repro_torch.optim.optimizers import apply_updates


# =========================================================================== #
# the round program: cohorts at once
# =========================================================================== #
def _cohort_step(loss, optimizer, in_dims):
    """step(opt_state, params, *args, keep) -> (opt_state, params,
    {"loss": (C,)}): one local step of C cohorts at once.  ``params`` and
    ``opt_state`` carry a leading (C,) axis; ``loss(params, *args)`` is
    one cohort's scalar loss and ``in_dims`` says which of ``args`` carry
    the cohort axis (0) and which all cohorts share (None).  Gradients are
    ``torch.func.vmap`` of ``grad_and_value``; the SGD update is
    elementwise, so it runs on the stacked trees as they are.  A cohort
    whose ``keep`` is False keeps its params and optimizer state exactly
    (``torch.where`` per leaf) and reports a loss of 0.  A tree of C
    cohorts' trainable params is GBs at full width (four of xlstm-1.3b's
    two periods: 8.5 GB), so each tree is dropped as soon as the next is
    made, and the update, the sum and the select go leaf by leaf."""

    def step(opt_state, params, *rest):
        *args, keep = rest

        def flat_loss(leaves, *a):
            return loss(tree_unflatten(params, leaves), *a)

        def sel(new, old):
            return torch.where(keep.view(-1, *[1] * (new.dim() - 1)), new,
                               old)

        grads, value = torch.func.vmap(
            torch.func.grad_and_value(flat_loss), in_dims=(0, *in_dims))(
                tree_leaves(params), *args)
        updates, new_opt = optimizer.update(tree_unflatten(params, grads),
                                            opt_state, params)
        del grads
        new_params = tree_map(lambda p, u: sel(apply_updates(p, u), p),
                              params, updates)
        del updates
        return (tree_map(sel, new_opt, opt_state), new_params,
                {"loss": torch.where(keep, value, torch.zeros_like(value))})

    return step


def cohort_stage_step(adapter: Adapter, optimizer, hp: CurriculumHP, t: int):
    """step(opt_state, trainable, frozen, batch, global_ref, keep): one
    stage-t local step of C cohorts (``_cohort_step``); ``trainable``,
    ``opt_state`` and ``batch`` carry the cohort axis, ``frozen`` and
    ``global_ref`` (the round's start) are shared, as the reference's
    ``in_axes=(None, None, 0, 0)``."""
    loss_fn = make_stage_loss(adapter, hp, t)
    return _cohort_step(lambda *a: loss_fn(*a)[0], optimizer,
                        (None, 0, None))


def cohort_full_step(adapter: Adapter, optimizer):
    """step(opt_state, params, batch, keep): one full-model (FedAvg) local
    step of C cohorts."""
    return _cohort_step(adapter.full_loss, optimizer, (0,))


def _local_training(call, optimizer, params, batches, step_mask):
    """E masked local steps of C cohorts, all starting from ``params``:
    ``call(opt_state, local, batch, keep)`` is one step of all cohorts on
    batch e of the (C, E, ...) stack.  Returns (locals_ (C, ...), losses
    (C,), the masked mean local loss of each cohort)."""
    device = tree_leaves(params)[0].device
    mask = torch.as_tensor(np.asarray(step_mask, bool), device=device)
    C, E = mask.shape
    # every cohort starts from params and a fresh optimizer state: views
    # of one copy, which the first step reads (a captured step copies them
    # into its buffers, and at full width a stack of the cohorts' params is
    # GBs beside the graph's)
    local = tree_map(lambda p: p.expand(C, *p.shape), params)
    opt_state = tree_map(lambda v: v.expand(C, *v.shape),
                         optimizer.init(params))
    total = torch.zeros(C, device=device)
    for e in range(E):
        # contiguous: a strided view can take other conv algorithms than
        # the copy a captured step reads, and so other bits
        batch = tree_map(lambda x: x[:, e].contiguous(), batches)
        opt_state, local, metrics = call(opt_state, local, batch, mask[:, e])
        total = total + metrics["loss"]
    return local, total / torch.clamp(mask.sum(1), min=1)


def make_local_program(adapter: Adapter, optimizer, hp: CurriculumHP,
                       t: int):
    """local_fn(trainable, frozen, batches, step_mask) -> (locals_, losses):
    the cohort-vmapped local training of a round without the Eq. 1
    aggregation.  ``locals_`` stacks each cohort's trained subtree on a
    leading (C,) axis, ``losses`` is the (C,) masked mean local loss.
    ``batches`` (C, E, ...) tensors on the params' device; a False entry
    of the (C, E) ``step_mask`` is an exact no-op."""
    step = cohort_stage_step(adapter, optimizer, hp, t)

    def local_fn(trainable, frozen, batches, step_mask):
        return _local_training(
            lambda o, p, b, k: step(o, p, frozen, b, trainable, k),
            optimizer, trainable, batches, step_mask)

    return local_fn


def eq1_aggregate(locals_, weights, losses):
    """The Eq. 1 aggregation: one weighted sum over the cohort axis per
    leaf (``aggregation.stacked_weighted_average``; a zero or non-finite
    weight sum raises).  ``weights`` are the (C,) sample counts (host
    numbers), ``losses`` the (C,) per-cohort mean local loss.  Returns
    ``(new_trainable, mean_loss)``."""
    w = np.asarray(weights, np.float64)
    new = agg.stacked_weighted_average(locals_, w)
    wn = torch.from_numpy((w / w.sum()).astype(np.float32))
    return new, (losses * wn.to(losses.device)).sum()


def make_round_program(adapter: Adapter, optimizer, hp: CurriculumHP, t: int):
    """round_fn(trainable, frozen, batches, weights, step_mask)
         -> (new_trainable, {"mean_local_loss", "cohort_losses"}):
    ``make_local_program`` then ``eq1_aggregate``."""
    local_fn = make_local_program(adapter, optimizer, hp, t)

    def round_fn(trainable, frozen, batches, weights, step_mask):
        locals_, losses = local_fn(trainable, frozen, batches, step_mask)
        new_trainable, mean_loss = eq1_aggregate(locals_, weights, losses)
        return new_trainable, {"mean_local_loss": mean_loss,
                               "cohort_losses": losses}

    return round_fn


def make_full_round_program(adapter: Adapter, optimizer):
    """Full-model FL round (FedAvg): round_fn(params, batches, weights,
    step_mask) -> (new_params, metrics), as ``make_round_program`` over
    every parameter (gradients and optimizer state for the whole model)."""
    step = cohort_full_step(adapter, optimizer)

    def round_fn(params, batches, weights, step_mask):
        locals_, losses = _local_training(step, optimizer, params, batches,
                                          step_mask)
        new_params, mean_loss = eq1_aggregate(locals_, weights, losses)
        return new_params, {"mean_local_loss": mean_loss,
                            "cohort_losses": losses}

    return round_fn


def make_fl_round_step(adapter: Adapter, optimizer, hp: CurriculumHP, t: int):
    """round_fn(trainable, frozen, batches, weights) -> (new_trainable,
    {"mean_local_loss"}): ``make_round_program`` with every step of the
    (C, E, ...) stack taken."""
    program = make_round_program(adapter, optimizer, hp, t)

    def round_fn(trainable, frozen, batches, weights):
        C, E = tree_leaves(batches)[0].shape[:2]
        new_trainable, metrics = program(trainable, frozen, batches, weights,
                                         np.ones((C, E), bool))
        return new_trainable, {"mean_local_loss": metrics["mean_local_loss"]}

    return round_fn


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
                 device: torch.device, capture: bool = True):
        self.adapter = adapter
        self.optimizer = optimizer
        self.hp = hp
        self.device = device
        # on the card, steps are captured (CUDA graphs) unless told not to
        self.capture = capture and donation_supported(device)
        self._programs: Dict[int, Any] = {}

    def release(self) -> None:
        """Drop the programs kept and their graphs, and hand the graphs'
        pools back to the card: the allocator keeps a dropped graph's pool
        reserved until its cache is emptied, so the round's Eq. 1 and
        the next round's warm-ups would otherwise sit beside it.  Trees a
        captured step returned before stay valid.  Every round calls it
        after its last local step."""
        held = bool(self._programs)
        for program in self._programs.values():
            getattr(program, "release", lambda: None)()
        self._programs.clear()
        if held and self.capture:
            torch.cuda.empty_cache()

    def _stage_program(self, t: int, build):
        """Stage t's program, built at the round's first step and dropped
        after its last (``release``)."""
        if t not in self._programs:
            self.release()
            self._programs[t] = build()
        return self._programs[t]

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
        return self._stage_program(t, lambda: jit_stage_step(
            self.adapter, self.optimizer, self.hp, t, donate=self.capture,
            device=self.device))

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
            if c == stack.num_cohorts - 1:
                self.release()      # no copy of the last cohort's tree
            results.append(own_outputs(step, tr_c))
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
        for i, cid in enumerate(cohorts):
            res = local_steps(step, self.optimizer, trainable, frozen,
                              batchers[cid], local_epochs,
                              global_ref=trainable, device=self.device)
            if i == len(cohorts) - 1:
                self.release()      # no copy of the last client's tree
            results.append(own_outputs(step, res.trainable))
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


class VectorizedRuntime(ClientRuntime):
    """All cohorts at once (``cohort_stage_step``): on the card one captured
    graph per (stage, C, batch shape), replayed E times, each replay
    copying step e of the (C, E, ...) batch stack into its static batch
    buffer (the reference donates the stack; the port reuses the buffer).
    E varies from round to round with the data split, so the graph is one
    step, not the whole scan.  Eq. 1 runs eagerly after the last step:
    once a round, a few ops a leaf, against E replays of the step."""

    name = "vectorized"

    def _step(self, t: int):
        def build():
            step = cohort_stage_step(self.adapter, self.optimizer, self.hp,
                                     t)
            if self.capture:
                step = CapturedStep(step, name=f"stage {t} cohort step",
                                    shared=(2, 4))
            return step
        return self._stage_program(t, build)

    def _run_stack(self, t, trainable, frozen, stack: RoundStack):
        step = self._step(t)
        batches = to_device(stack.batches, self.device)
        locals_, losses = _local_training(
            lambda o, p, b, k: step(o, p, frozen, b, trainable, k),
            self.optimizer, trainable, batches, stack.step_mask)
        self.release()      # the carried locals_ stay valid
        new_trainable, mean_loss = eq1_aggregate(locals_, stack.weights,
                                                 losses)
        return new_trainable, {"mean_local_loss": mean_loss,
                               "cohort_losses": losses}


RUNTIMES = {"sequential": SequentialRuntime,
            "vectorized": VectorizedRuntime}
NOT_PORTED = ("sharded", "async")


def make_runtime(spec: Union[str, ClientRuntime], adapter: Adapter,
                 optimizer, hp: CurriculumHP,
                 device: torch.device) -> ClientRuntime:
    """Resolve a runtime name (``FLConfig.runtime``) or pass an
    already-constructed ``ClientRuntime`` through unchanged."""
    if isinstance(spec, ClientRuntime):
        return spec
    if spec in NOT_PORTED:
        raise ValueError(f"runtime {spec!r} is not yet ported; the port has "
                         f"{sorted(RUNTIMES)}")
    try:
        cls = RUNTIMES[spec]
    except KeyError:
        raise ValueError(f"unknown runtime {spec!r}; the port has "
                         f"{sorted(RUNTIMES)}") from None
    return cls(adapter, optimizer, hp, device)
