"""Client runtimes for one NeuLite FL round (port of
``repro.federated.runtime``).

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
  ShardedRuntime     the vectorized round over a ``(data, model)`` mesh of
                     ``torch.distributed`` ranks (``launch.mesh``), every
                     rank running the same server: each data rank trains
                     its block of the cohort axis, and Eq. 1 is one
                     all-reduce over "data" per leaf.  With a model axis
                     each rank holds only its ``fit_spec`` shard of the
                     stage's trainable state between local steps.

  AsyncBufferedRuntime
                     FedBuff-style buffered-async server on a virtual
                     clock: the vectorized runtime's local training, then
                     a flush every K deliveries with per-entry staleness
                     discounts; deliveries short of K wait in a persistent
                     ``AsyncServerState`` buffer for a later round; on a
                     mesh its local training is the sharded runtime's.

A runtime builds its stage program at the start of a round and drops it
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
import functools
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.common.device import (DeviceLike, resolve_device,
                                      to_device)
from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.core.progressive import (Adapter, CapturedStep,
                                          donation_supported, jit_stage_step,
                                          make_full_step, make_stage_loss,
                                          make_stage_step, own_outputs)
from repro_torch.data.loader import (Batcher, RoundStack, stack_round,
                                     truncate_step_mask)
from repro_torch.federated import aggregation as agg
from repro_torch.federated.client import local_steps
from repro_torch.launch import sharding
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
    mask = to_device(np.asarray(step_mask, bool), device)
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
    wn = to_device((w / w.sum()).astype(np.float32), losses.device)
    return new, (losses * wn).sum()


def make_round_program(adapter: Adapter, optimizer, hp: CurriculumHP, t: int,
                       aggregate=None):
    """round_fn(trainable, frozen, batches, weights, step_mask)
         -> (new_trainable, {"mean_local_loss", "cohort_losses"}):
    ``make_local_program`` then ``aggregate`` (``eq1_aggregate`` by
    default)."""
    local_fn = make_local_program(adapter, optimizer, hp, t)
    aggregate = eq1_aggregate if aggregate is None else aggregate

    def round_fn(trainable, frozen, batches, weights, step_mask):
        locals_, losses = local_fn(trainable, frozen, batches, step_mask)
        new_trainable, mean_loss = aggregate(locals_, weights, losses)
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


def make_fl_round_step(adapter: Adapter, optimizer, hp: CurriculumHP, t: int,
                       aggregate=None):
    """round_fn(trainable, frozen, batches, weights) -> (new_trainable,
    {"mean_local_loss"}): ``make_round_program`` (with ``aggregate``) with
    every step of the (C, E, ...) stack taken."""
    program = make_round_program(adapter, optimizer, hp, t, aggregate)

    def round_fn(trainable, frozen, batches, weights):
        C, E = tree_leaves(batches)[0].shape[:2]
        new_trainable, metrics = program(trainable, frozen, batches, weights,
                                         np.ones((C, E), bool))
        return new_trainable, {"mean_local_loss": metrics["mean_local_loss"]}

    return round_fn


def cohort_batches_specs(cfg, num_cohorts: int, local_steps: int,
                         per_cohort_batch: int, seq: int):
    """Meta-tensor tree of the (C, E, ...) batch stack of ``cfg``'s
    ``token_inputs`` and ``label_specs`` (nothing allocated)."""
    from repro_torch.configs.shapes import label_specs, token_inputs

    def stack(t):
        return torch.empty((num_cohorts, local_steps, *t.shape),
                           dtype=t.dtype, device="meta")

    return {"inputs": tree_map(stack, token_inputs(cfg, per_cohort_batch,
                                                   seq)),
            "labels": stack(label_specs(cfg, per_cohort_batch, seq))}


# =========================================================================== #
# the auditors' registry: runnable round programs (see repro_torch.analysis)
# =========================================================================== #
# dtypes off JAX's x64 mode: what the reference's ``abstract_like`` gives
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32,
              torch.complex128: torch.complex64}


def abstract_like(tree):
    """A tree of ``meta`` tensors with the shapes of ``tree``'s leaves and
    the dtypes ``torch.as_tensor`` gives them, 64-bit types canonicalised
    to 32 bits as the reference canonicalises off x64 (float64 -> float32,
    int64 -> int32): nothing is allocated.  Leaves are tensors, numpy
    arrays and Python or numpy numbers; a dataclass (a ``RoundStack``) is
    rebuilt from its fields' abstracts; ``None`` stays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: abstract_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(abstract_like(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: abstract_like(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, torch.Tensor):
        shape, dtype = tuple(tree.shape), tree.dtype
    else:
        t = torch.as_tensor(np.asarray(tree))
        shape, dtype = tuple(t.shape), t.dtype
    return torch.empty(shape, dtype=_CANONICAL.get(dtype, dtype),
                       device="meta")


def shard_abstract(abstract, placements, mesh):
    """The per-rank shard of each leaf of an abstract tree: a ``meta``
    tensor of the shape ``launch.sharding.shard`` gives this rank's block
    under its ``Placement`` (``model_dim`` over "model", the cohort or
    batch dim ``cohort_dim`` over ``cohort_axis``)."""
    def cut(a, p):
        shape = list(a.shape)
        if p.cohort_axis is not None:
            shape[p.cohort_dim] //= sharding.axes_size(mesh, p.cohort_axis)
        if p.model_dim is not None:
            shape[p.model_dim] //= mesh.shape[sharding.MODEL]
        return torch.empty(shape, dtype=a.dtype, device="meta")
    return tree_map(cut, abstract, placements)


@dataclasses.dataclass
class RoundProgramSpec:
    """One round program of a runtime and the contracts it must meet (port
    of the reference's ``RoundProgramSpec``).

    The runtimes contribute these through ``trace_specs`` /
    ``full_reference_spec``; ``repro_torch.analysis`` runs each once
    (``run``) to check purity, held state and collectives.  A torch
    program cannot be traced without running, so ``args`` are real
    tensors on the runtime's device, built from a real stack, where the
    reference holds abstract ones.

    kind          : "round" (local training fused with Eq. 1), "local"
                    (no aggregation: nothing may cross the data axis),
                    "aggregation" (the bare Eq. 1 seam), "step" (one client
                    step), "reference" (the full-model program every
                    stage's peak must undercut).
    alias_argnums : arguments whose every leaf the program must leave held
                    once: the optimizer state of a step, the trainable tree
                    of a round (the reference donates them).  ``global_ref``
                    is held by design and is not among them.
    n_agg_leaves  : leaves of the Eq. 1 contraction; bounds the legal count
                    of data-axis all-reduces.
    """

    name: str
    backend: str
    kind: str
    fn: Any
    args: tuple
    alias_argnums: tuple = ()
    mesh: Any = None
    data_axis: Optional[str] = None
    model_axis: Optional[str] = None
    stage: Optional[int] = None
    n_agg_leaves: int = 0

    @property
    def abstract_args(self) -> tuple:
        """``args`` as ``abstract_like`` gives them, as the reference's
        spec carries them."""
        return abstract_like(self.args)

    def run(self):
        """The program once, on its arguments."""
        return self.fn(*self.args)


@dataclasses.dataclass
class RoundOutcome:
    """What the server needs back from one executed round."""
    params: Any                  # full param tree with stage t merged back
    trainable: Any               # aggregated trainable subtree (upload bytes)
    mean_loss: Any               # |D_c|-weighted mean local loss (device)
    cohort_losses: Any           # (C,) per-cohort mean local loss (device)
    num_batches: List[int]       # true local steps per cohort (sim time)
    num_samples: List[float]     # effective per-cohort sample counts
    n_uploads: Optional[int] = None   # updates aggregated this round (no
                                      # step-0 crashes, no async pending)
    sim_times: Optional[List[float]] = None   # per-cohort simulated seconds
    round_sim_time: Optional[float] = None    # async: open to last flush


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

    def _lost_round_extras(self, stack: RoundStack,
                           cohorts: Sequence[int]) -> dict:
        """``RoundOutcome`` extras of an all-dropped (lost) round: the
        async runtime reports its virtual clock, which such a round never
        advanced."""
        return {}

    def run_stacked(self, params, t: int, stack: RoundStack, **kw):
        """One round on a prepared stack -> (new_trainable, metrics);
        ``kw`` goes to the runtime's ``_run_stack``."""
        if float(np.sum(stack.weights)) <= 0:
            raise ValueError("round has zero total aggregation weight")
        frozen, trainable = self.adapter.split_stage(params, t)
        return self._run_stack(t, trainable, frozen, stack, **kw)

    def _round_from_stack(self, params, t: int, stack: RoundStack,
                          cohorts: Sequence[int]):
        """One prepared stack -> (new_trainable, metrics, extras); the
        extras merge into the ``RoundOutcome``."""
        new_trainable, metrics = self.run_stacked(params, t, stack)
        return new_trainable, metrics, {}

    def _lost_round(self, params, t: int, num_batches, num_samples,
                    **extras):
        _, trainable = self.adapter.split_stage(params, t)
        return RoundOutcome(
            params=params, trainable=trainable,
            mean_loss=torch.full((), float("nan"), device=self.device),
            cohort_losses=torch.zeros(len(num_batches), device=self.device),
            num_batches=list(num_batches),
            num_samples=[float(n) for n in num_samples], n_uploads=0,
            **extras)

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
                                    stack.weights,
                                    **self._lost_round_extras(stack,
                                                              cohorts))
        new_trainable, metrics, extras = self._round_from_stack(
            params, t, stack, cohorts)
        extras.setdefault("n_uploads", int(np.count_nonzero(
            np.asarray(stack.weights) > 0)))
        return RoundOutcome(
            params=self.adapter.merge_stage(params, new_trainable, t),
            trainable=new_trainable,
            mean_loss=metrics["mean_local_loss"],
            cohort_losses=metrics["cohort_losses"],
            num_batches=list(stack.num_batches),
            num_samples=[float(w) for w in stack.weights], **extras)

    # -- the auditors' registry (repro_torch.analysis) --------------------- #
    def _device_stack(self, stack: RoundStack):
        """(batches on the device, host weights, host step mask): what a
        round program takes."""
        return (to_device(stack.batches, self.device),
                np.asarray(stack.weights), np.asarray(stack.step_mask, bool))

    def trace_specs(self, params, t: int,
                    stack: RoundStack) -> List[RoundProgramSpec]:
        """This runtime's stage-``t`` programs on ``stack`` (``params`` on
        the runtime's device): the auditors' entry point."""
        raise NotImplementedError

    def full_reference_spec(self, params,
                            stack: RoundStack) -> RoundProgramSpec:
        """The full-model (FedAvg) round on the same stack: the program
        every stage's peak must undercut."""
        batches, weights, mask = self._device_stack(stack)
        model = {"model": params["model"]}
        return RoundProgramSpec(
            name=f"{self.name}/full-model-round", backend=self.name,
            kind="reference",
            fn=make_full_round_program(self.adapter, self.optimizer),
            args=(model, batches, weights, mask),
            n_agg_leaves=len(tree_leaves(model)))


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
        w = to_device(w / w.sum(), self.device)
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

    def _first_batch(self, stack: RoundStack):
        return to_device(tree_map(lambda x: x[0, 0], stack.batches),
                         self.device)

    def trace_specs(self, params, t, stack):
        frozen, trainable = self.adapter.split_stage(params, t)
        return [RoundProgramSpec(
            name=f"sequential/stage{t}/step", backend=self.name, kind="step",
            fn=make_stage_step(self.adapter, self.optimizer, self.hp, t),
            args=(self.optimizer.init(trainable), trainable, frozen,
                  self._first_batch(stack), trainable),
            alias_argnums=(0,), stage=t)]

    def full_reference_spec(self, params, stack):
        model = {"model": params["model"]}
        return RoundProgramSpec(
            name="sequential/full-model-step", backend=self.name,
            kind="reference",
            fn=make_full_step(self.adapter, self.optimizer),
            args=(self.optimizer.init(model), model,
                  self._first_batch(stack)),
            alias_argnums=(0,))


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

    def _train_cohorts(self, t, trainable, frozen, stack: RoundStack):
        """Every cohort's E masked local steps from ``trainable``:
        (locals_ (C, ...), losses (C,)), the graphs released after the
        last step (the carried locals_ stay valid)."""
        step = self._step(t)
        batches = to_device(stack.batches, self.device)
        locals_, losses = _local_training(
            lambda o, p, b, k: step(o, p, frozen, b, trainable, k),
            self.optimizer, trainable, batches, stack.step_mask)
        self.release()
        return locals_, losses

    def _run_stack(self, t, trainable, frozen, stack: RoundStack):
        locals_, losses = self._train_cohorts(t, trainable, frozen, stack)
        new_trainable, mean_loss = eq1_aggregate(locals_, stack.weights,
                                                 losses)
        return new_trainable, {"mean_local_loss": mean_loss,
                               "cohort_losses": losses}

    def trace_specs(self, params, t, stack):
        frozen, trainable = self.adapter.split_stage(params, t)
        batches, weights, mask = self._device_stack(stack)
        return [RoundProgramSpec(
            name=f"{self.name}/stage{t}/round", backend=self.name,
            kind="round",
            fn=make_round_program(self.adapter, self.optimizer, self.hp, t),
            args=(trainable, frozen, batches, weights, mask),
            alias_argnums=(0,), stage=t,
            n_agg_leaves=len(tree_leaves(trainable)))]


# =========================================================================== #
# the (data, model) mesh of ranks
# =========================================================================== #
def resolve_round_mesh(mesh, model_parallel: int, device: torch.device,
                       model_axis: str = "model"):
    """Build (``launch.mesh.make_host_mesh`` on ``device``) or validate an
    explicit round mesh: one whose ``model_axis`` size contradicts
    ``model_parallel`` raises, since it would run with the mesh's
    sharding, not the request."""
    if mesh is None:
        from repro_torch.launch.mesh import make_host_mesh
        return make_host_mesh(model_parallel, device)
    if (model_parallel != 1
            and dict(mesh.shape).get(model_axis, 1) != model_parallel):
        raise ValueError(
            f"model_parallel={model_parallel} contradicts the explicit "
            f"mesh (shape {dict(mesh.shape)}): pass one or the other "
            f"— a mesh whose '{model_axis}' axis disagrees would "
            f"silently run with the mesh's sharding, not the request")
    return mesh


def pad_cohorts(stack: RoundStack, shards: int) -> RoundStack:
    """``stack`` with its cohort axis padded to a multiple of ``shards``
    by zero-weight, fully masked cohorts of zero data (exact no-ops on
    every path); ``stack`` itself where none is needed."""
    pad = (-stack.num_cohorts) % shards
    if not pad:
        return stack
    return RoundStack(
        batches=tree_map(lambda x: np.concatenate(
            [x, np.zeros((pad, *x.shape[1:]), x.dtype)]), stack.batches),
        step_mask=np.concatenate([np.asarray(stack.step_mask, bool),
                                  np.zeros((pad, stack.max_steps), bool)]),
        weights=np.concatenate([np.asarray(stack.weights),
                                np.zeros(pad, np.asarray(
                                    stack.weights).dtype)]),
        num_batches=list(stack.num_batches) + [0] * pad)


def _cohort_block(stack: RoundStack, start: int, stop: int) -> RoundStack:
    return RoundStack(batches=tree_map(lambda x: x[start:stop],
                                       stack.batches),
                      step_mask=np.asarray(stack.step_mask)[start:stop],
                      weights=np.asarray(stack.weights)[start:stop],
                      num_batches=list(stack.num_batches[start:stop]))


def _round_digest(stack: RoundStack, cohorts) -> np.ndarray:
    """A fixed-size digest of what every rank must agree on before a
    round: its cohorts, their Eq. 1 weights, step counts and step mask."""
    import hashlib
    h = hashlib.sha256()
    for part in (np.asarray(-1 if cohorts is None else list(cohorts),
                            np.int64),
                 np.asarray(stack.weights, np.float64),
                 np.asarray(stack.num_batches, np.int64),
                 np.asarray(stack.step_mask, bool)):
        h.update(part.tobytes())
        h.update(str(part.shape).encode())
    return np.frombuffer(h.digest(), np.int64).copy()


class StagePlacements:
    """Cached per-stage placements on a ``(data, model)`` mesh (port of the
    reference's ``StagePlacements``).

    One instance per runtime on a mesh: ``placements(t)`` gives the
    ``(trainable, frozen, cohort axis)`` ``Placement``s of stage ``t``
    (fitted from the adapter's ParamDef specs), ``stacked_locals(t)`` those
    of per-cohort locals (C, *param), and ``place_inputs`` cuts a round's
    inputs to this rank's part: the trainable tree to its model shards,
    the cohort stack to this rank's block of the data axis.  ``shard`` /
    ``unshard`` cut a stage-t trainable tree to this rank's model shards
    and gather it whole again.  The port keeps the frozen prefix whole on
    every rank, where the reference commits it to its model shards."""

    def __init__(self, adapter: Adapter, mesh, axis: str = "data",
                 model_axis: str = "model"):
        self.adapter = adapter
        self.mesh = mesh
        self.axis = axis
        self.model_axis = model_axis
        self._cache: Dict[int, Any] = {}

    def placements(self, t: int):
        if t not in self._cache:
            frozen_defs, trainable_defs = self.adapter.split_stage(
                self.adapter.defs, t)
            self._cache[t] = (
                sharding.tree_placements(trainable_defs, self.mesh),
                sharding.tree_placements(frozen_defs, self.mesh),
                sharding.Placement(None, self.axis))
        return self._cache[t]

    def stacked_locals(self, t: int):
        """Per-cohort local weights (C, *param): the cohort axis over
        ``axis``, the param dims as ``placements``."""
        return sharding.stacked_tree_placements(
            self.adapter.split_stage(self.adapter.defs, t)[1], self.mesh,
            self.axis)

    def shard(self, t: int, tree, lead: int = 0):
        """This rank's model shards of a stage-t trainable tree (``lead``
        leading axes in front of every leaf)."""
        return tree_map(lambda x, p: sharding.shard(
            x, None if p.model_dim is None else p.model_dim + lead,
            self.mesh, self.model_axis), tree, self.placements(t)[0])

    def unshard(self, t: int, tree, lead: int = 0):
        """A stage-t trainable tree whole from every rank's shards (a
        collective: every rank calls it)."""
        return tree_map(lambda x, p: sharding.unshard(
            x, None if p.model_dim is None else p.model_dim + lead,
            self.mesh, self.model_axis), tree, self.placements(t)[0])

    def place_inputs(self, t: int, trainable, stack: RoundStack):
        """(held, padded stack, start, stop, this rank's block of it):
        ``trainable`` cut to this rank's model shards (itself at a model
        size of 1), the cohort axis padded to a multiple of the data size
        (``pad_cohorts``) and this rank's contiguous block
        ``[start, stop)`` of it."""
        shards = self.mesh.shape[self.axis]
        padded = pad_cohorts(stack, shards)
        start, stop = sharding.block(padded.num_cohorts, shards,
                                     self.mesh.index(self.axis))
        return (self.shard(t, trainable), padded, start, stop,
                _cohort_block(padded, start, stop))


def all_cohorts(mesh, axis, block, start, n_padded, n):
    """A (block, ...) tensor of this rank's cohorts as the (n, ...) tensor
    of every rank's: written into zeros, all-reduced over ``axis`` (exact:
    every entry sums one value and zeros), the padding trimmed."""
    out = torch.zeros((n_padded, *block.shape[1:]), dtype=block.dtype,
                      device=block.device)
    out[start:start + block.shape[0]] = block
    return mesh.all_reduce(out, axis)[:n]


def eq1_over_mesh(mesh, axis, model_axis, placements, start, n, locals_held,
                  weights, losses):
    """Eq. 1 on a ``(data, model)`` mesh, the sharded runtime's seam:
    ``locals_held`` (C_block, ...) and ``losses`` (C_block,) are this rank's
    block (from cohort ``start``) of the padded cohort axis, each leaf cut
    to its model shard by ``placements`` (the stage's trainable
    ``Placement``s); the host ``weights`` (C_pad,) are normalised by their
    global total here (a zero or non-finite total raises).  Each leaf is
    summed over the block in f32, all-reduced over ``axis`` and, where
    model-sharded, gathered whole over ``model_axis``; the losses
    all-reduce as one zero (C_pad,) vector with this block written in.
    Returns ``(new_trainable, mean_loss, cohort_losses)`` of the first
    ``n`` cohorts."""
    w = np.asarray(weights, np.float64)
    total = w.sum()
    if not np.isfinite(total) or total <= 0:
        raise ValueError(f"aggregation needs a positive finite weight "
                         f"sum; got {total}")
    wn = to_device((w / total).astype(np.float32), losses.device)
    mine = wn[start:start + losses.shape[0]]

    def eq1(leaf, p):
        part = torch.einsum("c...,c->...", leaf.float(), mine)
        whole = sharding.unshard(mesh.all_reduce(part, axis), p.model_dim,
                                 mesh, model_axis)
        return whole.to(leaf.dtype)

    new_trainable = tree_map(eq1, locals_held, placements)
    cohort_losses = all_cohorts(mesh, axis, losses, start, len(w), n)
    return new_trainable, (cohort_losses * wn[:n]).sum(), cohort_losses


class ShardedRuntime(VectorizedRuntime):
    """The vectorized round over a 2-D ``(data, model)`` mesh of ranks
    (``launch.mesh.HostMesh``; the default ``make_host_mesh`` lays the
    world out, one rank on one card being the degenerate 1x1 mesh).  Every
    rank runs the same server: selection, batch stacking and all host
    state come from numpy and the seed, so every rank holds the same
    ``RoundStack``, and once a round every rank checks every rank's
    cohorts and weights against rank 0's (one all-gather of a digest: a
    rank whose host state drifted makes every rank raise rather than
    average the wrong clients).

    The cohort axis, padded to a multiple of the data size
    (``pad_cohorts``), splits over ``axis``: each data rank copies its
    contiguous block of the host stack to its device and trains it with
    the vectorized runtime's captured cohort step.  Eq. 1 normalises the
    weights by the global total on the host, sums this rank's cohorts in
    f32 and all-reduces each leaf over "data" (eager, after the last
    replay; no collective runs inside ``vmap`` or a captured graph); the
    losses all-reduce as a zero (C_pad,) vector with this rank's block
    written in.  At data size 1 a round gives the vectorized runtime's
    bits.

    With a model axis of k > 1 (``model_parallel=k`` or an explicit 2-D
    mesh) each rank holds, between local steps, only its ``fit_spec``
    shard (``launch.sharding``) of the stage's trainable leaves, of the
    per-cohort SGD momentum and of the per-cohort local weights
    (``held_trainable_bytes``: one copy of the trainable tree as this rank
    holds it); the frozen prefix and the round's start (the server's
    params) stay whole.  A step all-gathers its operands over "model",
    runs (on the card, replays) the whole step and keeps this rank's slice
    of its outputs; Eq. 1 reduces the shards over "data" and one
    all-gather over "model" returns the aggregate whole, so the server's
    params stay whole between rounds on every rank.  Unlike the
    reference, whose GSPMD program also splits the step's compute and
    returns the aggregate model-sharded, the port splits storage only:
    each rank computes the whole step (tensor-parallel layers are not
    ported)."""

    name = "sharded"

    def __init__(self, adapter: Adapter, optimizer, hp: CurriculumHP,
                 device: torch.device, capture: bool = True, *, mesh=None,
                 axis: str = "data", model_axis: str = "model",
                 model_parallel: int = 1):
        super().__init__(adapter, optimizer, hp, device, capture)
        self.mesh = resolve_round_mesh(mesh, model_parallel, device,
                                       model_axis)
        self.axis = axis
        self.model_axis = model_axis
        self.place = StagePlacements(adapter, self.mesh, axis, model_axis)
        self.held_trainable_bytes: Optional[int] = None

    @property
    def data_shards(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def model_shards(self) -> int:
        return dict(self.mesh.shape).get(self.model_axis, 1)

    def _check_same_round(self, stack: RoundStack, cohorts) -> None:
        """Every rank's round digest (``_round_digest``) against rank 0's,
        gathered on every rank, so that every rank refuses a drifted round
        before its first collective (a broadcast would tell only the
        drifted rank, and the others would wait in the round's
        all-reduce)."""
        digests = self.mesh.gather_host(_round_digest(stack, cohorts))
        drifted = [r for r in range(len(digests))
                   if not np.array_equal(digests[r], digests[0])]
        if drifted:
            raise RuntimeError(
                f"ranks {drifted} disagree with rank 0 on the round's "
                f"cohorts, weights or step mask: their host state drifted "
                f"(this rank {self.mesh.rank}: cohorts "
                f"{None if cohorts is None else list(cohorts)}, weights "
                f"{np.asarray(stack.weights).tolist()})")

    def _train_block(self, t, trainable, frozen, stack: RoundStack,
                     cohorts=None):
        """This rank's block of the padded cohort axis, trained:
        (padded stack, start, stop, locals_ (block, ...) as held, losses
        (block,), the stage's trainable as held)."""
        self._check_same_round(stack, cohorts)
        held, padded, start, stop, mine = self.place.place_inputs(
            t, trainable, stack)
        if self.model_shards == 1:
            locals_, losses = self._train_cohorts(t, trainable, frozen, mine)
        else:
            locals_, losses = self._train_sharded(t, held, trainable,
                                                  frozen, mine)
        self.held_trainable_bytes = sharding.per_device_nbytes(held)
        return padded, start, stop, locals_, losses, held

    def _train_sharded(self, t, held, trainable, frozen, stack: RoundStack):
        """``_train_cohorts`` with the carried state model-sharded: before
        each step the cohorts' local weights and momentum are gathered
        over "model" into the step's operands; after it each rank keeps
        its slice (a copy: the step's outputs are its graph's buffers)."""
        step = self._step(t)
        batches = to_device(stack.batches, self.device)
        mask = to_device(np.asarray(stack.step_mask, bool), self.device)
        C, E = mask.shape
        init = self.optimizer.init(held)
        local = tree_map(lambda p: p.expand(C, *p.shape), held)
        opt_state = tree_map(lambda v: v.expand(C, *v.shape), init)

        def opt_map(fn, state):
            # the SGD state: "mu" shaped as the trainable tree, "step" whole
            return dict(state, mu=None if state["mu"] is None
                        else fn(state["mu"]))

        total = torch.zeros(C, device=self.device)
        for e in range(E):
            batch = tree_map(lambda x: x[:, e].contiguous(), batches)
            opt_state, local, metrics = step(
                opt_map(lambda m: self.place.unshard(t, m, lead=1),
                        opt_state),
                self.place.unshard(t, local, lead=1), frozen, batch,
                trainable, mask[:, e])
            local = self.place.shard(t, local, lead=1)
            opt_state = opt_map(
                lambda m: self.place.shard(t, m, lead=1),
                dict(opt_state, step=opt_state["step"].clone()))
            total = total + metrics["loss"]
        self.release()
        return local, total / torch.clamp(mask.sum(1), min=1)

    def cohort_deltas(self, t, trainable, frozen, stack: RoundStack,
                      cohorts=None):
        """Every cohort's f32 delta against the pull on every rank:
        ``(deltas (C, ...) as held, losses (C,), the trainable as held)``
        (model shards stay shards); the buffered-async runtime's local
        training on a mesh."""
        padded, start, _, locals_, losses, held = self._train_block(
            t, trainable, frozen, stack, cohorts)
        deltas, losses = self._exchange_deltas(
            start, padded.num_cohorts, stack.num_cohorts, locals_, held,
            losses)
        return deltas, losses, held

    def _exchange_deltas(self, start, n_padded, n, locals_, held, losses):
        """This rank's block of trained cohorts as every cohort's f32 delta
        against ``held`` and every cohort's loss, on every rank: one
        all-reduce over "data" of a zero (n_padded, ...) stack a leaf,
        and one of the losses."""
        deltas = tree_map(lambda loc, base: all_cohorts(
            self.mesh, self.axis, loc.float() - base.float(), start,
            n_padded, n), locals_, held)
        return deltas, all_cohorts(self.mesh, self.axis, losses, start,
                                   n_padded, n)

    def _run_stack(self, t, trainable, frozen, stack: RoundStack,
                   cohorts=None):
        padded, start, _, locals_, losses, _ = self._train_block(
            t, trainable, frozen, stack, cohorts)
        return self._eq1_seam(t, start, stack.num_cohorts, locals_,
                              padded.weights, losses)

    def _eq1_seam(self, t, start, n, locals_, weights, losses):
        """``eq1_over_mesh`` of this rank's block of stage-t locals:
        ``(new_trainable, metrics)`` of the first ``n`` cohorts."""
        new_trainable, mean_loss, cohort_losses = eq1_over_mesh(
            self.mesh, self.axis, self.model_axis, self.place.placements(t)[0],
            start, n, locals_, weights, losses)
        return new_trainable, {"mean_local_loss": mean_loss,
                               "cohort_losses": cohort_losses}

    def _mesh_spec(self, t, n_leaves) -> dict:
        return dict(backend=self.name, mesh=self.mesh, data_axis=self.axis,
                    model_axis=self.model_axis, stage=t,
                    n_agg_leaves=n_leaves)

    def _block_of_locals(self, t, trainable, stack: RoundStack):
        """(start, padded weights, a stand-in for this rank's block of
        trained locals: the trainable tree as held, once a cohort, and zero
        losses): the Eq. 1 seam's arguments without running a round."""
        held, padded, start, stop, _ = self.place.place_inputs(
            t, trainable, stack)
        locals_ = tree_map(lambda p: p.expand(stop - start, *p.shape)
                           .clone(), held)
        return (start, np.asarray(padded.weights), locals_,
                torch.zeros(stop - start, device=self.device), held)

    def trace_specs(self, params, t, stack):
        """The whole round on this rank (every rank runs it: its
        collectives are real) and the Eq. 1 seam alone, on a block of
        stand-in locals."""
        frozen, trainable = self.adapter.split_stage(params, t)
        kw = self._mesh_spec(t, len(tree_leaves(trainable)))
        layout = "sharded2d" if self.model_shards > 1 else "sharded1d"
        start, weights, locals_, losses, _ = self._block_of_locals(
            t, trainable, stack)
        return [RoundProgramSpec(
            name=f"{layout}/stage{t}/round", kind="round",
            fn=functools.partial(self._run_stack, t),
            args=(trainable, frozen, stack), alias_argnums=(0,), **kw),
            RoundProgramSpec(
                name=f"{layout}/stage{t}/eq1-seam", kind="aggregation",
                fn=functools.partial(self._eq1_seam, t, start,
                                     stack.num_cohorts),
                args=(locals_, weights, losses), **kw)]

    def _round_from_stack(self, params, t, stack, cohorts):
        new_trainable, metrics = self.run_stacked(params, t, stack,
                                                  cohorts=cohorts)
        return new_trainable, metrics, {}


# =========================================================================== #
# buffered-async (FedBuff-style) backend
# =========================================================================== #
@dataclasses.dataclass
class FlushPlan:
    """Arrival-order schedule of buffered-async flushes.

    flushes    : delivery-index arrays, one per server flush, in arrival
                 order (staleness is computed per entry at flush time by
                 ``AsyncServerState.schedule``)
    pending    : deliveries still in the buffer when the round closes
    round_time : simulated time of the last flush (0.0 when nothing
                 flushed): the round ends there, not at the slowest
                 straggler
    """
    flushes: List[np.ndarray]
    pending: np.ndarray
    round_time: float


def plan_flushes(sim_times: Sequence[float], buffer_size: int) -> FlushPlan:
    """FedBuff flushes on a virtual clock: deliveries arrive at
    ``sim_times`` and the server flushes every ``buffer_size`` arrivals (0:
    one synchronous flush of everything).  Arrivals after the last full
    buffer stay pending, so fewer than ``buffer_size`` arrivals flush
    nothing.  Ties break by position (a stable sort)."""
    t = np.asarray(sim_times, np.float64)
    if t.ndim != 1 or t.size == 0:
        raise ValueError(f"sim_times must be a non-empty 1-D sequence; "
                         f"got shape {t.shape}")
    if t.min() < 0:
        raise ValueError(f"negative sim_time {t.min()}")
    order = np.argsort(t, kind="stable")
    C = t.size
    K = C if buffer_size <= 0 else int(buffer_size)
    n_full = C // K
    flushes = [order[j * K:(j + 1) * K] for j in range(n_full)]
    pending = order[n_full * K:]
    round_time = float(t[flushes[-1][-1]]) if flushes else 0.0
    return FlushPlan(flushes=flushes, pending=pending,
                     round_time=round_time)


@dataclasses.dataclass
class BufferEntry:
    """One delivered, not yet flushed client delta in the async buffer; it
    is aggregated exactly once, however many rounds later."""
    delta: Any            # f32 trainable-subtree delta against the pull
    weight: float         # Eq. 1 sample weight (completed-step scaled)
    loss: Any             # the client's mean local loss (0-d tensor)
    pulled_version: int   # server version when the client pulled params
    arrival_time: float   # absolute virtual-clock delivery time
    stage: int            # progressive stage the delta trains
    cohort: int           # cohort index within its round


@dataclasses.dataclass
class Flush:
    """One server flush: its entries, each entry's staleness (server
    versions since its pull), the version it updates and its time."""
    entries: List[BufferEntry]
    staleness: np.ndarray
    version: int
    time: float


class AsyncServerState:
    """The buffered-async server's state across rounds.

    entries : deliveries waiting for a flush
    version : server parameter version, one bump per flush; an entry's
              staleness at its flush is ``version - pulled_version``
    clock   : absolute virtual time of the last flush
    """

    def __init__(self):
        self.entries: List[BufferEntry] = []
        self.version: int = 0
        self.clock: float = 0.0

    def __len__(self) -> int:
        return len(self.entries)

    def evict_stale(self, max_staleness: Optional[int]) -> List[BufferEntry]:
        """Drop (and return) the entries more than ``max_staleness``
        versions behind (``None``: none), checked at round open."""
        if max_staleness is None:
            return []
        keep, evicted = [], []
        for e in self.entries:
            dest = (evicted if self.version - e.pulled_version
                    > max_staleness else keep)
            dest.append(e)
        self.entries = keep
        return evicted

    def drop_retired_stages(self, current_stage: int) -> List[BufferEntry]:
        """Drop (and return) the entries of stages before
        ``current_stage``: under a schedule that never revisits a stage
        they can never flush."""
        keep = [e for e in self.entries if e.stage >= current_stage]
        dropped = [e for e in self.entries if e.stage < current_stage]
        self.entries = keep
        return dropped

    def schedule(self, new_entries: Sequence[BufferEntry], buffer_size: int,
                 stage: int) -> List[Flush]:
        """Admit a round's deliveries and plan its flushes: pending entries
        of ``stage`` merge with the new ones in delivery order, other
        stages' entries stay untouched.  Every flush bumps ``version``;
        flushed entries leave the buffer."""
        eligible = [e for e in self.entries if e.stage == stage]
        held = [e for e in self.entries if e.stage != stage]
        eligible.extend(new_entries)
        if not eligible:
            return []
        plan = plan_flushes([e.arrival_time for e in eligible], buffer_size)
        flushes = []
        for idx in plan.flushes:
            group = [eligible[i] for i in idx]
            staleness = np.asarray(
                [self.version - e.pulled_version for e in group], int)
            flushes.append(Flush(entries=group, staleness=staleness,
                                 version=self.version,
                                 time=float(group[-1].arrival_time)))
            self.version += 1
        self.entries = held + [eligible[i] for i in plan.pending]
        if flushes:
            self.clock = max(self.clock, flushes[-1].time)
        return flushes

    # the checkpoint's "async" slot, in the reference's format and layout
    def state_dict(self):
        """``(arrays, meta)``: per stage, the stacked f32 deltas (CPU
        tensors in the reference's layout, the conv weights' last four
        axes permuted, ``bridge.reference_layout(lead=1)``) and per-entry
        ``weight`` (f64), ``loss`` (f32), ``pulled_version`` (i64),
        ``arrival_time`` (f64) and ``cohort`` (i64); ``meta`` the version,
        the clock and the buffer order as a per-entry stage list (flush
        planning breaks ties by position).  Every delta must be
        materialised, as it is between rounds."""
        for e in self.entries:
            if e.delta is None:
                raise ValueError(
                    "cannot serialize AsyncServerState mid-round: a buffer "
                    "entry has no materialized delta")
        order = [int(e.stage) for e in self.entries]
        arrays = {}
        for t in sorted(set(order)):
            es = [e for e in self.entries if e.stage == t]
            arrays[f"stage_{t}"] = {
                "delta": bridge.reference_layout(
                    tree_map(lambda *xs: torch.stack(xs).float(),
                             *[e.delta for e in es]), lead=1),
                "weight": torch.tensor([e.weight for e in es],
                                       dtype=torch.float64),
                "loss": torch.stack([torch.as_tensor(e.loss).reshape(())
                                     .float().cpu() for e in es]),
                "pulled_version": torch.tensor(
                    [e.pulled_version for e in es], dtype=torch.int64),
                "arrival_time": torch.tensor([e.arrival_time for e in es],
                                             dtype=torch.float64),
                "cohort": torch.tensor([e.cohort for e in es],
                                       dtype=torch.int64),
            }
        meta = {"version": int(self.version), "clock": float(self.clock),
                "stages": order}
        return arrays, meta

    @classmethod
    def arrays_like(cls, adapter, params, meta):
        """A template of ``state_dict``'s arrays for ``load_checkpoint``:
        meta tensors (no storage) shaped as the reference lays out each
        stage's trainable subtree under the entry axis."""
        counts: Dict[int, int] = {}
        for t in meta["stages"]:
            counts[int(t)] = counts.get(int(t), 0) + 1
        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        like = {}
        for t, n in sorted(counts.items()):
            trainable = adapter.split_stage(params, t)[1]
            like[f"stage_{t}"] = {
                "delta": bridge.reference_permuted(tree_map(
                    lambda x, n=n: empty((n, *x.shape), torch.float32),
                    trainable), lead=1),
                "weight": empty(n, torch.float64),
                "loss": empty(n, torch.float32),
                "pulled_version": empty(n, torch.int64),
                "arrival_time": empty(n, torch.float64),
                "cohort": empty(n, torch.int64)}
        return like

    @classmethod
    def from_state_dict(cls, meta, arrays, device: DeviceLike = None
                        ) -> "AsyncServerState":
        """The buffer ``state_dict`` saved: the same entries in the same
        order, version and clock, each delta in the port's layout on
        ``device`` in storage of its own, each loss a 0-d tensor there."""
        dev = resolve_device(device)
        state = cls()
        state.version = int(meta["version"])
        state.clock = float(meta["clock"])
        stages = {k: dict(g, delta=bridge.from_reference(g["delta"], dev,
                                                         lead=1),
                          loss=torch.as_tensor(g["loss"]).to(dev))
                  for k, g in arrays.items()}
        cursor: Dict[int, int] = {}
        for s in meta["stages"]:
            s = int(s)
            i = cursor.get(s, 0)
            cursor[s] = i + 1
            g = stages[f"stage_{s}"]
            state.entries.append(BufferEntry(
                delta=tree_map(lambda x, i=i: x[i].clone(), g["delta"]),
                weight=float(g["weight"][i]),
                loss=g["loss"][i].clone(),
                pulled_version=int(g["pulled_version"][i]),
                arrival_time=float(g["arrival_time"][i]),
                stage=s, cohort=int(g["cohort"][i])))
        return state


class AsyncBufferedRuntime(VectorizedRuntime):
    """FedBuff-style buffered-async server on a simulated clock (port of
    the reference's ``AsyncBufferedRuntime``).

    Each ``run_round`` opens at the server's virtual clock and version:
    the cohorts pull the round's params (``pulled_version``), train as the
    vectorized runtime's cohorts do (one captured cohort step, replayed E
    times, its graphs released after the last), and deliver their deltas
    ``num_batches / speed`` later.  The server flushes every K deliveries
    (``buffer_size``; 0: everything delivered this round): Eq. 1 over the
    flushed deltas, each weight scaled by its own staleness discount (true
    versions behind), times ``server_lr``; every flush bumps the version.
    Deliveries after the last full buffer stay in the persistent
    ``AsyncServerState`` and flush in a later round of their stage; a
    pending delta is a copy with storage of its own, so that it does not
    keep the round's (C, ...) stack alive.  Cohorts of weight 0 never
    deliver.  ``max_staleness`` evicts entries more than that many
    versions behind at round open (off by default).  The round's simulated
    time runs from its open to its last flush (0 when nothing flushed).
    With K = C a fresh server's one flush at staleness 0 is the
    vectorized round.

    With ``mesh``, ``model_parallel != 1`` or in a world of more than one
    rank (``torch.distributed``) the local training is the sharded
    runtime's (``ShardedRuntime.cohort_deltas``, on ``make_host_mesh``'s
    mesh unless one is given): each rank trains its block of cohorts,
    writes its deltas into a zero (C, ...) stack and all-reduces it over
    "data", so every rank holds every cohort's delta (model shards stay
    shards).  From there the
    flushes, the buffer and the checkpoint slot run as in one process,
    the same on every rank: the host numbers (deliveries, flushes,
    staleness, versions, clock) are those of the one-process runtime.  A
    pending entry keeps this rank's model shard; ``checkpoint_state``
    gathers it, ``load_server_state`` cuts it again."""

    name = "async"

    def __init__(self, adapter: Adapter, optimizer, hp: CurriculumHP,
                 device: torch.device, capture: bool = True, *,
                 buffer_size: int = 0,
                 staleness_schedule: str = "polynomial",
                 staleness_alpha: float = 0.5, server_lr: float = 1.0,
                 client_speeds=None, max_staleness: Optional[int] = None,
                 mesh=None, model_parallel: int = 1, axis: str = "data",
                 model_axis: str = "model"):
        super().__init__(adapter, optimizer, hp, device, capture)
        on_mesh = (mesh is not None or model_parallel != 1
                   or (dist.is_initialized() and dist.get_world_size() > 1))
        self._sharded = (ShardedRuntime(
            adapter, optimizer, hp, device, capture, mesh=mesh, axis=axis,
            model_axis=model_axis, model_parallel=model_parallel)
            if on_mesh else None)
        self.mesh = None if self._sharded is None else self._sharded.mesh
        agg.staleness_discount(np.zeros(1), staleness_schedule,
                               staleness_alpha)    # validate eagerly
        self.buffer_size = int(buffer_size)
        self.staleness_schedule = staleness_schedule
        self.staleness_alpha = float(staleness_alpha)
        self.server_lr = float(server_lr)
        self.client_speeds = client_speeds
        self.max_staleness = (None if max_staleness is None
                              else int(max_staleness))
        self.state = AsyncServerState()

    @property
    def model_shards(self) -> int:
        return 1 if self._sharded is None else self._sharded.model_shards

    @property
    def held_trainable_bytes(self) -> Optional[int]:
        """On a mesh, the sharded runtime's (one copy of the last round's
        trainable tree as this rank holds it)."""
        return (None if self._sharded is None
                else self._sharded.held_trainable_bytes)

    def release(self) -> None:
        super().release()
        if self._sharded is not None:
            self._sharded.release()

    def reset_state(self):
        """A fresh server: empty buffer, version 0, clock 0."""
        self.state = AsyncServerState()

    def load_server_state(self, state: AsyncServerState):
        """Install a restored ``AsyncServerState``; on a model-sharded mesh
        each entry's delta is cut to this rank's shard."""
        if self.model_shards > 1:
            for e in state.entries:
                e.delta = self._sharded.place.shard(e.stage, e.delta)
        self.state = state

    def checkpoint_state(self):
        """The checkpoint's ``async`` slot, ``(arrays, meta)`` of
        ``AsyncServerState.state_dict``, every delta whole: on a
        model-sharded mesh each entry's shards are gathered (a collective:
        every rank calls it)."""
        if self.model_shards == 1:
            return self.state.state_dict()
        whole = AsyncServerState()
        whole.version, whole.clock = self.state.version, self.state.clock
        whole.entries = [dataclasses.replace(
            e, delta=self._sharded.place.unshard(e.stage, e.delta))
            for e in self.state.entries]
        return whole.state_dict()

    def cohort_sim_times(self, stack: RoundStack,
                         cohorts: Optional[Sequence[int]] = None
                         ) -> np.ndarray:
        """Simulated delivery durations: completed steps / client speed.
        ``client_speeds`` is a ``{client_id: speed}`` dict or anything with
        ``speeds(ids)`` (the streaming ``Fleet``)."""
        steps = np.asarray(stack.num_batches, np.float64)
        if self.client_speeds is None or cohorts is None:
            return steps
        if hasattr(self.client_speeds, "speeds"):
            speeds = np.asarray(self.client_speeds.speeds(list(cohorts)),
                                np.float64)
        else:
            speeds = np.asarray([self.client_speeds.get(c, 1.0)
                                 for c in cohorts], np.float64)
        return steps / np.maximum(speeds, 1e-9)

    def _run_stack(self, t, trainable, frozen, stack: RoundStack, *,
                   sim_times: Optional[Sequence[float]] = None,
                   cohorts=None):
        """One buffered-async round (through ``run_stacked``); advances
        the server's buffer, version and clock (``reset_state`` for a fresh
        server).  ``sim_times`` are per-cohort delivery durations from the
        round's open (default: the step counts, unit speed).  Metrics add
        ``staleness`` (per cohort of this stack, -1 pending or crashed),
        ``n_pending``, ``n_uploads``, ``n_carried``, ``n_evicted``,
        ``server_version`` and ``sim_round_time``."""
        C = stack.num_cohorts
        weights = np.asarray(stack.weights, np.float64)
        times = np.asarray(self.cohort_sim_times(stack)
                           if sim_times is None else sim_times, np.float64)
        if self._sharded is None:
            locals_, losses = self._train_cohorts(t, trainable, frozen,
                                                  stack)
            # deltas against the pull-time params, in f32
            deltas = tree_map(lambda loc, base: loc.float() - base.float(),
                              locals_, trainable)
            del locals_
            base = trainable
        else:
            deltas, losses, base = self._sharded.cohort_deltas(
                t, trainable, frozen, stack, cohorts)
        active = np.flatnonzero(weights > 0)    # weight 0: never delivers
        round_open = self.state.clock
        pulled = self.state.version
        evicted = self.state.evict_stale(self.max_staleness)
        # this round's deliveries read the stacked deltas (one gather a
        # flush); the pending tail copies its own slice below
        new_entries = [
            BufferEntry(delta=None, weight=float(weights[i]), loss=losses[i],
                        pulled_version=pulled,
                        arrival_time=round_open + float(times[i]),
                        stage=t, cohort=int(i))
            for i in active]
        new_ids = {id(e) for e in new_entries}
        flushes = self.state.schedule(new_entries, self.buffer_size, t)
        for e in self.state.entries:
            if e.delta is None:               # this round's pending tail
                e.delta = tree_map(lambda x, i=e.cohort: x[i].clone(),
                                   deltas)
                e.loss = e.loss.clone()

        new_tr = tree_map(lambda b: b.float(), base)
        staleness = np.full(C, -1, int)
        eff_w, flushed_losses, n_flushed, n_carried = [], [], 0, 0
        for fl in flushes:
            # fresh deliveries (one gather from the stacked deltas) before
            # carried ones, as the reference stacks them: Eq. 1 commutes,
            # but its f32 sums do not reassociate exactly
            pairs = list(zip(fl.entries, fl.staleness))
            fresh = [(e, s) for e, s in pairs if id(e) in new_ids]
            carried = [(e, s) for e, s in pairs if id(e) not in new_ids]
            parts = []
            if fresh:
                pos = to_device(np.asarray([e.cohort for e, _ in fresh]),
                                self.device)
                parts.append(tree_map(lambda x: x[pos], deltas))
            if carried:
                parts.append(tree_map(lambda *xs: torch.stack(xs),
                                      *[e.delta for e, _ in carried]))
            stacked = parts[0] if len(parts) == 1 else tree_map(
                lambda a, b: torch.cat([a, b]), *parts)
            ordered = fresh + carried
            update, d = agg.buffered_flush_average(
                stacked, [e.weight for e, _ in ordered],
                [s for _, s in ordered], schedule=self.staleness_schedule,
                alpha=self.staleness_alpha)
            del stacked
            new_tr = tree_map(lambda b, u: b + self.server_lr * u.float(),
                              new_tr, update)
            for (e, s), di in zip(ordered, d):
                n_flushed += 1
                n_carried += id(e) not in new_ids
                if id(e) in new_ids:
                    staleness[e.cohort] = int(s)
                eff_w.append(e.weight * float(di))
                flushed_losses.append(e.loss)
        new_trainable = tree_map(lambda b, ref: b.to(ref.dtype), new_tr,
                                 base)
        if self._sharded is not None:
            new_trainable = self._sharded.place.unshard(t, new_trainable)
        if n_flushed:
            w = to_device((np.asarray(eff_w) / np.sum(eff_w))
                          .astype(np.float32), self.device)
            mean_loss = (torch.stack(flushed_losses) * w).sum()
        else:
            # deliveries only buffered: params unchanged, nothing averaged
            mean_loss = torch.full((), float("nan"), device=self.device)
        return new_trainable, {
            "mean_local_loss": mean_loss,
            "cohort_losses": losses,
            "staleness": staleness,
            "n_pending": len(self.state),
            "n_uploads": n_flushed,
            "n_carried": n_carried,
            "n_evicted": len(evicted),
            "server_version": self.state.version,
            "sim_round_time": (max(0.0, flushes[-1].time - round_open)
                               if flushes else 0.0)}

    def _round_from_stack(self, params, t, stack, cohorts):
        sim_times = self.cohort_sim_times(stack, cohorts)
        new_trainable, metrics = self.run_stacked(params, t, stack,
                                                  sim_times=sim_times,
                                                  cohorts=cohorts)
        return new_trainable, metrics, {
            "sim_times": [float(x) for x in sim_times],
            "round_sim_time": float(metrics["sim_round_time"]),
            "n_uploads": metrics["n_uploads"]}

    def _lost_round_extras(self, stack, cohorts):
        # nothing delivered, nothing flushed, the clock never advanced:
        # not the synchronous straggler time of a barrier never held
        return {"round_sim_time": 0.0,
                "sim_times": [0.0] * stack.num_cohorts}

    def _flush_program(self):
        """flush(stacked_deltas) -> update: one buffered flush of K f32
        deltas at weight 1 and staleness 0 (weights and staleness are host
        numbers at flush time)."""
        schedule, alpha = self.staleness_schedule, self.staleness_alpha

        def flush(stacked):
            K = tree_leaves(stacked)[0].shape[0]
            update, _ = agg.buffered_flush_average(
                stacked, [1.0] * K, [0] * K, schedule=schedule, alpha=alpha)
            return update

        return flush

    def trace_specs(self, params, t, stack):
        """The local training and the flush seam.  On a mesh the local
        training is this rank's block (every rank runs it) and the seam
        starts from a block of stand-in locals: their exchange over "data"
        (every cohort's delta on every rank), then the flush."""
        frozen, trainable = self.adapter.split_stage(params, t)
        n_leaves = len(tree_leaves(trainable))
        flush = self._flush_program()
        if self._sharded is None:
            batches, _, mask = self._device_stack(stack)
            C = stack.num_cohorts
            deltas = tree_map(lambda p: torch.zeros(
                (C, *p.shape), device=p.device), trainable)
            return [RoundProgramSpec(
                name=f"async/stage{t}/local", backend=self.name,
                kind="local",
                fn=make_local_program(self.adapter, self.optimizer, self.hp,
                                      t),
                args=(trainable, frozen, batches, mask), stage=t),
                RoundProgramSpec(
                    name=f"async/stage{t}/flush-seam", backend=self.name,
                    kind="aggregation", fn=flush, args=(deltas,), stage=t,
                    n_agg_leaves=n_leaves)]
        sh = self._sharded
        kw = dict(sh._mesh_spec(t, n_leaves), backend=self.name)
        start, weights, locals_, losses, held = sh._block_of_locals(
            t, trainable, stack)

        def exchange_and_flush(locals_, held, losses):
            deltas, _ = sh._exchange_deltas(start, len(weights),
                                            stack.num_cohorts, locals_,
                                            held, losses)
            return flush(deltas)

        return [RoundProgramSpec(
            name=f"async/stage{t}/local", kind="local",
            fn=functools.partial(sh._train_block, t),
            args=(trainable, frozen, stack), **dict(kw, n_agg_leaves=0)),
            RoundProgramSpec(
                name=f"async/stage{t}/flush-seam", kind="aggregation",
                fn=exchange_and_flush, args=(locals_, held, losses), **kw)]


RUNTIMES = {"sequential": SequentialRuntime,
            "vectorized": VectorizedRuntime,
            "sharded": ShardedRuntime,
            "async": AsyncBufferedRuntime}


def make_runtime(spec: Union[str, ClientRuntime], adapter: Adapter,
                 optimizer, hp: CurriculumHP, device: torch.device,
                 **kwargs) -> ClientRuntime:
    """Resolve a runtime name (``FLConfig.runtime``) into a runtime built
    with ``kwargs``, or pass an already-constructed ``ClientRuntime``
    through unchanged (constructor kwargs beside an instance raise: they
    would be dropped)."""
    if isinstance(spec, ClientRuntime):
        if kwargs:
            raise ValueError(
                f"make_runtime got an already-constructed "
                f"{type(spec).__name__} AND constructor kwargs "
                f"{sorted(kwargs)} — those would be silently ignored; "
                f"configure the instance directly or pass the runtime "
                f"name instead")
        return spec
    try:
        cls = RUNTIMES[spec]
    except KeyError:
        raise ValueError(f"unknown runtime {spec!r}; the port has "
                         f"{sorted(RUNTIMES)}") from None
    return cls(adapter, optimizer, hp, device, **kwargs)
