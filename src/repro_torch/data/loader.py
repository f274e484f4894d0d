"""Batching pipeline: per-client epochs + cohort batch stacks.

``Batcher`` yields fixed-shape batches (sub-batch remainders are dropped
per epoch; datasets smaller than one batch are filled by resampling).
``stack_round`` materializes the ``(C, E, ...)`` cohort batch stack that
the vectorized / mesh-sharded ``ClientRuntime`` backends consume as one
array program input.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


class Batcher:
    """Yields fixed-shape batches (jit-friendly).

    An epoch yields ``floor(n / batch_size)`` full batches; the remainder is
    dropped for that epoch (each epoch reshuffles, so coverage rotates).
    Only when ``len(ds) < batch_size`` does the epoch resample examples to
    fill the single batch it yields.  Resampled duplicates must NOT inflate
    FedAvg weights — ``num_samples`` always reports the *true*
    (deduplicated) dataset size, and aggregation weighting goes through it
    rather than counting batch rows.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 kind: str = "image"):
        self.ds = dataset
        self.bs = batch_size
        self.rng = np.random.default_rng(seed)
        self.kind = kind

    @property
    def num_samples(self) -> int:
        """True sample count — excludes wraparound resampling duplicates."""
        return len(self.ds)

    @property
    def steps_per_epoch(self) -> int:
        return max(1, len(self.ds) // self.bs)

    def epoch(self):
        n = len(self.ds)
        order = self.rng.permutation(n)
        if n < self.bs:
            order = np.concatenate(
                [order, self.rng.choice(n, self.bs - n, replace=True)])
            n = self.bs
        for i in range(0, n - self.bs + 1, self.bs):
            idx = order[i : i + self.bs]
            yield self.make_batch(idx)

    def batches(self, num_steps: int):
        """Exactly ``num_steps`` batches, cycling shuffled epochs as needed."""
        done = 0
        while done < num_steps:
            for batch in self.epoch():
                yield batch
                done += 1
                if done == num_steps:
                    return

    def make_batch(self, idx):
        if self.kind == "image":
            return {"inputs": {"images": self.ds.images[idx]},
                    "labels": self.ds.labels[idx]}
        toks = self.ds.tokens[idx]
        return {"inputs": {"tokens": toks[:, :-1]},
                "labels": toks[:, 1:]}

    def sample(self, batch_size=None):
        bs = batch_size or self.bs
        idx = self.rng.integers(0, len(self.ds), bs)
        return self.make_batch(idx)


@dataclasses.dataclass
class RoundStack:
    """One FL round's cohort data as a single array program input.

    batches   : pytree with leading (C, E, ...) axes — C cohorts × E local
                steps of per-cohort data (numpy; runtimes move it on device)
    step_mask : (C, E) bool — False marks padding steps (cohorts with fewer
                true local steps than the widest cohort); masked steps are
                exact no-ops for params and optimizer state
    weights   : (C,) float32 — true per-cohort sample counts (Eq. 1 weights)
    num_batches : true (unpadded) local step count per cohort
    """
    batches: dict
    step_mask: np.ndarray
    weights: np.ndarray
    num_batches: List[int]

    @property
    def num_cohorts(self) -> int:
        return len(self.num_batches)

    @property
    def max_steps(self) -> int:
        return int(self.step_mask.shape[1])


def _stack_trees(trees):
    """Stack the leaves of equally shaped dict trees on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def stack_round(batchers: Sequence[Batcher],
                cohorts: Optional[Sequence[int]] = None,
                local_steps: Optional[int] = None, *,
                local_epochs: Optional[int] = None) -> RoundStack:
    """Materialize the (C, E, ...) batch stack for a vectorized FL round.

    cohorts selects which batchers participate (default: all).  Pass either
    ``local_steps`` (uniform step count per cohort) or ``local_epochs``
    (each cohort runs ``local_epochs * steps_per_epoch`` true steps — the
    sequential reference semantics).  Cohorts with fewer true steps than the
    widest cohort are padded with repeated batches masked out of training.
    """
    if (local_steps is None) == (local_epochs is None):
        raise ValueError("pass exactly one of local_steps / local_epochs")
    if cohorts is None:
        cohorts = range(len(batchers))
    picked = [batchers[c] for c in cohorts]
    if not picked:
        raise ValueError("stack_round needs at least one cohort")

    targets = [local_steps if local_steps is not None
               else local_epochs * b.steps_per_epoch for b in picked]
    E = max(targets)

    per_cohort, mask_rows = [], []
    for b, tgt in zip(picked, targets):
        seq = list(b.batches(tgt))
        seq.extend(seq[-1] for _ in range(E - tgt))      # masked padding
        per_cohort.append(_stack_trees(seq))
        mask_rows.append([True] * tgt + [False] * (E - tgt))

    return RoundStack(
        batches=_stack_trees(per_cohort),
        step_mask=np.asarray(mask_rows, bool),
        weights=np.asarray([b.num_samples for b in picked], np.float32),
        num_batches=[int(t) for t in targets])


def truncate_step_mask(stack: RoundStack,
                       completed_steps: Sequence[Optional[int]]
                       ) -> RoundStack:
    """Mid-round dropout / fault injection on a prepared ``RoundStack``.

    ``completed_steps[i]`` is the number of true local steps cohort i
    finished before dropping out (``None`` = no fault).  The cohort's mask
    row is truncated to its first ``completed_steps[i]`` true steps — the
    remaining steps become exact no-ops on every backend — and its Eq. 1
    weight is scaled by the completed fraction (completed-step-weighted
    aggregation).  A cohort that crashes before step 0 keeps zero weight;
    weights never increase, so dropout can only *shrink* a cohort's share.

    Returns a new ``RoundStack`` sharing the (immutable here) batch arrays.
    """
    if len(completed_steps) != stack.num_cohorts:
        raise ValueError(
            f"completed_steps has {len(completed_steps)} entries for "
            f"{stack.num_cohorts} cohorts")
    mask = stack.step_mask.copy()
    weights = np.asarray(stack.weights, np.float32).copy()
    num_batches = list(stack.num_batches)
    for i, done in enumerate(completed_steps):
        if done is None:
            continue
        done = int(done)
        if done < 0:
            raise ValueError(f"negative completed_steps[{i}] = {done}")
        target = num_batches[i]
        if done >= target:
            continue                      # fault after finishing: no-op
        true_pos = np.flatnonzero(mask[i])
        mask[i, true_pos[done:]] = False
        weights[i] *= done / target
        num_batches[i] = done
    return RoundStack(batches=stack.batches, step_mask=mask,
                      weights=weights, num_batches=num_batches)
