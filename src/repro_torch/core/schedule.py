"""Stage scheduling: which block trains in round r.

Two policies from the paper:

* ``PlateauSchedule`` — the base progressive paradigm (§Progressive Training):
  train block t until the server's Progress Evaluation detects convergence
  (validation-metric plateau), then freeze and grow.

* ``RoundRobinSchedule`` — the Training Harmonizer's parameter co-adaptation
  paradigm (Alg. 1, line 3: ``t = r mod T``): the model grows every round and
  cycles back to block 1 after the final block, so blocks continuously
  co-adapt.  This is NeuLite's default.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


class StageSchedule:
    # True when a stage can run again after the schedule moved past it
    # (round-robin cycling).  Monotone schedules set False, which lets the
    # async server retire pending deltas of permanently-finished stages
    # instead of stranding them in its buffer forever.  The conservative
    # default (True) never drops anything.
    revisits_stages: bool = True

    def stage(self, round_idx: int) -> int:
        raise NotImplementedError

    def observe(self, round_idx: int, metric: float) -> None:
        pass

    # -- checkpoint/resume seam -------------------------------------------- #
    def state_dict(self) -> dict:
        """JSON-able mutable state for exact server resume.  Stateless
        schedules (round-robin / sequential derive the stage from the round
        index alone) have nothing to persist."""
        return {}

    def load_state_dict(self, state: dict) -> None:
        if state:
            raise ValueError(
                f"{type(self).__name__} is stateless but the checkpoint "
                f"carries schedule state {sorted(state)} — schedule kind "
                f"mismatch between save and restore")


@dataclasses.dataclass
class RoundRobinSchedule(StageSchedule):
    """Alg. 1: t = r mod T."""
    num_stages: int

    def stage(self, round_idx: int) -> int:
        return round_idx % self.num_stages


@dataclasses.dataclass
class SequentialSchedule(StageSchedule):
    """Fixed-interval progressive training (ProgFed-style / naive PT):
    stage t for rounds [t*interval, (t+1)*interval), clamped to the last."""
    num_stages: int
    rounds_per_stage: int
    revisits_stages = False             # stages only ever advance

    def stage(self, round_idx: int) -> int:
        return min(round_idx // self.rounds_per_stage, self.num_stages - 1)


@dataclasses.dataclass
class PlateauSchedule(StageSchedule):
    """Progress Evaluation: freeze the active block when the observed metric
    (e.g. validation loss) stops improving by ``min_delta`` for ``patience``
    consecutive rounds; then grow to the next block."""
    num_stages: int
    revisits_stages = False             # stages only ever advance
    patience: int = 3
    min_delta: float = 1e-3
    max_rounds_per_stage: int = 50

    _stage: int = 0
    _best: Optional[float] = None
    _bad: int = 0
    _rounds_in_stage: int = 0
    _lost: int = 0

    def stage(self, round_idx: int) -> int:
        return self._stage

    def observe(self, round_idx: int, metric: float) -> None:
        if not math.isfinite(metric):
            # Lost rounds (empty selection / every client dropped) observe
            # NaN.  A NaN must never become ``_best`` — every later
            # ``metric < NaN - delta`` is False, so the stage would
            # force-advance after ``patience`` rounds even while the model
            # improves — and a lost round says nothing about convergence,
            # so it counts toward neither patience nor the
            # ``max_rounds_per_stage`` budget.  A run whose *every* round is
            # non-finite (divergence, not dropout) must still hit the
            # budget backstop, so consecutive lost rounds get their own
            # counter; any finite observation resets it.
            self._lost += 1
            if self._lost >= self.max_rounds_per_stage:
                self._advance()
            return
        self._lost = 0
        self._rounds_in_stage += 1
        improved = self._best is None or metric < self._best - self.min_delta
        if improved:
            self._best, self._bad = metric, 0
        else:
            self._bad += 1
        if (self._bad >= self.patience
                or self._rounds_in_stage >= self.max_rounds_per_stage):
            self._advance()

    def _advance(self) -> None:
        if self._stage < self.num_stages - 1:
            self._stage += 1
            self._best, self._bad = None, 0
            self._rounds_in_stage = self._lost = 0

    def state_dict(self) -> dict:
        return {"stage": self._stage, "best": self._best, "bad": self._bad,
                "rounds_in_stage": self._rounds_in_stage,
                "lost": self._lost}

    def load_state_dict(self, state: dict) -> None:
        self._stage = int(state["stage"])
        self._best = (None if state["best"] is None
                      else float(state["best"]))
        self._bad = int(state["bad"])
        self._rounds_in_stage = int(state["rounds_in_stage"])
        self._lost = int(state["lost"])

    @property
    def converged_all(self) -> bool:
        return (self._stage == self.num_stages - 1
                and self._bad >= self.patience)
