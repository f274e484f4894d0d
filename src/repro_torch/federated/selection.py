"""Client selection over the streaming fleet (numpy-only copy of the
random policy of ``repro.federated.selection``).

NeuLite's rule: uniform random among devices whose memory fits the *current
stage's* requirement (paper: "selects 10% devices based on their available
memory").  Candidates are never enumerated for large populations: the fleet
decides feasibility analytically per tier and draws the cohort at O(cohort)
cost.  The TiFL and Oort policies come with a later part of the port.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.federated.devices import Fleet


class SelectionPolicy:
    """One FL round's cohort from a streaming ``Fleet``.

    ``select`` returns ``(selected_ids, n_feasible)`` — ``n_feasible`` is
    the fleet's memory-feasible device count (exact for small populations,
    the analytic expectation for large ones).  ``observe`` feeds back the
    round's per-cohort losses; the base implementation ignores it.
    """

    name = "random"

    def select(self, rng: np.random.Generator, fleet: Fleet, k: int,
               required_bytes: int,
               round_idx: int) -> Tuple[List[int], int]:
        raise NotImplementedError

    def observe(self, selected: Sequence[int], losses: Sequence[float],
                round_idx: int) -> None:
        pass


class RandomPolicy(SelectionPolicy):
    """Uniform among memory-feasible devices (the paper's NeuLite rule)."""

    name = "random"

    def select(self, rng, fleet, k, required_bytes, round_idx):
        selected = fleet.sample_cohort(rng, k, required_bytes)
        return selected, fleet.feasible_count(required_bytes)


POLICIES = {"random": RandomPolicy}


def make_policy(spec: str) -> SelectionPolicy:
    """Resolve ``FLConfig.selection``."""
    try:
        cls = POLICIES[spec]
    except KeyError:
        raise ValueError(f"unknown selection policy {spec!r}; the port has "
                         f"{sorted(POLICIES)}") from None
    return cls()
