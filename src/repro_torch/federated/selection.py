"""Client selection policies (numpy-only copy of
``repro.federated.selection``).

* NeuLite / inclusive methods: uniform random among devices whose memory fits
  the *current stage's* requirement (paper: "selects 10% devices based on
  their available memory").
* TiFL (Chai et al. 2020): tier devices by profiled round time, pick a tier
  (credit-based), then sample within it.
* Oort (Lai et al. 2021): utility = statistical utility (recent loss) ×
  (T_desired / T_i)^penalty system factor, ε-greedy exploration.

Two layers:

* the historical **functional API** (``memory_feasible`` / ``tifl_select``
  / ``oort_select``) over materialized ``DeviceProfile`` lists — the
  baselines' path, O(population) per call;
* **policy classes** (``RandomPolicy`` / ``TiFLPolicy`` / ``OortPolicy``,
  built by ``make_policy`` from ``FLConfig.selection``) over a streaming
  ``Fleet``: candidates are never enumerated — memory feasibility is
  decided analytically per tier and cohorts are drawn by the fleet at
  O(cohort) cost, so round opening stays flat from 10^2 to 10^6 clients.
  Policy state (TiFL credits, Oort utilities) is O(tiers + participants),
  not O(population).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.federated.devices import DeviceProfile, Fleet


def memory_feasible(devices: Sequence[DeviceProfile],
                    required_bytes: int) -> List[int]:
    return [d.device_id for d in devices if d.mem_bytes >= required_bytes]


def random_select(rng: np.random.Generator, candidates: Sequence[int],
                  k: int) -> List[int]:
    if len(candidates) == 0:
        return []
    k = min(k, len(candidates))
    return list(rng.choice(np.asarray(candidates), size=k, replace=False))


# --------------------------------------------------------------------------- #
# TiFL
# --------------------------------------------------------------------------- #
def tifl_select(rng: np.random.Generator, devices: Sequence[DeviceProfile],
                candidates: Sequence[int], k: int, n_tiers: int = 5,
                credits: Dict[int, int] | None = None) -> List[int]:
    """Tier-based selection over a materialized device list.

    Credit bookkeeping contract: a tier's credit is spent only when the
    tier actually yields clients (an empty pool costs nothing), credits
    never go below zero, and when every non-empty tier is exhausted the
    credit table replenishes deterministically (one credit per non-empty
    tier) instead of silently ignoring itself forever.
    """
    cand = [d for d in devices if d.device_id in set(candidates)]
    if not cand:
        return []
    times = np.array([1.0 / d.speed for d in cand])
    order = np.argsort(times)
    tiers = np.array_split(order, n_tiers)
    nonempty = [t for t in range(n_tiers) if len(tiers[t])]
    credited = [t for t in nonempty
                if credits is None or credits.get(t, 1) > 0]
    if not credited:
        # all candidate tiers out of credit: deterministic replenish —
        # every non-empty tier gets one credit and stays selectable
        for t in nonempty:
            credits[t] = 1
        credited = nonempty
    tier = credited[int(rng.integers(len(credited)))]
    pool = [cand[i].device_id for i in tiers[tier]]
    selected = random_select(rng, pool, k)
    if credits is not None and selected:
        # spend only on a successful pick, and never below zero
        credits[tier] = max(credits.get(tier, 1) - 1, 0)
    return selected


# --------------------------------------------------------------------------- #
# Oort
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class OortState:
    util: Dict[int, float] = dataclasses.field(default_factory=dict)
    last_round: Dict[int, int] = dataclasses.field(default_factory=dict)
    epsilon: float = 0.3
    t_desired: float = 1.0
    alpha: float = 2.0


def oort_update(state: OortState, device_id: int, stat_loss: float,
                round_idx: int):
    state.util[device_id] = float(stat_loss)
    state.last_round[device_id] = round_idx


def _oort_scores(state: OortState, explored: Sequence[int],
                 speeds: np.ndarray, round_idx: int) -> List[float]:
    scores = []
    for c, speed in zip(explored, speeds):
        sys_f = min(1.0, (state.t_desired * float(speed))) ** state.alpha
        staleness = np.sqrt(
            0.1 * (round_idx - state.last_round.get(c, 0) + 1))
        scores.append(state.util[c] * sys_f + staleness)
    return scores


def oort_select(rng: np.random.Generator, devices: Sequence[DeviceProfile],
                candidates: Sequence[int], k: int, state: OortState,
                round_idx: int) -> List[int]:
    if not candidates:
        return []
    k = min(k, len(candidates))
    n_exploit = int(round(k * (1 - state.epsilon)))
    dev_map = {d.device_id: d for d in devices}
    explored = [c for c in candidates if c in state.util]
    speeds = np.asarray([dev_map[c].speed for c in explored])
    scores = _oort_scores(state, explored, speeds, round_idx)
    chosen: List[int] = []
    if explored and n_exploit > 0:
        top = np.argsort(scores)[::-1][:n_exploit]
        chosen = [explored[i] for i in top]
    rest = [c for c in candidates if c not in chosen]
    chosen += random_select(rng, rest, k - len(chosen))
    return chosen


# --------------------------------------------------------------------------- #
# streaming policies (Fleet-backed, O(cohort) per round)
# --------------------------------------------------------------------------- #
class SelectionPolicy:
    """One FL round's cohort from a streaming ``Fleet``.

    ``select`` returns ``(selected_ids, n_feasible)`` — ``n_feasible`` is
    the fleet's memory-feasible device count (exact for small populations,
    the analytic expectation for large ones).  ``observe`` feeds back the
    round's per-cohort losses (Oort's statistical utility); the base
    implementation ignores it.
    """

    name = "random"

    def select(self, rng: np.random.Generator, fleet: Fleet, k: int,
               required_bytes: int,
               round_idx: int) -> Tuple[List[int], int]:
        raise NotImplementedError

    def observe(self, selected: Sequence[int], losses: Sequence[float],
                round_idx: int) -> None:
        pass

    # -- checkpoint/resume seam -------------------------------------------- #
    def state_dict(self) -> dict:
        """JSON-able mutable policy state (TiFL credits, Oort utilities)
        for exact server resume; stateless policies persist nothing.
        Constructor configuration (epsilon, credits_per_tier, ...) is NOT
        included — the restoring server rebuilds the policy from its own
        ``FLConfig`` and only the accumulated state transfers."""
        return {}

    def load_state_dict(self, state: dict) -> None:
        if state:
            raise ValueError(
                f"{type(self).__name__} is stateless but the checkpoint "
                f"carries selector state {sorted(state)} — selection "
                f"policy mismatch between save and restore")


class RandomPolicy(SelectionPolicy):
    """Uniform among memory-feasible devices (the paper's NeuLite rule)."""

    name = "random"

    def select(self, rng, fleet, k, required_bytes, round_idx):
        selected = fleet.sample_cohort(rng, k, required_bytes)
        return selected, fleet.feasible_count(required_bytes)


class TiFLPolicy(SelectionPolicy):
    """TiFL over fleet speed tiers: pick a credited tier uniformly among
    tiers with any memory-feasible member (decided analytically), then
    sample the cohort inside it.  Credits follow the ``tifl_select``
    contract: spent only on successful picks, never negative,
    deterministic replenish when all feasible tiers are exhausted."""

    name = "tifl"

    def __init__(self, credits_per_tier: int = 10 ** 9):
        self.credits_per_tier = int(credits_per_tier)
        self.credits: Dict[int, int] = {}

    def select(self, rng, fleet, k, required_bytes, round_idx):
        n_feasible = fleet.feasible_count(required_bytes)
        prob = fleet.tier_feasible_prob(required_bytes) * fleet.tier_fracs
        avail = [t for t in range(fleet.n_tiers) if prob[t] > 0]
        if not avail:
            return [], n_feasible
        credited = [t for t in avail
                    if self.credits.get(t, self.credits_per_tier) > 0]
        if not credited:
            for t in avail:
                self.credits[t] = 1
            credited = avail
        tier = credited[int(rng.integers(len(credited)))]
        selected = fleet.sample_cohort(rng, k, required_bytes, tier=tier)
        if selected:
            self.credits[tier] = max(
                self.credits.get(tier, self.credits_per_tier) - 1, 0)
        return selected, n_feasible

    def state_dict(self) -> dict:
        # JSON object keys are strings; load converts back to int tiers
        return {"credits": {str(t): int(c)
                            for t, c in self.credits.items()}}

    def load_state_dict(self, state: dict) -> None:
        self.credits = {int(t): int(c)
                        for t, c in state.get("credits", {}).items()}


class OortPolicy(SelectionPolicy):
    """Oort ε-greedy over the fleet: exploit the top-utility *explored*
    devices (state is O(participants) — the only ids ever held), explore
    the rest of the cohort uniformly from the feasible population."""

    name = "oort"

    def __init__(self, epsilon: float = 0.3, t_desired: float = 1.0,
                 alpha: float = 2.0):
        self.state = OortState(epsilon=epsilon, t_desired=t_desired,
                               alpha=alpha)

    def select(self, rng, fleet, k, required_bytes, round_idx):
        n_feasible = fleet.feasible_count(required_bytes)
        k = int(min(k, max(n_feasible, 0)))
        if k <= 0:
            return [], n_feasible
        n_exploit = int(round(k * (1 - self.state.epsilon)))
        explored = sorted(self.state.util)
        if explored:
            feasible = fleet.mem_bytes(explored) >= int(required_bytes)
            explored = [c for c, ok in zip(explored, feasible) if ok]
        chosen: List[int] = []
        if explored and n_exploit > 0:
            scores = _oort_scores(self.state, explored,
                                  fleet.speeds(explored), round_idx)
            top = np.argsort(scores)[::-1][:n_exploit]
            chosen = [explored[i] for i in top]
        need = k - len(chosen)
        if need > 0:
            # explore: fresh feasible devices from the full population
            pool = fleet.sample_cohort(rng, need + len(chosen),
                                       required_bytes)
            fresh = [c for c in pool if c not in set(chosen)]
            chosen += fresh[:need]
        return chosen, n_feasible

    def observe(self, selected, losses, round_idx):
        for cid, loss in zip(selected, losses):
            if np.isfinite(loss):
                oort_update(self.state, int(cid), float(loss), round_idx)

    def state_dict(self) -> dict:
        return {"util": {str(c): float(u)
                         for c, u in self.state.util.items()},
                "last_round": {str(c): int(r)
                               for c, r in self.state.last_round.items()}}

    def load_state_dict(self, state: dict) -> None:
        self.state.util = {int(c): float(u)
                           for c, u in state.get("util", {}).items()}
        self.state.last_round = {
            int(c): int(r) for c, r in state.get("last_round", {}).items()}


POLICIES = {"random": RandomPolicy, "tifl": TiFLPolicy, "oort": OortPolicy}


def make_policy(spec, **kwargs) -> SelectionPolicy:
    """Resolve ``FLConfig.selection`` ("random" | "tifl" | "oort") or pass
    an already-constructed policy through unchanged."""
    if isinstance(spec, SelectionPolicy):
        if kwargs:
            raise ValueError(
                f"make_policy got an already-constructed "
                f"{type(spec).__name__} AND constructor kwargs "
                f"{sorted(kwargs)} — configure the instance directly")
        return spec
    try:
        cls = POLICIES[spec]
    except KeyError:
        raise ValueError(f"unknown selection policy {spec!r}; "
                         f"choose from {sorted(POLICIES)}") from None
    return cls(**kwargs)
