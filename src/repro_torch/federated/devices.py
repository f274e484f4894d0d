"""Simulated device fleet: memory budgets + relative compute speeds.

The paper establishes a 100-device FL system whose memory budgets follow
profiled hardware configurations (off-the-shelf devices, 4-16 GB RAM, with
only part of RAM available to training).  We reproduce that as a categorical
mix of device tiers; budgets are expressed in *bytes available for training*
and scale down with the experiment (`budget_scale`) so the tiny CPU models
see the same *relative* memory wall the paper's testbed does.

Production FL is 10^5-10^7 clients, so the fleet is **streaming**: a
``Fleet`` holds only the tier table plus scalars, and any device's profile
is a stateless counter-based PRNG lookup keyed by ``(fleet_seed,
device_id)`` (``common.prng``).  Server-side memory and per-round cost are
O(cohort) — sampling a memory-feasible cohort from a million-device
population rejection-samples against the analytic per-tier feasibility
probabilities instead of scanning a materialized list.

This is a numpy-only copy of ``repro.federated.devices``'s streaming
``Fleet``; the materialized fleet comes with a later part of the port.

Determinism contract: a device's tier depends only on ``(seed, n_devices,
device_id)`` (tiers are stratified — a seed-keyed bijection of ``[0, n)``
gives every tier its exact population share at any fleet size) and its
jitters only on ``(seed, device_id)`` — changing ``full_model_bytes``
rescales memory budgets without reshuffling the fleet (each attribute
draws from its own hash stream; the old implementation threaded one
sequential RNG through all three, so changing the model silently re-dealt
tiers and speeds).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.common.prng import permute_index, uniform01


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    device_id: int
    mem_bytes: int          # memory available for local training
    speed: float            # relative compute throughput (1.0 = median)


# tier mix modeled on the paper's hardware profiles (Jetson-class to phones)
_TIERS = [
    # (fraction of fleet, available-memory fraction of the "full" budget, speed)
    (0.25, 0.25, 0.5),
    (0.30, 0.45, 0.8),
    (0.25, 0.65, 1.0),
    (0.12, 0.85, 1.4),
    (0.08, 1.10, 2.0),
]

# memory jitter ~ U(0.9, 1.1), speed jitter ~ U(0.85, 1.15) (per device)
_MEM_JITTER = (0.9, 1.1)
_SPEED_JITTER = (0.85, 1.15)

# hash streams: one attribute, one stream — the determinism contract above
_STREAM_TIER, _STREAM_MEM, _STREAM_SPEED = 0, 1, 2

# populations at or below this are filtered exactly (one vectorized pass)
# instead of rejection-sampled; keeps small historical fleets byte-stable
# while 10^5+ populations never materialize anything
_SCAN_THRESHOLD = 4096


class Fleet:
    """Streaming device fleet: O(1) state, profiles derived on demand.

    Holds the tier table and three scalars; ``profile(i)`` /
    ``speeds(ids)`` / ``mem_bytes(ids)`` are stateless counter-PRNG
    lookups, so two fleets with the same ``(seed, n_devices)`` agree on
    every device no matter what was queried before.  ``sample_cohort`` /
    ``sample_feasible`` draw cohorts from the full population at O(cohort)
    cost: feasibility is decided analytically per tier (clipped jitter
    CDF), never by scanning a device list.
    """

    def __init__(self, seed: int, n_devices: int, full_model_bytes: int,
                 tiers: Sequence = _TIERS):
        self.seed = int(seed)
        self.n_devices = int(n_devices)
        self.full_model_bytes = int(full_model_bytes)
        t = np.asarray(tiers, np.float64)
        self.tier_fracs = t[:, 0] / t[:, 0].sum()
        self.tier_mem_frac = t[:, 1]
        self.tier_speed = t[:, 2]
        self._cum = np.cumsum(self.tier_fracs)

    @property
    def n_tiers(self) -> int:
        return len(self.tier_fracs)

    # -- per-device attribute lookups (vectorized, stateless) -------------- #
    def tier_of(self, device_ids) -> np.ndarray:
        # stratified: a seed-keyed bijection of [0, n) gives each tier
        # EXACTLY round(frac * n) members (±1) at any population size —
        # i.i.d. tier draws would leave a 10-device fleet with no
        # full-model-capable tier more often than not, so tiny test fleets
        # would go infeasible on luck alone
        pos = permute_index(self.seed, device_ids, self.n_devices,
                            stream=_STREAM_TIER)
        u = (pos.astype(np.float64) + 0.5) / self.n_devices
        return np.minimum(np.searchsorted(self._cum, u, side="right"),
                          self.n_tiers - 1)

    def speeds(self, device_ids) -> np.ndarray:
        lo, hi = _SPEED_JITTER
        jitter = lo + (hi - lo) * uniform01(self.seed, device_ids,
                                            _STREAM_SPEED)
        return self.tier_speed[self.tier_of(device_ids)] * jitter

    def mem_bytes(self, device_ids) -> np.ndarray:
        lo, hi = _MEM_JITTER
        jitter = lo + (hi - lo) * uniform01(self.seed, device_ids,
                                            _STREAM_MEM)
        frac = self.tier_mem_frac[self.tier_of(device_ids)]
        return (self.full_model_bytes * frac * jitter).astype(np.int64)

    def profile(self, device_id: int) -> DeviceProfile:
        ids = np.asarray([device_id])
        return DeviceProfile(device_id=int(device_id),
                             mem_bytes=int(self.mem_bytes(ids)[0]),
                             speed=float(self.speeds(ids)[0]))

    def profiles(self, device_ids) -> List[DeviceProfile]:
        ids = np.asarray(list(device_ids))
        mem, spd = self.mem_bytes(ids), self.speeds(ids)
        return [DeviceProfile(device_id=int(i), mem_bytes=int(m),
                              speed=float(s))
                for i, m, s in zip(ids, mem, spd)]

    # -- analytic per-tier memory feasibility ------------------------------ #
    def tier_feasible_prob(self, required_bytes: int) -> np.ndarray:
        """P(device of tier t fits ``required_bytes``) — closed form from
        the uniform jitter CDF, no device enumerated."""
        lo, hi = _MEM_JITTER
        denom = np.maximum(self.full_model_bytes * self.tier_mem_frac, 1e-12)
        r = float(required_bytes) / denom          # jitter needed per tier
        return np.clip((hi - r) / (hi - lo), 0.0, 1.0)

    def feasible_fraction(self, required_bytes: int) -> float:
        """Fraction of the population that fits ``required_bytes``."""
        return float(self.tier_fracs @ self.tier_feasible_prob(
            required_bytes))

    def feasible_count(self, required_bytes: int) -> int:
        """Memory-feasible device count: exact (one vectorized pass) below
        ``_SCAN_THRESHOLD``, analytic expectation above it."""
        if self.n_devices <= _SCAN_THRESHOLD:
            ids = np.arange(self.n_devices)
            return int(np.count_nonzero(
                self.mem_bytes(ids) >= int(required_bytes)))
        return int(round(self.feasible_fraction(required_bytes)
                         * self.n_devices))

    # -- cohort sampling (O(cohort), not O(population)) -------------------- #
    def sample_cohort(self, rng: np.random.Generator, k: int,
                      required_bytes: int = 0,
                      tier: Optional[int] = None) -> List[int]:
        """Draw up to ``k`` distinct device ids uniformly from the
        population subset that fits ``required_bytes`` (optionally further
        restricted to one speed ``tier``).

        Small populations (≤ ``_SCAN_THRESHOLD``) filter exactly and use
        one ``rng.choice`` without replacement — the historical
        ``memory_feasible`` + ``random_select`` behavior.  Large
        populations rejection-sample id draws against the analytic
        acceptance probability with a bounded draw budget, so cost is
        O(k / acceptance), independent of population size.
        """
        k = int(k)
        if k <= 0:
            return []
        accept = self.tier_feasible_prob(required_bytes)
        if tier is not None:
            p = float(self.tier_fracs[tier] * accept[tier])
        else:
            p = float(self.tier_fracs @ accept)
        if p <= 0.0:
            return []

        if self.n_devices <= _SCAN_THRESHOLD:
            ids = np.arange(self.n_devices)
            ok = self.mem_bytes(ids) >= int(required_bytes)
            if tier is not None:
                ok &= self.tier_of(ids) == tier
            pool = ids[ok]
            if pool.size == 0:
                return []
            take = min(k, pool.size)
            return [int(x) for x in rng.choice(pool, size=take,
                                               replace=False)]

        chosen: List[int] = []
        seen = set()
        # enough draws to find k acceptances w.h.p.; bounded so a nearly
        # infeasible requirement terminates instead of spinning
        budget = int(np.ceil(4 * k / p)) + 64
        while len(chosen) < k and budget > 0:
            m = min(budget, int(np.ceil((k - len(chosen)) / p)) + 8)
            budget -= m
            ids = rng.integers(0, self.n_devices, size=m)
            ok = self.mem_bytes(ids) >= int(required_bytes)
            if tier is not None:
                ok &= self.tier_of(ids) == tier
            for i in ids[ok]:
                i = int(i)
                if i not in seen:
                    seen.add(i)
                    chosen.append(i)
                    if len(chosen) == k:
                        break
        return chosen

    # alias matching selection-policy vocabulary
    def sample_feasible(self, rng, k, required_bytes):
        return self.sample_cohort(rng, k, required_bytes)
