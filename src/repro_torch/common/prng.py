"""Counter-based host-side PRNG (splitmix64).

Stateless, vectorized uniforms keyed by ``(seed, counter, stream)``: the
value at a counter never depends on how many other counters were queried,
in what order, or on which process — the property that lets a million-device
fleet (``federated.devices.Fleet``) and procedural per-client datasets
(``data.partition.ProceduralClients``) look up any entity's attributes in
O(1) without materializing the population.  numpy's ``default_rng`` offers
the same determinism per ``SeedSequence`` but costs a Python-level
constructor per entity; these hashes vectorize over id arrays at
numpy-ufunc speed, which keeps rejection-sampling a cohort from a 10^6
population off the round's critical path.
"""
from __future__ import annotations

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Finalizer of splitmix64 — bijective avalanche mix on uint64.

    uint64 wraparound is the algorithm; numpy warns on scalar (but not
    array) overflow, so silence it locally."""
    with np.errstate(over="ignore"):
        x = (x + _GOLDEN)
        x = (x ^ (x >> np.uint64(30))) * _MIX1
        x = (x ^ (x >> np.uint64(27))) * _MIX2
        return x ^ (x >> np.uint64(31))


def hash_u64(seed: int, counters, stream: int = 0) -> np.ndarray:
    """uint64 hash of each counter under ``(seed, stream)``.

    ``counters`` may be a scalar or any integer array; the result has its
    shape.  Distinct ``stream`` values give independent draws for the same
    counter (tier pick vs memory jitter vs speed jitter).
    """
    ids = np.asarray(counters, dtype=np.uint64)
    with np.errstate(over="ignore"):
        key = _splitmix64(_splitmix64(np.uint64(seed & (2**64 - 1)))
                          + np.uint64(stream))
        return _splitmix64(ids ^ key)


def uniform01(seed: int, counters, stream: int = 0) -> np.ndarray:
    """float64 uniforms in [0, 1), one per counter (53-bit mantissa)."""
    return (hash_u64(seed, counters, stream) >> np.uint64(11)).astype(
        np.float64) * (1.0 / (1 << 53))


def permute_index(seed: int, indices, n: int, stream: int = 0,
                  rounds: int = 4) -> np.ndarray:
    """Seed-keyed bijection of ``[0, n)`` with O(1) random access.

    A balanced Feistel network over the smallest even-bit power-of-two
    domain covering ``n``, cycle-walked back into range (the domain is at
    most 4n, so each walk step keeps ≥ 1/4 of the lanes and the loop
    terminates because a permutation's cycles must re-enter ``[0, n)``).
    Stateless: ``permute_index(seed, i, n)`` for one ``i`` equals entry
    ``i`` of the full shuffle without materializing it — this is what lets
    the streaming fleet stratify tier assignment exactly over a 10^6
    population at per-device O(1) cost.
    """
    n = int(n)
    if n <= 0:
        raise ValueError("permute_index needs n >= 1")
    idx = np.atleast_1d(np.asarray(indices, dtype=np.uint64))
    if np.any(idx >= n):
        raise ValueError(f"indices must lie in [0, {n})")
    if n == 1:
        return np.zeros_like(idx)
    bits = max(int(np.ceil(np.log2(n))), 2)
    bits += bits & 1                      # even split for a balanced network
    half = np.uint64(bits // 2)
    mask = np.uint64((1 << (bits // 2)) - 1)

    def feistel(x):
        a, b = x >> half, x & mask
        for r in range(rounds):
            f = hash_u64(seed, b, stream=(stream << 8) | r) & mask
            a, b = b, a ^ f
        return (a << half) | b

    out = feistel(idx)
    walking = out >= n
    while np.any(walking):
        out[walking] = feistel(out[walking])
        walking = out >= n
    return out
