"""The work of one K4 call, the one formula that both the kernel's bound
(``chip_smoke.py``) and the dry-run's FLOP count (``FlopCounterMode``, the
formula registered in ``kernel.py``) read.

``flash_work`` returns ``(bytes, product FLOPs, elementwise FLOPs)``: q, k
and v read once and o written once; QK^T and PV, 2 D FLOPs each per
(query, key) pair that the masks allow (a causal mask, a sliding window);
the softmax (max, subtract, exp, sum, rescale: 5 per pair) and q's scale.
"""
from __future__ import annotations

import numpy as np


def allowed_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one head the masks allow: query i sees keys
    max(0, i - window + 1) (a window) .. min(Skv - 1, i) (causal)."""
    i = np.arange(Sq, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    hi = np.minimum(Skv - 1, i) if causal else np.full_like(i, Skv - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_work(B, Sq, Skv, H, KV, D, causal, window, dtype):
    """Bytes, product and elementwise FLOPs of one call on q (B, Sq, H, D)
    and k, v (B, Skv, KV, D) of ``dtype`` ("float32" or "bfloat16")."""
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * (2 * B * Sq * H * D + 2 * B * Skv * KV * D)
    pairs = allowed_pairs(Sq, Skv, causal, window) * B * H
    return nbytes, 4 * pairs * D, 5 * pairs + B * Sq * H * D
