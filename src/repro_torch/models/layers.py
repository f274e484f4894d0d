"""Shared layers (port of ``repro.models.layers``; cross-entropy only)."""
from __future__ import annotations

import torch


def cross_entropy(logits, labels):
    """Mean cross-entropy. logits (..., V) float; labels (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()
