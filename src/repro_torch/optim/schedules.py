"""Learning-rate schedules (port of ``repro.optim.schedules``).

Each takes the optimizer's step, a 0-d int32 tensor on the device (or a
number), and returns a float32 0-d tensor, as the reference's return
``jnp`` scalars: read on the device, so that a captured step follows it.
"""
from __future__ import annotations

import math

import torch


def _as_tensor(step):
    return step if torch.is_tensor(step) else torch.tensor(step)


def constant_schedule(lr: float):
    return lambda step: torch.tensor(
        lr, dtype=torch.float32, device=_as_tensor(step).device)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        frac = torch.clamp(_as_tensor(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return (lr * (final_frac + (1 - final_frac) * cos)).float()
    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_schedule(lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        step = _as_tensor(step)
        warm = lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           cos(step - warmup_steps)).float()
    return fn
