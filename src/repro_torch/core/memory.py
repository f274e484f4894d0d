"""Analytic training-memory model, CNN branch (port of
``repro.core.memory``).

    M(t) = params(all, fwd) + grads(trainable) + opt_state(trainable)
         + activations(trainable segment)

Frozen-prefix activations are not retained (the prefix runs without
gradient), which is the NeuLite saving.  The fleet's memory budgets and the
cohort draw depend on these byte counts, which equal the reference's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.common import paramdef as PD
from repro_torch.models import cnn as cnn_mod


@dataclasses.dataclass(frozen=True)
class MemoryEstimate:
    params_bytes: int
    grads_bytes: int
    opt_bytes: int
    act_bytes: int

    @property
    def total(self) -> int:
        return (self.params_bytes + self.grads_bytes + self.opt_bytes
                + self.act_bytes)

    @property
    def total_gb(self) -> float:
        return self.total / 1e9


def _cnn_act_bytes(ccfg: cnn_mod.CNNConfig, batch: int, unit_range) -> int:
    hw = ccfg.image_size
    total = 0
    for i, (_kind, meta) in enumerate(cnn_mod.unit_meta(ccfg)):
        hw_out = hw // meta["stride"]
        if i in unit_range:
            total += 3 * batch * hw_out * hw_out * meta["cout"] * 4
        hw = hw_out
    return total


def _check_cnn(adapter) -> None:
    if adapter.kind != "cnn":
        raise ValueError("the port's memory model has the CNN branch only")


def estimate_stage_memory(adapter, t: int, batch: int, seq: int = 0,
                          opt_slots: int = 1) -> MemoryEstimate:
    """opt_slots: momentum=1 (SGD), adam=2.  ``seq`` is unused by CNNs."""
    _check_cnn(adapter)
    _frozen_defs, trainable_defs = adapter.split_stage(adapter.defs, t)
    train_bytes = PD.nbytes(trainable_defs)
    opt = opt_slots * 4 * PD.nparams(trainable_defs)   # fp32 slots
    (_, _), (b0, _b1), (_a0, a1) = adapter.plan.stage_ranges(t)
    act = _cnn_act_bytes(adapter.cfg, batch, range(b0, a1))
    return MemoryEstimate(PD.nbytes(adapter.defs), train_bytes, opt, act)


def estimate_full_memory(adapter, batch: int, seq: int = 0,
                         opt_slots: int = 1) -> MemoryEstimate:
    _check_cnn(adapter)
    params_bytes = PD.nbytes(adapter.defs["model"])
    opt = opt_slots * 4 * PD.nparams(adapter.defs["model"])
    act = _cnn_act_bytes(adapter.cfg, batch, range(0, adapter.plan.num_units))
    return MemoryEstimate(params_bytes, params_bytes, opt, act)
