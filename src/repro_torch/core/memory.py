"""Analytic training-memory model (port of ``repro.core.memory``).

    M(t) = params(all, fwd) + grads(trainable) + opt_state(trainable)
         + activations(trainable segment)

Frozen-prefix activations are not retained (the prefix runs without
gradient), which is the NeuLite saving.  The fleet's memory budgets and the
cohort draw depend on these byte counts, which equal the reference's, on
transformer periods and on CNN units.  As in the reference, a transformer's
activation bytes scale with ``seq``, which the server sets to 0 for image
data: an image model is charged no activation bytes.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.common import paramdef as PD
from repro_torch.models import cnn as cnn_mod
from repro_torch.models.config import ModelConfig


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


def _tx_act_bytes_per_unit(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Activation bytes one period is charged: the saved carry plus one
    period's live working set, amortized over the pattern (the reference's
    accounting, which assumes recomputation inside a period)."""
    bytes_el = cfg.param_dtype.itemsize
    carry = batch * seq * cfg.d_model * bytes_el
    work = 0
    for kind, ffn in cfg.pattern:
        if kind == "attn":
            work += 4 * batch * seq * cfg.d_model * bytes_el
        elif kind == "mamba":
            d_in = cfg.ssm.expand * cfg.d_model
            work += 2 * batch * seq * d_in * bytes_el
        elif kind in ("mlstm", "slstm"):
            work += 3 * batch * seq * cfg.d_model * bytes_el
        if ffn == "mlp":
            work += 2 * batch * seq * cfg.d_ff * bytes_el
        elif ffn == "moe":
            work += 2 * batch * seq * cfg.moe.top_k \
                * cfg.moe.d_ff_expert * bytes_el // max(cfg.moe.top_k, 1)
    return carry + work // max(len(cfg.pattern), 1)


def _cnn_act_bytes(ccfg: cnn_mod.CNNConfig, batch: int, unit_range) -> int:
    hw = ccfg.image_size
    total = 0
    for i, (_kind, meta) in enumerate(cnn_mod.unit_meta(ccfg)):
        hw_out = hw // meta["stride"]
        if i in unit_range:
            total += 3 * batch * hw_out * hw_out * meta["cout"] * 4
        hw = hw_out
    return total


def estimate_stage_memory(adapter, t: int, batch: int, seq: int = 0,
                          opt_slots: int = 1) -> MemoryEstimate:
    """opt_slots: momentum=1 (SGD), adam=2.  ``seq`` is unused by CNNs."""
    _frozen_defs, trainable_defs = adapter.split_stage(adapter.defs, t)
    train_bytes = PD.nbytes(trainable_defs)
    opt = opt_slots * 4 * PD.nparams(trainable_defs)   # fp32 slots
    (_, _), (b0, b1), (a0, a1) = adapter.plan.stage_ranges(t)
    if adapter.kind == "transformer":
        act = ((b1 - b0) + (a1 - a0)) * _tx_act_bytes_per_unit(
            adapter.cfg, batch, seq)
    else:
        act = _cnn_act_bytes(adapter.cfg, batch, range(b0, a1))
    return MemoryEstimate(PD.nbytes(adapter.defs), train_bytes, opt, act)


def estimate_full_memory(adapter, batch: int, seq: int = 0,
                         opt_slots: int = 1) -> MemoryEstimate:
    params_bytes = PD.nbytes(adapter.defs["model"])
    opt = opt_slots * 4 * PD.nparams(adapter.defs["model"])
    if adapter.kind == "transformer":
        act = adapter.cfg.num_periods * _tx_act_bytes_per_unit(
            adapter.cfg, batch, seq)
    else:
        act = _cnn_act_bytes(adapter.cfg, batch,
                             range(0, adapter.plan.num_units))
    return MemoryEstimate(params_bytes, params_bytes, opt, act)


def stage_memory_table(adapter, batch: int, seq: int = 0,
                       opt_slots: int = 1) -> List[MemoryEstimate]:
    """``estimate_stage_memory`` of every stage, in stage order."""
    return [estimate_stage_memory(adapter, t, batch, seq, opt_slots)
            for t in range(adapter.plan.num_stages)]
