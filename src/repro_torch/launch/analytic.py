"""Analytic per-step FLOP and HBM-byte models for the roofline (port of
``repro.launch.analytic``).

The reference's roofline takes these closed forms because XLA's
``cost_analysis()`` counts a ``while``-loop body once.  The port's dry-run
counts its own FLOPs and bytes per rank as it runs (``launch.dryrun``) and
keeps these numbers beside them: the partitioned ideal, the global count
divided over the chips.

Conventions:
  * forward matmul FLOPs = 2·m·n·k; training = 3× forward (1 fwd + 2 bwd);
  * causal attention context factor: mean context = S/2 (window: min(W,S));
  * NeuLite stage step: frozen prefix forward-only (1×), trainable segment 3×;
  * HBM bytes: every parameter read once per pass + activations written/read
    once per layer boundary + KV-cache traffic for decode.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


def _itemsize(cfg: ModelConfig) -> int:
    return getattr(torch, cfg.dtype).itemsize


def _attn_flops_per_token(cfg: ModelConfig, ctx: float) -> float:
    """Per-layer attention sublayer forward FLOPs per token."""
    d = cfg.d_model
    if cfg.attn_impl == "mla":
        m = cfg.mla
        H = cfg.num_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        proj = 2 * d * m.kv_lora_rank + 2 * d * m.qk_rope_head_dim
        if m.q_lora_rank:
            proj += 2 * d * m.q_lora_rank + 2 * m.q_lora_rank * H * qk
        else:
            proj += 2 * d * H * qk
        proj += 2 * m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
        proj += 2 * H * m.v_head_dim * d
        attn = 2 * ctx * H * qk + 2 * ctx * H * m.v_head_dim
        return proj + attn
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    proj = 2 * d * Dh * (2 * H + 2 * KV)
    attn = 4 * ctx * H * Dh
    return proj + attn


def _ffn_flops_per_token(cfg: ModelConfig, ffn: str) -> float:
    d = cfg.d_model
    if ffn == "none":
        return 0.0
    if ffn == "moe":
        m = cfg.moe
        routed = 6 * d * m.d_ff_expert * m.top_k
        shared = 6 * d * m.d_ff_expert * m.num_shared
        router = 2 * d * m.num_experts
        return routed + shared + router
    ff = cfg.d_ff
    if cfg.moe is not None and cfg.moe.d_ff_dense:
        ff = cfg.moe.d_ff_dense
    mult = 6 if cfg.act == "swiglu" else 4
    return mult * d * ff


def _mixer_flops_per_token(cfg: ModelConfig, kind: str, ctx: float) -> float:
    d = cfg.d_model
    if kind == "attn":
        return _attn_flops_per_token(cfg, ctx)
    if kind == "mamba":
        s = cfg.ssm
        d_in = s.expand * d
        dtr = s.dt_rank or -(-d // 16)
        return (2 * d * 2 * d_in + 2 * d_in * s.d_conv
                + 2 * d_in * (dtr + 2 * s.d_state) + 2 * dtr * d_in
                + 10 * d_in * s.d_state + 2 * d_in * d)
    if kind == "mlstm":
        d_in = cfg.xlstm.mlstm_expand * d
        proj = 2 * d * 2 * d_in + 3 * 2 * d_in * d_in + 2 * d_in * d
        seq_mix = 4 * ctx * d_in          # parallel form (train/prefill)
        return proj + seq_mix
    if kind == "slstm":
        H = cfg.num_heads
        Dh = d // H
        ff = int(cfg.xlstm.slstm_proj_factor * d)
        return 8 * d * d + 8 * d * Dh + 6 * d * ff
    raise ValueError(kind)


def layer_flops_per_token(cfg: ModelConfig, ctx: float) -> float:
    """Mean forward FLOPs per token per *period*, divided by period size."""
    total = 0.0
    for kind, ffn in cfg.pattern:
        k = kind
        c = ctx
        if kind in ("mlstm",) and ctx <= 1:
            # recurrent decode: matrix-memory update ~ d_in * Dh
            d_in = cfg.xlstm.mlstm_expand * cfg.d_model
            total += (2 * cfg.d_model * 2 * d_in + 3 * 2 * d_in * d_in
                      + 2 * d_in * cfg.d_model
                      + 4 * d_in * (d_in // cfg.num_heads))
            total += _ffn_flops_per_token(cfg, ffn)
            continue
        total += _mixer_flops_per_token(cfg, k, c)
        total += _ffn_flops_per_token(cfg, ffn)
    return total / len(cfg.pattern)


def head_flops_per_token(cfg: ModelConfig) -> float:
    return 2 * cfg.d_model * cfg.vocab_size * cfg.num_output_heads


@dataclasses.dataclass
class StepCost:
    flops_global: float
    hbm_bytes_global: float

    def per_chip(self, chips: int):
        return self.flops_global / chips, self.hbm_bytes_global / chips


def _ctx(cfg: ModelConfig, seq: int, kind: str) -> float:
    win = cfg.window
    if kind in ("train", "prefill"):
        return min(win, seq) if win > 0 else seq / 2.0
    return float(min(win, seq)) if win > 0 else float(seq)


def _param_bytes(cfg: ModelConfig) -> float:
    from repro_torch.models.model import total_param_count
    return total_param_count(cfg) * _itemsize(cfg)


def _active_param_bytes(cfg: ModelConfig) -> float:
    from repro_torch.models.model import active_param_count
    return active_param_count(cfg) * _itemsize(cfg)


def _cache_bytes_per_token(cfg: ModelConfig, seq: int) -> float:
    """Decode-step cache traffic per sequence (read whole cache once)."""
    el = _itemsize(cfg)
    per_layer = 0.0
    for kind, _ in cfg.pattern:
        if kind == "attn":
            if cfg.attn_impl == "mla":
                m = cfg.mla
                S = seq
                per_layer += S * (m.kv_lora_rank + m.qk_rope_head_dim) * el
            else:
                S = min(cfg.window, seq) if cfg.window > 0 else seq
                per_layer += 2 * S * cfg.num_kv_heads \
                    * cfg.resolved_head_dim * el
        elif kind == "mamba":
            d_in = cfg.ssm.expand * cfg.d_model
            per_layer += d_in * cfg.ssm.d_state * 4
        elif kind == "mlstm":
            d_in = cfg.xlstm.mlstm_expand * cfg.d_model
            per_layer += (d_in // cfg.num_heads) * d_in * 4
        elif kind == "slstm":
            per_layer += 4 * cfg.d_model * 4
    return per_layer / len(cfg.pattern) * cfg.num_layers


def step_cost(cfg: ModelConfig, kind: str, batch: int, seq: int,
              neulite_fraction: float | None = None) -> StepCost:
    """kind: train | neulite | prefill | decode.

    ``neulite_fraction``: trainable fraction of the stack for the stage step
    (boundary+active units / total units); frozen prefix ≈ half the stack on
    average, surrogate output module ≈ 1 extra cheap layer + head.
    """
    el = _itemsize(cfg)
    L = cfg.num_layers
    if kind in ("train", "prefill"):
        tokens = batch * seq
        ctx = _ctx(cfg, seq, kind)
        fwd = tokens * (L * layer_flops_per_token(cfg, ctx)
                        + head_flops_per_token(cfg))
        if kind == "train":
            flops = 3.0 * fwd
            # params read fwd+bwd + grads written + optimizer update traffic
            bytes_ = (3 * _param_bytes(cfg)
                      + tokens * cfg.d_model * el * 2 * L * 2)
        else:
            flops = fwd
            bytes_ = _param_bytes(cfg) + tokens * cfg.d_model * el * 2 * L \
                + _cache_bytes_per_token(cfg, seq) * batch
        return StepCost(flops, bytes_)
    if kind == "neulite":
        f = neulite_fraction if neulite_fraction is not None else 0.3
        frozen_frac = max(0.0, 0.5 - f / 2)   # average prefix before stage
        tokens = batch * seq
        ctx = _ctx(cfg, seq, "train")
        lf = layer_flops_per_token(cfg, ctx)
        fwd_frozen = tokens * L * frozen_frac * lf
        fwd_train = tokens * (L * f * lf + cfg.d_model * cfg.d_model * 4
                              + head_flops_per_token(cfg))
        flops = fwd_frozen + 3.0 * fwd_train
        bytes_ = ((frozen_frac + 3 * f) * _param_bytes(cfg)
                  + tokens * cfg.d_model * el * 2 * L * (frozen_frac + 2 * f))
        return StepCost(flops, bytes_)
    # decode
    tokens = batch
    ctx = _ctx(cfg, seq, "decode")
    flops = tokens * (L * layer_flops_per_token(cfg, ctx)
                      + head_flops_per_token(cfg))
    bytes_ = _active_param_bytes(cfg) + batch * _cache_bytes_per_token(cfg, seq)
    return StepCost(flops, bytes_)
