"""Attention layers (port of ``repro.models.attention``, the GQA part):
grouped-query attention with RoPE, causal and sliding-window masks.

``gqa_forward`` runs attention through the hand-written CUDA flash kernel
(``kernels.flash_attention.ops``) when ``cfg.use_flash_kernel`` is set, and
through the plain ``sdpa`` otherwise.  Layouts are the reference's:
activations (B, S, H, D), weights ``wq`` (d, H, Dh), ``wk``/``wv``
(d, KV, Dh), ``wo`` (H, Dh, d).  Decode and its caches come with a later
part of the port, as do qk-norm and QKV bias.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.paramdef import ParamDef
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def sdpa(q, k, v, *, causal: bool, window: int):
    """Plain grouped attention.  q: (B, Sq, H, D); k, v: (B, Skv, KV, D);
    H % KV == 0."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def gqa_defs(cfg: ModelConfig) -> dict:
    d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    Dh = cfg.resolved_head_dim
    dt = cfg.param_dtype
    return {"wq": ParamDef((d, H, Dh), dt), "wk": ParamDef((d, KV, Dh), dt),
            "wv": ParamDef((d, KV, Dh), dt), "wo": ParamDef((H, Dh, d), dt)}


def _project(x, w):
    """einsum("bsd,dhe->bshe") as one matmul."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).reshape(*x.shape[:-1], h, e)


def _gqa_project(params, cfg: ModelConfig, x, positions):
    q = apply_rope(_project(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, params["wk"]), positions, cfg.rope_theta)
    return q, k, _project(x, params["wv"])


def gqa_forward(params, cfg: ModelConfig, x, positions):
    """Full-sequence attention; x (B, S, d) -> (B, S, d)."""
    q, k, v = _gqa_project(params, cfg, x, positions)
    if cfg.use_flash_kernel:
        from repro_torch.kernels.flash_attention.ops import flash_attention
        out = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window)
    else:
        out = sdpa(q, k, v, causal=cfg.causal, window=cfg.window)
    B, S, H, Dh = out.shape
    return out.reshape(B, S, H * Dh) @ params["wo"].reshape(H * Dh, -1)
