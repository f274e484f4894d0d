"""Attention layers (port of ``repro.models.attention``, the GQA part):
grouped-query attention with RoPE, qk-norm, QKV bias, causal and
sliding-window masks, and its one-token decode against a KV cache.

``gqa_forward`` runs attention through the hand-written CUDA flash kernel
(``kernels.flash_attention.ops``) when ``cfg.use_flash_kernel`` is set, and
through the plain ``sdpa`` otherwise; with ``with_cache`` it also returns
the layer's cache (prefill).  ``gqa_decode`` attends one new token to the
cache with the plain ``sdpa``, as the reference's decode does.  Layouts are
the reference's: activations (B, S, H, D), weights ``wq`` (d, H, Dh),
``wk``/``wv`` (d, KV, Dh), ``wo`` (H, Dh, d).

Caches (per layer): ``{"k": (B, S, KV, Dh), "v": (B, S, KV, Dh)}``; with a
window W, S = W and token j sits at slot j % W (a ring buffer).  A prefill
longer than W keeps its last W keys rolled into that layout, so that decode
evicts the oldest token (the reference keeps them unrolled, and its decode
then evicts the wrong one when S % W != 0).  ``gqa_decode`` writes the new
token's k and v into the cache in place and returns it.

MLA (DeepSeek-V2) is not ported yet: the dispatch helpers raise for it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.paramdef import ParamDef
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MODEL_AXIS, apply_rope, rmsnorm,
                                       rmsnorm_defs)

NEG_INF = -1e30


def sdpa(q, k, v, *, causal: bool, window: int, q_offset: int = 0,
         kv_mask=None):
    """Plain grouped attention.  q: (B, Sq, H, D); k, v: (B, Skv, KV, D);
    H % KV == 0.  ``q_offset``: absolute position of q[0] relative to k[0];
    ``kv_mask``: optional (B, Skv) bool of the valid cache slots."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, NEG_INF)
    if kv_mask is not None:
        scores = scores.masked_fill(~kv_mask[:, None, None, None, :],
                                    NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


# =========================================================================== #
# GQA
# =========================================================================== #
def gqa_defs(cfg: ModelConfig) -> dict:
    d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    Dh = cfg.resolved_head_dim
    dt = cfg.param_dtype
    defs = {"wq": ParamDef((d, H, Dh), dt, (None, MODEL_AXIS)),
            "wk": ParamDef((d, KV, Dh), dt, (None, MODEL_AXIS)),
            "wv": ParamDef((d, KV, Dh), dt, (None, MODEL_AXIS)),
            "wo": ParamDef((H, Dh, d), dt, (MODEL_AXIS,))}
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, Dh), dt, (MODEL_AXIS,), init="zeros")
        defs["bk"] = ParamDef((KV, Dh), dt, (MODEL_AXIS,), init="zeros")
        defs["bv"] = ParamDef((KV, Dh), dt, (MODEL_AXIS,), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = rmsnorm_defs(Dh, dt)
        defs["k_norm"] = rmsnorm_defs(Dh, dt)
    return defs


def _project(x, w):
    """einsum("bsd,dhe->bshe") as one matmul."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).reshape(*x.shape[:-1], h, e)


def _gqa_project(params, cfg: ModelConfig, x, positions):
    """q, k, v: the projections, then the bias, qk-norm and RoPE, in the
    reference's order."""
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(params, out):
    B, S, H, Dh = out.shape
    return out.reshape(B, S, H * Dh) @ params["wo"].reshape(H * Dh, -1)


def gqa_forward(params, cfg: ModelConfig, x, positions, *, with_cache=False):
    """Full-sequence attention; x (B, S, d) -> (B, S, d), and with
    ``with_cache`` also the layer's cache (the module docstring)."""
    q, k, v = _gqa_project(params, cfg, x, positions)
    if cfg.use_flash_kernel:
        from repro_torch.kernels.flash_attention.ops import flash_attention
        out = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window)
    else:
        out = sdpa(q, k, v, causal=cfg.causal, window=cfg.window)
    y = _out(params, out)
    if not with_cache:
        return y
    W, S = cfg.window, x.shape[1]
    if 0 < W < S:
        # the last W tokens, token j at slot j % W
        k, v = (torch.roll(t[:, -W:], S % W, dims=1) for t in (k, v))
    return y, {"k": k, "v": v}


def gqa_decode(params, cfg: ModelConfig, x, cache, pos: int):
    """x: (B, 1, d); ``pos``: the new token's absolute position.  Writes
    its k and v into ``cache`` in place; returns (y, cache)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _gqa_project(params, cfg, x, positions)
    S = cache["k"].shape[1]
    slot = pos % S if cfg.window > 0 else min(pos, S - 1)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    n_valid = min(pos + 1, S) if cfg.window > 0 else pos + 1
    valid = torch.arange(S, device=x.device) < n_valid
    # positions are baked into the cached keys by RoPE, and softmax does
    # not care about slot order, so the ring buffer needs no unrolling
    out = sdpa(q, cache["k"], cache["v"], causal=False, window=0,
               kv_mask=valid[None].expand(B, S))
    return _out(params, out), cache


def gqa_cache_defs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    KV, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    S = min(seq, cfg.window) if cfg.window > 0 else seq
    # batch over the data axes; kv heads over "model" when they divide
    # evenly, else the cache's sequence axis takes it (the reference's)
    spec = ((("pod", "data"), None, MODEL_AXIS) if KV % 16 == 0
            else (("pod", "data"), MODEL_AXIS))
    return {"k": ParamDef((batch, S, KV, Dh), cfg.param_dtype, spec,
                          init="zeros"),
            "v": ParamDef((batch, S, KV, Dh), cfg.param_dtype, spec,
                          init="zeros")}


# =========================================================================== #
# dispatch helpers (MLA: not ported)
# =========================================================================== #
def _gqa_only(cfg: ModelConfig):
    if cfg.attn_impl == "mla":
        raise ValueError(f"{cfg.name}: not yet ported: MLA attention")


def attn_defs(cfg: ModelConfig) -> dict:
    _gqa_only(cfg)
    return gqa_defs(cfg)


def attn_forward(params, cfg, x, positions, *, with_cache=False):
    _gqa_only(cfg)
    return gqa_forward(params, cfg, x, positions, with_cache=with_cache)


def attn_decode(params, cfg, x, cache, pos: int):
    _gqa_only(cfg)
    return gqa_decode(params, cfg, x, cache, pos)


def attn_cache_defs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    _gqa_only(cfg)
    return gqa_cache_defs(cfg, batch, seq)
