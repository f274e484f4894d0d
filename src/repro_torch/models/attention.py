"""Attention layers (port of ``repro.models.attention``): grouped-query
attention with RoPE, qk-norm, QKV bias, causal and sliding-window masks,
and DeepSeek-V2's multi-head latent attention (MLA); each with its
one-token decode against a cache.

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

MLA (``attn_impl="mla"``) keeps per layer a compressed cache ``{"ckv":
(B, S, kv_lora_rank), "krope": (B, S, qk_rope_head_dim)}``.  Its forward
expands the latents to per-head keys and values (q and k of nope + rope
dims, v of ``v_head_dim``) and attends with the plain ``sdpa``, as the
reference's does whatever ``use_flash_kernel`` says; its decode attends in
the latent space (W_uk absorbed into q, W_uv applied after), writing the
new token at slot ``min(pos, S - 1)``.  The query is ``wq``, or with
``q_lora_rank`` the compressed ``w_dq`` -> RMSNorm -> ``w_uq``.
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
# MLA (DeepSeek-V2)
# =========================================================================== #
def mla_defs(cfg: ModelConfig) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    dt = cfg.param_dtype
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    defs = {
        "w_dkv": ParamDef((d, m.kv_lora_rank), dt),
        "w_kr": ParamDef((d, m.qk_rope_head_dim), dt),
        "kv_norm": rmsnorm_defs(m.kv_lora_rank, dt),
        "w_uk": ParamDef((m.kv_lora_rank, H, m.qk_nope_head_dim), dt,
                         (None, MODEL_AXIS)),
        "w_uv": ParamDef((m.kv_lora_rank, H, m.v_head_dim), dt,
                         (None, MODEL_AXIS)),
        "wo": ParamDef((H, m.v_head_dim, d), dt, (MODEL_AXIS,)),
    }
    if m.q_lora_rank:
        defs["w_dq"] = ParamDef((d, m.q_lora_rank), dt)
        defs["q_norm"] = rmsnorm_defs(m.q_lora_rank, dt)
        defs["w_uq"] = ParamDef((m.q_lora_rank, H, qk_dim), dt,
                                (None, MODEL_AXIS))
    else:
        defs["wq"] = ParamDef((d, H, qk_dim), dt, (None, MODEL_AXIS))
    return defs


def _mla_q(params, cfg: ModelConfig, x, positions):
    """(q_nope, q_rope), each (B, S, H, ·), RoPE on the rope part."""
    m = cfg.mla
    if m.q_lora_rank:
        cq = rmsnorm(params["q_norm"], x @ params["w_dq"], cfg.norm_eps)
        q = _project(cq, params["w_uq"])
    else:
        q = _project(x, params["wq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _mla_latents(params, cfg: ModelConfig, x, positions):
    """(ckv (B, S, rank) normed, krope (B, S, rope) with RoPE)."""
    ckv = rmsnorm(params["kv_norm"], x @ params["w_dkv"], cfg.norm_eps)
    krope = apply_rope((x @ params["w_kr"])[:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0, :]
    return ckv, krope


def mla_forward(params, cfg: ModelConfig, x, positions, *, with_cache=False):
    """Prefill / train: the latents expanded to per-head keys and values
    (the naive path), attended with the plain ``sdpa``.  Returns y, and
    with ``with_cache`` (y, {"ckv", "krope"})."""
    m = cfg.mla
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    ckv, krope = _mla_latents(params, cfg, x, positions)
    k_nope = _project(ckv, params["w_uk"])
    v = _project(ckv, params["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    H = cfg.num_heads
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        *krope.shape[:2], H, m.qk_rope_head_dim)], dim=-1)
    out = sdpa(q, k, v, causal=True, window=cfg.window)
    y = _out(params, out)
    if not with_cache:
        return y
    return y, {"ckv": ckv, "krope": krope}


def mla_decode(params, cfg: ModelConfig, x, cache, pos: int):
    """Absorbed decode: attention in the latent (rank) space, the cache
    kept compressed; per-head keys and values are never formed.  Writes
    the new latents into ``cache`` in place; returns (y, cache)."""
    m = cfg.mla
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, positions)         # (B,1,H,·)
    ckv_new, krope_new = _mla_latents(params, cfg, x, positions)
    S = cache["ckv"].shape[1]
    slot = min(pos, S - 1)
    cache["ckv"][:, slot] = ckv_new[:, 0]
    cache["krope"][:, slot] = krope_new[:, 0]
    ckv, krope = cache["ckv"], cache["krope"]
    # W_uk absorbed into q: q_lat = q_nope W_uk^T, in the rank space
    q_lat = torch.einsum("bqhe,rhe->bqhr", q_nope, params["w_uk"])
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckv)
              + torch.einsum("bqhe,bse->bhqs", q_rope, krope))
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    scores = scores.float() * scale
    valid = torch.arange(S, device=x.device) <= pos
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(ckv.dtype)
    ctx_lat = torch.einsum("bhqs,bsr->bqhr", probs, ckv)
    ctx = torch.einsum("bqhr,rhe->bqhe", ctx_lat, params["w_uv"])
    return _out(params, ctx), cache


def mla_cache_defs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    m = cfg.mla
    dt = cfg.param_dtype
    bspec = ("pod", "data")
    return {"ckv": ParamDef((batch, seq, m.kv_lora_rank), dt,
                            (bspec, None, MODEL_AXIS), init="zeros"),
            "krope": ParamDef((batch, seq, m.qk_rope_head_dim), dt,
                              (bspec,), init="zeros")}


# =========================================================================== #
# dispatch helpers
# =========================================================================== #
def attn_defs(cfg: ModelConfig) -> dict:
    return mla_defs(cfg) if cfg.attn_impl == "mla" else gqa_defs(cfg)


def attn_forward(params, cfg, x, positions, *, with_cache=False):
    fn = mla_forward if cfg.attn_impl == "mla" else gqa_forward
    return fn(params, cfg, x, positions, with_cache=with_cache)


def attn_decode(params, cfg, x, cache, pos: int):
    fn = mla_decode if cfg.attn_impl == "mla" else gqa_decode
    return fn(params, cfg, x, cache, pos)


def attn_cache_defs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    fn = mla_cache_defs if cfg.attn_impl == "mla" else gqa_cache_defs
    return fn(cfg, batch, seq)
