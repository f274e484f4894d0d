"""xLSTM cells (port of the mLSTM and sLSTM half of ``repro.models.ssm``):
mLSTM with matrix memory, in its chunkwise-parallel form, and sLSTM with
scalar memory and recurrent gating.

The reference's ``lax.scan`` over chunks (mLSTM) and over time (sLSTM)
become Python loops.  With ``ModelConfig.use_slstm_kernel`` the sLSTM time
scan runs in the hand-written CUDA kernel (``kernels/slstm_scan``);
otherwise in that kernel's plain per-step loop (``slstm_scan/ref.py``).
Mamba, the decode steps and the recurrent caches are not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common.paramdef import ParamDef
from repro_torch.models.config import ModelConfig


# =========================================================================== #
# causal depthwise conv
# =========================================================================== #
def causal_conv(x, w, b=None):
    """x: (B, S, C); w: (C, K) depthwise causal conv along S (tap i of the
    padded input meets ``w[:, K-1-i]``, as in the reference)."""
    K = w.shape[-1]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = sum(pad[:, i:i + S, :] * w[None, None, :, K - 1 - i]
            for i in range(K))
    if b is not None:
        y = y + b
    return y


# =========================================================================== #
# mLSTM (xLSTM matrix-memory cell)
# =========================================================================== #
def mlstm_dims(cfg: ModelConfig):
    d_in = cfg.xlstm.mlstm_expand * cfg.d_model
    H = cfg.num_heads
    return d_in, H, d_in // H


def mlstm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in, H, Dh = mlstm_dims(cfg)
    dt = cfg.param_dtype
    f32 = torch.float32
    return {
        "w_up": ParamDef((d, 2 * d_in), dt),
        "conv_w": ParamDef((d_in, 4), dt, scale=0.1),
        "wq": ParamDef((d_in, H, Dh), dt),
        "wk": ParamDef((d_in, H, Dh), dt),
        "wv": ParamDef((d_in, H, Dh), dt),
        "wi": ParamDef((d_in, H), f32, scale=0.02),
        "wf": ParamDef((d_in, H), f32, scale=0.02),
        "bi": ParamDef((H,), f32, init="zeros"),
        "bf": ParamDef((H,), f32, init="ones"),
        "out_norm": ParamDef((d_in,), dt, init="ones"),
        "w_down": ParamDef((d_in, d), dt),
    }


def _mlstm_qkv_gates(params, x_in):
    """x_in: (B, S, d_in) (post-conv for the q/k path)."""
    q = torch.einsum("bsc,che->bshe", x_in, params["wq"])
    k = torch.einsum("bsc,che->bshe", x_in, params["wk"])
    return q, k


_MLSTM_CHUNK = 128


def _mlstm_chunk_step(carry, inp, Dh):
    """Chunkwise-parallel mLSTM (xLSTM chunkwise form).

    carry: (C (B,H,Dh,Dh), n (B,H,Dh), m (B,H)) log-stabilized state.
    inp:   q, k, v (B,Q,H,Dh) + logi, logf (B,Q,H) for one chunk.
    Intra-chunk pairs use the quadratic form (Q x Q); the previous chunks'
    contribution enters through the running matrix memory.  Maxima over an
    axis are ``torch.amax``, which splits the gradient between ties as
    ``jnp.max`` does (``Tensor.max(dim)`` sends it to one index)."""
    C, n, m_run = carry
    q, k, v, logi, logf = inp
    Q = q.shape[1]
    Fc = torch.cumsum(logf, dim=1)                     # (B,Q,H)

    # intra-chunk log weights D_ij = F_i - F_j + logi_j (j <= i)
    Dm = Fc[:, :, None, :] - Fc[:, None, :, :] + logi[:, None, :, :]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=q.device))
    Dm = torch.where(causal[None, :, :, None], Dm,
                     torch.full_like(Dm, -math.inf))
    m_intra = torch.amax(Dm, dim=2)                    # (B,Q,H)
    m_inter = Fc + m_run[:, None]                      # (B,Q,H)
    m_i = torch.maximum(m_intra, m_inter)

    W = torch.exp(Dm - m_i[:, :, None, :])             # (B,Q,Q,H)
    scores = torch.einsum("bqhe,bkhe->bqkh", q, k).float()
    scores = scores / math.sqrt(Dh) * W
    w_inter = torch.exp(m_inter - m_i)                 # (B,Q,H)

    qf = q.float()
    num = (torch.einsum("bqkh,bkhe->bqhe", scores, v.float())
           + w_inter[..., None]
           * torch.einsum("bhef,bqhe->bqhf", C, qf) / math.sqrt(Dh))
    den_intra = scores.sum(dim=2)                      # (B,Q,H)
    den_inter = (w_inter * torch.einsum("bhe,bqhe->bqh", n, qf)
                 / math.sqrt(Dh))
    den = torch.maximum(torch.abs(den_intra + den_inter), torch.exp(-m_i))
    h = num / den[..., None]                           # (B,Q,H,Dh)

    # end-of-chunk state update
    wk = Fc[:, -1:, :] - Fc + logi                     # (B,Q,H)
    m_new = torch.maximum(Fc[:, -1] + m_run, torch.amax(wk, dim=1))
    kw = k.float() * torch.exp(wk - m_new[:, None])[..., None]
    decay = torch.exp(Fc[:, -1] + m_run - m_new)       # (B,H)
    C_new = (decay[:, :, None, None] * C
             + torch.einsum("bqhe,bqhf->bhef", kw, v.float()))
    n_new = decay[..., None] * n + kw.sum(dim=1)
    return (C_new, n_new, m_new), h


def mlstm_forward(params, cfg: ModelConfig, x, positions):
    """Chunkwise-parallel form: O(S·Q) memory instead of O(S²)."""
    d_in, H, Dh = mlstm_dims(cfg)
    B, S, _ = x.shape
    up = x @ params["w_up"]
    x_m, z = up.chunk(2, dim=-1)
    xc = F.silu(causal_conv(x_m, params["conv_w"]))
    q, k = _mlstm_qkv_gates(params, xc)
    v = torch.einsum("bsc,che->bshe", x_m, params["wv"])

    logi = (xc.float() @ params["wi"]) + params["bi"]          # (B,S,H)
    logf = F.logsigmoid((xc.float() @ params["wf"]) + params["bf"])

    Q = min(_MLSTM_CHUNK, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        def zpad(a, val=0.0):
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad), value=val)
        q, k, v = zpad(q), zpad(k), zpad(v)
        logi = zpad(logi, -30.0)     # padded steps: no input
        logf = zpad(logf, 0.0)       # keep state
    f32 = dict(dtype=torch.float32, device=x.device)
    carry = (torch.zeros((B, H, Dh, Dh), **f32),
             torch.zeros((B, H, Dh), **f32),
             torch.zeros((B, H), **f32) - 30.0)
    hs = []
    for c in range(nc):
        chunk = tuple(a[:, c * Q:(c + 1) * Q] for a in (q, k, v, logi, logf))
        carry, h = _mlstm_chunk_step(carry, chunk, Dh)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, nc * Q, d_in)[:, :S].to(x.dtype)
    h = h * params["out_norm"]
    return (h * F.silu(z)) @ params["w_down"]


# =========================================================================== #
# sLSTM (xLSTM scalar-memory cell with recurrent gating)
# =========================================================================== #
def slstm_dims(cfg: ModelConfig):
    H = cfg.num_heads
    return cfg.d_model, H, cfg.d_model // H


def slstm_defs(cfg: ModelConfig) -> dict:
    d, H, Dh = slstm_dims(cfg)
    dt = cfg.param_dtype
    f32 = torch.float32
    ff = int(cfg.xlstm.slstm_proj_factor * d)
    ff = -(-ff // 64) * 64
    return {
        # input projections for gates i, f, z, o
        "w_in": ParamDef((4, d, H, Dh), f32, scale=0.02),
        # block-diagonal recurrent projections (per head)
        "r": ParamDef((4, H, Dh, Dh), f32, scale=0.02),
        "b": ParamDef((4, H, Dh), f32, init="zeros"),
        "out_norm": ParamDef((d,), dt, init="ones"),
        # post-cell gated FFN (proj factor 4/3)
        "ffn_gate": ParamDef((d, ff), dt),
        "ffn_up": ParamDef((d, ff), dt),
        "ffn_down": ParamDef((ff, d), dt),
    }


def slstm_forward(params, cfg: ModelConfig, x, positions):
    d, H, Dh = slstm_dims(cfg)
    B, S, _ = x.shape
    zeros = torch.zeros((B, H, Dh), dtype=torch.float32, device=x.device)
    g_in = torch.einsum("bsd,gdhe->bsghe", x.float(),
                        params["w_in"])                      # (B,S,4,H,Dh)
    st0 = {"c": zeros, "n": zeros, "m": zeros - 30.0, "h": zeros}
    if cfg.use_slstm_kernel:
        from repro_torch.kernels.slstm_scan.ops import slstm_scan as scan
    else:
        from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref as scan
    hs, _ = scan(g_in, params["r"], params["b"], st0)
    h = hs.reshape(B, S, d).to(x.dtype)
    h = h * params["out_norm"]
    return (F.silu(h @ params["ffn_gate"]) * (h @ params["ffn_up"])) \
        @ params["ffn_down"]
