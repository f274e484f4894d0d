"""Recurrent sequence layers (port of ``repro.models.ssm``): the Mamba-1
selective SSM (Jamba), and the xLSTM cells, mLSTM with matrix memory, in
its chunkwise-parallel form, and sLSTM with scalar memory and recurrent
gating; each with its one-token decode.

The reference's ``lax.scan`` over chunks (Mamba, mLSTM) and over time
(sLSTM) become Python loops.  Mamba's selective scan runs in float32 as a
first-order recurrence, step by step within each 256-step chunk (the
reference's ``associative_scan`` over (dA, dBx) pairs computes the same
recurrence in a log-depth order).  With ``ModelConfig.use_slstm_kernel`` the sLSTM time
scan runs in the hand-written CUDA kernel (``kernels/slstm_scan``);
otherwise in that kernel's plain per-step loop (``slstm_scan/ref.py``).

``*_forward(..., with_cache=True)`` also returns the final recurrent state,
which ``*_decode`` carries one token on (serving):
  Mamba: ``{"h": (B, d_in, N) float32, "conv": (B, K-1, d_in)}`` (the
           conv's last K-1 = 3 pre-conv inputs, zero-padded in front for a
           prompt shorter than that, as mLSTM's below)
  mLSTM: ``{"C": (B, H, Dh, Dh), "n": (B, H, Dh), "m": (B, H),
           "conv": (B, 3, d_in)}`` (the conv's last three inputs,
           zero-padded in front for a prompt shorter than three tokens;
           the reference pads such a prompt's behind, and its decode then
           convolves the wrong taps)
  sLSTM: ``{"c", "n", "m", "h"}``, each (B, H, Dh), the scan's final state
The decode steps run no kernel, as the reference's do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common.paramdef import ParamDef
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MODEL_AXIS


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


def causal_conv_step(x_t, buf, w, b=None):
    """One step of ``causal_conv``: x_t (B, C) the new input, buf (B, K-1,
    C) the previous ones.  Returns (y (B, C), the new buffer)."""
    window = torch.cat([buf, x_t[:, None, :]], dim=1)           # (B, K, C)
    y = torch.einsum("bkc,ck->bc", window, w.flip(-1))
    if b is not None:
        y = y + b
    return y, window[:, 1:, :]


# =========================================================================== #
# Mamba-1
# =========================================================================== #
def mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, s.d_state, s.d_conv


def mamba_defs(cfg: ModelConfig) -> dict:
    """``dt_bias``, ``A_log`` and ``D`` are float32 in any model dtype."""
    d = cfg.d_model
    d_in, dt_rank, N, K = mamba_dims(cfg)
    dt = cfg.param_dtype
    f32 = torch.float32
    return {
        "in_proj": ParamDef((d, 2 * d_in), dt, (None, MODEL_AXIS)),
        "conv_w": ParamDef((d_in, K), dt, (MODEL_AXIS,), scale=0.1),
        "conv_b": ParamDef((d_in,), dt, (MODEL_AXIS,), init="zeros"),
        "x_proj": ParamDef((d_in, dt_rank + 2 * N), dt, (MODEL_AXIS,)),
        "dt_proj": ParamDef((dt_rank, d_in), dt, (None, MODEL_AXIS)),
        "dt_bias": ParamDef((d_in,), f32, (MODEL_AXIS,), init="zeros"),
        "A_log": ParamDef((d_in, N), f32, (MODEL_AXIS,), init="zeros"),
        "D": ParamDef((d_in,), f32, (MODEL_AXIS,), init="ones"),
        "out_proj": ParamDef((d_in, d), dt, (MODEL_AXIS,)),
    }


def _mamba_ssm_inputs(params, cfg, xc):
    """xc: (B, S, d_in) post-conv activations -> (dt, Bs, Cs), float32."""
    _, dt_rank, N, _ = mamba_dims(cfg)
    proj = xc @ params["x_proj"]
    dt_lo, Bs, Cs = proj.split([dt_rank, N, N], dim=-1)
    dt = F.softplus((dt_lo @ params["dt_proj"]).float() + params["dt_bias"])
    return dt, Bs.float(), Cs.float()


_MAMBA_CHUNK = 256


def _mamba_scan(dt, Bs, Cs, xc, A, h0):
    """The selective scan h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t =
    C_t . h_t, in float32 over chunks of 256 steps.

    dt, xc: (B, S, d_in); Bs, Cs: (B, S, N); A: (d_in, N); h0: (B, d_in, N).
    Returns y (B, S, d_in) float32 and the final state.  As in the
    reference, S is padded with zeros to whole chunks: there dt = 0, so
    exp(dt A) = 1 and the padded steps leave the state as it is.  Within a
    chunk the recurrence runs step by step (no running product of
    exp(dt A) divided out later: at A = -1, the init, that product
    underflows float32 well inside a chunk).  Memory: autograd keeps a
    chunk's exp(dt A), its states and their stack, three (B, 256, d_in, N)
    float32 tensors a chunk (at Jamba's d_in = 16384, N = 16 and B = 2,
    1.61 GB a chunk)."""
    Bsz, S, d_in = xc.shape
    Q = min(_MAMBA_CHUNK, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        dt, Bs, Cs, xc = (F.pad(a, (0, 0, 0, pad)) for a in (dt, Bs, Cs, xc))
    h, ys = h0, []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        dt_c = dt[:, sl]
        dA = torch.exp(dt_c[..., None] * A)                  # (B,Q,d_in,N)
        dBx = (dt_c * xc[:, sl].float())[..., None] * Bs[:, sl, None, :]
        hs = []
        for q in range(Q):
            h = dA[:, q] * h + dBx[:, q]
            hs.append(h)
        ys.append(torch.einsum("bqdn,bqn->bqd", torch.stack(hs, 1),
                               Cs[:, sl]))
    y = torch.cat(ys, dim=1)[:, :S]
    return y, h


def mamba_forward(params, cfg: ModelConfig, x, positions, *,
                  with_cache=False):
    """x (B, S, d) -> y, and with ``with_cache`` (y, cache)."""
    d_in, _, N, K = mamba_dims(cfg)
    B, S, _ = x.shape
    xz = x @ params["in_proj"]
    x1, z = xz.chunk(2, dim=-1)
    xc = F.silu(causal_conv(x1, params["conv_w"], params["conv_b"]))
    dt, Bs, Cs = _mamba_ssm_inputs(params, cfg, xc)
    A = -torch.exp(params["A_log"])
    h0 = torch.zeros((B, d_in, N), dtype=torch.float32, device=x.device)
    y, h = _mamba_scan(dt, Bs, Cs, xc, A, h0)
    y = (y + params["D"] * xc.float()).to(x.dtype)
    out = (y * F.silu(z)) @ params["out_proj"]
    if not with_cache:
        return out
    conv = F.pad(x1[:, -(K - 1):], (0, 0, max(0, K - 1 - S), 0))
    return out, {"h": h, "conv": conv}


def mamba_decode(params, cfg: ModelConfig, x, cache, pos: int):
    """x: (B, 1, d) -> (y (B, 1, d), the new cache)."""
    xz = x[:, 0] @ params["in_proj"]
    x1, z = xz.chunk(2, dim=-1)
    xc_t, conv = causal_conv_step(x1, cache["conv"], params["conv_w"],
                                  params["conv_b"])
    xc = F.silu(xc_t)[:, None]                           # (B, 1, d_in)
    dt, Bs, Cs = _mamba_ssm_inputs(params, cfg, xc)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[:, 0, :, None] * A)                # (B, d_in, N)
    dBx = (dt[:, 0] * xc[:, 0].float())[..., None] * Bs[:, 0, None]
    h = dA * cache["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h, Cs[:, 0])
    y = (y + params["D"] * xc[:, 0].float()).to(x.dtype)
    out = (y * F.silu(z))[:, None] @ params["out_proj"]
    return out, {"h": h, "conv": conv}


def mamba_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    d_in, _, N, K = mamba_dims(cfg)
    bspec = ("pod", "data")
    return {"h": ParamDef((batch, d_in, N), torch.float32,
                          (bspec, MODEL_AXIS), init="zeros"),
            "conv": ParamDef((batch, K - 1, d_in), cfg.param_dtype,
                             (bspec, None, MODEL_AXIS), init="zeros")}


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
        "w_up": ParamDef((d, 2 * d_in), dt, (None, MODEL_AXIS)),
        "conv_w": ParamDef((d_in, 4), dt, (MODEL_AXIS,), scale=0.1),
        "wq": ParamDef((d_in, H, Dh), dt, (None, MODEL_AXIS)),
        "wk": ParamDef((d_in, H, Dh), dt, (None, MODEL_AXIS)),
        "wv": ParamDef((d_in, H, Dh), dt, (None, MODEL_AXIS)),
        "wi": ParamDef((d_in, H), f32, (None, MODEL_AXIS), scale=0.02),
        "wf": ParamDef((d_in, H), f32, (None, MODEL_AXIS), scale=0.02),
        "bi": ParamDef((H,), f32, (MODEL_AXIS,), init="zeros"),
        "bf": ParamDef((H,), f32, (MODEL_AXIS,), init="ones"),
        "out_norm": ParamDef((d_in,), dt, (MODEL_AXIS,), init="ones"),
        "w_down": ParamDef((d_in, d), dt, (MODEL_AXIS,)),
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


def mlstm_forward(params, cfg: ModelConfig, x, positions, *,
                  with_cache=False):
    """Chunkwise-parallel form: O(S·Q) memory instead of O(S²).  Returns
    y, and with ``with_cache`` (y, cache)."""
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
    y = (h * F.silu(z)) @ params["w_down"]
    if not with_cache:
        return y
    C, n, m = carry
    conv = F.pad(x_m[:, -3:], (0, 0, max(0, 3 - S), 0))
    return y, {"C": C, "n": n, "m": m, "conv": conv}


def mlstm_decode(params, cfg: ModelConfig, x, cache, pos: int):
    """x: (B, 1, d) -> (y (B, 1, d), the new cache)."""
    d_in, H, Dh = mlstm_dims(cfg)
    B = x.shape[0]
    up = x[:, 0] @ params["w_up"]
    x_m, z = up.chunk(2, dim=-1)
    xc_t, conv = causal_conv_step(x_m, cache["conv"], params["conv_w"])
    xc = F.silu(xc_t)
    q = torch.einsum("bc,che->bhe", xc, params["wq"])
    k = torch.einsum("bc,che->bhe", xc, params["wk"])
    v = torch.einsum("bc,che->bhe", x_m, params["wv"])

    logi = (xc.float() @ params["wi"]) + params["bi"]          # (B,H)
    logf = F.logsigmoid((xc.float() @ params["wf"]) + params["bf"])
    m_new = torch.maximum(logf + cache["m"], logi)
    f_s = torch.exp(logf + cache["m"] - m_new)[..., None]
    i_s = torch.exp(logi - m_new)[..., None]
    kf = k.float()
    C = f_s[..., None] * cache["C"] + i_s[..., None] * torch.einsum(
        "bhe,bhf->bhef", kf, v.float())
    n = f_s * cache["n"] + i_s * kf
    qf = q.float() / math.sqrt(Dh)
    num = torch.einsum("bhef,bhe->bhf", C, qf)
    den = torch.maximum(torch.abs(torch.einsum("bhe,bhe->bh", n, qf)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, d_in).to(x.dtype)
    h = h * params["out_norm"]
    y = ((h * F.silu(z)) @ params["w_down"])[:, None]
    return y, {"C": C, "n": n, "m": m_new, "conv": conv}


def mlstm_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    d_in, H, Dh = mlstm_dims(cfg)
    bspec = ("pod", "data")
    f32 = torch.float32
    return {
        "C": ParamDef((batch, H, Dh, Dh), f32, (bspec, MODEL_AXIS),
                      init="zeros"),
        "n": ParamDef((batch, H, Dh), f32, (bspec, MODEL_AXIS),
                      init="zeros"),
        "m": ParamDef((batch, H), f32, (bspec, MODEL_AXIS), init="zeros"),
        "conv": ParamDef((batch, 3, d_in), cfg.param_dtype,
                         (bspec, None, MODEL_AXIS), init="zeros"),
    }


# =========================================================================== #
# sLSTM (xLSTM scalar-memory cell with recurrent gating)
# =========================================================================== #
STATE = ("c", "n", "m", "h")     # the sLSTM cache's leaves, in order


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
        "w_in": ParamDef((4, d, H, Dh), f32, (None, None, MODEL_AXIS),
                         scale=0.02),
        # block-diagonal recurrent projections (per head)
        "r": ParamDef((4, H, Dh, Dh), f32, (None, MODEL_AXIS), scale=0.02),
        "b": ParamDef((4, H, Dh), f32, (None, MODEL_AXIS), init="zeros"),
        "out_norm": ParamDef((d,), dt, init="ones"),
        # post-cell gated FFN (proj factor 4/3)
        "ffn_gate": ParamDef((d, ff), dt, (None, MODEL_AXIS)),
        "ffn_up": ParamDef((d, ff), dt, (None, MODEL_AXIS)),
        "ffn_down": ParamDef((ff, d), dt, (MODEL_AXIS,)),
    }


def _slstm_step(params, carry, g_in):
    """The plain one-step recurrence.  carry: (c, n, m, h), each (B, H,
    Dh); g_in: (B, 4, H, Dh).  One step of the scan's plain version
    (``slstm_scan/ref.py``: the recurrent projection as four per-gate
    products, as in the reference).  Returns (the new carry, h)."""
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
    hs, fin = slstm_scan_ref(g_in[:, None], params["r"], params["b"],
                             dict(zip(STATE, carry)))
    return tuple(fin[k] for k in STATE), hs[:, 0]


def _slstm_ffn(params, h):
    return (F.silu(h @ params["ffn_gate"]) * (h @ params["ffn_up"])) \
        @ params["ffn_down"]


def slstm_forward(params, cfg: ModelConfig, x, positions, *,
                  with_cache=False):
    """Returns y, and with ``with_cache`` (y, the scan's final state)."""
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
    hs, fin = scan(g_in, params["r"], params["b"], st0)
    h = hs.reshape(B, S, d).to(x.dtype)
    y = _slstm_ffn(params, h * params["out_norm"])
    if not with_cache:
        return y
    return y, {k: fin[k] for k in STATE}


def slstm_decode(params, cfg: ModelConfig, x, cache, pos: int):
    """x: (B, 1, d) -> (y (B, 1, d), the new state)."""
    d, H, Dh = slstm_dims(cfg)
    B = x.shape[0]
    g_in = torch.einsum("bd,gdhe->bghe", x[:, 0].float(), params["w_in"])
    state, h = _slstm_step(params, tuple(cache[k] for k in STATE), g_in)
    h = h.reshape(B, d).to(x.dtype) * params["out_norm"]
    return _slstm_ffn(params, h)[:, None], dict(zip(STATE, state))


def slstm_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    _, H, Dh = slstm_dims(cfg)
    return {k: ParamDef((batch, H, Dh), torch.float32,
                        (("pod", "data"), MODEL_AXIS), init="zeros")
            for k in STATE}
