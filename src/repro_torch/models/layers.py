"""Shared layers (port of ``repro.models.layers``): RMSNorm, rotary
embeddings, MLPs, embeddings, output heads and the cross-entropy.

Every layer is a pair of functions, as in the reference:
``<layer>_defs(...) -> ParamDef tree`` and ``<layer>(params, x, ...) -> y``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.paramdef import ParamDef


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #
def rmsnorm_defs(d: int, dtype) -> dict:
    return {"scale": ParamDef((d,), dtype, init="ones")}


def rmsnorm(params, x, eps: float = 1e-5):
    """Computed in float32, returned in ``x``'s dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------- #
# rotary position embeddings (rotate-half layout)
# --------------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)            # (head_dim // 2,)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs   # (..., S, D/2)
    angles = angles[..., None, :]                    # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------------- #
def mlp_defs(d_model: int, d_ff: int, dtype, act: str = "swiglu") -> dict:
    defs = {"w_up": ParamDef((d_model, d_ff), dtype),
            "w_down": ParamDef((d_ff, d_model), dtype)}
    if act == "swiglu":
        defs["w_gate"] = ParamDef((d_model, d_ff), dtype)
    return defs


def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp(params, x, act: str = "swiglu"):
    up = x @ params["w_up"]
    if act == "swiglu":
        up = F.silu(x @ params["w_gate"]) * up
    else:
        up = gelu(up)
    return up @ params["w_down"]


# --------------------------------------------------------------------------- #
# embeddings / output heads
# --------------------------------------------------------------------------- #
def embedding_defs(vocab: int, d_model: int, dtype) -> dict:
    return {"table": ParamDef((vocab, d_model), dtype, init="embed")}


def embed(params, tokens):
    return params["table"][tokens.long()]


def head_defs(d_model: int, vocab: int, dtype) -> dict:
    return {"w_out": ParamDef((d_model, vocab), dtype)}


def lm_head(params, x):
    """Logits (..., vocab)."""
    return x @ params["w_out"]


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #
def cross_entropy(logits, labels, mask=None):
    """Mean cross-entropy. logits (..., V) float; labels (...) int; with
    ``mask`` the mean runs over the positions where it is set."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
