"""Plain PyTorch version of the flash-attention kernel (port of
``repro.kernels.flash_attention.ref``).

Grouped (GQA) scaled-dot-product attention with causal and sliding-window
masks, computed in float32.  The kernel wrapper takes it for CPU tensors;
on the card it is what the kernel is held against, and its autograd is the
backward of ``ops.flash_attention``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(Sq: int, Skv: int, causal: bool, window: int, device):
    """(Sq, Skv) bool of allowed (query, key) pairs, both positions counted
    from 0."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D); H % KV == 0.

    Returns (B, Sq, H, D) in q.dtype.  A row with no allowed key (causal
    with a window can mask a whole row) is 0, not the mean of v that the
    finite NEG_INF softmax would give."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    mask = attention_mask(Sq, Skv, causal, window, q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(dim=-1)[:, None], probs,
                        torch.zeros_like(probs))
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)
