"""Differentiable flash attention (port of
``repro.kernels.flash_attention.ops``).

The forward is the CUDA kernel (``kernel.flash_attention_fwd``; its plain
version on CPU tensors).  The backward recomputes through autograd of
``ref.attention_ref``, as the reference's ``_flash_bwd`` takes the VJP of
its ``attention_ref``: the JAX package has no backward kernel, so neither
has the port.  Only q, k and v are saved.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window)
        return kernel.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, window = ctx.mask
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = ref.attention_ref(*leaves, causal=causal, window=window)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D); H % KV == 0.  Returns
    (B, Sq, H, D).  Differentiable (backward: autograd of the plain
    version)."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), bool(causal), int(window))
