"""Differentiable flash attention (port of
``repro.kernels.flash_attention.ops``).

The forward is the CUDA kernel (``kernel.flash_attention_fwd``; its plain
version on CPU tensors).  The backward recomputes through
``torch.func.vjp`` of ``ref.attention_ref``, as the reference's ``_flash_bwd`` takes the VJP of
its ``attention_ref``: the JAX package has no backward kernel, so neither
has the port.  Only q, k and v are saved.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.audit import KernelAuditCase
from repro_torch.kernels.flash_attention import kernel, ref


class FlashAttention(torch.autograd.Function):
    """In the ``setup_context`` form with a generated vmap rule, so that it
    composes with ``torch.func`` (``vmap(grad(...))``: the vectorized
    runtime): under vmap the forward's op folds the cohorts into its batch
    axis, and the backward is ``torch.func.vjp`` of the plain attention."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, causal: bool, window: int):
        return kernel.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, window = ctx.mask
        _, vjp = torch.func.vjp(
            lambda q_, k_, v_: ref.attention_ref(q_, k_, v_, causal=causal,
                                                 window=window), q, k, v)
        return (*vjp(g), None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D); H % KV == 0.  Returns
    (B, Sq, H, D).  Differentiable (backward: autograd of the plain
    version)."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), bool(causal), int(window))


# --------------------------------------------------------------------------- #
# the kernel audit's registry (analysis/kernel_audit.py)
# --------------------------------------------------------------------------- #
def _flash_case(name, B, H, S, D, dtype, notes=""):
    shape = (B, S, H, D)
    return KernelAuditCase(
        family="flash_attention", name=name, source=kernel.SOURCE,
        kernels=("flash_fwd_kernel",), shapes=(shape, shape, shape),
        dtypes=(dtype,) * 3, notes=notes)


def AUDIT_CASES():
    """The reference's flash audit cases: its shapes and dtypes, q, k and
    v in the port's (B, S, H, D) layout."""
    return [
        _flash_case("fwd_f32_B2H2S1024D64", 2, 2, 1024, 64, "float32"),
        _flash_case("fwd_bf16_B2H2S512D64", 2, 2, 512, 64, "bfloat16",
                    "bf16 operands, f32 accumulation"),
        _flash_case("fwd_f32_pad_S200", 1, 2, 200, 64, "float32",
                    "a ragged sequence: the kernel masks the last tile"),
        _flash_case("fwd_f32_windowed", 1, 1, 512, 32, "float32",
                    "causal=False, window=64"),
    ]
