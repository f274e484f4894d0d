"""Differentiable sLSTM scan (port of ``repro.kernels.slstm_scan.ops``).

The forward is the CUDA kernel (``kernel.slstm_scan_fwd``; its plain
version on CPU tensors).  The backward recomputes through autograd of
``ref.slstm_scan_ref``, as the reference's ``_scan_bwd`` takes the VJP of
its ``slstm_scan_ref``: the JAX package has no backward kernel, so neither
has the port.  Only ``g_in``, ``r``, ``b`` and the initial state are saved.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.slstm_scan import kernel, ref

_STATE = ("c", "n", "m", "h")


class SLSTMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g_in, r, b, c0, n0, m0, h0):
        ctx.save_for_backward(g_in, r, b, c0, n0, m0, h0)
        return kernel.slstm_scan_fwd(g_in, r, b, c0, n0, m0, h0)

    @staticmethod
    def backward(ctx, *cts):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            hs, fin = ref.slstm_scan_ref(*leaves[:3],
                                         dict(zip(_STATE, leaves[3:])))
            # an output the caller did not use has a cotangent of zeros
            return torch.autograd.grad([hs] + [fin[k] for k in _STATE],
                                       leaves, cts)


def slstm_scan(g_in, r, b, state0: dict):
    """g_in: (B, S, 4, H, Dh); r: (4, H, Dh, Dh); b: (4, H, Dh); state0:
    dict(c, n, m, h) each (B, H, Dh).  Returns (hs (B, S, H, Dh), final
    state dict).  Differentiable in all four inputs (backward: autograd of
    the plain version)."""
    hs, *fin = SLSTMScan.apply(g_in.contiguous(), r.contiguous(),
                               b.contiguous(),
                               *(state0[k].contiguous() for k in _STATE))
    return hs, dict(zip(_STATE, fin))
