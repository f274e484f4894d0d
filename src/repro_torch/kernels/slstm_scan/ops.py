"""Differentiable sLSTM scan (port of ``repro.kernels.slstm_scan.ops``).

The forward is the CUDA kernel (``kernel.slstm_scan_fwd``; its plain
version on CPU tensors).  Under ``torch.func.vmap`` (the vectorized round)
both kernels run batched over the cohorts through their vmap rules, and
torch batches r's and b's gradients.  When a gradient is needed it also saves the
per-step pre-activations and states, and the backward is the reverse-scan
kernel (``kernel.slstm_scan_bwd``; ``ref.slstm_scan_bwd_ref`` on CPU
tensors), the counterpart of the reference's ``_scan_bwd``, which takes the
VJP of its plain scan.  r's and b's gradients are two plain large products
of the gate gradients, as XLA computes them in the reference.  Without
grad (the frozen prefix, evaluation) nothing is saved.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.audit import KernelAuditCase
from repro_torch.kernels.slstm_scan import kernel
from repro_torch.kernels.slstm_scan.kernel import STATE


class SLSTMScan(torch.autograd.Function):
    """In the ``setup_context`` form with a generated vmap rule, so that it
    composes with ``torch.func`` (``vmap(grad(...))``: the vectorized
    runtime): under vmap forward and backward kernels each launch for all
    cohorts at once.  ``save`` (the caller's: whether a gradient is needed)
    makes the forward also return the per-step pre-activations and
    states, as outputs that carry no gradient."""

    generate_vmap_rule = True

    @staticmethod
    def forward(g_in, r, b, c0, n0, m0, h0, save: bool):
        return kernel.slstm_scan_fwd(g_in, r, b, c0, n0, m0, h0, save=save)

    @staticmethod
    def setup_context(ctx, inputs, output):
        if inputs[-1]:
            r, c0, n0, m0, h0 = inputs[1], *inputs[3:7]
            hs, *_, g, cs, ns, ms = output
            ctx.mark_non_differentiable(g, cs, ns, ms)
            ctx.save_for_backward(r, c0, n0, m0, h0, hs, g, cs, ns, ms)

    @staticmethod
    def backward(ctx, dhs, dc, dn, dm, dh, *_):
        r, c0, n0, m0, h0, hs, g, cs, ns, ms = ctx.saved_tensors
        with torch.no_grad():   # first order only; under torch.func.grad
            dg, dc0, dn0, dm0, dh0 = kernel.slstm_scan_bwd(
                g, cs, ns, ms, r, c0, n0, m0,
                *(t.contiguous() for t in (dhs, dc, dn, dm, dh)))
        h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
        dr = torch.einsum("bshe,bsghj->ghej", h_prev, dg)
        return dg, dr, dg.sum(dim=(0, 1)), dc0, dn0, dm0, dh0, None


def slstm_scan(g_in, r, b, state0: dict):
    """g_in: (B, S, 4, H, Dh); r: (4, H, Dh, Dh); b: (4, H, Dh); state0:
    dict(c, n, m, h) each (B, H, Dh).  Returns (hs (B, S, H, Dh), final
    state dict).  Differentiable in all four inputs (backward: the
    reverse-scan kernel); without grad nothing is saved."""
    inputs = (g_in, r, b, *(state0[k] for k in STATE))
    save = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    hs, *fin = SLSTMScan.apply(*(t.contiguous() for t in inputs), save)[:5]
    return hs, dict(zip(STATE, fin))


# --------------------------------------------------------------------------- #
# the kernel audit's registry (analysis/kernel_audit.py)
# --------------------------------------------------------------------------- #
def _slstm_case(name, B, H, S, Dh):
    state = (B, H, Dh)
    return KernelAuditCase(
        family="slstm_scan", name=name, source=kernel.SOURCE,
        kernels=("slstm_fwd_kernel", "slstm_bwd_kernel"),
        shapes=((B, S, 4, H, Dh), (4, H, Dh, Dh), (4, H, Dh)) + (state,) * 4,
        dtypes=("float32",) * 7,
        notes="r resident or streamed: the launch picks the kernel's form")


def AUDIT_CASES():
    """The reference's two sLSTM-scan audit cases."""
    return [_slstm_case("scan_Dh512_S256", 2, 2, 256, 512),
            _slstm_case("scan_Dh64_S128", 2, 4, 128, 64)]
