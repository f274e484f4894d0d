"""Differentiable nHSIC over the streaming kernels (port of
``repro.kernels.hsic_gram.ops``).

Forward and backward both recompute Gram tiles from the (B, D) activations,
so no B×B matrix is kept: the saved residuals are the two activation
matrices, the O(B) Gram row means and a few scalars.

Backward (H idempotent and self-adjoint, so centering commutes with the
adjoint): with T = Σ K̃xK̃z, N* = ‖K̃*‖_F, f = T/(NxNz+ε) and cotangent ḡ,

    ∂f/∂Kx = (K̃z − f·(Nz/Nx)·K̃x) / (NxNz+ε)

which gives G_x = cA·K̃z − cBx·K̃x (and symmetrically for z); the kernel maps
G back to the activations through the RBF or linear chain rule.  All
scalars stay on the device: no host synchronisation.

``nhsic_unfused`` is the forward-only baseline the streaming path is
benchmarked against: two dense (B, B) Grams in device memory, then their
centred statistics.
"""
from __future__ import annotations

import torch

from repro_torch.core.hsic import rbf_sigma2
from repro_torch.kernels.hsic_gram import kernel

_EPS = 1e-8
# Nx→0 guard; large enough that _TINY·_EPS does not flush to 0 in f32
_TINY = 1e-12


def _forward(x, z, lx: bool, lz: bool):
    """(value, residuals): row sums first (centering needs them), then the
    centred statistics."""
    B = x.shape[0]
    one = torch.ones((), device=x.device)
    s2x = one if lx else rbf_sigma2(x)
    s2z = one if lz else rbf_sigma2(z)
    rxs, rzs = kernel.nhsic_rowsums(x, z, torch.stack([s2x, s2z]),
                                    linear_x=lx, linear_z=lz)
    rx = rxs / B                      # Gram row means (= column means)
    rz = rzs / B
    s = torch.stack([s2x, s2z, rxs.sum() / (B * B), rzs.sum() / (B * B)])
    t, nx2, nz2 = kernel.nhsic_stats_feats(x, z, rx, rz, s, linear_x=lx,
                                           linear_z=lz)
    nx = torch.sqrt(nx2)
    nz = torch.sqrt(nz2)
    return t / (nx * nz + _EPS), (x, z, rx, rz, s, t, nx, nz)


class NHSIC(torch.autograd.Function):
    """nHSIC(x, z) with the streaming kernels forward and backward.

    In the ``setup_context`` form with a generated vmap rule, so that it
    composes with ``torch.func`` (``vmap(grad(...))``: the vectorized
    runtime): under vmap the three kernels each launch once for all
    cohorts.  The forward returns its residuals beside the value, as
    outputs that carry no gradient."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, z, linear_x: bool, linear_z: bool):
        out, (_, _, *res) = _forward(x, z, linear_x, linear_z)
        return (out, *res)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, z, linear_x, linear_z = inputs
        _, *res = output
        ctx.mark_non_differentiable(*res)
        ctx.save_for_backward(x, z, *res)
        ctx.linear = (linear_x, linear_z)

    @staticmethod
    def backward(ctx, g, *_):
        x, z, rx, rz, s, t, nx, nz = ctx.saved_tensors
        denom = nx * nz + _EPS
        f = t / denom
        # guard Nx→0 (a degenerate batch of identical rows): 0, not NaN
        c_a = g / denom
        c_bx = g * f * nz / (torch.clamp(nx, min=_TINY) * denom)
        c_bz = g * f * nx / (torch.clamp(nz, min=_TINY) * denom)
        scal = torch.cat([s, torch.stack([c_a, c_bx, c_bz])])
        lx, lz = ctx.linear
        with torch.no_grad():   # first order only; under torch.func.grad
            dx, dz = kernel.nhsic_grad(x, z, rx, rz, scal, linear_x=lx,
                                       linear_z=lz)
        return dx.to(x.dtype), dz.to(z.dtype), None, None


def nhsic(x, z, *, kernel_x: str = "rbf", kernel_z: str = "rbf"):
    """Differentiable nHSIC(x, z); x: (B, Dx), z: (B, Dz).  The kernels run
    for CUDA tensors, their plain versions for CPU tensors."""
    return NHSIC.apply(x.float().contiguous(), z.float().contiguous(),
                       kernel_x == "linear", kernel_z == "linear")[0]


def nhsic_residuals(x, z, *, kernel_x: str = "rbf", kernel_z: str = "rbf"):
    """(value, residuals) of the forward pass, to check that what backward
    keeps is O(B·D)."""
    with torch.no_grad():
        return _forward(x.float().contiguous(), z.float().contiguous(),
                        kernel_x == "linear", kernel_z == "linear")


def nhsic_unfused(x, z, *, kernel_x: str = "rbf", kernel_z: str = "rbf"):
    """Forward-only nHSIC(x, z) through the dense-Gram kernels: ``gram``
    twice, then ``gram_stats``.  Not differentiable: it runs under
    ``torch.no_grad``."""
    with torch.no_grad():
        lx, lz = kernel_x == "linear", kernel_z == "linear"
        one = torch.ones((), device=x.device)
        kx = kernel.gram(x, one if lx else rbf_sigma2(x), linear=lx)
        kz = kernel.gram(z, one if lz else rbf_sigma2(z), linear=lz)
        t, nx2, nz2 = kernel.gram_stats(kx, kz)
        return t / (torch.sqrt(nx2) * torch.sqrt(nz2) + _EPS)
