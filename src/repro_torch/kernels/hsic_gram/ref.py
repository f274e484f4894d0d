"""Plain PyTorch versions of the streaming nHSIC kernels.

Each function has the signature of its kernel wrapper in ``kernel.py`` and
computes the same thing with dense (B, B) Grams.  The wrappers use them for
CPU tensors; on the card they are what the kernels are held against.
"""
from __future__ import annotations

import torch


def gram(a, s2, linear: bool):
    """(B, D) -> (B, B) Gram: linear a·aᵀ, or RBF
    exp(−max(‖a‖²+‖b‖²−2a·b, 0) / 2σ²)."""
    a = a.float()
    dot = a @ a.T
    if linear:
        return dot
    sq = (a * a).sum(1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * dot, min=0.0)
    return torch.exp(-d2 / (2.0 * s2))


def _centred(K, r, m):
    return K - r[:, None] - r[None, :] + m


def nhsic_rowsums(x, z, s2, *, linear_x: bool = False,
                  linear_z: bool = False):
    """s2 = [σ²x, σ²z] -> (row sums of Kx, row sums of Kz), each (B,)."""
    return (gram(x, s2[0], linear_x).sum(1),
            gram(z, s2[1], linear_z).sum(1))


def nhsic_stats_feats(x, z, rx, rz, s, *, linear_x: bool = False,
                      linear_z: bool = False):
    """s = [σ²x, σ²z, mean Kx, mean Kz]; rx, rz the Gram row means ->
    (3,) [tr(K̃xK̃z), ‖K̃x‖², ‖K̃z‖²]."""
    kxc = _centred(gram(x, s[0], linear_x), rx, s[2])
    kzc = _centred(gram(z, s[1], linear_z), rz, s[3])
    return torch.stack([(kxc * kzc).sum(), (kxc * kxc).sum(),
                        (kzc * kzc).sum()])


def nhsic_grad(x, z, rx, rz, scal, *, linear_x: bool = False,
               linear_z: bool = False):
    """scal = [σ²x, σ²z, mean Kx, mean Kz, cA, cBx, cBz] -> (dx, dz).

    G_x = cA·K̃z − cBx·K̃x (and symmetrically for z); RBF:
    dx_i = 4·(rowsum(W)_i·x_i − (W·x)_i) with W = G∘K·(−1/2σ²); linear:
    dx = 2·G·x."""
    s2x, s2z, mx, mz, c_a, c_bx, c_bz = scal
    x = x.float()
    z = z.float()
    kx = gram(x, s2x, linear_x)
    kz = gram(z, s2z, linear_z)
    kxc = _centred(kx, rx, mx)
    kzc = _centred(kz, rz, mz)
    g_x = c_a * kzc - c_bx * kxc
    g_z = c_a * kxc - c_bz * kzc

    def chain(g, k, a, s2, linear):
        if linear:
            return 2.0 * (g @ a)
        w = g * k * (-1.0 / (2.0 * s2))
        return 4.0 * (w.sum(1)[:, None] * a - w @ a)

    return (chain(g_x, kx, x, s2x, linear_x),
            chain(g_z, kz, z, s2z, linear_z))
