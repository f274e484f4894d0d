"""Plain PyTorch versions of the nHSIC kernels.

Each function has the signature of its kernel wrapper in ``kernel.py`` and
computes the same thing with dense (B, B) Grams, per cohort where the
inputs carry leading cohort axes.  The wrappers use them for
CPU tensors; on the card they are what the kernels are held against.
"""
from __future__ import annotations

import torch

from repro_torch.core.hsic import center


def gram(a, s2, linear: bool):
    """(..., B, D) -> (..., B, B) Gram: linear a·aᵀ, or RBF
    exp(−max(‖a‖²+‖b‖²−2a·b, 0) / 2σ²); σ² broadcasts against the Gram."""
    a = a.float()
    dot = a @ a.mT
    if linear:
        return dot
    sq = (a * a).sum(-1)
    d2 = torch.clamp(sq[..., :, None] + sq[..., None, :] - 2.0 * dot,
                     min=0.0)
    return torch.exp(-d2 / (2.0 * s2))


def gram_stats(Kx, Kz):
    """Two (B, B) Grams -> (3,) [Σ K̃x∘K̃z, ‖K̃x‖², ‖K̃z‖²] with
    K̃ = K − rowmean_i − colmean_j + mean (``core.hsic.center``); neither
    Gram need be symmetric."""
    kxc, kzc = center(Kx.float()), center(Kz.float())
    return torch.stack([(kxc * kzc).sum(), (kxc * kxc).sum(),
                        (kzc * kzc).sum()])


# K1-K3's plain versions take any leading (cohort) axes in front of x's
# (B, D), as the kernels do: s2 (..., 2), s (..., 4), scal (..., 7) and
# rx (..., B) carry the same leading axes.
def _tile(v):
    """(...,) -> (..., 1, 1): a per-cohort scalar against a (B, B) tile."""
    return v[..., None, None]


def _centred(K, r, m):
    return K - r[..., :, None] - r[..., None, :] + _tile(m)


def _sums(a, b, c):
    return torch.stack([a.sum((-2, -1)), b.sum((-2, -1)), c.sum((-2, -1))],
                       dim=-1)


def nhsic_rowsums(x, z, s2, *, linear_x: bool = False,
                  linear_z: bool = False):
    """s2 = [σ²x, σ²z] -> (row sums of Kx, row sums of Kz), each (B,)."""
    return (gram(x, _tile(s2[..., 0]), linear_x).sum(-1),
            gram(z, _tile(s2[..., 1]), linear_z).sum(-1))


def nhsic_stats_feats(x, z, rx, rz, s, *, linear_x: bool = False,
                      linear_z: bool = False):
    """s = [σ²x, σ²z, mean Kx, mean Kz]; rx, rz the Gram row means ->
    (3,) [tr(K̃xK̃z), ‖K̃x‖², ‖K̃z‖²]."""
    kxc = _centred(gram(x, _tile(s[..., 0]), linear_x), rx, s[..., 2])
    kzc = _centred(gram(z, _tile(s[..., 1]), linear_z), rz, s[..., 3])
    return _sums(kxc * kzc, kxc * kxc, kzc * kzc)


def nhsic_grad(x, z, rx, rz, scal, *, linear_x: bool = False,
               linear_z: bool = False):
    """scal = [σ²x, σ²z, mean Kx, mean Kz, cA, cBx, cBz] -> (dx, dz).

    G_x = cA·K̃z − cBx·K̃x (and symmetrically for z); RBF:
    dx_i = 4·(rowsum(W)_i·x_i − (W·x)_i) with W = G∘K·(−1/2σ²); linear:
    dx = 2·G·x."""
    s2x, s2z, mx, mz, c_a, c_bx, c_bz = (_tile(scal[..., k])
                                         for k in range(7))
    x = x.float()
    z = z.float()
    kx = gram(x, s2x, linear_x)
    kz = gram(z, s2z, linear_z)
    kxc = kx - rx[..., :, None] - rx[..., None, :] + mx
    kzc = kz - rz[..., :, None] - rz[..., None, :] + mz
    g_x = c_a * kzc - c_bx * kxc
    g_z = c_a * kxc - c_bz * kzc

    def chain(g, k, a, s2, linear):
        if linear:
            return 2.0 * (g @ a)
        w = g * k * (-1.0 / (2.0 * s2))
        return 4.0 * (w.sum(-1)[..., :, None] * a - w @ a)

    return (chain(g_x, kx, x, s2x, linear_x),
            chain(g_z, kz, z, s2z, linear_z))
