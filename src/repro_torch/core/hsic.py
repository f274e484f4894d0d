"""Normalized HSIC estimator, plain PyTorch (port of ``repro.core.hsic``).

    nHSIC(A, B) = tr(K̃_A K̃_B) / (‖K̃_A‖_F ‖K̃_B‖_F),   K̃ = H K H

with a Gaussian kernel at the mean-distance bandwidth for continuous
features and a linear kernel for one-hot labels.  ``use_kernel=True`` routes
through the streaming CUDA kernels (``kernels.hsic_gram.ops``).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def pairwise_sqdists(x):
    """x: (B, D) -> (B, B) squared euclidean distances."""
    x = x.float()
    sq = (x * x).sum(-1)
    return torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), min=0.0)


def rbf_sigma2(x):
    """Mean pairwise squared distance in O(B·D):
    mean_ij ‖xi−xj‖² = 2·mean_i‖xi‖² − 2·‖mean_i xi‖².  Detached: the
    bandwidth is an estimator setting, not a learning signal."""
    x = x.detach().float()
    s = 2.0 * (x * x).sum(1).mean() - 2.0 * x.mean(0).square().sum()
    return torch.clamp(s, min=_EPS)


def gram_rbf(x):
    """Gaussian-kernel Gram at the mean-distance bandwidth."""
    return torch.exp(-pairwise_sqdists(x) / (2.0 * rbf_sigma2(x)))


def gram_linear(x):
    x = x.float()
    return x @ x.T


def center(K):
    """K̃ = H K H with H = I − 11ᵀ/m."""
    row = K.mean(0, keepdim=True)
    col = K.mean(1, keepdim=True)
    return K - row - col + K.mean()


def nhsic_from_grams(Kx, Kz):
    Kxc, Kzc = center(Kx), center(Kz)
    num = (Kxc * Kzc).sum()
    den = torch.linalg.norm(Kxc) * torch.linalg.norm(Kzc) + _EPS
    return num / den


def nhsic(x, z, *, kernel_x: str = "rbf", kernel_z: str = "rbf",
          use_kernel: bool = False):
    """nHSIC between x: (B, Dx) and z: (B, Dz)."""
    if use_kernel:
        from repro_torch.kernels.hsic_gram import ops
        return ops.nhsic(x, z, kernel_x=kernel_x, kernel_z=kernel_z)
    gx = gram_rbf(x) if kernel_x == "rbf" else gram_linear(x)
    gz = gram_rbf(z) if kernel_z == "rbf" else gram_linear(z)
    return nhsic_from_grams(gx, gz)


def label_features(labels, num_classes: int, max_dim: int = 256):
    """Labels -> unit-norm features whose linear Gram measures label
    agreement (exact one-hot for classification)."""
    labels = labels.reshape(labels.shape[0], -1).long()
    buckets = min(num_classes, max_dim)
    # one-hot by comparison: F.one_hot reads the labels' range on the host
    # on the CPU, which neither torch.func.vmap nor a CUDA graph allows
    onehot = ((labels % buckets)[..., None]
              == torch.arange(buckets, device=labels.device)).float()
    feats = onehot.mean(1)
    return feats / (torch.linalg.norm(feats, dim=-1, keepdim=True) + _EPS)


def pool_features(x):
    """Pool (B, S, D) / (B, H, W, C) activations to (B, D) for the Gram."""
    if x.dim() == 2:
        return x.float()
    return x.mean(dim=tuple(range(1, x.dim() - 1))).float()
