"""Curriculum Mentor losses, paper Eq. 4 / Eq. 5 (port of
``repro.core.curriculum``).

    L_Θt   = L_CE − λ1,t·nHSIC(X; Z_t) − λ2,t·nHSIC(Y; Z_t)        (Eq. 4)
    L^r_nt = L_Θt + μ/2 ‖θ_nt − θ_t^l‖²                            (Eq. 5)

λ1 decreases over blocks, λ2 increases.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.tree import tree_leaves
from repro_torch.core import hsic
from repro_torch.models.layers import cross_entropy


@dataclasses.dataclass(frozen=True)
class CurriculumHP:
    lambda1_max: float = 2.0      # nHSIC(X;Z) weight for the first block
    lambda2_max: float = 1.0      # nHSIC(Y;Z) weight for the last block
    mu: float = 0.1               # proximal (FedProx) weight, Eq. 5
    use_hsic_kernel: bool = False  # route nHSIC through the CUDA kernels
    enabled: bool = True          # ablation switch (w/o CA)


def lambdas(hp: CurriculumHP, t: int, num_stages: int):
    """λ1 decreasing, λ2 increasing in the stage index."""
    if num_stages <= 1:
        return hp.lambda1_max, hp.lambda2_max
    frac = t / (num_stages - 1)
    return (hp.lambda1_max * (1.0 - frac),
            hp.lambda2_max * (0.25 + 0.75 * frac))


def task_ce(logits, labels):
    """Cross-entropy; the port has the classification layout only."""
    if logits.dim() != 2:
        raise ValueError("the port's task_ce takes (B, classes) logits")
    return cross_entropy(logits, labels)


def curriculum_loss(logits, feats, batch, cfg, hp: CurriculumHP, t: int,
                    num_stages: int, num_classes: int):
    """Eq. 4 on one local batch. Returns (loss, metrics)."""
    labels = batch["labels"]
    ce = task_ce(logits, labels)
    metrics = {"ce": ce}
    loss = ce
    if hp.enabled and feats.get("z_proj") is not None:
        lam1, lam2 = lambdas(hp, t, num_stages)
        x_feat = hsic.pool_features(feats["x_embed"])
        z_feat = hsic.pool_features(feats["z_active"])
        zp_feat = hsic.pool_features(feats["z_proj"])
        y_feat = hsic.label_features(labels, num_classes)
        h_xz = hsic.nhsic(x_feat, z_feat, use_kernel=hp.use_hsic_kernel)
        h_yz = hsic.nhsic(y_feat, zp_feat, kernel_x="linear",
                          use_kernel=hp.use_hsic_kernel)
        loss = loss - lam1 * h_xz - lam2 * h_yz
        metrics.update({"nhsic_xz": h_xz, "nhsic_yz": h_yz,
                        "lambda1": lam1, "lambda2": lam2})
    return loss, metrics


def proximal_term(trainable, global_ref, mu: float):
    """μ/2 ‖θ − θ^l‖² over the trainable subtree (Eq. 5)."""
    leaves = tree_leaves(trainable)
    if mu == 0.0:
        return torch.zeros((), device=leaves[0].device)
    sq = sum(torch.sum(torch.square(a.float() - b.float()))
             for a, b in zip(leaves, tree_leaves(global_ref)))
    return 0.5 * mu * sq
