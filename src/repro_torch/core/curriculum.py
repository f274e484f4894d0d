"""Curriculum Mentor losses, paper Eq. 4 / Eq. 5 (port of
``repro.core.curriculum``).

    L_Θt   = L_CE − λ1,t·nHSIC(X; Z_t) − λ2,t·nHSIC(Y; Z_t)        (Eq. 4)
    L^r_nt = L_Θt + μ/2 ‖θ_nt − θ_t^l‖²                            (Eq. 5)

λ1 decreases over blocks, λ2 increases.  A MoE model's stage loss also
carries ``moe_aux_loss`` of the trainable periods' aux sums, as the
reference's does.
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


def task_ce(logits, labels, cfg=None, loss_mask=None):
    """Cross-entropy over (B, classes) logits (classification), over
    (B, S, V) logits of the ``lm`` layout masked by ``loss_mask`` where
    given, over (B, S, heads, V) multi-head logits against (B, S, heads)
    labels (the mask broadcast over the heads), and over the text suffix
    of a VLM's (B, Pv + St, V) logits against (B, St) labels."""
    if getattr(cfg, "task", "lm") == "classify" or logits.dim() == 2:
        return cross_entropy(logits, labels)
    if getattr(cfg, "num_output_heads", 1) > 1:
        return cross_entropy(logits, labels,
                             None if loss_mask is None
                             else loss_mask[..., None])
    if logits.shape[1] != labels.shape[1]:      # vlm: labels = text suffix
        logits, loss_mask = logits[:, -labels.shape[1]:], None
    return cross_entropy(logits, labels, loss_mask)


def curriculum_loss(logits, feats, batch, cfg, hp: CurriculumHP, t: int,
                    num_stages: int, num_classes: int):
    """Eq. 4 on one local batch. Returns (loss, metrics)."""
    labels = batch["labels"]
    ce = task_ce(logits, labels, cfg, feats.get("loss_mask"))
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
    aux = feats.get("aux")
    if aux is not None and getattr(cfg, "moe", None) is not None:
        from repro_torch.models.moe import moe_aux_loss
        loss = loss + moe_aux_loss(aux, cfg.moe)
    return loss, metrics


class _SquaredDistance(torch.autograd.Function):
    """‖a − b‖² of one leaf, in float32.  Its backward recomputes a − b
    from a and b rather than keeping it: autograd of the plain expression
    keeps the difference, a second copy of the trainable subtree (for the
    vectorized round's C cohorts, GBs at full width)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        return torch.sum(torch.square(a.float() - b.float()))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        d = (2 * g) * (a.float() - b.float())
        return (d.to(a.dtype) if ctx.needs_input_grad[0] else None,
                (-d).to(b.dtype) if ctx.needs_input_grad[1] else None)


def proximal_term(trainable, global_ref, mu: float):
    """μ/2 ‖θ − θ^l‖² over the trainable subtree (Eq. 5)."""
    leaves = tree_leaves(trainable)
    if mu == 0.0:
        return torch.zeros((), device=leaves[0].device)
    sq = sum(_SquaredDistance.apply(a, b)
             for a, b in zip(leaves, tree_leaves(global_ref)))
    return 0.5 * mu * sq
