"""The work of one call of each nHSIC kernel (K1-K3, K6, K7): the one
formula that both the kernels' bounds (``chip_smoke.py``) and the
dry-run's FLOP count (``FlopCounterMode``, the formulas registered in
``kernel.py``) read.  Each returns ``(bytes, product FLOPs, elementwise
FLOPs)``; every product is float32.
"""
from __future__ import annotations


def gram_flops(B, D, linear):
    """(products, elementwise) FLOPs of the Gram of (B, D) rows with
    themselves.  It is symmetric, so it needs B(B+1)/2 dot products of 2D
    FLOPs; RBF adds the B squared norms (2D each, products too) and
    |a|^2+|b|^2-2ab, clamp, scale and exp (6) per distinct entry."""
    dots = B * (B + 1) * D
    return (dots, 0) if linear else (dots + 2 * B * D, 3 * B * (B + 1))


def gram_work(B, D, linear):
    """One K6 call: x and sigma^2 read, the Gram written."""
    return (4 * B * D + 4 + 4 * B * B, *gram_flops(B, D, linear))


def gram_stats_work(B):
    """One K7 call: two Grams read, three sums written; per entry of each
    Gram its row and column sums (2), its centring (3), and the three
    products with their sums (6 in all), all elementwise."""
    return 8 * B * B + 12, 0, 16 * B * B


def nhsic_work(name, B, Dx, Dz, lx, lz=False):
    """One K1 (``nhsic_rowsums``), K2 (``nhsic_stats_feats``) or K3
    (``nhsic_grad``) call on x (B, Dx) and z (B, Dz)."""
    (px, ex), (pz, ez) = gram_flops(B, Dx, lx), gram_flops(B, Dz, lz)
    prod, elem = px + pz, ex + ez
    act = 4 * B * (Dx + Dz)
    if name == "nhsic_rowsums":
        return act + 8 + 8 * B, prod, elem + 2 * B * B
    if name == "nhsic_stats_feats":
        # centring (3 per entry per Gram) and three products with sums
        return act + 8 * B + 16 + 12, prod, elem + 12 * B * B
    # centring, G (3 each), W (2 each), the row-sum term; W.x a product
    return (act + 8 * B + 28 + act, prod + 2 * B * B * (Dx + Dz),
            elem + 16 * B * B + 4 * B * (Dx + Dz))
