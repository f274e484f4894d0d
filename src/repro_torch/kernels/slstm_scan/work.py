"""The work of one K5 call, forward and backward: the one formula that
both the kernels' bounds (``chip_smoke.py``) and the dry-run's FLOP count
(``FlopCounterMode``, the formulas registered in ``kernel.py``) read.
Each returns ``(bytes, product FLOPs, elementwise FLOPs)``; the products
are 3xTF32 float32 products on the card.
"""
from __future__ import annotations


def slstm_work(B, S, H, Dh, *_):
    """One forward call: g_in, r, b and the four initial states read once,
    hs and the four final states written once; the four recurrent
    products (2 Dh^2 FLOPs per gate, step, row and head), ~30 FLOPs of
    gate arithmetic per (step, row, head, column)."""
    nbytes = 4 * (B * S * 4 * H * Dh + 4 * H * Dh * Dh + 4 * H * Dh
                  + 4 * B * H * Dh + B * S * H * Dh + 4 * B * H * Dh)
    return nbytes, 2 * B * S * H * 4 * Dh * Dh, 30 * B * S * H * Dh


def slstm_bwd_work(B, S, H, Dh, *_):
    """One backward call: the saved g, c, n, m, the cotangent of hs, r,
    the initial c, n, m and the four final-state cotangents read once, dg
    and the four initial-state gradients written once; the recurrent
    products dh = dg r^T (2 Dh^2 FLOPs per gate, step, row and head), ~60
    FLOPs of gate arithmetic per (step, row, head, column).  dr and db are
    plain products outside the kernel."""
    step = B * S * H * Dh
    nbytes = 4 * (4 * step + 3 * step + step + 4 * H * Dh * Dh
                  + 7 * B * H * Dh + 4 * step + 4 * B * H * Dh)
    return nbytes, 2 * step * 4 * Dh, 60 * step
