"""Plain PyTorch version of the sLSTM scan kernel (port of
``repro.kernels.slstm_scan.ref``).

Stabilized sLSTM recurrence over precomputed gate inputs:
    g_t   = g_in[t] + R h_{t-1} + b          (per gate, block-diagonal heads)
    m_t   = max(log σ(g_f) + m_{t-1}, g_i)
    i'    = exp(g_i − m_t);  f' = exp(log σ(g_f) + m_{t-1} − m_t)
    c_t   = f' c + i' tanh(g_z);  n_t = f' n + i'
    h_t   = σ(g_o) · c_t / max(n_t, 1e-6)

The kernel wrapper takes it for CPU tensors; on the card it is what the
kernel is held against, and its autograd is the backward of
``ops.slstm_scan``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def slstm_scan_ref(g_in, r, b, state0):
    """g_in: (B, S, 4, H, Dh); r: (4, H, Dh, Dh); b: (4, H, Dh);
    state0: dict(c, n, m, h) each (B, H, Dh).
    Returns (hs (B, S, H, Dh), final state dict)."""
    c, n, m, h = state0["c"], state0["n"], state0["m"], state0["h"]
    hs = []
    for t in range(g_in.shape[1]):
        rec = torch.stack([torch.einsum("bhe,hef->bhf", h, r[i])
                           for i in range(4)], dim=1)
        g = g_in[:, t] + rec + b
        gi, gf, gz, go = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
        logf = F.logsigmoid(gf)
        m_new = torch.maximum(logf + m, gi)
        i_s = torch.exp(gi - m_new)
        f_s = torch.exp(logf + m - m_new)
        c = f_s * c + i_s * torch.tanh(gz)
        n = f_s * n + i_s
        h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), {"c": c, "n": n, "m": m, "h": h}
