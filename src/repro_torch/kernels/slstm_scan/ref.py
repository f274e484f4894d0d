"""Plain PyTorch versions of the sLSTM scan kernels (port of
``repro.kernels.slstm_scan.ref``, and of its VJP as one reverse loop).

Stabilized sLSTM recurrence over precomputed gate inputs:
    g_t   = g_in[t] + R h_{t-1} + b          (per gate, block-diagonal heads)
    m_t   = max(log σ(g_f) + m_{t-1}, g_i)
    i'    = exp(g_i − m_t);  f' = exp(log σ(g_f) + m_{t-1} − m_t)
    c_t   = f' c + i' tanh(g_z);  n_t = f' n + i'
    h_t   = σ(g_o) · c_t / max(n_t, 1e-6)

The kernel wrappers take them for CPU tensors; on the card the kernels are
held against them, and against autograd of ``slstm_scan_ref``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def slstm_scan_ref(g_in, r, b, state0, save=False):
    """g_in: (B, S, 4, H, Dh); r: (4, H, Dh, Dh); b: (4, H, Dh);
    state0: dict(c, n, m, h) each (B, H, Dh).
    Returns (hs (B, S, H, Dh), final state dict); with ``save`` also a
    dict of what ``slstm_scan_bwd_ref`` takes: the per-step
    pre-activations g (B, S, 4, H, Dh) and states c, n, m (B, S, H, Dh)."""
    c, n, m, h = state0["c"], state0["n"], state0["m"], state0["h"]
    hs, gs, cs, ns, ms = [], [], [], [], []
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
        if save:
            gs.append(g)
            cs.append(c)
            ns.append(n)
            ms.append(m)
    out = torch.stack(hs, dim=1), {"c": c, "n": n, "m": m, "h": h}
    if not save:
        return out
    return (*out, {"g": torch.stack(gs, dim=1), "c": torch.stack(cs, dim=1),
                   "n": torch.stack(ns, dim=1), "m": torch.stack(ms, dim=1)})


def slstm_scan_bwd_ref(g, cs, ns, ms, r, c0, n0, m0, dhs, dc, dn, dm, dh):
    """The scan's backward as an explicit reverse loop, the contract of the
    backward kernel.  g (B, S, 4, H, Dh) and cs, ns, ms (B, S, H, Dh): the
    saved pre-activations and states (``slstm_scan_ref(..., save=True)``);
    r and the initial c0, n0, m0; dhs (B, S, H, Dh) and dc, dn, dm, dh
    (B, H, Dh): the cotangents of hs and of the final states.  Returns
    (dg (B, S, 4, H, Dh), dc0, dn0, dm0, dh0).  dg is the gradient of g_in
    (and summed, of b); r's gradient is sum_t h_{t-1}^T dg_t, outside.

    Per step it takes autograd's own rules: ``torch.maximum`` splits a tie
    half and half, ``clamp(n, min=1e-6)`` passes the gradient where
    n >= 1e-6, and the gradient flows through m into i' and f'."""
    dg = torch.empty_like(g)
    for t in range(g.shape[1] - 1, -1, -1):
        if t:
            c_p, n_p, m_p = cs[:, t - 1], ns[:, t - 1], ms[:, t - 1]
        else:
            c_p, n_p, m_p = c0, n0, m0
        gi, gf, gz, go = g[:, t].unbind(1)
        c, n = cs[:, t], ns[:, t]
        a = F.logsigmoid(gf) + m_p
        m_new = torch.maximum(a, gi)
        i_s = torch.exp(gi - m_new)
        f_s = torch.exp(a - m_new)
        tz = torch.tanh(gz)
        o = torch.sigmoid(go)
        nc = torch.clamp(n, min=1e-6)
        dh = dhs[:, t] + dh
        # h = (o c) / max(n, 1e-6)
        dp = dh / nc
        dn = dn + torch.where(n >= 1e-6, -dh * ((o * c) / (nc * nc)), 0.0)
        dc = dc + dp * o
        dgo = dp * c * (o * (1 - o))
        # c = f' c_p + i' tanh(g_z);  n = f' n_p + i'
        dfs = dc * c_p + dn * n_p
        dis = dc * tz + dn
        dgz = dc * i_s * (1 - tz * tz)
        # i' = exp(g_i - m);  f' = exp(a - m), a = log σ(g_f) + m_p
        x1, x2 = dis * i_s, dfs * f_s
        dm_tot = dm - x1 - x2
        # m = max(a, g_i): a tie splits half and half
        wa = (a > gi).to(g.dtype) + 0.5 * (a == gi).to(g.dtype)
        da = x2 + dm_tot * wa
        dgi = x1 + dm_tot * (1 - wa)
        dgf = da * torch.sigmoid(-gf)
        dg[:, t] = torch.stack([dgi, dgf, dgz, dgo], dim=1)
        dc, dn, dm = dc * f_s, dn * f_s, da
        dh = torch.einsum("bghj,ghej->bhe", dg[:, t], r)
    return dg, dc, dn, dm, dh
