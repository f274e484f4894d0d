"""Wrappers of the sLSTM scan CUDA kernels (``csrc/slstm_scan.cu``): the
forward scan and its backward, a reverse scan.

``slstm_scan_fwd`` and ``slstm_scan_bwd`` take the plain versions in
``ref.py`` for CPU tensors.  For a CUDA tensor they launch the kernel or
raise; they never fall back.  The library is built with ``nvcc`` at the
first launch (``kernels/build.py``), so importing this module needs neither
a card nor a compiler.

``LAUNCHES`` counts each kernel's launches (one per call on the card, none
on the CPU); ``reset_launches`` sets the counts to 0.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.common.device import check_kernel_inputs
from repro_torch.kernels.build import load_library
from repro_torch.kernels.slstm_scan import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "slstm_scan.cu"
MAX_HEAD_DIM = 1024         # MAX_DH in slstm_scan.cu

LAUNCHES = {"slstm_scan_fwd": 0, "slstm_scan_bwd": 0}
STATE = ("c", "n", "m", "h")
TILE = 16                   # TW in slstm_scan.cu: columns per block

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"slstm_scan_fwd": [_P] * 17 + [_I] * 4 + [_P],
             "slstm_scan_bwd": [_P] * 20 + [_I] * 4 + [_P]}
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def library() -> ctypes.CDLL:
    """The compiled kernel, built and bound at first use."""
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        for name, argtypes in _ARGTYPES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


def _shapes(name, gates, others, steps=None, states=None):
    """Check the shapes against ``gates`` (B, S, 4, H, Dh): ``others`` by
    name, ``steps`` (B, S, H, Dh) and ``states`` (B, H, Dh)."""
    steps, states = steps or {}, states or {}
    first = next(iter(gates))
    g = gates[first]
    if g.dim() != 5 or g.shape[2] != 4:
        raise ValueError(f"{name}: {first} must be (B, S, 4, H, Dh), got "
                         f"{tuple(g.shape)}")
    B, S, _, H, Dh = g.shape
    want = {"r": (4, H, Dh, Dh), "b": (4, H, Dh)}
    want = {k: want[k] for k in others}
    want.update({k: (B, S, H, Dh) for k in steps})
    want.update({k: (B, H, Dh) for k in states})
    got = {**others, **steps, **states}
    for k, shape in want.items():
        if tuple(got[k].shape) != shape:
            raise ValueError(f"{name}: {k} must be {shape} for {first} "
                             f"{tuple(g.shape)}, got {tuple(got[k].shape)}")
    if min(B, S, H) < 1 or not 1 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: {first} {tuple(g.shape)} needs B, S, "
                         f"H >= 1 and head dim in [1, {MAX_HEAD_DIM}]")
    return B, S, H, Dh


def _launch(name, device, *args):
    err = getattr(library(), name)(
        *(a.data_ptr() if torch.is_tensor(a) else a for a in args),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1


def slstm_scan_fwd(g_in, r, b, c0, n0, m0, h0, *, save=False):
    """g_in: (B, S, 4, H, Dh); r: (4, H, Dh, Dh); b: (4, H, Dh); the
    initial states (B, H, Dh), all float32.  Returns (hs (B, S, H, Dh),
    c, n, m, h), the last four the final states; with ``save`` also the
    per-step pre-activations g (B, S, 4, H, Dh) and states c, n, m
    (B, S, H, Dh) that ``slstm_scan_bwd`` takes.  Replaces
    ``slstm_scan_pallas``."""
    states = {"c0": c0, "n0": n0, "m0": m0, "h0": h0}
    if g_in.device.type == "cpu":
        hs, fin, *saved = ref.slstm_scan_ref(
            g_in, r, b, dict(zip(STATE, states.values())), save=save)
        out = (hs, *(fin[k] for k in STATE))
        return out + tuple(saved[0][k] for k in "gcnm") if save else out
    B, S, H, Dh = _shapes("slstm_scan_fwd", {"g_in": g_in},
                          {"r": r, "b": b}, states=states)
    check_kernel_inputs("slstm_scan_fwd", g_in.device, g_in=g_in, r=r, b=b,
                        **states)
    hs = torch.empty((B, S, H, Dh), dtype=g_in.dtype, device=g_in.device)
    fin = [torch.empty_like(c0) for _ in STATE]
    saved = ([torch.empty_like(g_in)] + [torch.empty_like(hs)
                                         for _ in range(3)]) if save else []
    counters = torch.zeros(H, dtype=torch.int32, device=g_in.device)
    _launch("slstm_scan_fwd", g_in.device, g_in, r, b, *states.values(), hs,
            *fin, *(saved or [None] * 4), counters, B, S, H, Dh)
    return (hs, *fin, *saved)


def slstm_scan_bwd(g, cs, ns, ms, r, c0, n0, m0, dhs, dc, dn, dm, dh):
    """The backward of the scan, a reverse scan: g (B, S, 4, H, Dh) and
    cs, ns, ms (B, S, H, Dh) as ``slstm_scan_fwd(..., save=True)`` gives
    them; r; the initial c0, n0, m0 (B, H, Dh); the cotangents dhs
    (B, S, H, Dh) of hs and dc, dn, dm, dh (B, H, Dh) of the final states.
    Returns (dg (B, S, 4, H, Dh), dc0, dn0, dm0, dh0), all float32.  The
    counterpart of the reference's ``_scan_bwd`` without r's and b's
    gradients (two plain products of dg, in ``ops``)."""
    steps = {"cs": cs, "ns": ns, "ms": ms, "dhs": dhs}
    states = {"c0": c0, "n0": n0, "m0": m0, "dc": dc, "dn": dn, "dm": dm,
              "dh": dh}
    if g.device.type == "cpu":
        return ref.slstm_scan_bwd_ref(g, cs, ns, ms, r, c0, n0, m0, dhs, dc,
                                      dn, dm, dh)
    B, S, H, Dh = _shapes("slstm_scan_bwd", {"g": g}, {"r": r}, steps,
                          states)
    check_kernel_inputs("slstm_scan_bwd", g.device, g=g, r=r, **steps,
                        **states)
    dg = torch.empty_like(g)
    d0 = [torch.empty_like(c0) for _ in STATE]
    tiles = -(-Dh // TILE)
    scratch = torch.empty((2, H, tiles, B, Dh), dtype=g.dtype,
                          device=g.device)
    counters = torch.zeros(H, dtype=torch.int32, device=g.device)
    _launch("slstm_scan_bwd", g.device, g, cs, ns, ms, r, c0, n0, m0, dhs,
            dc, dn, dm, dh, dg, *d0, scratch, counters, B, S, H, Dh)
    return (dg, *d0)
