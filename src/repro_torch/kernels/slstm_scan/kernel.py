"""Wrapper of the sLSTM scan CUDA kernel (``csrc/slstm_scan.cu``).

``slstm_scan_fwd`` takes the plain version in ``ref.py`` for CPU tensors.
For a CUDA tensor it launches the kernel or raises; it never falls back.
The library is built with ``nvcc`` at the first launch
(``kernels/build.py``), so importing this module needs neither a card nor a
compiler.

``LAUNCHES`` counts the kernel's launches (one per call on the card, none
on the CPU); ``reset_launches`` sets the count to 0.
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

LAUNCHES = {"slstm_scan_fwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 12 + [_I] * 4 + [_P]
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def library() -> ctypes.CDLL:
    """The compiled kernel, built and bound at first use."""
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        lib.slstm_scan_fwd.argtypes = _ARGTYPES
        lib.slstm_scan_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _shapes(g_in, r, b, states):
    if g_in.dim() != 5 or g_in.shape[2] != 4:
        raise ValueError("slstm_scan_fwd: g_in must be (B, S, 4, H, Dh), got "
                         f"{tuple(g_in.shape)}")
    B, S, _, H, Dh = g_in.shape
    want = {"r": (4, H, Dh, Dh), "b": (4, H, Dh)}
    want.update({k: (B, H, Dh) for k in states})
    got = {"r": r, "b": b, **states}
    for k, shape in want.items():
        if tuple(got[k].shape) != shape:
            raise ValueError(f"slstm_scan_fwd: {k} must be {shape} for g_in "
                             f"{tuple(g_in.shape)}, got "
                             f"{tuple(got[k].shape)}")
    if min(B, S, H) < 1 or not 1 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"slstm_scan_fwd: g_in {tuple(g_in.shape)} needs "
                         f"B, S, H >= 1 and head dim in [1, {MAX_HEAD_DIM}]")
    return B, S, H, Dh


def slstm_scan_fwd(g_in, r, b, c0, n0, m0, h0):
    """g_in: (B, S, 4, H, Dh); r: (4, H, Dh, Dh); b: (4, H, Dh); the
    initial states (B, H, Dh), all float32.  Returns (hs (B, S, H, Dh),
    c, n, m, h), the last four the final states.  Replaces
    ``slstm_scan_pallas``."""
    states = {"c0": c0, "n0": n0, "m0": m0, "h0": h0}
    if g_in.device.type == "cpu":
        hs, fin = ref.slstm_scan_ref(g_in, r, b, dict(zip("cnmh",
                                                          states.values())))
        return hs, fin["c"], fin["n"], fin["m"], fin["h"]
    B, S, H, Dh = _shapes(g_in, r, b, states)
    check_kernel_inputs("slstm_scan_fwd", g_in.device, g_in=g_in, r=r, b=b,
                        **states)
    hs = torch.empty((B, S, H, Dh), dtype=g_in.dtype, device=g_in.device)
    fin = [torch.empty_like(c0) for _ in range(4)]
    err = library().slstm_scan_fwd(
        g_in.data_ptr(), r.data_ptr(), b.data_ptr(),
        *(t.data_ptr() for t in states.values()), hs.data_ptr(),
        *(t.data_ptr() for t in fin), B, S, H, Dh,
        torch.cuda.current_stream(g_in.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan_fwd: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES["slstm_scan_fwd"] += 1
    return (hs, *fin)
