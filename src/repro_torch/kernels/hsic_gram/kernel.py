"""Wrappers of the streaming nHSIC CUDA kernels (``csrc/nhsic.cu``).

Each wrapper takes its plain version in ``ref.py`` for CPU tensors.  For a
CUDA tensor it launches the kernel or raises; it never falls back.  The
library is built with ``nvcc`` at the first launch (``kernels/build.py``),
so importing this module needs neither a card nor a compiler.

``LAUNCHES`` counts each wrapper's kernel launches (one per call on the
card, none on the CPU); ``reset_launches`` sets the counts to 0.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.common.device import check_kernel_inputs
from repro_torch.kernels.build import load_library
from repro_torch.kernels.hsic_gram import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "nhsic.cu"
TILE = 32   # rows and columns of one Gram tile, as in nhsic.cu

LAUNCHES = {"nhsic_rowsums": 0, "nhsic_stats_feats": 0, "nhsic_grad": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "nhsic_rowsums": [_P] * 5 + [_I] * 5 + [_P],
    "nhsic_stats_feats": [_P] * 7 + [_I] * 5 + [_P],
    "nhsic_grad": [_P] * 7 + [_I] * 5 + [_P],
}
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def library() -> ctypes.CDLL:
    """The compiled kernels, built and bound at first use."""
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(name: str, *args) -> None:
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1


def _shapes(name, x, z, *vectors):
    if x.dim() != 2 or z.dim() != 2 or x.shape[0] != z.shape[0]:
        raise ValueError(f"{name}: x and z must be (B, Dx) and (B, Dz), got "
                         f"{tuple(x.shape)} and {tuple(z.shape)}")
    B, Dx = x.shape
    Dz = z.shape[1]
    if min(B, Dx, Dz) < 1:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}, "
                         f"{tuple(z.shape)}")
    for v, n in vectors:
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name}: expected a ({n},) vector, got "
                             f"{tuple(v.shape)}")
    return B, Dx, Dz


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def nhsic_rowsums(x, z, s2, *, linear_x: bool = False,
                  linear_z: bool = False):
    """Row sums of Kx and Kz, each (B,) float32; s2 = [σ²x, σ²z] on the
    device.  Replaces ``nhsic_rowsums_pallas``."""
    if x.device.type == "cpu":
        return ref.nhsic_rowsums(x, z, s2, linear_x=linear_x,
                                 linear_z=linear_z)
    B, Dx, Dz = _shapes("nhsic_rowsums", x, z, (s2, 2))
    check_kernel_inputs("nhsic_rowsums", x.device, x=x, z=z, s2=s2)
    rx = torch.empty(B, device=x.device, dtype=torch.float32)
    rz = torch.empty(B, device=x.device, dtype=torch.float32)
    _launch("nhsic_rowsums", x.data_ptr(), z.data_ptr(), s2.data_ptr(),
            rx.data_ptr(), rz.data_ptr(), B, Dx, Dz, int(linear_x),
            int(linear_z), _stream(x.device))
    return rx, rz


def nhsic_stats_feats(x, z, rx, rz, s, *, linear_x: bool = False,
                      linear_z: bool = False):
    """(3,) [tr(K̃xK̃z), ‖K̃x‖², ‖K̃z‖²] with s = [σ²x, σ²z, mean Kx,
    mean Kz] and rx, rz the Gram row means.  Replaces
    ``nhsic_stats_feats_pallas``; sums in a fixed order."""
    if x.device.type == "cpu":
        return ref.nhsic_stats_feats(x, z, rx, rz, s, linear_x=linear_x,
                                     linear_z=linear_z)
    B, Dx, Dz = _shapes("nhsic_stats_feats", x, z, (rx, x.shape[0]),
                        (rz, x.shape[0]), (s, 4))
    check_kernel_inputs("nhsic_stats_feats", x.device, x=x, z=z, rx=rx,
                        rz=rz, s=s)
    tiles = -(-B // TILE)
    partial = torch.empty(3 * tiles * tiles, device=x.device,
                          dtype=torch.float32)
    out = torch.empty(3, device=x.device, dtype=torch.float32)
    _launch("nhsic_stats_feats", x.data_ptr(), z.data_ptr(), rx.data_ptr(),
            rz.data_ptr(), s.data_ptr(), partial.data_ptr(), out.data_ptr(),
            B, Dx, Dz, int(linear_x), int(linear_z), _stream(x.device))
    return out


def nhsic_grad(x, z, rx, rz, scal, *, linear_x: bool = False,
               linear_z: bool = False):
    """(dx, dz) from O(B·D) residuals; scal = [σ²x, σ²z, mean Kx, mean Kz,
    cA, cBx, cBz].  Replaces ``nhsic_grad_pallas``."""
    if x.device.type == "cpu":
        return ref.nhsic_grad(x, z, rx, rz, scal, linear_x=linear_x,
                              linear_z=linear_z)
    B, Dx, Dz = _shapes("nhsic_grad", x, z, (rx, x.shape[0]),
                        (rz, x.shape[0]), (scal, 7))
    check_kernel_inputs("nhsic_grad", x.device, x=x, z=z, rx=rx, rz=rz,
                        scal=scal)
    dx = torch.empty_like(x)
    dz = torch.empty_like(z)
    _launch("nhsic_grad", x.data_ptr(), z.data_ptr(), rx.data_ptr(),
            rz.data_ptr(), scal.data_ptr(), dx.data_ptr(), dz.data_ptr(), B,
            Dx, Dz, int(linear_x), int(linear_z), _stream(x.device))
    return dx, dz
