"""Wrappers of the nHSIC CUDA kernels (``csrc/nhsic.cu``): the three
streaming kernels behind ``ops.nhsic`` and the two dense-Gram kernels
behind ``ops.nhsic_unfused``.

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

LAUNCHES = {"nhsic_rowsums": 0, "nhsic_stats_feats": 0, "nhsic_grad": 0,
            "gram": 0, "gram_stats": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "nhsic_rowsums": [_P] * 5 + [_I] * 5 + [_P],
    "nhsic_stats_feats": [_P] * 7 + [_I] * 5 + [_P],
    "nhsic_grad": [_P] * 7 + [_I] * 5 + [_P],
    "gram": [_P] * 3 + [_I] * 3 + [_P],
    "gram_stats": [_P] * 9 + [_I] + [_P],
}
_lib = None
_fns = {}     # the bound C entry points, looked up once


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
            _fns[name] = fn
        _lib = lib
    return _lib


def _launch(name: str, *args) -> None:
    if _lib is None:
        library()
    err = _fns[name](*args)
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
    out = torch.empty(3, device=x.device, dtype=torch.float32)
    # one tile: the kernel writes `out` itself and never touches `partial`
    partial = out if tiles == 1 else torch.empty(
        3 * tiles * tiles, device=x.device, dtype=torch.float32)
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


def gram(x, s2, *, linear: bool = False):
    """(B, D) -> (B, B) float32 Gram: linear x·xᵀ, or RBF
    exp(−max(‖xi‖²+‖xj‖²−2xi·xj, 0) / 2σ²) with σ² = ``s2`` (a number or a
    one-element tensor; unused when linear).  Half-precision input is
    upcast to float32 first, which is exact.  Replaces ``gram_pallas``."""
    if x.device.type == "cpu":
        return ref.gram(x, s2, linear)
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"gram: x must be a non-empty (B, D), got "
                         f"{tuple(x.shape)}")
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    if not (isinstance(s2, torch.Tensor) and s2.dtype == torch.float32
            and s2.device == x.device):
        s2 = torch.as_tensor(s2, dtype=torch.float32, device=x.device)
    if s2.numel() != 1:
        raise ValueError(f"gram: s2 must hold one value, got "
                         f"{tuple(s2.shape)}")
    check_kernel_inputs("gram", x.device, x=x, s2=s2)
    B, D = x.shape
    out = torch.empty(B, B, device=x.device, dtype=torch.float32)
    _launch("gram", x.data_ptr(), s2.data_ptr(), out.data_ptr(), B, D,
            int(linear), _stream(x.device))
    return out


def gram_stats(Kx, Kz):
    """Two (B, B) Grams -> (3,) [Σ K̃x∘K̃z, ‖K̃x‖², ‖K̃z‖²] with
    K̃ = K − rowmean_i − colmean_j + mean, summed in a fixed order.  The
    means are reduced here, outside the kernel, as the reference does.
    Replaces ``gram_stats_pallas``."""
    if Kx.device.type == "cpu":
        return ref.gram_stats(Kx, Kz)
    if (Kx.dim() != 2 or Kx.shape[0] != Kx.shape[1] or Kx.shape[0] < 1
            or Kz.shape != Kx.shape):
        raise ValueError(f"gram_stats: Kx and Kz must be (B, B), got "
                         f"{tuple(Kx.shape)} and {tuple(Kz.shape)}")
    check_kernel_inputs("gram_stats", Kx.device, Kx=Kx, Kz=Kz)
    B = Kx.shape[0]
    rx, cx, rz, cz = Kx.mean(1), Kx.mean(0), Kz.mean(1), Kz.mean(0)
    m = torch.stack([Kx.mean(), Kz.mean()])
    tiles = -(-B // TILE)
    partial = torch.empty(3 * tiles * tiles, device=Kx.device,
                          dtype=torch.float32)
    out = torch.empty(3, device=Kx.device, dtype=torch.float32)
    _launch("gram_stats", Kx.data_ptr(), Kz.data_ptr(), rx.data_ptr(),
            cx.data_ptr(), rz.data_ptr(), cz.data_ptr(), m.data_ptr(),
            partial.data_ptr(), out.data_ptr(), B, _stream(Kx.device))
    return out
