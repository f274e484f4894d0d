"""Wrapper of the flash-attention forward CUDA kernel
(``csrc/flash_attention.cu``).

``flash_attention_fwd`` takes the plain version in ``ref.py`` for CPU
tensors.  For a CUDA tensor it launches the kernel or raises; it never
falls back.  The library is built with ``nvcc`` at the first launch
(``kernels/build.py``), so importing this module needs neither a card nor
a compiler.

``LAUNCHES`` counts the kernel's launches (one per call on the card, none
on the CPU); ``reset_launches`` sets the count to 0.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.common.device import check_kernel_inputs
from repro_torch.kernels.build import load_library
from repro_torch.kernels.flash_attention import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 128          # DMAX in flash_attention.cu
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = {"flash_attention_fwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 9 + [_P]
_lib = None
_fwd = None   # the bound C entry point, looked up once


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def library() -> ctypes.CDLL:
    """The compiled kernel, built and bound at first use."""
    global _lib, _fwd
    if _lib is None:
        lib = load_library(SOURCE)
        lib.flash_attention_fwd.argtypes = _ARGTYPES
        lib.flash_attention_fwd.restype = ctypes.c_int
        _lib, _fwd = lib, lib.flash_attention_fwd
    return _lib


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention_fwd: q must be (B, Sq, H, D) and "
                         "k, v (B, Skv, KV, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV < 1 or H % KV:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match (H % KV == 0)")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_fwd: head dim {D} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    return B, Sq, Skv, H, KV, D


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D) -> (B, Sq, H, D) in q's
    dtype.  Replaces ``flash_attention_bhsd``.  A custom op
    (``torch.library``): the CUDA implementation is the launch, the CPU one
    ``ref.attention_ref``; under ``torch.func.vmap`` the cohort axis folds
    into the batch axis (attention is independent per batch row), one
    launch for all cohorts."""
    B, Sq, Skv, H, KV, D = _shapes(q, k, v)
    check_kernel_inputs("flash_attention_fwd", q.device, dtypes=DTYPES, q=q,
                        k=k, v=v)
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("flash_attention_fwd: q, k and v must share a dtype")
    o = torch.empty_like(q)
    if _fwd is None:
        library()
    err = _fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Skv,
        H, KV, D, int(causal), int(window), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES["flash_attention_fwd"] += 1
    return o


@flash_attention_fwd.register_kernel("cpu")
def _(q, k, v, *, causal, window=0):
    return ref.attention_ref(q, k, v, causal=causal,
                             window=window).contiguous()


@flash_attention_fwd.register_fake
def _(q, k, v, *, causal, window=0):
    return torch.empty_like(q)


@torch.library.register_vmap(flash_attention_fwd)
def _(info, in_dims, q, k, v, *, causal, window=0):
    q, k, v = (t.movedim(d, 0) if d is not None
               else t.expand(info.batch_size, *t.shape)
               for t, d in zip((q, k, v), in_dims))
    C, B = q.shape[:2]
    o = flash_attention_fwd(*(t.reshape(C * B, *t.shape[2:]).contiguous()
                              for t in (q, k, v)), causal=causal,
                            window=window)
    return o.reshape(C, B, *o.shape[1:]), 0
