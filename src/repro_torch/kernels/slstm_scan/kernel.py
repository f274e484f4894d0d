"""Wrappers of the sLSTM scan CUDA kernels (``csrc/slstm_scan.cu``): the
forward scan and its backward, a reverse scan.

Both are ``torch.library`` custom ops: the CUDA implementation is the
launch, the CPU one the plain version in ``ref.py``; for a CUDA tensor
they launch the kernel or raise, and never fall back.  Their inputs may
carry one leading cohort axis (C scans with their own r and b: C H heads
of the kernel, each cohort the bits of a launch of its own), and under
``torch.func.vmap`` the vmap rule gives it one: cohorts that share r and
b (a frozen layer) fold into the batch axis instead, as K4's do.  The
library is built with ``nvcc`` at the first launch (``kernels/build.py``),
so importing this module needs neither a card nor a compiler.

``LAUNCHES`` counts each kernel's launches (one per call on the card,
more where the heads of all cohorts exceed what the card holds at once;
none on the CPU); ``reset_launches`` sets the counts to 0.  A replayed
CUDA graph runs no Python: the captured step adds the counts it recorded
at capture (``core.progressive``).  ``kernel_resources`` reads each built
kernel's registers, shared memory and spills (it launches nothing).
``FlopCounterMode`` counts a call's product FLOPs from ``work.py``, the
formulas of the kernels' bounds.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.common.device import check_kernel_inputs
from repro_torch.kernels.audit import read_resources
from repro_torch.kernels.build import load_library
from repro_torch.kernels.slstm_scan import ref, work

SOURCE = Path(__file__).resolve().parent / "csrc" / "slstm_scan.cu"
MAX_HEAD_DIM = 1024         # MAX_DH in slstm_scan.cu

LAUNCHES = {"slstm_scan_fwd": 0, "slstm_scan_bwd": 0}
STATE = ("c", "n", "m", "h")
TILE = 16                   # TW in slstm_scan.cu: columns per block

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"slstm_scan_fwd": [_P] * 17 + [_I] * 5 + [_P] * 2,
             "slstm_scan_bwd": [_P] * 20 + [_I] * 5 + [_P] * 2,
             "slstm_kernel_attributes": [_P, _I]}
# the instances of the two kernels, in slstm_kernel_attributes' order
RESOURCE_KERNELS = ("slstm_fwd_kernel<true>", "slstm_fwd_kernel<false>",
                    "slstm_bwd_kernel<true>", "slstm_bwd_kernel<false>")
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


def kernel_resources():
    """Registers, shared memory, spills and block limits of every instance
    of the built kernels (``kernels.audit.read_resources``)."""
    return read_resources(library().slstm_kernel_attributes,
                          RESOURCE_KERNELS)


def _shapes(name, gates, others, steps=None, states=None):
    """(C, B, S, H, Dh) of ``gates`` (..., B, S, 4, H, Dh), its leading
    (cohort) axes flattened into C; ``others`` by name (r (..., 4, H, Dh,
    Dh), b (..., 4, H, Dh)), ``steps`` (..., B, S, H, Dh) and ``states``
    (..., B, H, Dh) must have the same leading axes."""
    steps, states = steps or {}, states or {}
    first = next(iter(gates))
    g = gates[first]
    if g.dim() < 5 or g.shape[-3] != 4:
        raise ValueError(f"{name}: {first} must be (..., B, S, 4, H, Dh), "
                         f"got {tuple(g.shape)}")
    *lead, B, S, _, H, Dh = g.shape
    lead = tuple(lead)
    want = {"r": (4, H, Dh, Dh), "b": (4, H, Dh)}
    want = {k: lead + want[k] for k in others}
    want.update({k: lead + (B, S, H, Dh) for k in steps})
    want.update({k: lead + (B, H, Dh) for k in states})
    got = {**others, **steps, **states}
    for k, shape in want.items():
        if tuple(got[k].shape) != shape:
            raise ValueError(f"{name}: {k} must be {shape} for {first} "
                             f"{tuple(g.shape)}, got {tuple(got[k].shape)}")
    if min(B, S, H) < 1 or not 1 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: {first} {tuple(g.shape)} needs B, S, "
                         f"H >= 1 and head dim in [1, {MAX_HEAD_DIM}]")
    return math.prod(lead), B, S, H, Dh


def _launch(name, device, *args):
    launches = ctypes.c_int(0)
    err = getattr(library(), name)(
        *(a.data_ptr() if torch.is_tensor(a) else a for a in args),
        ctypes.addressof(launches),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += launches.value


def _unsaved(like, n=4):
    """What the forward returns in place of the saved states when it saves
    nothing: empty tensors."""
    return [like.new_empty(0) for _ in range(n)]


def _per_cohort(fn, lead_of, *args):
    """``fn`` on each cohort of ``args`` (tensors with ``lead_of``'s
    leading axes, or other values passed as they are), the outputs stacked
    back onto those axes: a plain version's loop over cohorts."""
    lead = tuple(lead_of.shape[:lead_of.dim() - 5])
    if not lead:
        return fn(*args)
    C = math.prod(lead)
    flat = [a.reshape(C, *a.shape[len(lead):]) if torch.is_tensor(a) else a
            for a in args]
    outs = [fn(*(a[c] if torch.is_tensor(a) else a for a in flat))
            for c in range(C)]
    return tuple(torch.stack(o).reshape(*lead, *o[0].shape)
                 for o in zip(*outs))


_Out9 = tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor,
              Tensor]


@torch.library.custom_op("repro_torch::slstm_scan_fwd", mutates_args=())
def _scan_fwd(g_in: Tensor, r: Tensor, b: Tensor, c0: Tensor, n0: Tensor,
              m0: Tensor, h0: Tensor, save: bool) -> _Out9:
    C, B, S, H, Dh = _shapes("slstm_scan_fwd", {"g_in": g_in},
                             {"r": r, "b": b},
                             states={"c0": c0, "n0": n0, "m0": m0, "h0": h0})
    check_kernel_inputs("slstm_scan_fwd", g_in.device, g_in=g_in, r=r, b=b,
                        c0=c0, n0=n0, m0=m0, h0=h0)
    hs = g_in.new_empty((*g_in.shape[:-3], H, Dh))
    fin = [torch.empty_like(c0) for _ in STATE]
    saved = ([torch.empty_like(g_in)] + [torch.empty_like(hs)
                                         for _ in range(3)]) if save else []
    counters = torch.zeros(C * H, dtype=torch.int32, device=g_in.device)
    _launch("slstm_scan_fwd", g_in.device, g_in, r, b, c0, n0, m0, h0, hs,
            *fin, *(saved or [None] * 4), counters, C, B, S, H, Dh)
    return (hs, *fin, *(saved or _unsaved(g_in)))


@_scan_fwd.register_kernel("cpu")
def _(g_in, r, b, c0, n0, m0, h0, save):
    def one(g_in, r, b, c0, n0, m0, h0):
        hs, fin, *saved = ref.slstm_scan_ref(
            g_in, r, b, dict(zip(STATE, (c0, n0, m0, h0))), save=save)
        out = (hs, *(fin[k] for k in STATE))
        return out + (tuple(saved[0][k] for k in "gcnm") if save else ())

    out = _per_cohort(one, g_in, g_in, r, b, c0, n0, m0, h0)
    return (*(t.contiguous() for t in out), *_unsaved(g_in, 9 - len(out)))


@_scan_fwd.register_fake
def _(g_in, r, b, c0, n0, m0, h0, save):
    hs = g_in.new_empty((*g_in.shape[:-3], *g_in.shape[-2:]))
    fin = [torch.empty_like(c0) for _ in STATE]
    saved = ([torch.empty_like(g_in)] + [torch.empty_like(hs)
                                         for _ in range(3)]) if save else \
        _unsaved(g_in)
    return (hs, *fin, *saved)


def _scan_flops(work_fn, g_shape):
    """Product FLOPs of one call on gates (..., B, S, 4, H, Dh): each
    leading cohort's scan."""
    *lead, B, S, _, H, Dh = g_shape
    return math.prod(lead) * work_fn(B, S, H, Dh)[1]


@register_flop_formula(torch.ops.repro_torch.slstm_scan_fwd)
def _(g_shape, *_, out_shape=None, **__):
    return _scan_flops(work.slstm_work, g_shape)


def slstm_scan_fwd(g_in, r, b, c0, n0, m0, h0, *, save=False):
    """g_in: (B, S, 4, H, Dh); r: (4, H, Dh, Dh); b: (4, H, Dh); the
    initial states (B, H, Dh), all float32; each may carry one leading
    cohort axis, all the same.  Returns (hs (B, S, H, Dh), c, n, m, h),
    the last four the final states; with ``save`` also the per-step
    pre-activations g (B, S, 4, H, Dh) and states c, n, m (B, S, H, Dh)
    that ``slstm_scan_bwd`` takes.  Replaces ``slstm_scan_pallas``."""
    out = _scan_fwd(g_in, r, b, c0, n0, m0, h0, save)
    return out if save else out[:5]


@torch.library.custom_op("repro_torch::slstm_scan_bwd", mutates_args=())
def _scan_bwd(g: Tensor, cs: Tensor, ns: Tensor, ms: Tensor, r: Tensor,
              c0: Tensor, n0: Tensor, m0: Tensor, dhs: Tensor, dc: Tensor,
              dn: Tensor, dm: Tensor, dh: Tensor
              ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    steps = {"cs": cs, "ns": ns, "ms": ms, "dhs": dhs}
    states = {"c0": c0, "n0": n0, "m0": m0, "dc": dc, "dn": dn, "dm": dm,
              "dh": dh}
    C, B, S, H, Dh = _shapes("slstm_scan_bwd", {"g": g}, {"r": r}, steps,
                             states)
    check_kernel_inputs("slstm_scan_bwd", g.device, g=g, r=r, **steps,
                        **states)
    dg = torch.empty_like(g)
    d0 = [torch.empty_like(c0) for _ in STATE]
    tiles = -(-Dh // TILE)
    scratch = torch.empty((2, C * H, tiles, B, Dh), dtype=g.dtype,
                          device=g.device)
    counters = torch.zeros(C * H, dtype=torch.int32, device=g.device)
    _launch("slstm_scan_bwd", g.device, g, cs, ns, ms, r, c0, n0, m0, dhs,
            dc, dn, dm, dh, dg, *d0, scratch, counters, C, B, S, H, Dh)
    return (dg, *d0)


@_scan_bwd.register_kernel("cpu")
def _(g, cs, ns, ms, r, c0, n0, m0, dhs, dc, dn, dm, dh):
    out = _per_cohort(ref.slstm_scan_bwd_ref, g, g, cs, ns, ms, r, c0, n0,
                      m0, dhs, dc, dn, dm, dh)
    return tuple(t.contiguous() for t in out)


@_scan_bwd.register_fake
def _(g, cs, ns, ms, r, c0, n0, m0, dhs, dc, dn, dm, dh):
    return (torch.empty_like(g), *(torch.empty_like(c0) for _ in STATE))


@register_flop_formula(torch.ops.repro_torch.slstm_scan_bwd)
def _(g_shape, *_, out_shape=None, **__):
    return _scan_flops(work.slstm_bwd_work, g_shape)


def slstm_scan_bwd(g, cs, ns, ms, r, c0, n0, m0, dhs, dc, dn, dm, dh):
    """The backward of the scan, a reverse scan: g (B, S, 4, H, Dh) and
    cs, ns, ms (B, S, H, Dh) as ``slstm_scan_fwd(..., save=True)`` gives
    them; r; the initial c0, n0, m0 (B, H, Dh); the cotangents dhs
    (B, S, H, Dh) of hs and dc, dn, dm, dh (B, H, Dh) of the final states;
    each may carry one leading cohort axis, all the same.  Returns
    (dg (B, S, 4, H, Dh), dc0, dn0, dm0, dh0), all float32.  The
    counterpart of the reference's ``_scan_bwd`` without r's and b's
    gradients (two plain products of dg, in ``ops``)."""
    return _scan_bwd(g, cs, ns, ms, r, c0, n0, m0, dhs, dc, dn, dm, dh)


# Under torch.func.vmap: a frozen layer's cohorts share r (and b) and fold
# into the rows (B -> C B: one call, rows independent); a trainable
# layer's have their own, and go to the kernel as C H heads.
def _front(t, d, C):
    """``t`` with the vmapped axis ``d`` at the front, expanded to C where
    it is not batched."""
    return t.movedim(d, 0) if d is not None else t.expand(C, *t.shape)


def _fold(info, in_dims, args, shared):
    """(args for one call, how to unfold its outputs): ``shared`` names
    the positions of r and b; cohorts fold into B where those are not
    batched, else every tensor takes a leading cohort axis."""
    C = info.batch_size
    if all(in_dims[i] is None for i in shared) and args[shared[0]].dim() == 4:
        rows = [_front(a, d, C) if i not in shared and torch.is_tensor(a)
                else a for i, (a, d) in enumerate(zip(args, in_dims))]
        B = rows[0].shape[1]
        flat = [a if i in shared or not torch.is_tensor(a)
                else a.reshape(C * B, *a.shape[2:]).contiguous()
                for i, a in enumerate(rows)]
        return flat, lambda t: t.reshape(C, B, *t.shape[1:])
    return ([_front(a, d, C).contiguous() if torch.is_tensor(a) else a
             for a, d in zip(args, in_dims)], lambda t: t)


@torch.library.register_vmap(_scan_fwd)
def _(info, in_dims, g_in, r, b, c0, n0, m0, h0, save):
    args, unfold = _fold(info, in_dims, (g_in, r, b, c0, n0, m0, h0, save),
                         (1, 2))
    out = _scan_fwd(*args)
    n = 9 if save else 5
    return ((*(unfold(t) for t in out[:n]), *out[n:]),
            (0,) * n + (None,) * (9 - n))


@torch.library.register_vmap(_scan_bwd)
def _(info, in_dims, *args):
    flat, unfold = _fold(info, in_dims, args, (4,))
    return tuple(unfold(t) for t in _scan_bwd(*flat)), (0,) * 5
