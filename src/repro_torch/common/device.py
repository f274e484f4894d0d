"""Device resolution, the one sanctioned read of device values
(``to_host``) and the input checks every kernel wrapper makes.

The port runs on CUDA unless the caller asks for the CPU.  ``resolve_device``
never falls back: with no card and no explicit ``"cpu"`` it raises.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch
from torch._guards import detect_fake_mode

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA card; any other value is taken as
    given.  Raises when CUDA is asked for (explicitly or by default) and no
    card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def to_device(tree, device: torch.device):
    """numpy / tensor leaves of a dict tree -> tensors on ``device``.  Host
    data goes to a CUDA device through a pinned copy and an asynchronous
    copy from it: a copy from pageable memory waits for the stream to
    drain (a host sync, which ``analysis.hostsync`` flags).  Under a fake
    tensor mode (the dry-run) nothing is copied, so nothing is pinned."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    t = torch.as_tensor(tree)
    if (t.device.type == "cpu" and torch.device(device).type == "cuda"
            and detect_fake_mode() is None):
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_host(tree):
    """A tree's tensor leaves as numpy arrays, other leaves as they are:
    the port's ``jax.device_get``, the seam through which the server reads
    the device (once a round, once an evaluation;
    ``analysis.hostsync`` counts its calls and flags any other read)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def check_kernel_inputs(name: str, device: torch.device, *,
                        dtypes=(torch.float32,), **tensors) -> None:
    """Raise unless every tensor lies on ``device`` (a CUDA device), has
    one of ``dtypes`` and is contiguous: what the CUDA kernels take."""
    if device.type != "cuda":
        raise ValueError(f"{name}: kernel inputs must be CUDA tensors, got "
                         f"{device}")
    if device.index is not None and device.index != torch.cuda.current_device():
        # the kernels launch on the current device
        raise ValueError(f"{name}: inputs are on {device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: {arg} has dtype {t.dtype}, expected "
                             f"one of {', '.join(map(str, dtypes))}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
