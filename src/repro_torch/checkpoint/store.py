"""Tree checkpoints: flat-path .npz files, a JSON sidecar, rotation (port
of ``repro.checkpoint.store``, with its on-disk format, so that either
package reads what the other wrote).

Layout: ``<dir>/ckpt_<step:08d>.npz`` keyed by leaf path
(``common.tree.map_with_path``) plus a ``ckpt_<step:08d>.npz.json`` sidecar
``{"__store__": {"version": 1, "dtypes": {path: name}}, "meta": ...}``.

Crash-atomic: both files are written to temp names, fsynced and renamed
into place, the sidecar first, so a visible ``ckpt_*.npz`` always has its
sidecar.  A torn file (disk corruption, an older writer) is skipped by
``latest_checkpoint`` and makes ``load_checkpoint`` raise a clean
``ValueError``.

Dtypes: numpy has no bfloat16 (the reference's ``ml_dtypes`` gives it
one).  A bf16 leaf goes to disk as the raw ``uint16`` view of its bits with
``"bfloat16"`` in the sidecar, as the reference's ``_raw_view`` writes it,
and comes back through the same view as a ``torch.bfloat16`` tensor with
the same bits (the float8 types too, as ``uint8``).  Every leaf loads as a
tensor on the device asked for, 64-bit leaves as int64 / float64.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import map_with_path

# reserved sidecar key: {"version": ..., "dtypes": {path: true_dtype_name}}
_STORE_KEY = "__store__"
_STORE_VERSION = 1
_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz")

# the reference's ml_dtypes names with a torch dtype, each stored as the
# unsigned integer view of its width
_VIEWED = {name: getattr(torch, name) for name in (
    "bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
    "float8_e5m2fnuz") if hasattr(torch, name)}
_SIGNED = {1: torch.int8, 2: torch.int16}


def _to_numpy(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """(savez-safe array, the true dtype's name where a view was needed)."""
    if not torch.is_tensor(leaf):
        return np.asarray(leaf), None
    t = leaf.detach().cpu().contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if name in _VIEWED:
        width = t.element_size()
        return (t.view(_SIGNED[width]).numpy()
                .view(np.dtype(f"uint{width * 8}")), name)
    return t.numpy(), None


def _to_tensor(arr: np.ndarray, dtype_name: Optional[str],
               device: torch.device) -> torch.Tensor:
    arr = np.array(arr, copy=True)
    if dtype_name is None:
        return torch.from_numpy(arr).to(device)
    width = arr.dtype.itemsize
    return (torch.from_numpy(arr.view(np.dtype(f"int{width * 8}")))
            .view(_VIEWED[dtype_name]).to(device))


def _fsync_write(directory: str, suffix: str, write_fn) -> str:
    """Write via ``write_fn(file)`` to a temp name in ``directory`` and
    fsync it; returns the temp path (the caller renames it visible)."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        os.unlink(tmp)
        raise
    return tmp


def checkpoint_path(directory: str, step: int) -> str:
    """Where ``save_checkpoint`` writes step ``step`` in ``directory``."""
    return os.path.join(directory, f"ckpt_{step:08d}.npz")


def save_checkpoint(directory: str, step: int, tree,
                    meta: Optional[dict] = None, keep: int = 3) -> str:
    """Atomically write ``ckpt_<step>.npz`` (and its ``.json`` sidecar) of
    ``tree`` (tensor, numpy or scalar leaves) and rotate old checkpoints
    down to the newest ``keep`` (``keep >= 1``)."""
    if keep < 1:
        raise ValueError(f"keep={keep}: must retain at least one checkpoint")
    os.makedirs(directory, exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}

    def visit(p, leaf):
        flat[p], name = _to_numpy(leaf)
        if name is not None:
            dtypes[p] = name

    map_with_path(visit, tree)
    path = checkpoint_path(directory, step)
    sidecar = {_STORE_KEY: {"version": _STORE_VERSION, "dtypes": dtypes},
               "meta": meta}
    tmp_npz = _fsync_write(directory, ".npz.tmp",
                           lambda f: np.savez(f, **flat))
    try:
        tmp_json = _fsync_write(
            directory, ".json.tmp",
            lambda f: f.write(json.dumps(sidecar).encode()))
    except BaseException:
        os.unlink(tmp_npz)
        raise
    # the sidecar first: once the npz is visible, its sidecar exists
    os.replace(tmp_json, path + ".json")
    os.replace(tmp_npz, path)
    _rotate(directory, keep)
    return path


def _read_sidecar(path: str) -> Tuple[Optional[dict], Dict[str, str]]:
    """(user meta, dtype map) from the ``.json`` sidecar (a sidecar from
    before the atomic store holds the user meta alone)."""
    jpath = path + ".json"
    if not os.path.exists(jpath):
        return None, {}
    with open(jpath) as f:
        parsed = json.load(f)
    if isinstance(parsed, dict) and _STORE_KEY in parsed:
        return parsed.get("meta"), parsed[_STORE_KEY].get("dtypes", {})
    return parsed, {}


def read_checkpoint_meta(path: str) -> Optional[dict]:
    """A checkpoint's user meta, without reading its arrays."""
    return _read_sidecar(path)[0]


class _StructureMismatch(ValueError):
    """The archive's leaf paths are not ``like``'s (not file corruption)."""


def load_checkpoint(path: str, like, device: DeviceLike = None
                    ) -> Tuple[Any, Optional[dict]]:
    """(tree shaped like ``like``, meta): every leaf a tensor on ``device``
    (the current CUDA card unless the caller passes another).  ``like``'s
    leaves only name the paths.  Raises ``ValueError`` naming the missing
    and extra paths when the archive's disagree with ``like``'s, and on a
    corrupt or truncated archive."""
    dev = resolve_device(device)
    meta, dtypes = _read_sidecar(path)
    unknown = {p: n for p, n in dtypes.items() if n not in _VIEWED}
    if unknown:
        raise ValueError(
            f"checkpoint {path!r} stores leaves of dtypes the port cannot "
            f"represent: {unknown} (it reads {sorted(_VIEWED)})")
    want = set()
    map_with_path(lambda p, leaf: want.add(p), like)
    try:
        with np.load(path) as data:
            have = set(data.files)
            missing, extra = sorted(want - have), sorted(have - want)
            if missing or extra:
                raise _StructureMismatch(
                    f"checkpoint {path!r} does not match the requested "
                    f"structure: missing leaf paths {missing}, "
                    f"unexpected leaf paths {extra}")
            out = map_with_path(
                lambda p, leaf: _to_tensor(data[p], dtypes.get(p), dev),
                like)
    except (_StructureMismatch, FileNotFoundError):
        raise
    except (zipfile.BadZipFile, EOFError, OSError, ValueError, KeyError) as e:
        raise ValueError(
            f"corrupt or truncated checkpoint {path!r}: {e}") from e
    return out, meta


def checkpoint_step(path: str) -> int:
    """The integer step of a ``ckpt_<step>.npz`` path."""
    m = _CKPT_RE.fullmatch(os.path.basename(path))
    if m is None:
        raise ValueError(f"not a checkpoint path: {path!r}")
    return int(m.group(1))


def _list_checkpoints(directory: str):
    """[(step, filename)] in numeric step order (``{step:08d}`` orders
    lexically only up to 10^8)."""
    out = []
    for p in os.listdir(directory):
        m = _CKPT_RE.fullmatch(p)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest complete checkpoint by step; a file that is not a
    readable zip archive (a torn write) is skipped."""
    if not os.path.isdir(directory):
        return None
    for _, p in reversed(_list_checkpoints(directory)):
        full = os.path.join(directory, p)
        if zipfile.is_zipfile(full):
            return full
    return None


def _rotate(directory: str, keep: int) -> None:
    for _, p in _list_checkpoints(directory)[:-keep]:
        os.remove(os.path.join(directory, p))
        j = os.path.join(directory, p + ".json")
        if os.path.exists(j):
            os.remove(j)
