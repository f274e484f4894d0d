"""Builds the CUDA sources of the port with ``nvcc`` and loads them with
ctypes.

A ``csrc/*.cu`` file has a plain C interface.  At first use it is compiled
for Hopper (``sm_90a``) into a shared library under ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
not.  ``build_libraries`` compiles several sources at once, one ``nvcc``
process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build_libraries(sources) -> None:
    """Compile each of ``sources`` whose library does not exist yet, all
    at the same time, and wait for every compiler.  Raises with the
    compiler's output if a build fails."""
    jobs = []
    for source in map(Path, sources):
        lib = library_path(source)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(source)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((source, lib, tmp, proc))
    failed = []
    for source, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


def open_library(path) -> ctypes.CDLL:
    """Load a built library: the one place the port calls ``ctypes.CDLL``
    (``analysis/contracts.py``, CON-LOAD-SEAM)."""
    return ctypes.CDLL(str(path))


def load_library(source: Path) -> ctypes.CDLL:
    """Compile ``source`` unless its library exists, then load it."""
    build_libraries([source])
    return open_library(library_path(Path(source)))
