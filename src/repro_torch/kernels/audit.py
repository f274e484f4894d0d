"""The kernel seam of the auditors (port of the reference's
``KernelAuditCase`` in ``repro.kernels``).

Each ``kernels/<family>/ops.py`` exposes ``AUDIT_CASES()``: the reference's
audit shapes and dtypes of its ``pallas_call`` sites, each naming the
``__global__`` kernels of the family's ``.cu`` that the call runs on the
card.  The reference's static checks read Pallas grids and BlockSpecs,
which a CUDA kernel does not have; the port's counterpart reads what the
card built (``read_resources``: registers, shared memory, spills, the most
threads a block may have and the block the launches use) and runs no
kernel (``analysis/kernel_audit.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import re
from pathlib import Path
from typing import List, Tuple

RESOURCE_FIELDS = ("registers", "static_smem", "local_bytes", "max_threads",
                   "block")


@dataclasses.dataclass
class KernelAuditCase:
    """One audited kernel call at the reference's representative shapes.

    ``kernels`` are the ``__global__`` kernels of ``source`` the call runs;
    ``shapes`` the operand shapes and ``dtypes`` their types, as the
    reference's case states them."""

    family: str                       # kernel package name
    name: str                         # the reference's case name
    source: Path                      # the family's .cu
    kernels: Tuple[str, ...]
    shapes: Tuple[tuple, ...]
    dtypes: Tuple[str, ...]
    notes: str = ""

    def location(self) -> str:
        """``file:line`` of the first of its kernels' definitions."""
        text = Path(self.source).read_text()
        m = re.search(rf"\b{re.escape(self.kernels[0])}\s*\(", text)
        line = text.count("\n", 0, m.start()) + 1 if m else 1
        return f"{Path(self.source).name}:{line}"


def global_kernels(source) -> List[str]:
    """Names of the ``__global__`` functions of a CUDA source."""
    text = Path(source).read_text()
    return re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
        text)


def read_resources(entry, names) -> List[dict]:
    """Call a ``*_kernel_attributes`` entry point (bound with ctypes) for
    the kernels ``names`` in its order; one dict of ``RESOURCE_FIELDS`` a
    kernel.  Raises on a CUDA error."""
    rows = (ctypes.c_int * (len(RESOURCE_FIELDS) * len(names)))()
    err = entry(rows, len(names))
    if err != 0:
        raise RuntimeError(f"reading the kernels' attributes failed with "
                           f"CUDA error {err}")
    n = len(RESOURCE_FIELDS)
    return [dict(kernel=name, **dict(zip(RESOURCE_FIELDS,
                                         rows[n * i:n * (i + 1)])))
            for i, name in enumerate(names)]
