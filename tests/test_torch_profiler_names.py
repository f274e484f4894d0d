"""The kernel names ``chip_smoke.py`` picks out of a profile are the port's
own ``__global__`` functions.

``chip_smoke.py`` times each hand-written kernel, and sums its share of a
step, by matching the profiler's kernel names against substrings
(``STREAMING_KERNELS``, ``KERNEL_NAMES``).  A name that no kernel has any
more reads as no time at all, and a name inside another kernel's name
(``stats_kernel`` in ``gram_stats_kernel``) adds that kernel's time: both
without a warning.  These tests read the CUDA sources, so they run without
a card.
"""
import importlib.util
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels"
SOURCES = {"nhsic": CSRC / "hsic_gram" / "csrc" / "nhsic.cu",
           "flash": CSRC / "flash_attention" / "csrc" / "flash_attention.cu",
           "slstm": CSRC / "slstm_scan" / "csrc" / "slstm_scan.cu"}
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                     r"(\w+)\s*\(")

_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# (where chip_smoke lists it, family, name)
NAMES = ([("STREAMING_KERNELS", "nhsic", n)
          for names in chip_smoke.STREAMING_KERNELS.values() for n in names]
         + [("KERNEL_NAMES", fam, n)
            for fam, names in chip_smoke.KERNEL_NAMES.items()
            for n in names])
IDS = [f"{where}-{n}" for where, _, n in NAMES]


def _globals(path):
    return set(_GLOBAL.findall(path.read_text()))


def test_every_source_declares_kernels():
    for fam, path in SOURCES.items():
        assert _globals(path), f"no __global__ function found in {path}"
    assert set(chip_smoke.KERNEL_NAMES) == set(SOURCES)
    assert set(chip_smoke.STREAMING_KERNELS) == {
        "nhsic_rowsums", "nhsic_stats_feats", "nhsic_grad"}


@pytest.mark.parametrize("where,family,name", NAMES, ids=IDS)
def test_profiled_name_is_a_kernel_of_its_source(where, family, name):
    assert name in _globals(SOURCES[family]), (
        f"{where} names {name!r}, which is no __global__ function of "
        f"{SOURCES[family].relative_to(ROOT)}")


@pytest.mark.parametrize("where,family,name", NAMES, ids=IDS)
def test_profiled_name_is_inside_no_other_kernel_name(where, family, name):
    every = set().union(*(_globals(p) for p in SOURCES.values()))
    others = sorted(k for k in every if name in k and k != name)
    assert not others, f"{where}'s {name!r} also matches {others}"
