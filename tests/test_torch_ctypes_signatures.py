"""Each C entry point of the port's CUDA sources takes the arguments its
ctypes binding declares.

The wrappers bind ``extern "C"`` functions with ctypes, which checks
nothing against the source: an argument too many or too few reads a
stray register on the card, and a pointer declared as an int is cut to
32 bits.  Both first show as a crash on the card.  These tests read the
sources and the ``_ARGTYPES`` of each wrapper module, so they run without
a card.
"""
import ctypes
import pathlib
import re

import pytest

from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.hsic_gram import kernel as hkernel
from repro_torch.kernels.slstm_scan import kernel as skernel

ROOT = pathlib.Path(__file__).resolve().parents[1]
# module -> {entry point: argtypes}
BINDINGS = {hkernel: hkernel._ARGTYPES,
            fkernel: {"flash_attention_fwd": fkernel._ARGTYPES,
                      "flash_attention_attributes": fkernel._ATTR_ARGTYPES},
            skernel: skernel._ARGTYPES}
_ONE = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')
_BLOCK = re.compile(r'extern\s+"C"\s*\{(.*?)\}\s*//\s*extern\s+"C"', re.S)
_DEF = re.compile(r"^int\s+(\w+)\s*\(([^)]*)\)", re.M)


def _entry_points(source):
    """{name: [parameter declarations]} of the ``extern "C"`` functions of
    a CUDA source, declared one by one or in an ``extern "C" { }`` block."""
    text = pathlib.Path(source).read_text()
    found = dict(_ONE.findall(text))
    for block in _BLOCK.findall(text):
        found.update(_DEF.findall(block))
    return {name: [p.strip() for p in params.split(",")]
            for name, params in found.items()}


def _ctype_of(decl):
    """The ctypes type a C parameter declaration must be bound as."""
    if "*" in decl or decl.split()[0] == "cudaStream_t":
        return ctypes.c_void_p
    if decl.split()[0] == "int":
        return ctypes.c_int
    raise AssertionError(f"no ctypes binding known for {decl!r}")


CASES = [(mod, name) for mod, table in BINDINGS.items() for name in table]
IDS = [f"{pathlib.Path(mod.SOURCE).name}-{name}" for mod, name in CASES]


@pytest.mark.parametrize("mod", list(BINDINGS),
                         ids=[pathlib.Path(m.SOURCE).name for m in BINDINGS])
def test_every_entry_point_is_bound(mod):
    assert set(_entry_points(mod.SOURCE)) == set(BINDINGS[mod])


@pytest.mark.parametrize("mod,name", CASES, ids=IDS)
def test_argtypes_match_the_source(mod, name):
    params = _entry_points(mod.SOURCE)[name]
    argtypes = BINDINGS[mod][name]
    assert len(argtypes) == len(params), (
        f"{name}: {len(params)} parameters in "
        f"{pathlib.Path(mod.SOURCE).relative_to(ROOT)}, {len(argtypes)} "
        f"argtypes")
    for decl, argtype in zip(params, argtypes):
        assert argtype is _ctype_of(decl), (
            f"{name}: {decl!r} is bound as {argtype.__name__}")


def test_parser_reads_both_forms(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text('extern "C" int a(const void* x, int n, void* s) {}\n'
                   'extern "C" {\n'
                   'int b(const float* x,\n      int n, cudaStream_t s) {\n'
                   '  return 0;\n}\n'
                   '}  // extern "C"\n')
    assert _entry_points(src) == {
        "a": ["const void* x", "int n", "void* s"],
        "b": ["const float* x", "int n", "cudaStream_t s"]}
