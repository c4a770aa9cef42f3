"""The ctypes signatures of the port's CUDA entry points (``kernels/_build.
SIGNATURES``) against the ``extern "C"`` functions of ``csrc/*.cu``: one
argtype per parameter, of the parameter's C type. A missing or extra
argtype, or a pointer passed as a 32-bit int, would cut arguments silently
at the call; this reads the sources, so it runs on the CPU."""

import ctypes
import re

import pytest

from repro_torch.kernels import _build

_EXTERN = re.compile(r'extern "C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _c_type(param: str):
    """The ctypes type a C parameter declaration is passed as."""
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.split()[:-1]  # drop the parameter's name
    kinds = {("int",): ctypes.c_int, ("long", "long"): ctypes.c_longlong,
             ("unsigned", "int"): ctypes.c_uint, ("float",): ctypes.c_float}
    return kinds[tuple(w for w in words if w != "const")]


def _entry_points(name: str):
    src = (_build.CSRC / f"{name}.cu").read_text()
    src = re.sub(r"//[^\n]*", "", src)
    return {fn: [p for p in params.split(",") if p.strip()] for fn, params in _EXTERN.findall(src)}


def test_every_source_has_a_signature_table():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == _build.sources()


@pytest.mark.parametrize("name", _build.sources())
def test_argtypes_match_the_extern_c_parameters(name):
    found = _entry_points(name)
    assert sorted(found) == sorted(_build.SIGNATURES[name]), name
    for fn, params in found.items():
        argtypes = _build.SIGNATURES[name][fn]
        assert len(argtypes) == len(params), (fn, len(argtypes), len(params))
        assert [_c_type(p) for p in params] == list(argtypes), fn
