"""The C ABI of the port's kernel library, on the CPU.

Every ``extern "C"`` function of ``cara_tpu_torch/csrc/*.cu`` is parsed
from its source and held against ``_build._SIGNATURES``, the ctypes
argument types ``_build.lib()`` sets: the same name, the same number of
arguments, and the same kind for each (a pointer is ``c_void_p``, a
pointer to long long the strides array, ``int`` ``c_int``, ``float``
``c_float``, ``unsigned`` ``c_uint``).  A pointer passed as ``c_int`` is
cut to 32 bits, and an argument too few or too many shifts every one after
it, on the card only; this test catches both where there is no card.
"""

import ctypes
import re

import pytest

from cara_tpu_torch.ops.cuda import _build

_DECL = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)


def _entry_points():
    found = []
    for src in sorted(_build.CSRC.glob("*.cu")):
        for m in _DECL.finditer(src.read_text()):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            found.append((src.name, m.group(1), params))
    return found


ENTRIES = _entry_points()


def _kind(param: str):
    """The ctypes type a C parameter declaration passes as."""
    words = param.replace("*", " * ").split()
    if "*" in words:
        if words[:3] == ["const", "long", "long"]:
            return _build._S
        return ctypes.c_void_p
    base = words[0]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "unsigned": ctypes.c_uint}
    assert base in kinds, f"unexpected parameter type in {param!r}"
    return kinds[base]


@pytest.mark.parametrize("src, name, params", ENTRIES,
                         ids=[name for _, name, _ in ENTRIES])
def test_entry_point_matches_ctypes_signature(src, name, params):
    assert name in _build._SIGNATURES, f"{src}: {name} has no signature"
    want = [_kind(p) for p in params]
    got = _build._SIGNATURES[name]
    assert len(got) == len(want), (src, name, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is w, (src, name, i, params[i], g, w)


def test_every_signature_names_an_entry_point():
    assert sorted(_build._SIGNATURES) == sorted(n for _, n, _ in ENTRIES)
