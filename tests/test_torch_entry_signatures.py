"""The ctypes argument types that ops/_build.py binds to each C entry point
of ops/csrc/*.cu match the entry point's declaration, argument by argument: a
pointer (`void*`, `int*`, `long long*`) as c_void_p, an `int` as c_int, a
`float` as c_float. The card is not needed: the declarations are read from
the sources. A wrong count shows only at a call on the card (ctypes refuses
it there), a wrong kind as garbage."""

import ctypes
import re

import pytest

from multimodal_particles_tpu_torch.ops import _build


def declarations():
    """Entry point → its parameter list's text, from every `extern "C" int`
    definition in the sources."""
    found = {}
    for path in sorted(_build.CSRC_DIR.glob("*.cu")):
        text = path.read_text()
        for match in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[match.group(1)] = match.group(2)
    return found


def kind(param):
    """The ctypes type a C parameter (`const void* x`, `int B`, …) is bound as."""
    declared = " ".join(param.split())
    if "*" in declared:
        return ctypes.c_void_p
    words = declared.split()[:-1]  # drop the parameter's name
    return {"int": ctypes.c_int, "float": ctypes.c_float}[" ".join(w for w in words if w != "const")]


DECLARED = declarations()


def test_every_bound_entry_point_is_declared_and_every_declared_one_bound():
    assert set(_build._SIGNATURES) == set(DECLARED)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_argument_types_match_the_declaration(name):
    params = [p for p in DECLARED[name].split(",") if p.strip()]
    assert [kind(p) for p in params] == list(_build._SIGNATURES[name]), name
