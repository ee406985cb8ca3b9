"""PyTorch port: the C interface between the wrappers and ``csrc/``.

``ops/_ext._SIGNATURES`` gives ``ctypes`` the argument types of every
kernel entry point; the kernel library is loaded only where a card and
``nvcc`` exist, and a launch there trusts those types.  Here, on the CPU,
each entry is held to its ``extern "C"`` definition in the sources: one
definition, returning ``int``, whose parameters map one by one to the
entry's types (``void*`` and ``const void*`` to ``c_void_p``, ``int`` to
``c_int``, ``int64_t`` to ``c_int64``, ``float`` to ``c_float``).  Every
other ``extern "C"`` definition is one that ``_ext.library`` types
itself."""
import ctypes
import functools
import re

import pytest

pytest.importorskip("torch")

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import _ext  # noqa: E402

C_TYPES = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p,
           "int": ctypes.c_int, "int64_t": ctypes.c_int64,
           "float": ctypes.c_float}
# the entry points library() types by hand: (return type, parameter types)
OWN = {"gta_error_string": ("const char*", [ctypes.c_int]),
       "gta_sddmm_tiles_walk": ("const char*", []),
       "gta_sddmm_grouped_walk": ("const char*", [])}
_DEF = re.compile(r'extern\s+"C"\s+([\w\s*]+?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{')
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def _c_type(param: str):
    """The ctypes type of one C parameter declaration (its name dropped),
    or the C type's text where none is mapped, which no entry equals."""
    decl = re.sub(r"\s*\*\s*", "* ", " ".join(param.split())).strip()
    ctype = decl.rsplit(" ", 1)[0]
    return C_TYPES.get(ctype, ctype)


def _names(types):
    return [getattr(t, "__name__", t) for t in types]


@functools.cache
def _definitions():
    """name -> [(file, return type, parameter types)] of every ``extern "C"``
    definition in the sources the library is built from."""
    cu, cuh = _ext._sources()
    defs = {}
    for path in cu + cuh:
        text = _COMMENT.sub("", path.read_text())
        for ret, name, params in _DEF.findall(text):
            params = [p for p in params.split(",")
                      if p.strip() not in ("", "void")]
            ret = re.sub(r"\s*\*", "*", " ".join(ret.split()))
            defs.setdefault(name, []).append(
                (path.name, ret, [_c_type(p) for p in params]))
    return defs


@pytest.mark.parametrize("name", sorted(_ext._SIGNATURES))
def test_signature_matches_the_c_definition(name):
    found = _definitions().get(name, [])
    assert len(found) == 1, f"{name}: {len(found)} definitions {found}"
    where, ret, types = found[0]
    assert ret == "int", f"{name} ({where}) returns {ret}"
    want = _ext._SIGNATURES[name]
    assert types == want, (
        f"{name} ({where}): C has {len(types)} parameters {_names(types)}, "
        f"_SIGNATURES {len(want)} {_names(want)}")


def test_other_c_definitions_are_typed_by_the_loader():
    """Every ``extern "C"`` definition not in ``_SIGNATURES`` is one of the
    entry points ``library()`` types itself, once, as it types it."""
    others = {n: d for n, d in _definitions().items()
              if n not in _ext._SIGNATURES}
    assert set(others) == set(OWN)
    for name, found in others.items():
        assert len(found) == 1, f"{name}: {len(found)} definitions {found}"
        _, ret, types = found[0]
        assert (ret, types) == OWN[name], name
