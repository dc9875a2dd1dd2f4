"""The ctypes bindings of the port's CUDA sources against their C signatures.

Each ``ops/*_kernels.py`` binds its library's C functions with an
``argtypes`` list (``_SIGNATURES``).  ctypes passes arguments beyond that
list with default conversions, so a missing entry (the stream, last) would
hand the kernel a 32-bit stream; the sources are only compiled on the card,
so this reads each ``extern "C"`` definition in ``csrc/`` and checks the
count and the int/pointer kind of every parameter here.
"""

import ctypes
import re
from pathlib import Path

import pytest

from ccm_slam_tpu_torch.ops import ba_kernels, hamming_kernels

CSRC = Path(ba_kernels.__file__).resolve().parents[1] / "csrc"
CASES = [(mod, fn) for mod in (ba_kernels, hamming_kernels) for fn in mod._SIGNATURES]


def c_params(source: str, fn: str):
    """The parameter declarations of ``int fn(...)`` in a CUDA source."""
    m = re.search(rf"\bint {fn}\(([^)]*)\)\s*{{", source)
    assert m, f"{fn} not defined in csrc"
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("mod,fn", CASES, ids=[fn for _, fn in CASES])
def test_argtypes_match_c_signature(mod, fn):
    name = Path(mod.__file__).stem
    params = c_params((CSRC / f"{name}.cu").read_text(), fn)
    argtypes = mod._SIGNATURES[fn]
    assert len(argtypes) == len(params)
    for ctype, decl in zip(argtypes, params):
        if "*" in decl or decl.startswith("cudaStream_t"):
            assert ctype is ctypes.c_void_p, decl
        elif decl.startswith("float"):
            assert ctype is ctypes.c_float, decl
        else:
            assert decl.startswith("int") and ctype is ctypes.c_int, decl
