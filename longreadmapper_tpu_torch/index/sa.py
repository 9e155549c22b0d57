"""Suffix-array build glue: the in-RAM branch of
longreadmapper_tpu/index/sa.py.  The SA-IS construction is the port's own
copy, `csrc/sais.cpp`, built with g++ at first use into `_build/libsais.so`
(native_build.py) and called through ctypes.  A failed build raises with
g++'s message; there is no slower fallback.  Writes `<prefix>.sa5` in the
40-bit codec."""

from __future__ import annotations

import ctypes

import numpy as np

from ..device import roadmap_gap
from ..formats.ui40 import write_sa5
from .. import native_build

_FUNCS = {"lrm_sais_u8": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]}


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array (int64) of a uint8 text, suffixes compared with an
    implicit terminal sentinel smaller than every byte (the convention of
    longreadmapper_tpu.native.suffix_array)."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = text.shape[0]
    lib = native_build.load("sais", _FUNCS)
    # n + 1 slots: the build's sentinel scratch, so it needs no copy
    sa = np.empty(n + 1, dtype=np.int64)
    rc = lib.lrm_sais_u8(text.ctypes.data, n, sa.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"lrm_sais_u8 failed: {rc}")
    return sa[:n]


def sa_build(prefix: str, ram_use: int = 0) -> np.ndarray:
    """Build and persist `<prefix>.sa5`; returns the SA as int64.

    `ram_use` > 0 selects the blocked external-memory construction in the JAX
    package, which is not ported."""
    if ram_use > 0:
        raise roadmap_gap("the external-memory SA build (index --ram-gb)",
                          "A12")
    text = np.fromfile(prefix, dtype=np.uint8)
    sa = suffix_array(text)
    write_sa5(sa, prefix + ".sa5")
    return sa
