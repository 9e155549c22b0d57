"""The edlib-equivalent host aligners: the port of
longreadmapper_tpu/native/__init__.py's `traceback`, `banded_align`,
`myers_distance`, `ops_extended` and `myers_align` (the same import path
under this package, so `native.X` here answers for `native.X` there).

The reference vendors edlib as its fallback and rescoring aligner (modes
NW global, SHW prefix, HW infix; tasks DISTANCE, LOC and PATH; the k
bound; `edlibAlignmentToCigar`'s extended CIGAR).  The distance is the
Myers bit-parallel scorer (csrc/myers.cpp), the path the banded unit-cost
aligner (csrc/align.cpp); both are the port's copies of the JAX package's
C++, built with g++ at first use by native_build.py and called through
ctypes.  A failed build raises with g++'s message; there is no numpy
fallback.  The functions take numpy arrays of 2-bit codes (4 = N) on the
host, as JAX's do; nothing here runs on the card.

Ops are run-length lists [(count, op)]: 'M', 'I' (consumes the query
only), 'D' (consumes the target only), or '='/'X' in the extended form.
Among co-optimal paths the tie-break is M > I > D, the order of the device
walks.  The affine aligner is ops/affine.py::affine_align.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from . import native_build

INF16 = 0x3FFF

_P, _I, _L = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_ALIGN = {
    "lrm_traceback": ([_P, _I, _I, _P, _P, _I, _I, _P, _P, _I], _I),
    "lrm_banded_align": ([_P, _I, _P, _I, _I, _P, _P, _I, _P], _I),
}
_MYERS = {"lrm_myers_distance": ([_P, _L, _P, _L, ctypes.c_int, _L, _P],
                                 ctypes.c_int)}
_MODES = {"NW": 0, "SHW": 1, "HW": 2}

Ops = List[Tuple[int, str]]


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def _ops(ops: np.ndarray, lens: np.ndarray, n: int) -> Ops:
    return [(int(lens[i]), chr(ops[i])) for i in range(n)]


def traceback(H: np.ndarray, W: int, q: np.ndarray, t: np.ndarray,
              qlen: int, tlen: int) -> Optional[Ops]:
    """CIGAR traceback over a banded H matrix ((qlen+1, band) int16, band
    column d = j - i + W, INF16 outside the band) from (qlen, tlen).
    Returns [(count, op), ...] or None if no in-band path exists."""
    H = np.ascontiguousarray(H, dtype=np.int16)
    q, t = _u8(q), _u8(t)
    lib = native_build.load("align", _ALIGN)
    max_ops = 2 * (qlen + tlen) + 4
    ops = np.empty(max_ops, dtype=np.uint8)
    lens = np.empty(max_ops, dtype=np.int32)
    n = lib.lrm_traceback(H.ctypes.data, H.shape[1], W, q.ctypes.data,
                          t.ctypes.data, qlen, tlen, ops.ctypes.data,
                          lens.ctypes.data, max_ops)
    return None if n < 0 else _ops(ops, lens, n)


def banded_align(q: np.ndarray, t: np.ndarray, W: int):
    """Banded global unit-cost alignment of q against t at half-width W:
    (ed, ops), or (-1, None) when the global path leaves the band."""
    q, t = _u8(q), _u8(t)
    qlen, tlen = q.shape[0], t.shape[0]
    lib = native_build.load("align", _ALIGN)
    max_ops = 2 * (qlen + tlen) + 4
    ops = np.empty(max_ops, dtype=np.uint8)
    lens = np.empty(max_ops, dtype=np.int32)
    ed = ctypes.c_int32(-1)
    n = lib.lrm_banded_align(q.ctypes.data, qlen, t.ctypes.data, tlen, W,
                             ops.ctypes.data, lens.ctypes.data, max_ops,
                             ctypes.addressof(ed))
    if ed.value < 0:
        return -1, None
    return int(ed.value), _ops(ops, lens, n)


def myers_distance(q: np.ndarray, t: np.ndarray, mode: str = "NW",
                   k: int = -1) -> Tuple[int, int]:
    """Myers bit-parallel edit distance.  mode: 'NW' (global), 'SHW' (free
    target suffix), 'HW' (free target prefix and suffix).  Returns
    (distance, end): end is the 1-based target position where the best
    alignment ends (n for NW).  k >= 0 bounds the search (edlib's k):
    (-1, 0) when the distance exceeds k."""
    q, t = _u8(q), _u8(t)
    lib = native_build.load("myers", _MYERS)
    out2 = np.zeros(2, dtype=np.int64)
    lib.lrm_myers_distance(q.ctypes.data, q.shape[0], t.ctypes.data,
                           t.shape[0], _MODES[mode], k, out2.ctypes.data)
    return int(out2[0]), int(out2[1])


def ops_extended(q: np.ndarray, t: np.ndarray, t_start: int,
                 ops: Ops) -> Ops:
    """Split the M runs of `ops` (aligning q against t from t_start) into
    '=' / 'X' runs, edlib's extended CIGAR.  N (code >= 4) never counts as
    a match, as in the scorer's pattern masks."""
    out: Ops = []

    def push(ln, op):
        if ln == 0:
            return
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + ln, op)
        else:
            out.append((ln, op))

    i, j = 0, t_start
    for ln, op in ops:
        if op == "I":
            push(ln, "I")
            i += ln
        elif op == "D":
            push(ln, "D")
            j += ln
        else:
            eq = (q[i:i + ln] == t[j:j + ln]) & (q[i:i + ln] < 4)
            s = 0
            for e in range(1, ln + 1):
                if e == ln or eq[e] != eq[s]:
                    push(e - s, "=" if eq[s] else "X")
                    s = e
            i += ln
            j += ln
    return out


def myers_align(q: np.ndarray, t: np.ndarray, mode: str = "HW",
                k: int = -1, extended: bool = False):
    """edlib-equivalent alignment with PATH: (distance, t_start, t_end,
    ops), the target window [t_start, t_end) 0-based half-open and ops
    covering q ([] for an empty query).

      NW  — the window is all of t.
      SHW — the end comes from the bit-parallel scorer, the start is 0.
      HW  — the end from the HW scorer; the start from the reversed pair
            rescored in SHW mode over t[:end].

    The window's path is `banded_align` at W = max(ed + 1, |span - m| +
    1): an optimal unit-cost path strays from the window's diagonal by at
    most the distance, so the path costs the scorer's distance.  k >= 0
    bounds the search: (-1, 0, 0, []) when the distance exceeds k.
    extended=True gives '=' / 'X' runs in place of 'M'.  Raises
    RuntimeError if the rescore or the path disagrees with the distance."""
    q, t = _u8(q), _u8(t)
    m, n = q.shape[0], t.shape[0]
    if m == 0:
        if mode == "NW":
            if 0 <= k < n:
                return -1, 0, 0, []
            return n, 0, n, ([(n, "D")] if n else [])
        return 0, 0, 0, []
    ed, end = myers_distance(q, t, mode, k)
    if ed < 0:
        return -1, 0, 0, []
    if mode == "NW":
        start, end = 0, n
    elif mode == "SHW":
        start = 0
    else:
        ed2, end2 = myers_distance(q[::-1], t[:end][::-1], "SHW")
        if ed2 != ed:
            raise RuntimeError(f"myers_align: the reversed SHW rescore gave "
                               f"{ed2}, the HW distance is {ed}")
        start = end - end2
    W = max(ed + 1, abs((end - start) - m) + 1)
    ed_b, ops = banded_align(q, t[start:end], W)
    if ed_b != ed:
        raise RuntimeError(f"myers_align ({mode}): the window's banded path "
                           f"costs {ed_b}, the distance is {ed}")
    if extended:
        ops = ops_extended(q, t, start, ops)
    return ed, start, end, ops
