"""External-memory (blocked) suffix-array construction: the port of
longreadmapper_tpu/index/sa_external.py (its native-merge path).

Builds `<prefix>.sa5` with a bounded-RAM working set, for texts whose
~12 B/char in-RAM SA-IS footprint exceeds the host (the pSAscan-class
capability; design: docs/EXTERNAL_SA.md).

1. Split the mmap'd text into blocks of ~ram/12 bytes.  Each block is
   suffix-sorted by the port's SA-IS (index/sa.py::suffix_array) over the
   block EXTENDED by `margin` bytes.  For kept (in-block) suffixes the
   result is exact except where two suffixes share their entire common
   extension: those pairs share the first `margin` bytes, so maximal runs
   of margin-prefix-equal entries are re-sorted with an exact whole-text
   comparator.  The last block extends to the real terminator: exact as
   is.
2. The partial SAs spill to disk (5-byte ui40 entries) and the native
   streamed merge (csrc/samerge.cpp) merges them with exact suffix
   comparisons against the mmap'd text, writing the .sa5 directly.

Peak RAM = one block's SA-IS working set + the merge's O(K) buffers.  The
merge is the port's only merge: a failed g++ build raises with g++'s
message, and a merge that writes another count than n raises.
Byte-identical to the in-RAM build and to the JAX package's
(tests/test_torch_sa.py).
"""

from __future__ import annotations

import ctypes
import functools
import os
import tempfile

import numpy as np

from .. import native_build
from ..formats.ui40 import Sa5Writer
from .sa import suffix_array

_MERGE = {"lrm_sa_merge": ([ctypes.c_char_p, ctypes.c_int64,
                            ctypes.POINTER(ctypes.c_char_p),
                            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
                            ctypes.c_char_p], ctypes.c_int64)}


def _suffix_less(X, a: int, b: int, step: int = 4096) -> bool:
    """Exact whole-text suffix comparison.  The text ends with a unique
    terminator, so distinct suffixes always differ before both slices run
    out; bytes order == implicit-sentinel order (a proper prefix sorts
    smaller)."""
    assert a != b
    n = X.shape[0]
    while a < n and b < n:
        ca = X[a:a + step].tobytes()
        cb = X[b:b + step].tobytes()
        if ca != cb:
            return ca < cb
        a += step
        b += step
    return a >= n  # the exhausted suffix is the smaller one


def _repair_groups(X, pos: np.ndarray, groups) -> np.ndarray:
    """`pos` with each [s, e) range of `groups` re-sorted exactly."""
    key = functools.cmp_to_key(
        lambda a, b: -1 if _suffix_less(X, a, b) else 1)
    out = pos.copy()
    for s, e in groups:
        out[s:e] = sorted(pos[s:e].tolist(), key=key)
    return out


def _equal_runs(eq_adjacent: np.ndarray):
    """[(start, end)] of maximal runs where eq_adjacent[i] marks element i
    equal to element i+1."""
    runs = []
    i = 0
    m = eq_adjacent.shape[0]
    while i < m:
        if eq_adjacent[i]:
            j = i
            while j < m and eq_adjacent[j]:
                j += 1
            runs.append((i, j + 1))
            i = j
        else:
            i += 1
    return runs


def _block_sa(X, b: int, e: int, margin: int) -> np.ndarray:
    """Exact suffix order (absolute positions) of the text suffixes that
    start in [b, e)."""
    n = X.shape[0]
    ext_end = min(e + margin, n)
    ext = np.asarray(X[b:ext_end])
    sa = suffix_array(ext)
    sa = sa[sa < (e - b)]
    if ext_end == n:
        return sa + b  # extension reaches the real terminator: exact

    # Suspect pairs share their first `margin` bytes (every kept suffix has
    # >= margin bytes of extension): a vectorized 16-byte prefix test of
    # adjacent entries (strided window rows), then full margin equality,
    # then an exact repair of the margin-equal runs.
    win = np.lib.stride_tricks.sliding_window_view(ext, 16)
    k16 = win[sa]
    eq16 = np.all(k16[:-1] == k16[1:], axis=1)
    eqm = np.zeros_like(eq16)
    for i in np.nonzero(eq16)[0]:
        p, q = int(sa[i]), int(sa[i + 1])
        eqm[i] = ext[p:p + margin].tobytes() == ext[q:q + margin].tobytes()
    if not eqm.any():
        return sa + b
    return _repair_groups(X, sa + b, _equal_runs(eqm))


def sa_merge_files(text_path: str, n: int, part_paths, counts,
                   out_path: str) -> None:
    """K-way exact merge of partial-SA files (ui40, each in suffix order)
    into `out_path` (.sa5) by csrc/samerge.cpp; raises unless it wrote all
    n entries.  Written via tmp + rename, as write_sa5 writes, so a failed
    merge leaves no partial file at `out_path`."""
    lib = native_build.load("samerge", _MERGE)
    k = len(part_paths)
    paths = (ctypes.c_char_p * k)(*[p.encode() for p in part_paths])
    cnt = (ctypes.c_int64 * k)(*[int(c) for c in counts])
    wrote = lib.lrm_sa_merge(text_path.encode(), n, paths, cnt, k,
                             (out_path + ".tmp").encode())
    if wrote != n:
        raise RuntimeError(f"lrm_sa_merge wrote {wrote} of {n} entries "
                           f"into {out_path}.tmp")
    os.replace(out_path + ".tmp", out_path)


def sa_build_external(prefix: str, ram_bytes: int, margin: int = 4096,
                      tmpdir: str | None = None) -> int:
    """Build `<prefix>.sa5` with a ~ram_bytes-bounded working set,
    byte-identical to `sa_build`'s in-RAM path; returns the block count.
    The partial SAs live in a temporary directory under `tmpdir` (default:
    the system's), removed in every case."""
    assert margin >= 32
    X = np.memmap(prefix, dtype=np.uint8, mode="r")
    n = int(X.shape[0])
    block = max(4 * margin, int(ram_bytes // 12))
    td = tempfile.mkdtemp(prefix="lrm_sa_ext_", dir=tmpdir)
    try:
        paths, counts = [], []
        for b in range(0, n, block):
            part = _block_sa(X, b, min(b + block, n), margin)
            paths.append(os.path.join(td, f"part{b}.ui40"))
            with Sa5Writer(paths[-1]) as pw:   # 5-byte spill
                pw.append(part)
            counts.append(part.shape[0])
            del part
        sa_merge_files(prefix, n, paths, counts, prefix + ".sa5")
        return len(paths)
    finally:
        for f in os.listdir(td):
            os.unlink(os.path.join(td, f))
        os.rmdir(td)
