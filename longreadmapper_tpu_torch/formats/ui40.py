"""40-bit suffix-array entry codec (.sa5 files; the port's copy of
longreadmapper_tpu/formats/ui40.py: `write_sa5`, `Sa5Writer`,
`read_sa5`).

Reference layout (psascan/sa_use.h:17-47): each entry is 5 bytes
little-endian — a uint32 low word followed by a uint8 high byte
(`ui40_t { uint32_t low; uint8_t high; }` packed).  pSAscan writes the
suffix array of the .cat text in this format; the aligner reads it whole
(alnmain.c:242-252).
"""

from __future__ import annotations

import os

import numpy as np


def write_sa5(sa: np.ndarray, path: str, chunk: int = 1 << 27) -> None:
    """Write int array `sa` as 5-byte little-endian entries.

    Streams in `chunk`-entry blocks: the packing temporaries are ~12
    bytes/entry, which at genome scale (hg19 .cat = 6.2e9 entries) would
    add ~75 GB on top of the SA itself if materialized whole.  Written via
    tmp + atomic rename, so an interrupted write leaves no partial file at
    the final path."""
    n = sa.shape[0]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for s in range(0, n, chunk):
            part = np.asarray(sa[s:s + chunk], dtype=np.uint64)
            m = part.shape[0]
            buf = np.empty((m, 5), dtype=np.uint8)
            low = (part & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            buf[:, 0:4] = low.view(np.uint8).reshape(m, 4)  # LE platform
            buf[:, 4] = (part >> np.uint64(32)).astype(np.uint8)
            buf.tofile(f)
    os.replace(tmp, path)


class Sa5Writer:
    """Incremental .sa5 writer: append int batches in order (the external
    SA build spills its partial SAs through it)."""

    def __init__(self, path: str):
        # written to a tmp path; close() renames: see write_sa5
        self._path = path
        self._f = open(path + ".tmp", "wb")

    def append(self, batch: np.ndarray) -> None:
        part = np.ascontiguousarray(batch, dtype=np.uint64)
        m = part.shape[0]
        buf = np.empty((m, 5), dtype=np.uint8)
        low = (part & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        buf[:, 0:4] = low.view(np.uint8).reshape(m, 4)  # LE platform
        buf[:, 4] = (part >> np.uint64(32)).astype(np.uint8)
        buf.tofile(self._f)

    def close(self) -> None:
        self._f.close()
        os.replace(self._path + ".tmp", self._path)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:  # leave the .tmp for post-mortem; never promote a partial file
            self._f.close()


def read_sa5(path: str, count: int = -1) -> np.ndarray:
    """Read .sa5 into an int64 array (ui40_fread + ui40_convert equivalent)."""
    raw = np.fromfile(path, dtype=np.uint8,
                      count=-1 if count < 0 else count * 5)
    n = raw.shape[0] // 5
    raw = raw[: n * 5].reshape(n, 5)
    low = raw[:, 0:4].copy().view(np.uint32).reshape(n).astype(np.uint64)
    high = raw[:, 4].astype(np.uint64)
    return ((high << np.uint64(32)) | low).astype(np.int64)
