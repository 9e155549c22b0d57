""".lch lchash table serialization, byte-compatible with the reference (the
port's copy of longreadmapper_tpu/formats/lch.py: `read_lch`, `write_lch`).

Layout (reference lchash/lchash.c:106-127):
  hlen   int32
  len    u64            (= 2 * 4^hlen)
  table  len x u64      interleaved (k, l) SA-interval pairs; (0,0) = absent
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

from .mfi import _read_exact


def write_lch(path: str, hlen: int, kl: np.ndarray) -> None:
    """`kl` is (4^hlen, 2) — rows are (k, l) pairs."""
    kl = np.asarray(kl, dtype="<u8")
    assert kl.shape == (1 << (2 * hlen), 2), kl.shape
    # tmp + atomic rename so an interrupted build can't leave a truncated
    # table that a resume later loads as silently corrupt gathers
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<i", hlen))
        f.write(struct.pack("<Q", kl.size))
        f.write(kl.tobytes())  # row-major == interleaved k,l
    os.replace(tmp, path)


def read_lch(path: str) -> Tuple[int, np.ndarray]:
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<i", _read_exact(f, 4, "lch hlen"))
        (length,) = struct.unpack("<Q", _read_exact(f, 8, "lch len"))
        kl = np.frombuffer(_read_exact(f, length * 8, "lch table"),
                           dtype="<u8").copy().reshape(-1, 2)
    if kl.shape != (1 << (2 * hlen), 2):
        raise ValueError(f"lch table shape {kl.shape} != 4^{hlen} rows")
    return hlen, kl
