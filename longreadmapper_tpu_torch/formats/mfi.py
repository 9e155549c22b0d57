""".mfi FM-index serialization, byte-compatible with the reference (the
port's copy of longreadmapper_tpu/formats/mfi.py: `MfiData`, `read_mfi`,
`write_mfi`).

Layout (reference fmidx.c:221-275, Notes.txt:20-26):
  C table      256 x u64
  o_ratio      int32
  o_len        u64
  O table      o_len x u64   (4 interleaved base counters per sample)
  bwt length   u64
  BWT          length x char
  csa_ratio    int32
  csa_len      u64
  CSA          csa_len x u64

Divergence (documented): the reference's O table tail beyond the last
written sample index holds uninitialized malloc memory (fmidx.c:128-150
never writes entries past (length-1)/ratio); the final running counts are
written instead.  Functionally identical — those entries are never read.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np


def _read_exact(f, n: int, what: str) -> bytes:
    """Read exactly n bytes or raise: a truncated index artifact (an
    interrupted build that a resume later trusts) must fail loudly, not
    load as a silently shorter table."""
    b = f.read(n)
    if len(b) != n:
        raise ValueError(
            f"truncated {what}: wanted {n} bytes, got {len(b)} "
            f"({getattr(f, 'name', '?')})")
    return b


@dataclass
class MfiData:
    c: np.ndarray        # (256,) uint64 — C table indexed by raw char
    o_ratio: int
    o: np.ndarray        # (o_len,) uint64 — interleaved (4*sample + base)
    bwt: np.ndarray      # (length,) uint8 — raw BWT chars ('$' included)
    csa_ratio: int
    csa: np.ndarray      # (csa_len,) uint64

    @property
    def length(self) -> int:
        return int(self.bwt.shape[0])


def write_mfi(data: MfiData, prefix: str) -> None:
    # tmp + atomic rename: an interrupted build must never leave a
    # truncated .mfi at the final path for a resume to trust
    tmp = prefix + ".mfi.tmp"
    with open(tmp, "wb") as f:
        f.write(np.asarray(data.c, dtype="<u8").tobytes())
        f.write(struct.pack("<i", data.o_ratio))
        f.write(struct.pack("<Q", data.o.shape[0]))
        f.write(np.asarray(data.o, dtype="<u8").tobytes())
        f.write(struct.pack("<Q", data.bwt.shape[0]))
        f.write(np.asarray(data.bwt, dtype=np.uint8).tobytes())
        f.write(struct.pack("<i", data.csa_ratio))
        f.write(struct.pack("<Q", data.csa.shape[0]))
        f.write(np.asarray(data.csa, dtype="<u8").tobytes())
    os.replace(tmp, prefix + ".mfi")


def read_mfi(prefix: str) -> MfiData:
    with open(prefix + ".mfi", "rb") as f:
        c = np.frombuffer(_read_exact(f, 256 * 8, "mfi C table"),
                          dtype="<u8").copy()
        (o_ratio,) = struct.unpack("<i", _read_exact(f, 4, "mfi o_ratio"))
        (o_len,) = struct.unpack("<Q", _read_exact(f, 8, "mfi o_len"))
        o = np.frombuffer(_read_exact(f, o_len * 8, "mfi O table"),
                          dtype="<u8").copy()
        (length,) = struct.unpack("<Q", _read_exact(f, 8, "mfi bwt length"))
        bwt = np.frombuffer(_read_exact(f, length, "mfi BWT"),
                            dtype=np.uint8).copy()
        (csa_ratio,) = struct.unpack("<i", _read_exact(f, 4, "mfi csa_ratio"))
        (csa_len,) = struct.unpack("<Q", _read_exact(f, 8, "mfi csa_len"))
        csa = np.frombuffer(_read_exact(f, csa_len * 8, "mfi CSA"),
                            dtype="<u8").copy()
    return MfiData(c=c, o_ratio=o_ratio, o=o, bwt=bwt, csa_ratio=csa_ratio,
                   csa=csa)
