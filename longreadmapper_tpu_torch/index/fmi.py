"""Host-side FM-index build and serialization (numpy).

A copy of longreadmapper_tpu/index/fmi.py's FMIndex.build/read/write and
encode_bytes: the original module cannot be imported without JAX (its
package __init__ pulls in the device index).  Build semantics match the
reference exactly, so `.mfi` files interoperate with the JAX package:

  C table   — char counts over text[0 .. n-2] (the final '$' is not
              counted), prefix-summed over all 256 byte values.
  BWT       — bwt[i] = text[SA[i]-1], '$' where SA[i] == 0.
  O table   — per-base counts sampled every `o_ratio` positions, exclusive
              of the sample position; '$' not counted.
  CSA       — SA[i * csa_ratio].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..formats.mfi import MfiData, read_mfi, write_mfi
from ..formats.ui40 import read_sa5

# raw byte -> 2-bit code (A0 C1 G2 T3), '$' and others -> 4
_CODE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    _CODE_LUT[_ch] = _i
    _CODE_LUT[_ch + 0x20] = _i


@dataclass
class FMIndex:
    sa: np.ndarray          # (n,) int64
    c: np.ndarray           # (256,) uint64 raw-char C table
    bwt: np.ndarray         # (n,) uint8 raw BWT bytes ('$' included)
    o_ratio: int
    o: np.ndarray           # (4*(n/o_ratio+1),) uint64 interleaved
    csa_ratio: int
    csa: np.ndarray         # (n/csa_ratio+1,) uint64

    @property
    def length(self) -> int:
        return int(self.bwt.shape[0])

    @staticmethod
    def build(prefix: str, o_ratio: int = 32, csa_ratio: int = 4,
              sa: Optional[np.ndarray] = None) -> "FMIndex":
        """Build from the text file at `prefix`; builds (and writes `.sa5`
        via index/sa.sa_build) the suffix array when `sa` is not given."""
        text = np.fromfile(prefix, dtype=np.uint8)
        n = text.shape[0]
        if sa is None:
            from .sa import sa_build
            sa = sa_build(prefix)

        counts = np.bincount(text[: n - 1], minlength=256).astype(np.uint64)
        c_tab = np.zeros(256, dtype=np.uint64)
        np.cumsum(counts[:-1], out=c_tab[1:])

        bwt = np.empty(n, dtype=np.uint8)
        nz = sa != 0
        bwt[nz] = text[sa[nz] - 1]
        bwt[~nz] = ord("$")

        # exclusive sampled counts, chunked to bound the one-hot transient
        n_samples = n // o_ratio + 1
        o = np.zeros((n_samples, 4), dtype=np.uint64)
        running = np.zeros(4, dtype=np.uint64)
        chunk_samples = max(1, (1 << 26) // o_ratio)
        for ss in range(1, n_samples, chunk_samples):
            se = min(ss + chunk_samples, n_samples)
            lo, hi = (ss - 1) * o_ratio, min((se - 1) * o_ratio, n)
            codes_c = _CODE_LUT[bwt[lo:hi]]
            m = hi - lo
            oh = np.zeros((m, 4), dtype=np.uint64)
            valid = codes_c < 4
            oh[np.nonzero(valid)[0], codes_c[valid]] = 1
            csum = np.cumsum(oh, axis=0)
            sample_pos = np.minimum(np.arange(ss, se) * o_ratio, n) - lo
            o[ss:se] = running + csum[sample_pos - 1]
            running += csum[m - 1]
        o = o.reshape(-1)

        # the last CSA entry is clamped where the reference reads past the
        # end (that entry is never validly read)
        csa_len = n // csa_ratio + 1
        csa_pos = np.minimum(np.arange(csa_len) * csa_ratio, n - 1)
        csa = sa[csa_pos].astype(np.uint64)

        return FMIndex(sa=np.asarray(sa, dtype=np.int64), c=c_tab, bwt=bwt,
                       o_ratio=o_ratio, o=o, csa_ratio=csa_ratio, csa=csa)

    def write(self, prefix: str) -> None:
        write_mfi(MfiData(c=self.c, o_ratio=self.o_ratio, o=self.o,
                          bwt=self.bwt, csa_ratio=self.csa_ratio,
                          csa=self.csa), prefix)

    @staticmethod
    def read(prefix: str, with_sa: bool = True) -> "FMIndex":
        """Load `.mfi` (+ `.sa5` when `with_sa`)."""
        d = read_mfi(prefix)
        sa = read_sa5(prefix + ".sa5") if with_sa else np.empty(0, np.int64)
        return FMIndex(sa=sa, c=d.c, bwt=d.bwt, o_ratio=d.o_ratio, o=d.o,
                       csa_ratio=d.csa_ratio, csa=d.csa)

    def c4(self) -> np.ndarray:
        """(4,) int64 — C table entries for 'A','C','G','T' raw chars."""
        return self.c[[ord("A"), ord("C"), ord("G"), ord("T")]].astype(
            np.int64)


def encode_bytes(raw: np.ndarray) -> np.ndarray:
    """Raw text bytes -> 2-bit codes (4 for '$'/N/other)."""
    return _CODE_LUT[np.asarray(raw, dtype=np.uint8)]
